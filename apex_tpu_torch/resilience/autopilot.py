"""Self-driving parallelism: drift detection -> re-rank -> gated adoption —
port of ``apex_tpu/resilience/autopilot.py``.

The :class:`ParallelismAutopilot` runs the measure -> plan -> adopt
pipeline ONLINE, as a control loop with the same discipline as
:class:`~apex_tpu_torch.resilience.capacity.CapacityController`, over the
port's :class:`~apex_tpu_torch.resilience.elastic.ElasticTrainer`:

1. **Observe.** Production telemetry flows in continuously —
   :meth:`ParallelismAutopilot.record_step` takes measured training
   step times (what a ``TrainingMonitor`` sees), and
   :meth:`ParallelismAutopilot.observe` takes collective
   :class:`~apex_tpu_torch.observability.costmodel.Measurement` points.
   Nothing stalls: points are buffered by ``CostModel.update``.
   :meth:`ParallelismAutopilot.observe_anatomy` is the third feed — a
   measured-vs-predicted timeline diff (a dict with a ``drift_score``, or
   the bare score), the STRUCTURAL drift channel that curve refits cannot
   see.
2. **Detect.** Each tick refits the buffer.  A refit whose curves moved
   past ``drift_threshold`` relative to the loaded profile counts toward a
   confirmation streak; a refit within the threshold RESETS it — so a
   one-window spike never moves a plan, and too-few fresh measurements
   never even refit.
3. **Re-rank.** On a confirmed streak the refreshed profile is adopted,
   and the plan space is re-ranked against it (a pluggable ``ranker``;
   the built-in one prices dp candidates by a telemetry-calibrated
   compute roofline + the alpha-beta cost of the gradient all-reduce).
4. **Adopt, gated.** A winning plan that differs from the current one
   goes through measure -> drain -> commit: re-measure ``gate_steps``
   fresh step times under the OLD plan (the pre-adoption baseline),
   ``trainer.replan_to(new)`` (the boundary checkpoint under the old
   plan IS the drain), then measure ``gate_steps`` under the NEW plan.
   Commit only when the new measured mean is within ``gate_tolerance`` of
   the baseline; on measured regression ROLL BACK — ``replan_to(old)``.
   Commits and rollbacks both start a cooldown; drifts confirmed while
   busy or cooling down QUEUE, never interleave.

Chaos hooks: the injector's ``cost_drift`` fault scales the (simulated)
machine's link coefficients — drifted telemetry keeps flowing so the
DETECTOR must converge on it; ``plan_regression`` inflates the commit-gate
measurements so the rollback path is forced deterministically.
:meth:`ParallelismAutopilot.audit` replays the adoption log and flags any
adoption that started without a confirmed over-threshold drift or before
cooldown expiry.

Many ranks: every rank of the trainer's job (the default
:mod:`torch.distributed` group, as for ``ElasticTrainer``) runs its own
autopilot, and their decisions must agree (a re-plan is a collective).
Over more than one rank the feeds (:meth:`record_step`, :meth:`observe`)
only buffer, and each :meth:`tick` opens with one broadcast from the first
rank: its buffered step times and measurements, its clock reading (the
tick's time for every cooldown and log entry) and its model's gradient
bytes.  Every rank applies that same input to the same state, so they rank
the same plans and take the same decisions at the same tick; the other
ranks' own feeds are dropped (a data-parallel step ends on every rank
together).  Ticks are collective; feeds are not.  :meth:`observe_anatomy`
is applied at once and must be fed the same report on every rank.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional

from apex_tpu_torch.observability.costmodel import (
    CostModel, simulate_link_measurements)

ADOPTION_OUTCOMES = ("commit", "rollback", "no_change")


def _world_size() -> int:
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


@dataclasses.dataclass
class _Adoption:
    """One in-flight plan adoption (at most one exists at a time)."""
    entry: dict                      # the adoption_log row, updated in place
    t0: float
    regression_scale: float = 1.0    # injected plan_regression inflation
    old_spec: object = None
    new_spec: object = None
    predicted_s: float = 0.0
    phase: str = "baseline"          # baseline -> gate
    rank_s: float = 0.0
    drain_s: float = 0.0
    reshard_s: float = 0.0
    baseline_s: float = 0.0
    baseline_times: List[float] = dataclasses.field(default_factory=list)
    gate_times: List[float] = dataclasses.field(default_factory=list)


class ParallelismAutopilot:
    """Online cost-drift detection with gated, reversible plan adoption.

    Drive it like the capacity controller: feed telemetry
    (:meth:`observe`, :meth:`record_step`) as it arrives and call
    :meth:`tick` from the control loop.  The autopilot never blocks
    the training loop — refits and ranking are cheap host-side fits,
    and the only training-visible actions are the two ``replan_to``
    calls of an adoption (drain + re-shard, exactly what a manual
    re-plan costs).

    ``ranker(cost_model)`` may be supplied to rank the full plan space
    (the JAX package's ``tools/autotune.py rank_plans`` has no port yet);
    it must return ``[{"spec": TopologySpec, "predicted_s": float}, ...]``
    best-first.  The built-in fallback re-ranks the dp degrees available
    on the trainer's ranks (its job's rank list; the gradient bytes are
    its model's parameters' ``numel * element_size``): compute is a
    roofline calibrated from the measured baseline (``(baseline -
    comm(dp_cur)) * dp_cur``), comm is the profile's alpha-beta price of
    the gradient all-reduce — enough for a drifted interconnect to flip
    the winner, which is the loop under test.
    """

    def __init__(self, trainer, profile: CostModel, *,
                 ranker: Optional[Callable] = None,
                 drift_threshold: float = 0.3,
                 structural_threshold: Optional[float] = None,
                 confirm_windows: int = 2,
                 min_measurements: int = 8,
                 cooldown_s: float = 60.0,
                 gate_steps: int = 3,
                 gate_tolerance: float = 1.2,
                 refit_every: int = 1,
                 min_dp: int = 1,
                 link_class: str = "ici",
                 grad_bytes: Optional[int] = None,
                 max_profile_age_s: Optional[float] = None,
                 step_window: int = 8,
                 injector=None, registry=None, tracer=None,
                 recorder=None,
                 clock: Optional[Callable[[], float]] = None):
        if drift_threshold <= 0.0:
            raise ValueError("drift_threshold must be > 0")
        if confirm_windows < 1:
            raise ValueError("confirm_windows must be >= 1")
        if gate_steps < 1:
            raise ValueError("gate_steps must be >= 1")
        if gate_tolerance < 1.0:
            raise ValueError("gate_tolerance must be >= 1.0 (a gate "
                             "tighter than measured-parity would veto "
                             "every adoption on noise)")
        if refit_every < 1:
            raise ValueError("refit_every must be >= 1")
        self.trainer = trainer
        self.profile = profile
        self.ranker = ranker
        self.drift_threshold = float(drift_threshold)
        self.structural_threshold = float(
            drift_threshold if structural_threshold is None
            else structural_threshold)
        if self.structural_threshold <= 0.0:
            raise ValueError("structural_threshold must be > 0")
        self.confirm_windows = int(confirm_windows)
        self.min_measurements = int(min_measurements)
        self.cooldown_s = float(cooldown_s)
        self.gate_steps = int(gate_steps)
        self.gate_tolerance = float(gate_tolerance)
        self.refit_every = int(refit_every)
        self.min_dp = int(min_dp)
        self.link_class = str(link_class)
        self.max_profile_age_s = max_profile_age_s
        self.injector = injector
        self.registry = registry
        self.tracer = tracer
        self.recorder = recorder
        self.clock = (clock if clock is not None
                      else getattr(trainer, "clock", None)
                      or time.perf_counter)
        self._job = _world_size()
        self._tick_now: Optional[float] = None   # the first rank's, a tick
        self._inbox_dt: List[float] = []
        self._inbox_ms: list = []

        self._tick = 0
        self._streak = 0
        self._anat_streak = 0
        self._cooldown_until = float("-inf")
        self._queue: Deque[dict] = collections.deque()
        self._adoption: Optional[_Adoption] = None
        self._candidate: Optional[CostModel] = None
        self._grad_bytes = grad_bytes
        self._recent_dt: Deque[float] = collections.deque(
            maxlen=int(step_window))
        # injected drifted environment: (op, dtype, link_class) ->
        # [alpha, beta]; non-empty only after a cost_drift fault, and
        # from then on it keeps synthetic telemetry flowing each tick
        # (the machine STAYS drifted — the detector must converge)
        self._drift_env: Dict[tuple, List[float]] = {}
        self.adoption_log: List[dict] = []
        self.stats = {"refits": 0, "drift_confirmed": 0, "adoptions": 0,
                      "rollbacks": 0, "no_change": 0, "queued": 0,
                      "drift_faults": 0, "last_drift": None,
                      "last_refit_s": 0.0, "last_adoption": None,
                      "structural_confirmed": 0,
                      "last_structural": None}

        self._g_drift = self._c_adopt = self._h_refit = None
        if registry is not None:
            self._g_drift = registry.gauge(
                "autopilot_drift_detected",
                "1 while a confirmed cost-model drift awaits or "
                "undergoes plan adoption")
            self._c_adopt = registry.counter(
                "autopilot_adoptions_total",
                "plan adoptions by outcome (commit|rollback|no_change)",
                labelnames=("outcome",))
            self._h_refit = registry.histogram(
                "autopilot_refit_seconds",
                "wall seconds per incremental cost-model refit")

    # -- telemetry in --------------------------------------------------------

    def _now(self) -> float:
        return self._tick_now if self._tick_now is not None \
            else self.clock()

    def _agree_tick(self) -> None:
        """Over several ranks, the tick's one collective: the first rank's
        buffered feeds, clock and gradient bytes, applied on every rank."""
        if self._job <= 1:
            return
        import torch.distributed as dist
        msg = None
        if dist.get_rank() == 0:
            model = getattr(self.trainer, "model", None)
            grad_bytes = self._grad_bytes
            if grad_bytes is None and model is not None:
                grad_bytes = sum(p.numel() * p.element_size()
                                 for p in model.parameters())
            msg = {"dt": self._inbox_dt, "ms": self._inbox_ms,
                   "now": self.clock(), "grad_bytes": grad_bytes}
        box = [msg]
        dist.broadcast_object_list(box, src=0)
        msg = box[0]
        self._inbox_dt, self._inbox_ms = [], []
        self._tick_now = msg["now"]
        if msg["grad_bytes"] is not None:
            self._grad_bytes = int(msg["grad_bytes"])
        if msg["ms"]:
            self.profile.update(msg["ms"])
        for dt in msg["dt"]:
            self._take_step(dt)

    def observe(self, measurements) -> int:
        """Feed fresh collective measurements (channel timings, traces,
        probes) into the profile's refit buffer; returns the buffered
        count.  Non-blocking — nothing is fitted until a tick's refit
        window.  Over several ranks they wait for the next tick (the
        first rank's are applied)."""
        if self._job > 1:
            self._inbox_ms.extend(measurements)
            return len(self.profile.fresh_measurements) + len(self._inbox_ms)
        return self.profile.update(measurements)

    def observe_anatomy(self, report) -> bool:
        """Feed one step's measured-vs-predicted timeline diff (the
        dict :func:`apex_tpu_torch.observability.anatomy.diff_timelines`
        returns for an :class:`~apex_tpu_torch.mpmd.engine.MpmdPipeline`
        step, or its bare ``drift_score``).

        This is the STRUCTURAL drift channel: the cost-model path
        sees curve drift (links got slower), this one sees the
        schedule itself diverging from the model — mis-ordered ops,
        bubbles the simulator didn't predict, one stage's ops
        suddenly off-median.  Scores at or past
        ``structural_threshold`` build their own confirmation streak
        (same ``confirm_windows`` debounce as refit drift, so one
        noisy step never moves a plan); a confirmed streak queues an
        adoption pass carrying the score and the report's worst
        offenders.  Returns True when this call confirmed."""
        if isinstance(report, dict):
            score = float(report.get("drift_score", 0.0))
            detail = {"worst_op": report.get("worst_op"),
                      "median_ratio": report.get("median_ratio"),
                      "unpredicted_bubble_fraction":
                          report.get("unpredicted_bubble_fraction"),
                      "misordered": len(report.get("misordered", []))}
        else:
            score = float(report)
            detail = {}
        self.stats["last_structural"] = score
        if score >= self.structural_threshold:
            self._anat_streak += 1
        else:
            self._anat_streak = 0
        self._record("anatomy", score=round(score, 6),
                     streak=self._anat_streak, **detail)
        if self._anat_streak < self.confirm_windows:
            return False
        self._anat_streak = 0
        self.stats["structural_confirmed"] += 1
        if self._g_drift is not None:
            self._g_drift.set(1)
        # coalesce with a pending structural request (same discipline
        # as _confirm_drift: an ongoing divergence re-confirms every
        # confirm_windows steps — refresh, don't pile up)
        for req in self._queue:
            if not req["manual"] and req.get("source") == "anatomy":
                req["drift"] = score
                req["detail"] = detail
                self._record("structural_confirmed", drift=score,
                             coalesced=True)
                return True
        self._queue.append({"model": None, "drift": score,
                            "manual": False, "source": "anatomy",
                            "detail": detail})
        self.stats["queued"] += 1
        self._record("structural_confirmed", drift=score)
        return True

    def record_step(self, dt: float) -> None:
        """Feed one measured training step duration.  Drives the rolling
        baseline the ranker calibrates against and, during an adoption,
        the K-step baseline/gate measurements (an in-flight adoption's
        samples are kept out of the rolling window until it resolves —
        they belong to exactly one arm of the A/B).  Over several ranks
        the time waits for the next tick, where the first rank's is
        recorded on every rank."""
        if self._job > 1:
            self._inbox_dt.append(float(dt))
            return
        self._take_step(float(dt))

    def _take_step(self, dt: float) -> None:
        ad = self._adoption
        if ad is not None:
            if ad.phase == "baseline":
                ad.baseline_times.append(float(dt))
                return
            if ad.phase == "gate":
                ad.gate_times.append(float(dt) * ad.regression_scale)
                return
        self._recent_dt.append(float(dt))

    # -- the control loop ----------------------------------------------------

    def tick(self) -> None:
        """One control-loop turn: consume due faults, refit the
        telemetry buffer, debounce drift, advance any in-flight
        adoption, and start a queued one once cooldown allows."""
        self._tick += 1
        self._agree_tick()
        self._poll_faults()
        if self._drift_env:
            self._synthesize_telemetry()
        if self._tick % self.refit_every == 0:
            drifted = self._refit_window()
            if drifted is not None:
                if drifted:
                    self._streak += 1
                else:
                    self._streak = 0
                if self._streak >= self.confirm_windows:
                    self._confirm_drift()
        if self._adoption is not None:
            self._advance(self._adoption)
            return
        now = self._now()
        if (self._queue and now >= self._cooldown_until
                and self._recent_dt):
            self._start_adoption(self._queue.popleft())

    def request_adoption(self, model: Optional[CostModel] = None) -> None:
        """Operator override: queue an adoption pass (re-rank + gated
        adopt) without waiting for a drift confirmation.  Marked manual
        so :meth:`audit` does not flag it."""
        self._queue.append({"model": model, "drift": None,
                            "manual": True})
        self.stats["queued"] += 1
        self._record("adoption_queued", manual=True)

    @property
    def adopting(self) -> bool:
        return self._adoption is not None

    @property
    def queued(self) -> int:
        return len(self._queue)

    # -- fault hooks ---------------------------------------------------------

    def _poll_faults(self) -> None:
        if self.injector is None:
            return
        step = int(getattr(self.trainer, "current_step", 0))
        f = self.injector.check_cost_drift(step)
        if f is not None:
            self._apply_cost_drift(f)

    def _apply_cost_drift(self, fault) -> None:
        """An injected ``cost_drift``: the (simulated) machine's links
        change speed by ``magnitude``.  Seeds the drifted environment
        from the CURRENT profile's curves; telemetry synthesized from
        it flows every tick from here on, so detection happens the
        honest way — by refitting measurements."""
        scale = float(fault.magnitude or 0.0) or 2.0
        if not self._drift_env:
            for key, fit in self.profile.curves().items():
                self._drift_env[key] = [fit.alpha_s, fit.beta_s_per_byte]
        for ab in self._drift_env.values():
            ab[0] *= scale
            ab[1] *= scale
        self.stats["drift_faults"] += 1
        self._record("cost_drift_fault", scale=scale)

    def _synthesize_telemetry(self) -> None:
        ms = []
        for (op, dtype, lc), (a, b) in sorted(self._drift_env.items()):
            ms.extend(simulate_link_measurements(
                a, b, link_class=lc, ops=(op,), dtypes=(dtype,),
                sizes=(1 << 12, 1 << 16, 1 << 20), group_sizes=(2, 4)))
        # the same on every rank: straight in, not through the tick's inbox
        self.profile.update(ms)

    # -- detect --------------------------------------------------------------

    def _refit_window(self) -> Optional[bool]:
        """One refit window; None when there was no window (too few
        fresh measurements — the buffer is kept and the confirmation
        streak is left UNTOUCHED: absence of data is not evidence of
        stability)."""
        t0 = time.perf_counter()
        res = self.profile.refit(min_measurements=self.min_measurements)
        if not res["refitted"]:
            return None
        dt = time.perf_counter() - t0
        self.stats["refits"] += 1
        self.stats["last_refit_s"] = dt
        if self._h_refit is not None:
            self._h_refit.observe(dt)
        drift = res["drift"]["max_drift"]
        self.stats["last_drift"] = drift
        self._candidate = res["model"]
        drifted = drift >= self.drift_threshold
        self._record("refit", n=res["n"], drift=round(drift, 6),
                     drifted=drifted)
        return drifted

    def _confirm_drift(self) -> None:
        self._streak = 0
        self.stats["drift_confirmed"] += 1
        if self._g_drift is not None:
            self._g_drift.set(1)
        # coalesce: while an adoption is busy or cooling down, the SAME
        # ongoing drift keeps re-confirming every confirm_windows ticks
        # — refresh the pending request to the latest refit candidate
        # instead of piling up stale duplicates (each stale entry would
        # later start its own adoption: plan churn, exactly what the
        # audit calls flapping)
        for req in self._queue:
            if not req["manual"] and req.get("source") != "anatomy":
                req["model"] = self._candidate
                req["drift"] = self.stats["last_drift"]
                self._record("drift_confirmed", drift=req["drift"],
                             coalesced=True)
                return
        self._queue.append({"model": self._candidate,
                            "drift": self.stats["last_drift"],
                            "manual": False, "source": "cost"})
        self.stats["queued"] += 1
        self._record("drift_confirmed", drift=self.stats["last_drift"])

    # -- rank ----------------------------------------------------------------

    def _rank_plans(self) -> List[dict]:
        if self.ranker is not None:
            return list(self.ranker(self.profile))
        cur = self.trainer.plan.spec
        if self._grad_bytes is None:
            model = getattr(self.trainer, "model", None)
            local = (0 if model is None else sum(
                p.numel() * p.element_size() for p in model.parameters()))
            self._grad_bytes = int(local)
        base = sum(self._recent_dt) / len(self._recent_dt)

        def comm(dp):
            if dp <= 1:
                return 0.0
            return self.profile.predict("psum", self._grad_bytes, dp,
                                        link_class=self.link_class)

        # roofline calibrated from what the machine measures RIGHT NOW:
        # whatever the baseline isn't spending on the all-reduce is
        # serial compute, perfectly dp-scalable for a replicated batch
        serial_s = max(base - comm(cur.dp), 0.0) * cur.dp
        n = len(getattr(self.trainer, "_ranks", ())) or cur.dp
        # a ZeRO plan at dp 1 has zero_shard 1 too: the trainer's base plan
        # says whether its state is sharded when it grows back (the JAX
        # ranker reads the current plan alone, and from dp 1 it would
        # build a ZeRO optimizer over a plan that says zero_shard 1)
        base = getattr(self.trainer, "_base_spec", cur)
        sharded = max(cur.zero_shard, base.zero_shard) > 1
        out = []
        for dp in range(1, n + 1):
            if n % dp or dp < self.min_dp:
                continue
            spec = dataclasses.replace(cur, dp=dp,
                                       zero_shard=dp if sharded else 1)
            out.append({"spec": spec,
                        "predicted_s": serial_s / dp + comm(dp)})
        out.sort(key=lambda r: r["predicted_s"])
        return out

    # -- adopt ---------------------------------------------------------------

    def _start_adoption(self, req: dict) -> None:
        now = self._now()
        model = req.get("model")
        if model is not None:
            # adopt the refreshed profile NOW: ranking must see it, and
            # it survives a plan rollback — the measurements don't lie,
            # only the plan bet is reversible.  Carry any telemetry
            # buffered since the refit window that produced it.
            model.update(self.profile.fresh_measurements)
            self.profile = model
        entry = {"tick": self._tick, "t": now,
                 "drift": req.get("drift"),
                 "manual": bool(req.get("manual")),
                 "source": req.get("source",
                                   "manual" if req.get("manual")
                                   else "cost"),
                 "cooldown_ok": now >= self._cooldown_until,
                 "fault": False, "old": None, "new": None,
                 "outcome": None, "reason": None}
        if req.get("detail"):
            entry["detail"] = req["detail"]
        self.adoption_log.append(entry)
        t0 = time.perf_counter()
        ranked = self._rank_plans()
        rank_s = time.perf_counter() - t0
        cur = self.trainer.plan.spec
        winner = ranked[0] if ranked else None
        entry["old"] = cur.describe()
        if winner is None or winner["spec"] == cur:
            entry["outcome"] = "no_change"
            entry["reason"] = ("ranked winner is the current plan"
                               if winner else "empty plan space")
            entry["new"] = entry["old"]
            self._resolve_counters("no_change")
            self.stats["no_change"] += 1
            self._cooldown_until = now + self.cooldown_s
            self._record("adoption_no_change", rank_s=round(rank_s, 6))
            return
        ad = _Adoption(entry=entry, t0=now, rank_s=rank_s,
                       old_spec=cur, new_spec=winner["spec"],
                       predicted_s=float(winner["predicted_s"]))
        entry["new"] = ad.new_spec.describe()
        if self.injector is not None:
            f = self.injector.check_plan_regression(
                int(getattr(self.trainer, "current_step", 0)))
            if f is not None:
                ad.regression_scale = float(f.magnitude or 0.0) or 2.0
                entry["fault"] = True
        self._adoption = ad
        self._record("adoption_start", old=entry["old"],
                     new=entry["new"], rank_s=round(rank_s, 6),
                     predicted_s=round(ad.predicted_s, 6),
                     drift=entry["drift"], manual=entry["manual"])

    def _advance(self, ad: _Adoption) -> None:
        if (ad.phase == "baseline"
                and len(ad.baseline_times) >= self.gate_steps):
            ad.baseline_s = (sum(ad.baseline_times)
                             / len(ad.baseline_times))
            ad.entry["baseline_s"] = ad.baseline_s
            self._record("phase", phase="drain",
                         baseline_s=round(ad.baseline_s, 6))
            try:
                self.trainer.replan_to(ad.new_spec)
            except Exception as e:   # manifest stamp already restored
                self._rollback(ad, f"replan failed: "
                                   f"{type(e).__name__}: {e}",
                               resharded=False)
                return
            st = getattr(self.trainer, "stats", {})
            ad.drain_s = float(st.get("last_checkpoint_s", 0.0))
            ad.reshard_s = float(st.get("last_reshard_s", 0.0))
            ad.phase = "gate"
            self._record("phase", phase="gate",
                         drain_s=round(ad.drain_s, 6),
                         reshard_s=round(ad.reshard_s, 6))
        elif (ad.phase == "gate"
                and len(ad.gate_times) >= self.gate_steps):
            gate = sum(ad.gate_times) / len(ad.gate_times)
            ad.entry["gate_s"] = gate
            if gate <= ad.baseline_s * self.gate_tolerance:
                self._commit(ad, gate)
            else:
                self._rollback(
                    ad, f"measured regression: gate mean {gate:.6f}s > "
                        f"baseline {ad.baseline_s:.6f}s x "
                        f"{self.gate_tolerance}")

    def _commit(self, ad: _Adoption, gate_s: float) -> None:
        now = self._now()
        ad.entry["outcome"] = "commit"
        ad.entry["reason"] = (f"gate mean {gate_s:.6f}s within "
                              f"{self.gate_tolerance}x of baseline "
                              f"{ad.baseline_s:.6f}s")
        self.stats["adoptions"] += 1
        self.stats["last_adoption"] = {
            "outcome": "commit", "old": ad.entry["old"],
            "new": ad.entry["new"], "rank_s": ad.rank_s,
            "drain_s": ad.drain_s, "reshard_s": ad.reshard_s,
            "rollback_s": 0.0, "baseline_s": ad.baseline_s,
            "gate_s": gate_s, "total_s": now - ad.t0}
        self._resolve_counters("commit")
        # the new plan's gate measurements seed the rolling baseline
        self._recent_dt.clear()
        self._recent_dt.extend(ad.gate_times)
        self._cooldown_until = now + self.cooldown_s
        self._adoption = None
        self._record("adoption_commit", new=ad.entry["new"],
                     gate_s=round(gate_s, 6))
        if self.recorder is not None:
            self.recorder.trigger(
                "autopilot_adoption", old=ad.entry["old"],
                new=ad.entry["new"], gate_s=gate_s)

    def _rollback(self, ad: _Adoption, reason: str,
                  resharded: bool = True) -> None:
        t0 = time.perf_counter()
        if resharded:
            # the boundary checkpoint written under the old plan makes
            # this bitwise: replan back and resume as if never adopted
            self.trainer.replan_to(ad.old_spec)
        rollback_s = time.perf_counter() - t0
        now = self._now()
        ad.entry["outcome"] = "rollback"
        ad.entry["reason"] = reason
        self.stats["rollbacks"] += 1
        self.stats["last_adoption"] = {
            "outcome": "rollback", "old": ad.entry["old"],
            "new": ad.entry["new"], "rank_s": ad.rank_s,
            "drain_s": ad.drain_s, "reshard_s": ad.reshard_s,
            "rollback_s": rollback_s, "baseline_s": ad.baseline_s,
            "gate_s": ad.entry.get("gate_s"), "total_s": now - ad.t0}
        self._resolve_counters("rollback")
        self._cooldown_until = now + self.cooldown_s
        self._adoption = None
        self._record("adoption_rollback", old=ad.entry["old"],
                     reason=reason)
        if self.recorder is not None:
            self.recorder.trigger(
                "autopilot_rollback", old=ad.entry["old"],
                new=ad.entry["new"], reason=reason)

    def _resolve_counters(self, outcome: str) -> None:
        if self._c_adopt is not None:
            self._c_adopt.inc(outcome=outcome)
        if self._g_drift is not None:
            self._g_drift.set(0)

    # -- audit ---------------------------------------------------------------

    def audit(self) -> List[dict]:
        """Replay the adoption log against the controller's own rules;
        a well-behaved run returns ``[]``.  Flags (a) a non-manual
        adoption that started without a confirmed over-threshold drift
        (``cost`` entries against ``drift_threshold``, ``anatomy``
        entries against ``structural_threshold``) and (b) any adoption
        that started before cooldown expiry — the plan-churn analogue
        of capacity flapping."""
        out = []
        for e in self.adoption_log:
            thr = (self.structural_threshold
                   if e.get("source") == "anatomy"
                   else self.drift_threshold)
            if not e["manual"] and (e["drift"] is None
                                    or e["drift"] < thr):
                out.append({"tick": e["tick"], "drift": e["drift"],
                            "reason": "adoption started without a "
                                      "confirmed drift past the "
                                      "threshold"})
            if not e["cooldown_ok"]:
                out.append({"tick": e["tick"],
                            "reason": "adoption started before "
                                      "cooldown expiry"})
        return out

    # -- plumbing ------------------------------------------------------------

    def _record(self, what: str, **kw) -> None:
        if self.recorder is not None:
            self.recorder.record("autopilot", what, tick=self._tick,
                                 **kw)
        if self.tracer is not None:
            self.tracer.instant(f"autopilot/{what}", tick=self._tick,
                                **kw)
