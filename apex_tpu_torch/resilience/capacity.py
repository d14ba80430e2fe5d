"""Pool capacity shifting for the disaggregated serving fleet — port of
the pool half of ``apex_tpu/resilience/capacity.py``.

A :class:`PoolCapacityController` moves serving replicas between named
pools (prefill and decode) on their SLO burn, with hysteresis + cooldown
and a two-phase reserve → drain → commit protocol whose every phase can
fail and roll back:

* **Hysteresis + cooldown** — a shift needs ``confirm_ticks``
  consecutive ticks beyond the band edge, and no shift starts within
  ``cooldown_s`` of the previous shift OR rollback; :meth:`audit` proves
  after the fact that no burn-driven shift broke that contract.
* **Fault injection** — the ``capacity_change`` fault kind of the
  serving injector lands here: :data:`CAPACITY_FAULT_MODES` maps the
  fault's ``magnitude`` to a mid-shift crash, a stuck drain (the
  ``drain_timeout_ticks`` timeout fires), or a failed re-shard
  (:class:`ReshardFailed` raised where a replica build would fail).
* **Flight recording** — every shift start, phase, commit and rollback
  lands in the recorder's ``capacity`` source.

After every commit the controller resets each live replica's SLO
windows: burn computed over a pre-shift window describes a fleet that
no longer exists.

The train/serve ``CapacityController`` (which moves chips between an
elastic trainer and the fleet) waits for the elastic trainer's port.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional, Tuple

CAPACITY_FAULT_MODES = ("mid_shift_crash", "stuck_drain",
                        "failed_reshard")


def fault_mode(magnitude: float) -> str:
    """Map a ``capacity_change`` fault's ``magnitude`` to its failure
    mode: 0/1 mid-shift crash, 2 stuck drain, 3 failed re-shard (out of
    range clamps to mid-shift crash, the most general failure)."""
    m = int(magnitude)
    if m == 2:
        return "stuck_drain"
    if m == 3:
        return "failed_reshard"
    return "mid_shift_crash"


class ReshardFailed(RuntimeError):
    """Injected re-shard failure (``capacity_change`` magnitude 3) —
    raised at the exact point a factory build or re-shard error would
    surface, so the rollback path it exercises is the real one."""


@dataclasses.dataclass(frozen=True)
class CapacityBudget:
    """The current chip split.  ``chips_per_replica`` is the exchange
    rate between the two sides: a shift frees/consumes training dp in
    whole-replica units."""
    total_chips: int
    train_chips: int
    serve_chips: int
    chips_per_replica: int = 1

    def __post_init__(self):
        if self.chips_per_replica < 1:
            raise ValueError("chips_per_replica must be >= 1")
        if self.train_chips + self.serve_chips != self.total_chips:
            raise ValueError(
                f"split {self.train_chips}+{self.serve_chips} != "
                f"total {self.total_chips}")


@dataclasses.dataclass
class _PoolShift:
    """In-flight pool-to-pool replica move (one at a time)."""
    direction: str                        # e.g. "to_decode"
    src: str
    dst: str
    mode: Optional[str]                   # injected failure mode
    entry: dict
    t0: float
    started_tick: int
    victim: int = -1
    phase: str = "reserve"
    drain_started_tick: int = 0


class PoolCapacityController:
    """The train/serve ``CapacityController``'s hysteresis + two-phase protocol
    generalized to N serving pools — built for the disaggregated
    prefill/decode fleet, where the two pools burn DIFFERENT SLOs
    (prefill burns TTFT, decode burns TPOT) and must be sized
    independently: a prompt-heavy hour needs prefill replicas that a
    decode-heavy hour should hand back.

    ``pools`` maps pool name → :class:`~apex_tpu_torch.serving.FleetRouter`;
    ``burn_metrics`` maps pool name → the SLO metric names whose burn
    drives THAT pool (default ``ttft``/``queue_wait`` for a pool named
    ``"prefill"``, ``token_latency`` for everything else — the TPOT
    side).  ``replica_factory(pool_name) -> engine`` builds a fresh
    replica for the receiving pool: a replica cannot simply change
    sides, because a prefill-pool engine is ``prefill_only=True`` and a
    decode-pool engine is not — the chip moves, the engine is rebuilt.

    A shift toward pool P starts when P's burn held ≥ ``burn_high``
    for ``confirm_ticks`` while the donor's burn held ≤ ``burn_low``
    for as long (a donor under its own pressure never donates), and
    never within ``cooldown_s`` of the previous shift or rollback —
    the same can-never-flap contract :meth:`audit` proves for the
    train/serve controller.  The move itself is the two-phase
    protocol over the fleet lifecycle: reserve (pick the least-loaded
    healthy donor replica) → drain (``begin_drain``; migration moves
    its work to donor peers; timeout → ``cancel_drain`` + rollback) →
    commit (``remove_replica`` from the donor, ``add_replica`` the
    rebuilt engine to the receiver, reset every SLO window).  The
    ``capacity_change`` fault kind fails a shift at the same three
    points the train/serve controller models.

    Series: ``capacity_pool_replicas{pool}`` / ``capacity_pool_burn
    {pool}`` gauges, ``capacity_pool_shifts_total{direction}`` /
    ``capacity_pool_rollbacks_total`` counters.
    """

    DEFAULT_PREFILL_METRICS = ("ttft", "queue_wait")
    DEFAULT_DECODE_METRICS = ("token_latency",)

    def __init__(self, pools: dict, replica_factory: Callable, *,
                 burn_metrics: Optional[dict] = None,
                 min_replicas: int = 1,
                 burn_high: float = 6.0, burn_low: float = 1.0,
                 burn_window_s: float = 30.0, confirm_ticks: int = 3,
                 cooldown_s: float = 60.0, drain_timeout_ticks: int = 50,
                 serving_injector=None, registry=None, tracer=None,
                 recorder=None,
                 clock: Optional[Callable[[], float]] = None):
        if len(pools) < 2:
            raise ValueError("need at least two pools to shift between")
        if burn_low >= burn_high:
            raise ValueError("need burn_low < burn_high (the hysteresis "
                             "band is what prevents thrash)")
        if confirm_ticks < 1 or drain_timeout_ticks < 1 \
                or min_replicas < 1:
            raise ValueError("confirm_ticks, drain_timeout_ticks and "
                             "min_replicas must be >= 1")
        self.pools = dict(pools)
        self.replica_factory = replica_factory
        self.burn_metrics = {
            name: tuple(burn_metrics[name]) if burn_metrics is not None
            and name in burn_metrics
            else (self.DEFAULT_PREFILL_METRICS if name == "prefill"
                  else self.DEFAULT_DECODE_METRICS)
            for name in self.pools}
        self.min_replicas = int(min_replicas)
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.burn_window_s = float(burn_window_s)
        self.confirm_ticks = int(confirm_ticks)
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout_ticks = int(drain_timeout_ticks)
        self.serving_injector = serving_injector
        self.tracer = tracer
        self.recorder = recorder
        self.clock = clock if clock is not None \
            else next(iter(self.pools.values())).clock
        self._tick = 0
        self._hi = {name: 0 for name in self.pools}
        self._lo = {name: 0 for name in self.pools}
        self._cooldown_until = float("-inf")
        self._shift: Optional[_PoolShift] = None
        self._queue: collections.deque = collections.deque()
        self.shift_log: List[dict] = []
        self.stats = {"shifts": 0, "rollbacks": 0, "queued": 0,
                      "last_shift": None}
        self._g_reps = self._g_burn = None
        self._c_shifts = self._c_rollbacks = None
        if registry is not None:
            self._g_reps = registry.gauge(
                "capacity_pool_replicas", "live replicas, by pool",
                labelnames=("pool",))
            self._g_burn = registry.gauge(
                "capacity_pool_burn",
                "per-pool max short-window SLO burn the controller sees",
                labelnames=("pool",))
            self._c_shifts = registry.counter(
                "capacity_pool_shifts_total",
                "committed pool-to-pool replica moves",
                labelnames=("direction",))
            self._c_rollbacks = registry.counter(
                "capacity_pool_rollbacks_total",
                "pool shifts rolled back (fault, timeout, failure)")
        self._publish()

    # -- observability -------------------------------------------------------

    @property
    def shifting(self) -> bool:
        return self._shift is not None

    @property
    def split(self) -> dict:
        """Live replica count per pool."""
        return {name: len(r._live()) for name, r in self.pools.items()}

    def _publish(self) -> None:
        if self._g_reps is not None:
            for name, n in self.split.items():
                self._g_reps.set(n, pool=name)

    def _record(self, what: str, **kw) -> None:
        if self.recorder is not None:
            self.recorder.record("capacity", what, tick=self._tick, **kw)
        if self.tracer is not None:
            self.tracer.instant(f"capacity/{what}", tick=self._tick, **kw)

    def audit(self) -> List[dict]:
        """Out-of-band flap check, same contract as
        ``CapacityController.audit``: every burn-driven shift must
        have started with the receiving pool's burn OUTSIDE the
        hysteresis band and after the cooldown expired — the disagg
        scenarios assert this returns ``[]``."""
        out = []
        for e in self.shift_log:
            if not e["manual"] \
                    and self.burn_low < e["burn"] < self.burn_high:
                out.append({"tick": e["tick"], "reason":
                            "shift started with burn inside the "
                            "hysteresis band", "burn": e["burn"]})
            if not e["cooldown_ok"]:
                out.append({"tick": e["tick"], "reason":
                            "shift started before cooldown expiry"})
        return out

    # -- signals -------------------------------------------------------------

    def pool_burn(self, name: str) -> float:
        """Max short-window burn across pool ``name``'s replicas, over
        the pool's OWN SLO metrics only (TTFT-class for prefill,
        TPOT-class for decode) — cross-pool metrics must not trigger a
        shift toward a pool whose own objective is healthy.  Falls back
        to all targets when none match (a monitor wired with custom
        metric names still drives the controller)."""
        metrics = self.burn_metrics[name]
        burns = []
        for _, e in self.pools[name]._live():
            slo = getattr(e.metrics, "slo", None)
            if slo is None or not slo.targets:
                continue
            mine = [t for t in slo.targets if t.metric in metrics]
            burns.append(max(slo.burn_rate(t, self.burn_window_s)
                             for t in (mine or slo.targets)))
        return max(burns, default=0.0)

    def _reset_slo_windows(self, tag: str) -> None:
        for router in self.pools.values():
            for _, e in router._live():
                slo = getattr(e.metrics, "slo", None)
                if slo is not None:
                    slo.reset_windows(epoch=tag)

    def _consume_fault(self) -> Optional[str]:
        if self.serving_injector is not None:
            f = self.serving_injector.capacity_change_at(self._tick)
            if f is not None:
                return fault_mode(f.magnitude)
        return None

    # -- public control ------------------------------------------------------

    def _parse_direction(self, direction: str) -> Tuple[str, str]:
        """``"to_<pool>"`` → (donor, receiver); the donor is the OTHER
        pool (two-pool fleets), or the calmest one with spare replicas
        (N pools)."""
        if not direction.startswith("to_") \
                or direction[3:] not in self.pools:
            raise ValueError(
                f"direction must be 'to_<pool>' for one of "
                f"{sorted(self.pools)}, got {direction!r}")
        dst = direction[3:]
        donors = [n for n in self.pools if n != dst
                  and self._spare(n)]
        if not donors:
            return "", dst
        src = min(donors, key=self.pool_burn)
        return src, dst

    def request_shift(self, direction: str) -> str:
        """Queue an operator-requested move (``"to_prefill"`` /
        ``"to_decode"``); runs when the in-flight shift finishes and
        the cooldown expires.  Returns ``"queued"``."""
        self._parse_direction(direction)      # validate early
        self._queue.append(direction)
        self.stats["queued"] += 1
        self._record("shift_queued", direction=direction)
        return "queued"

    def _spare(self, name: str) -> bool:
        router = self.pools[name]
        healthy = [i for i, _ in router._live()
                   if router._state[i].health.value == "healthy"]
        return len(healthy) > self.min_replicas

    def tick(self) -> None:
        """One controller round, after the fleet's tick: advance the
        in-flight shift a phase, or evaluate the hysteresis machine."""
        self._tick += 1
        burns = {name: self.pool_burn(name) for name in self.pools}
        if self._g_burn is not None:
            for name, b in burns.items():
                self._g_burn.set(b, pool=name)
        if self._shift is not None:
            self._advance(self._shift)
            return
        now = self.clock()
        if self._queue:
            if now >= self._cooldown_until:
                direction = self._queue.popleft()
                src, dst = self._parse_direction(direction)
                if src:
                    self._start(src, dst, burns[dst], manual=True)
                else:
                    self._record("shift_infeasible", direction=direction)
            return
        for name, b in burns.items():
            self._hi[name] = self._hi[name] + 1 if b >= self.burn_high \
                else 0
            self._lo[name] = self._lo[name] + 1 if b <= self.burn_low \
                else 0
        if now < self._cooldown_until:
            return
        for dst in self.pools:
            if self._hi[dst] < self.confirm_ticks:
                continue
            donors = [n for n in self.pools if n != dst
                      and self._lo[n] >= self.confirm_ticks
                      and self._spare(n)]
            if not donors:
                continue          # every peer busy or at the floor
            src = min(donors, key=lambda n: burns[n])
            self._start(src, dst, burns[dst], manual=False)
            return

    # -- the shift state machine ---------------------------------------------

    def _start(self, src: str, dst: str, burn: float,
               manual: bool) -> None:
        now = self.clock()
        mode = self._consume_fault()
        entry = {"tick": self._tick, "t": now,
                 "direction": f"to_{dst}", "src": src, "burn": burn,
                 "manual": manual,
                 "cooldown_ok": now >= self._cooldown_until,
                 "fault": mode, "outcome": None, "reason": None}
        self.shift_log.append(entry)
        self._hi = {name: 0 for name in self.pools}
        self._lo = {name: 0 for name in self.pools}
        self._record("shift_start", direction=f"to_{dst}", src=src,
                     burn=burn, manual=manual, fault=mode)
        self._shift = _PoolShift(direction=f"to_{dst}", src=src,
                                 dst=dst, mode=mode, entry=entry,
                                 t0=now, started_tick=self._tick)
        self._advance(self._shift)

    def _advance(self, sh: _PoolShift) -> None:
        router = self.pools[sh.src]
        if sh.phase == "reserve":
            victim = None
            best = None
            for i, e in router._live():
                if router._state[i].health.value != "healthy":
                    continue
                load = e.queue_depth + e.active_requests
                if best is None or load < best:
                    victim, best = i, load
            if victim is None:
                self._rollback("no healthy donor replica")
                return
            sh.victim = victim
            self._record("phase", phase="reserve", src=sh.src,
                         victim=victim)
            router.begin_drain(victim)
            if sh.mode == "mid_shift_crash":
                router.cancel_drain(victim)
                self._rollback("mid-shift crash (injected)")
                return
            sh.phase = "drain"
            sh.drain_started_tick = self._tick
            return
        if sh.phase != "drain":
            return
        done = sh.mode != "stuck_drain" and router.drained(sh.victim)
        if done:
            self._record("phase", phase="commit", victim=sh.victim)
            removed = router.remove_replica(sh.victim)
            try:
                if sh.mode == "failed_reshard":
                    raise ReshardFailed(
                        "injected re-shard failure (capacity_change)")
                engine = self.replica_factory(sh.dst)
                slot = self.pools[sh.dst].add_replica(engine)
            except Exception as e:
                # the chip never reached the receiver: re-attach the
                # drained engine to the donor, prior split restored
                router.add_replica(removed)
                self._rollback(f"reshard: {e}")
                return
            self._commit(sh, slot)
        elif self._tick - sh.drain_started_tick \
                >= self.drain_timeout_ticks:
            router.cancel_drain(sh.victim)
            self._rollback("drain timeout")

    def _commit(self, sh: _PoolShift, slot: int) -> None:
        now = self.clock()
        sh.entry["outcome"] = "commit"
        self.stats["shifts"] += 1
        self.stats["last_shift"] = {"direction": sh.direction,
                                    "src": sh.src, "victim": sh.victim,
                                    "dst_slot": slot,
                                    "total_s": now - sh.t0}
        if self._c_shifts is not None:
            self._c_shifts.inc(direction=sh.direction)
        self._publish()
        self._reset_slo_windows(f"pool-shift-{self.stats['shifts']}")
        self._cooldown_until = now + self.cooldown_s
        self._record("shift_commit", split=self.split,
                     **self.stats["last_shift"])
        if self.recorder is not None:
            self.recorder.trigger("capacity_shift",
                                  direction=sh.direction,
                                  tick=self._tick, split=self.split)
        self._shift = None

    def _rollback(self, reason: str) -> None:
        sh = self._shift
        now = self.clock()
        sh.entry["outcome"] = "rollback"
        sh.entry["reason"] = reason
        self.stats["rollbacks"] += 1
        if self._c_rollbacks is not None:
            self._c_rollbacks.inc()
        self._publish()
        self._cooldown_until = now + self.cooldown_s
        self._record("shift_rollback", direction=sh.direction,
                     reason=reason, split=self.split)
        if self.recorder is not None:
            self.recorder.trigger("capacity_rollback",
                                  direction=sh.direction,
                                  reason=reason, tick=self._tick)
        self._shift = None
