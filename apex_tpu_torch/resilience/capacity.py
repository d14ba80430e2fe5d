"""Capacity shifting — port of ``apex_tpu/resilience/capacity.py``.

A :class:`CapacityController` owns one chip budget split between an
:class:`~apex_tpu_torch.resilience.elastic.ElasticTrainer` and a serving
fleet, and moves chips between them under live traffic on the fleet's SLO
burn: sustained burn above ``burn_high`` shifts capacity **to serving**
(shrink training dp at a checkpoint boundary, start new replicas on the
freed chips); sustained burn below ``burn_low`` shifts it back **to
training** (drain the leased replicas via migration, grow training dp).  A
:class:`PoolCapacityController` moves serving replicas between named pools
(prefill and decode) on their own burns.  Both share the machinery:

* **Hysteresis + cooldown** — a shift needs ``confirm_ticks``
  consecutive ticks beyond the band edge, and no shift starts within
  ``cooldown_s`` of the previous shift OR rollback; ``audit()`` proves
  after the fact that no burn-driven shift broke that contract.
* **Two-phase shift protocol** — reserve → drain (a serving replica via
  the fleet's migration drain, or training via the elastic trainer's
  boundary checkpoint) → re-shard → commit; any failure rolls the split
  back to the prior one (the trainer re-plans back, bit for bit, via the
  boundary checkpoint; removed replicas are re-attached).
* **Fault injection** — the ``capacity_change`` fault kind of both
  injectors lands here: :data:`CAPACITY_FAULT_MODES` maps the fault's
  ``magnitude`` to a mid-shift crash, a stuck drain (the
  ``drain_timeout_ticks`` timeout fires), or a failed re-shard
  (:class:`ReshardFailed` raised where a factory build or re-shard would
  fail).
* **Flight recording** — every shift start, phase, commit and rollback
  lands in the recorder's ``capacity`` source.

After every commit the controller resets each live replica's SLO
windows: burn computed over a pre-shift window describes a fleet that
no longer exists.

Series: ``capacity_train_chips`` / ``capacity_serve_chips`` /
``capacity_serve_replicas`` / ``capacity_burn`` gauges,
``capacity_shifts_total{direction}`` / ``capacity_rollbacks_total``
counters, the ``capacity_shift_seconds`` histogram; the pool controller's
``capacity_pool_*`` series.  The controllers are pure Python: they touch
the card only through the trainer and the engines they drive.
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


class _ShiftBookkeeping:
    """What the two controllers share: the recorder/tracer entries, the
    after-the-fact flap audit and the rollback of an in-flight shift
    (``_shift``: a :class:`_Shift` or :class:`_PoolShift`)."""

    def _record(self, what: str, **kw) -> None:
        if self.recorder is not None:
            self.recorder.record("capacity", what, tick=self._tick, **kw)
        if self.tracer is not None:
            self.tracer.instant(f"capacity/{what}", tick=self._tick, **kw)

    def audit(self) -> List[dict]:
        """Out-of-band flap check over the full shift history: every
        burn-driven shift must have started with (the receiving side's)
        burn OUTSIDE the hysteresis band and after the cooldown expired —
        the scenarios assert this returns ``[]``."""
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
        split = self.split
        self._record("shift_rollback", direction=sh.direction,
                     reason=reason, split=(list(split) if isinstance(
                         split, tuple) else split))
        if self.recorder is not None:
            self.recorder.trigger("capacity_rollback",
                                  direction=sh.direction,
                                  reason=reason, tick=self._tick)
        self._shift = None


@dataclasses.dataclass
class _Shift:
    """In-flight shift state (one at a time — concurrent requests
    queue, never interleave)."""
    direction: str                        # "to_serving" | "to_training"
    mode: Optional[str]                   # injected failure mode
    entry: dict                           # the shift_log row
    t0: float
    started_tick: int
    phase: str = "reserve"
    old_dp: int = 0
    new_dp: int = 0
    victims: Tuple[int, ...] = ()
    drain_started_tick: int = 0
    drain_t0: float = 0.0
    drain_s: float = 0.0
    reshard_s: float = 0.0


class CapacityController(_ShiftBookkeeping):
    """Burn-driven chip budget controller over one trainer + one fleet.

    ``trainer`` is an :class:`~apex_tpu_torch.resilience.elastic.
    ElasticTrainer` (the controller reads ``plan.spec``, ``stats`` and
    ``current_step`` and calls ``replan_to``), ``fleet`` a
    :class:`~apex_tpu_torch.serving.FleetRouter` (``_live``,
    ``add_replica``, ``begin_drain``, ``cancel_drain``, ``drained``,
    ``remove_replica``, ``replicas``, ``clock``).

    ``replica_factory() -> engine`` builds a serving replica for chips
    freed from training (the day-in-the-life sim builds engines sharing
    the serving model).  ``tick()`` is the single entry point: call it
    once per fleet tick, after ``fleet.step()`` — it either advances an
    in-flight shift one phase or evaluates the hysteresis machine.

    Shifts **to serving** shrink the trainer to
    ``max(min_train_dp, dp // 2)`` and start one replica per
    ``chips_per_replica`` freed chips; each commit pushes a lease so
    shifts **to training** return exactly the leased capacity (drain
    those replicas, grow back to the pre-shift dp).  The trainer's
    boundary checkpoint + re-plan is bitwise-preserving, which is what
    makes rollback restore the prior split exactly.
    """

    def __init__(self, trainer, fleet, replica_factory: Callable, *,
                 min_train_dp: int = 1, chips_per_replica: int = 1,
                 burn_high: float = 6.0, burn_low: float = 1.0,
                 burn_window_s: float = 30.0, confirm_ticks: int = 3,
                 cooldown_s: float = 60.0, drain_timeout_ticks: int = 50,
                 injector=None, serving_injector=None,
                 registry=None, tracer=None, recorder=None,
                 clock: Optional[Callable[[], float]] = None):
        if burn_low >= burn_high:
            raise ValueError("need burn_low < burn_high (the hysteresis "
                             "band is what prevents thrash)")
        if confirm_ticks < 1 or drain_timeout_ticks < 1:
            raise ValueError("confirm_ticks and drain_timeout_ticks "
                             "must be >= 1")
        self.trainer = trainer
        self.fleet = fleet
        self.replica_factory = replica_factory
        self.min_train_dp = int(min_train_dp)
        self.chips_per_replica = int(chips_per_replica)
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.burn_window_s = float(burn_window_s)
        self.confirm_ticks = int(confirm_ticks)
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout_ticks = int(drain_timeout_ticks)
        self.injector = injector                  # training FaultInjector
        self.serving_injector = serving_injector
        self.tracer = tracer
        self.recorder = recorder
        self.clock = clock if clock is not None else fleet.clock
        self._tick = 0
        self._hi = self._lo = 0
        self._cooldown_until = float("-inf")
        self._shift: Optional[_Shift] = None
        self._queue: collections.deque = collections.deque()
        # (grow-back dp, shrunk dp, replica slots) per committed
        # to_serving shift — to_training pops, returning the lease
        self._leases: List[Tuple[int, int, Tuple[int, ...]]] = []
        self.shift_log: List[dict] = []
        self.stats = {"shifts": 0, "rollbacks": 0, "queued": 0,
                      "last_shift": None}
        dp = trainer.plan.spec.dp
        serve = len(fleet._live()) * self.chips_per_replica
        self.budget = CapacityBudget(dp + serve, dp, serve,
                                     self.chips_per_replica)
        self._g_train = self._g_serve = self._g_reps = None
        self._g_burn = self._c_shifts = self._c_rollbacks = None
        self._h_shift = None
        if registry is not None:
            self._g_train = registry.gauge(
                "capacity_train_chips", "chips held by training")
            self._g_serve = registry.gauge(
                "capacity_serve_chips", "chips held by serving")
            self._g_reps = registry.gauge(
                "capacity_serve_replicas", "live serving replicas")
            self._g_burn = registry.gauge(
                "capacity_burn",
                "fleet max short-window SLO burn the controller sees")
            self._c_shifts = registry.counter(
                "capacity_shifts_total", "committed capacity shifts",
                labelnames=("direction",))
            self._c_rollbacks = registry.counter(
                "capacity_rollbacks_total",
                "capacity shifts rolled back (fault, timeout, failure)")
            self._h_shift = registry.histogram(
                "capacity_shift_seconds",
                "end-to-end shift latency (drain+reshard+commit)")
        self._publish()

    # -- observability -------------------------------------------------------

    @property
    def shifting(self) -> bool:
        """True while a shift is in flight."""
        return self._shift is not None

    @property
    def outstanding_leases(self) -> int:
        """to_serving commits not yet returned by a to_training one."""
        return len(self._leases)

    @property
    def split(self) -> Tuple[int, int]:
        """(train_chips, serve_chips) — the quantity a rollback must
        restore bitwise alongside the trainer state."""
        return (self.budget.train_chips, self.budget.serve_chips)

    def _publish(self) -> None:
        dp = self.trainer.plan.spec.dp
        reps = len(self.fleet._live())
        self.budget = CapacityBudget(
            self.budget.total_chips, dp,
            self.budget.total_chips - dp, self.chips_per_replica)
        if self._g_train is not None:
            self._g_train.set(dp)
            self._g_serve.set(self.budget.serve_chips)
            self._g_reps.set(reps)


    # -- signals -------------------------------------------------------------

    def _serving_burn(self) -> float:
        burns = []
        for _, e in self.fleet._live():
            slo = getattr(e.metrics, "slo", None)
            if slo is None or not slo.targets:
                continue
            burns.append(max(slo.burn_rate(t, self.burn_window_s)
                             for t in slo.targets))
        return max(burns, default=0.0)

    def _reset_slo_windows(self, tag: str) -> None:
        for _, e in self.fleet._live():
            slo = getattr(e.metrics, "slo", None)
            if slo is not None:
                slo.reset_windows(epoch=tag)

    def _consume_fault(self) -> Optional[str]:
        """One injected ``capacity_change`` for THIS shift, serving
        schedule first (tick-keyed) then training (step-keyed); both
        are consume-once, so a fault fails one shift and the
        post-rollback retry can succeed."""
        if self.serving_injector is not None:
            f = self.serving_injector.capacity_change_at(self._tick)
            if f is not None:
                return fault_mode(f.magnitude)
        if self.injector is not None:
            f = self.injector.check_capacity_change(
                self.trainer.current_step)
            if f is not None:
                return fault_mode(f.magnitude)
        return None

    # -- public control ------------------------------------------------------

    def request_shift(self, direction: str) -> str:
        """Queue an operator-requested shift.  Requests made while a
        shift is in flight are QUEUED, never interleaved; they run as
        soon as the current shift finishes and the cooldown expires.
        Returns ``"queued"``."""
        if direction not in ("to_serving", "to_training"):
            raise ValueError(
                "direction must be 'to_serving' or 'to_training'")
        self._queue.append(direction)
        self.stats["queued"] += 1
        self._record("shift_queued", direction=direction)
        return "queued"

    def tick(self) -> None:
        """Advance the controller one fleet tick: progress the
        in-flight shift, or evaluate the hysteresis machine."""
        self._tick += 1
        burn = self._serving_burn()
        if self._g_burn is not None:
            self._g_burn.set(burn)
        if self._shift is not None:
            self._advance_shift()
            return
        now = self.clock()
        if self._queue:
            if now >= self._cooldown_until:
                direction = self._queue.popleft()
                if self._feasible(direction):
                    self._start_shift(direction, burn, manual=True)
                else:
                    self._record("shift_infeasible",
                                 direction=direction)
            return
        if burn >= self.burn_high:
            self._hi += 1
        else:
            self._hi = 0
        if burn <= self.burn_low:
            self._lo += 1
        else:
            self._lo = 0
        if now < self._cooldown_until:
            return
        if self._hi >= self.confirm_ticks \
                and self._feasible("to_serving"):
            self._start_shift("to_serving", burn, manual=False)
        elif self._lo >= self.confirm_ticks \
                and self._feasible("to_training"):
            self._start_shift("to_training", burn, manual=False)

    def _feasible(self, direction: str) -> bool:
        if direction == "to_serving":
            dp = self.trainer.plan.spec.dp
            new_dp = max(self.min_train_dp, dp // 2)
            return (dp - new_dp) >= self.chips_per_replica
        return bool(self._leases)

    # -- the shift state machine ---------------------------------------------

    def _dp_spec(self, new_dp: int):
        cur = self.trainer.plan.spec
        zero = new_dp if cur.zero_shard > 1 else 1
        return dataclasses.replace(cur, dp=new_dp, zero_shard=zero)

    def _start_shift(self, direction: str, burn: float,
                     manual: bool) -> None:
        now = self.clock()
        mode = self._consume_fault()
        entry = {"tick": self._tick, "t": now, "direction": direction,
                 "burn": burn, "manual": manual,
                 "cooldown_ok": now >= self._cooldown_until,
                 "fault": mode, "outcome": None, "reason": None}
        self.shift_log.append(entry)
        self._hi = self._lo = 0
        self._record("shift_start", direction=direction, burn=burn,
                     manual=manual, fault=mode)
        self._shift = _Shift(direction=direction, mode=mode,
                             entry=entry, t0=now,
                             started_tick=self._tick)
        self._advance_shift()

    def _advance_shift(self) -> None:
        sh = self._shift
        if sh.direction == "to_serving":
            self._advance_to_serving(sh)
        else:
            self._advance_to_training(sh)

    def _advance_to_serving(self, sh: _Shift) -> None:
        if sh.phase == "reserve":
            sh.old_dp = self.trainer.plan.spec.dp
            sh.new_dp = max(self.min_train_dp, sh.old_dp // 2)
            self._record("phase", phase="reserve", old_dp=sh.old_dp,
                         new_dp=sh.new_dp)
            if sh.mode == "stuck_drain":
                # the boundary-checkpoint drain never completes:
                # nothing has mutated yet, so the timeout path below
                # rolls back for free
                sh.phase = "drain_training"
                sh.drain_started_tick = self._tick
                return
            try:
                if sh.mode == "failed_reshard":
                    raise ReshardFailed(
                        "injected re-shard failure (capacity_change)")
                # drain = the boundary checkpoint inside the re-plan
                self.trainer.replan_to(self._dp_spec(sh.new_dp))
            except Exception as e:
                self._rollback(f"reshard: {e}")
                return
            sh.drain_s = self.trainer.stats["last_checkpoint_s"]
            sh.reshard_s = self.trainer.stats["last_reshard_s"]
            if sh.mode == "mid_shift_crash":
                # injected crash between the trainer shrink and the
                # replica add — the recovery re-plans back onto the
                # prior split (bitwise, via the boundary checkpoint)
                self.trainer.replan_to(self._dp_spec(sh.old_dp))
                self._rollback("mid-shift crash (injected)")
                return
            n_new = (sh.old_dp - sh.new_dp) // self.chips_per_replica
            engines = [self.replica_factory() for _ in range(n_new)]
            slots = tuple(self.fleet.add_replica(e) for e in engines)
            self._record("phase", phase="grow_fleet", slots=list(slots))
            self._leases.append((sh.old_dp, sh.new_dp, slots))
            self._commit()
        elif sh.phase == "drain_training":
            if self._tick - sh.drain_started_tick \
                    >= self.drain_timeout_ticks:
                self._rollback("stuck drain (injected): "
                               "boundary checkpoint timed out")

    def _advance_to_training(self, sh: _Shift) -> None:
        if sh.phase == "reserve":
            grow_dp, cur_dp, slots = self._leases[-1]
            sh.old_dp, sh.new_dp = cur_dp, grow_dp
            sh.victims = tuple(v for v in slots
                               if self.fleet.replicas[v] is not None)
            self._record("phase", phase="reserve",
                         victims=list(sh.victims), grow_dp=grow_dp)
            for v in sh.victims:
                try:
                    self.fleet.begin_drain(v)
                except ValueError:
                    pass          # already dead: its work migrated
            if sh.mode == "mid_shift_crash":
                # injected crash after the drain began — recovery
                # cancels it; migrated work stays where it landed
                for v in sh.victims:
                    self.fleet.cancel_drain(v)
                self._rollback("mid-shift crash (injected)")
                return
            sh.phase = "drain_serving"
            sh.drain_started_tick = self._tick
            sh.drain_t0 = self.clock()
            return
        if sh.phase != "drain_serving":
            return
        done = sh.mode != "stuck_drain" and all(
            self.fleet.drained(v) for v in sh.victims)
        if done:
            sh.drain_s = self.clock() - sh.drain_t0
            self._record("phase", phase="reshard",
                         drain_s=sh.drain_s)
            engines = [self.fleet.remove_replica(v)
                       for v in sh.victims
                       if self.fleet.replicas[v] is not None]
            try:
                if sh.mode == "failed_reshard":
                    raise ReshardFailed(
                        "injected re-shard failure (capacity_change)")
                self.trainer.replan_to(self._dp_spec(sh.new_dp))
            except Exception as e:
                for eng in engines:
                    self.fleet.add_replica(eng)
                self._rollback(f"reshard: {e}")
                return
            sh.reshard_s = self.trainer.stats["last_reshard_s"]
            self._leases.pop()
            self._commit()
        elif self._tick - sh.drain_started_tick \
                >= self.drain_timeout_ticks:
            for v in sh.victims:
                self.fleet.cancel_drain(v)
            self._rollback("drain timeout")

    # -- commit / rollback ---------------------------------------------------

    def _commit(self) -> None:
        sh = self._shift
        now = self.clock()
        total = now - sh.t0
        commit_s = max(total - sh.drain_s - sh.reshard_s, 0.0)
        sh.entry["outcome"] = "commit"
        self.stats["shifts"] += 1
        self.stats["last_shift"] = {
            "direction": sh.direction, "drain_s": sh.drain_s,
            "reshard_s": sh.reshard_s, "commit_s": commit_s,
            "total_s": total}
        if self._c_shifts is not None:
            self._c_shifts.inc(direction=sh.direction)
            self._h_shift.observe(total)
        self._publish()
        # pre-shift burn describes a fleet that no longer exists:
        # without this reset the stale window immediately re-triggers
        self._reset_slo_windows(f"shift-{self.stats['shifts']}")
        self._cooldown_until = now + self.cooldown_s
        self._record("shift_commit", split=list(self.split),
                     **self.stats["last_shift"])
        if self.recorder is not None:
            self.recorder.trigger("capacity_shift",
                                  direction=sh.direction,
                                  tick=self._tick,
                                  split=list(self.split))
        self._shift = None


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


class PoolCapacityController(_ShiftBookkeeping):
    """:class:`CapacityController`'s hysteresis + two-phase protocol
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
