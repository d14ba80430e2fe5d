"""Fault-tolerant serving fleet: the serving-side mirror of
:mod:`apex_tpu_torch.resilience`.

Training became preemption-native in PRs 4/9 (guards, checkpoint
resharding, elastic re-plan); this module gives the serving tier the
same property.  A replica that crashes, hangs mid-decode, or silently
slows down must cost the fleet a bounded blip — never a lost request,
never a duplicated one, never a changed token stream.

Four pieces, each the serving analogue of a training-resilience part:

* :class:`ServingFaultInjector` — deterministic, seedable REPLICA-level
  faults (:data:`SERVING_FAULT_KINDS`), the counterpart of the training
  :class:`~apex_tpu_torch.resilience.faults.FaultInjector` (both generate
  schedules from the shared ``seeded_schedule`` stream, both keep an
  applied-fault log as the ground truth tests assert against).  The
  admission-shaped kinds (``reject_admission``, ``kv_pool_exhaustion``)
  are injected at the engine backend hooks
  (``InferenceEngine.injected_faults``); the whole-replica kinds
  (``replica_crash``, ``stuck_decode``, ``slow_replica``) are applied by
  the fleet tick loop, which owns the replica lifecycle.
* **Health-checked routing** — :class:`FleetRouter` drives a per-replica
  state machine ``healthy → suspect → dead → recovering`` from heartbeat
  ticks (a replica heartbeats when its ``step()`` returns; a crash or a
  stuck decode is a miss) plus a relative-latency slow detector.  All
  placement decisions exclude non-healthy replicas.  Failed placements
  retry with jittered exponential backoff under a per-request retry
  budget; an optional hedged dispatch duplicates a request that has not
  produced its first token within ``hedge_after_s`` onto a second
  replica — first completion wins, the loser is cancelled, responses
  are deduplicated so completion stays exactly-once.
* **Cross-replica request migration** — when a replica is declared
  dead, :meth:`InferenceEngine.export_inflight` harvests its in-flight
  and queued requests *with their generated-so-far tokens* (exactly the
  tokens already streamed to the client, which is why a crash without
  warning still leaves them recoverable) and the fleet re-places each on
  a healthy replica via :meth:`InferenceEngine.adopt`: re-prefill
  ``prompt + generated``, resume the ``(seed, token-index)`` sampling
  stream at ``len(generated)``.  This is ``engine.preempt()``'s requeue
  machinery generalized across engines — the resumed stream is
  token-BITWISE the uninterrupted one, for greedy and seeded sampling,
  on contiguous and paged backends (asserted by ``tests/test_fleet.py``
  and ``__graft_entry__._dryrun_serving_chaos``).  A request whose
  context no longer fits the target finishes with
  ``reason="preempted"``, the same edge the single-engine requeue has.
* :class:`DegradationLadder` — graceful degradation wired to
  :class:`~apex_tpu_torch.observability.slo.SLOMonitor` burn: level 1 drops
  speculative decoding (``spec_enabled=False`` — the acceptance rule
  makes this token-invisible), level 2 flushes the prefix trie and
  shrinks the admitted context, level 3 sheds new admissions with a
  machine-readable ``retry_after_s``.  The current level is the
  ``serving_degraded_level`` gauge; transitions land on the Perfetto
  timeline as instants.

The fleet also exposes the **capacity lifecycle** the
:class:`~apex_tpu_torch.resilience.capacity.CapacityController` drives:
:meth:`FleetRouter.begin_drain` puts a replica in the DRAINING state
(no new placements, work migrated off via the same export/adopt
machinery, never marked dead), :meth:`FleetRouter.remove_replica`
detaches a drained replica leaving a ``None`` tombstone in its slot
(indices stay stable), and :meth:`FleetRouter.add_replica` attaches a
fresh engine, reusing tombstone slots.  :meth:`FleetRouter.cancel_drain`
is the shift-rollback path.

Fleet series: ``serving_retries_total`` / ``serving_hedges_total`` /
``serving_migrations_total`` counters, ``serving_replica_health``
(0 healthy, 1 suspect, 2 dead, 3 recovering, 4 draining, 5 removed) and
``serving_degraded_level`` gauges.  ``tools/loadgen.py --scenario``
drives the whole thing under chaos workloads (replica-kill mid-burst,
slow replica, diurnal, bursty overload) asserting SLO attainment and
exactly-once completion.

Port of ``apex_tpu/serving/fleet.py``; it imports no JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from apex_tpu_torch.inference.engine import QueueFull, Request, Response
from apex_tpu_torch.observability.fleetobs import FlightRecorder, emit_flow
from apex_tpu_torch.resilience.faults import seeded_schedule
from apex_tpu_torch.serving.router import RequestShed, Router, ShedReason

SERVING_FAULT_KINDS = ("replica_crash", "stuck_decode", "slow_replica",
                       "kv_pool_exhaustion", "reject_admission",
                       "capacity_change")


class VirtualClock:
    """Injectable discrete-event clock: the chaos scenarios run on
    simulated seconds (``advance``) instead of wall time, so fault
    timing, backoff, hedging and SLO burn are DETERMINISTIC on any
    host — the property the chaos CI leg needs."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclasses.dataclass(frozen=True)
class ServingFault:
    """One scheduled replica fault, active for ``duration`` fleet ticks
    starting at ``tick``.  ``magnitude`` is the injected extra seconds
    per tick for ``slow_replica`` and the failure mode for
    ``capacity_change`` (0/1 mid-shift crash, 2 stuck drain, 3 failed
    re-shard — see ``apex_tpu_torch.resilience.capacity.fault_mode``; that
    kind is fleet-scoped and consumed by the
    :class:`~apex_tpu_torch.resilience.capacity.CapacityController` via
    :meth:`ServingFaultInjector.capacity_change_at`, not applied by the
    fleet tick loop)."""
    tick: int
    replica: int
    kind: str
    magnitude: float = 0.0
    duration: int = 1

    def __post_init__(self):
        if self.kind not in SERVING_FAULT_KINDS:
            raise ValueError(f"unknown serving fault kind {self.kind!r}; "
                             f"one of {SERVING_FAULT_KINDS}")
        if self.tick < 0 or self.replica < 0:
            raise ValueError("fault tick and replica must be >= 0")
        if self.duration < 1:
            raise ValueError("fault duration must be >= 1 tick")


class ServingFaultInjector:
    """Deterministic replica-fault schedule for the serving fleet.

    Mirrors the training :class:`~apex_tpu_torch.resilience.faults.
    FaultInjector`: an explicit schedule or a seed-generated one
    (:meth:`from_seed`, same ``seeded_schedule`` stream discipline), and
    an applied-fault ``log`` of ``(tick, replica, kind)`` recorded when
    the fleet actually applies each fault — the ground truth the chaos
    tests assert against.
    """

    def __init__(self, schedule: Iterable[ServingFault] = ()):
        self.schedule: Tuple[ServingFault, ...] = tuple(schedule)
        self._by_replica: Dict[int, List[ServingFault]] = {}
        for f in self.schedule:
            self._by_replica.setdefault(f.replica, []).append(f)
        self.log: List[Tuple[int, int, str]] = []
        self._recorded: set = set()

    @classmethod
    def from_seed(cls, seed: int, n_ticks: int, n_replicas: int,
                  rates: Optional[Dict[str, float]] = None, *,
                  slow_s: float = 0.05, crash_ticks: int = 10 ** 6,
                  stuck_ticks: int = 4, slow_ticks: int = 4,
                  pressure_ticks: int = 2) -> "ServingFaultInjector":
        """Random-but-reproducible schedule over ``n_ticks`` ×
        ``n_replicas``: per (tick, replica, kind) a fault fires with
        probability ``rates[kind]`` under one seeded stream.  Crash
        defaults to effectively-permanent; pass a finite
        ``crash_ticks`` to exercise the recovering transition."""
        rates = dict(rates or {})
        bad = set(rates) - set(SERVING_FAULT_KINDS)
        if bad:
            raise ValueError(f"unknown fault kinds in rates: {sorted(bad)}")
        keys = [(rep, kind) for rep in range(n_replicas)
                for kind in SERVING_FAULT_KINDS]
        key_rates = {(rep, kind): rates.get(kind, 0.0)
                     for rep, kind in keys}
        dur = {"replica_crash": crash_ticks, "stuck_decode": stuck_ticks,
               "slow_replica": slow_ticks,
               "kv_pool_exhaustion": pressure_ticks,
               "reject_admission": pressure_ticks,
               "capacity_change": 1}
        faults = [
            ServingFault(tick, rep, kind,
                         magnitude=slow_s if kind == "slow_replica" else 0.0,
                         duration=dur[kind])
            for tick, (rep, kind) in seeded_schedule(seed, n_ticks, keys,
                                                     key_rates)]
        return cls(faults)

    def faults_at(self, tick: int, replica: int) -> Tuple[ServingFault, ...]:
        """Pure query: faults active at this (tick, replica)."""
        return tuple(f for f in self._by_replica.get(replica, ())
                     if f.tick <= tick < f.tick + f.duration)

    def activate(self, tick: int, replica: int) -> Tuple[ServingFault, ...]:
        """Active faults, recording each into the applied log the first
        tick the fleet actually applies it.  ``capacity_change`` is
        never recorded here — the fleet tick loop does not apply it;
        the capacity controller consumes it via
        :meth:`capacity_change_at`."""
        out = self.faults_at(tick, replica)
        for f in out:
            if f.kind == "capacity_change":
                continue
            if f not in self._recorded:
                self._recorded.add(f)
                self.log.append((int(tick), int(replica), f.kind))
        return out

    def capacity_change_at(self, tick: int) -> Optional[ServingFault]:
        """The first unconsumed ``capacity_change`` fault active at
        ``tick``, across ALL replicas — a capacity shift is fleet-
        scoped, so the replica field only disambiguates schedules.
        Consume-once: the fault is recorded into the applied log and
        never returned again, so one scheduled fault fails exactly one
        shift and the controller's post-rollback retry can succeed."""
        for f in self.schedule:
            if f.kind != "capacity_change" or f in self._recorded:
                continue
            if f.tick <= tick < f.tick + f.duration:
                self._recorded.add(f)
                self.log.append((int(tick), int(f.replica), f.kind))
                return f
        return None


class ReplicaHealth(enum.Enum):
    """Per-replica health states; the gauge exports the index below.

    ``DRAINING`` is the capacity-shift state: the replica still serves
    (and heartbeats) while its work migrates off, takes no new
    placements, and is NEVER marked dead — a drain is an orderly exit,
    not a failure, and declaring it dead would double-migrate the work
    the drain already moved.  ``REMOVED`` is terminal: the slot holds a
    ``None`` tombstone so every index-keyed structure stays valid."""
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"
    RECOVERING = "recovering"
    DRAINING = "draining"
    REMOVED = "removed"


HEALTH_INDEX = {ReplicaHealth.HEALTHY: 0, ReplicaHealth.SUSPECT: 1,
                ReplicaHealth.DEAD: 2, ReplicaHealth.RECOVERING: 3,
                ReplicaHealth.DRAINING: 4, ReplicaHealth.REMOVED: 5}


class DegradationLadder:
    """Burn-driven graceful degradation policy (pure, injectable).

    ``thresholds`` are the burn multiples that ENTER levels 1..3:
    level 1 drops speculative decoding, level 2 flushes the prefix trie
    and caps admitted context at ``ctx_cap_frac`` of ``max_seq``,
    level 3 sheds new admissions with ``retry_after_s``.  Escalation is
    immediate; de-escalation steps down ONE level after ``step_down_s``
    of burn below the current level's entry threshold (hysteresis — a
    ladder that flaps is worse than one that is a little sticky).

    ``burn_source`` overrides WHICH burn drives the ladder: by default
    the owning router feeds it the max burn across its own replicas,
    which is right for a homogeneous fleet but wrong for a
    disaggregated one — level 2's actions (prefix flush + context cap)
    relieve *decode* KV pressure, so a prefill-pool TTFT burn must not
    trigger them.  :class:`~apex_tpu_torch.serving.disagg.DisaggregatedFleet`
    threads the decode pool's burn through here so every router sharing
    the ladder degrades on the signal the actions actually act on.
    """

    LEVELS = ("normal", "no_spec", "shrink_context", "shed")

    def __init__(self, thresholds: Sequence[float] = (2.0, 6.0, 14.4), *,
                 step_down_s: float = 1.0, ctx_cap_frac: float = 0.5,
                 burn_source=None):
        if len(thresholds) != 3 or list(thresholds) != sorted(thresholds):
            raise ValueError("need 3 ascending burn thresholds")
        if not 0.0 < ctx_cap_frac <= 1.0:
            raise ValueError("ctx_cap_frac must be in (0, 1]")
        self.thresholds = tuple(float(t) for t in thresholds)
        self.step_down_s = float(step_down_s)
        self.ctx_cap_frac = float(ctx_cap_frac)
        self.burn_source = burn_source
        self.level = 0
        self._calm_since: Optional[float] = None

    def target_level(self, burn: float) -> int:
        lvl = 0
        for i, t in enumerate(self.thresholds):
            if burn >= t:
                lvl = i + 1
        return lvl

    def update(self, burn: float, now: float) -> int:
        tgt = self.target_level(burn)
        if tgt > self.level:
            self.level = tgt
            self._calm_since = None
        elif tgt < self.level:
            if self._calm_since is None:
                self._calm_since = now
            elif now - self._calm_since >= self.step_down_s:
                self.level -= 1
                self._calm_since = now      # re-arm for the next step
        else:
            self._calm_since = None
        return self.level


@dataclasses.dataclass
class _ReplicaState:
    health: ReplicaHealth = ReplicaHealth.HEALTHY
    misses: int = 0                 # consecutive heartbeat misses
    ok_streak: int = 0              # consecutive beats while recovering
    slow_streak: int = 0            # consecutive slow ticks
    slow: bool = False              # SUSPECT because of latency, not misses


@dataclasses.dataclass
class _InFlight:
    request: Request
    replica: int
    submitted_t: float
    hedge_replica: Optional[int] = None


@dataclasses.dataclass
class _PendingRetry:
    request: Request
    progress: List[int]
    attempts: int
    next_t: float


class FleetRouter(Router):
    """Health-checked, self-healing multi-replica router.

    Extends :class:`Router`'s least-loaded + SLO-burn placement with the
    fleet lifecycle: every :meth:`step` is a heartbeat round (faults
    applied, replicas ticked, health transitions taken), followed by
    response collection (deduplicated — exactly-once even under
    hedging), dead-replica migration, the hedge pass, the retry pass and
    the degradation ladder.  ``health_log`` records every transition as
    ``(tick, replica, old, new)``.

    Placement eligibility = base eligibility AND ``health is HEALTHY``.
    Migrated requests bypass the overload gate (work already admitted
    once is completed, not re-litigated) but still honor engine
    backpressure.  ``submit`` returns the replica index, or ``-1`` when
    the request was parked for internal retry (it will complete — or
    terminally shed with ``finish_reason="shed"`` — via :meth:`step`).
    """

    def __init__(self, replicas: Sequence, *,
                 injector: Optional[ServingFaultInjector] = None,
                 clock=time.monotonic,
                 suspect_after: int = 2, dead_after: int = 4,
                 recover_after: int = 3,
                 slow_factor: float = 4.0, slow_after: int = 3,
                 slow_floor_s: float = 1e-3,
                 retry_budget: int = 3, retry_base_s: float = 0.02,
                 retry_jitter: float = 0.5,
                 hedge_after_s: Optional[float] = None,
                 ladder: Optional[DegradationLadder] = None,
                 recorder: Optional[FlightRecorder] = None,
                 seed: int = 0, registry=None, **kw):
        super().__init__(replicas, registry=registry, **kw)
        if suspect_after < 1 or dead_after <= suspect_after:
            raise ValueError("need dead_after > suspect_after >= 1")
        if recover_after < 1 or retry_budget < 0:
            raise ValueError("recover_after >= 1 and retry_budget >= 0")
        self.injector = injector
        self.clock = clock
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.recover_after = recover_after
        self.slow_factor = slow_factor
        self.slow_after = slow_after
        self.slow_floor_s = slow_floor_s
        self.retry_budget = retry_budget
        self.retry_base_s = retry_base_s
        self.retry_jitter = retry_jitter
        self.hedge_after_s = hedge_after_s
        self.ladder = ladder
        self.recorder = recorder
        self._rng = np.random.RandomState(seed)
        self._tick = 0
        self._state = [_ReplicaState() for _ in self.replicas]
        self.health_log: List[Tuple[int, int, str, str]] = []
        self._inflight: Dict[object, _InFlight] = {}
        self._retry: List[_PendingRetry] = []
        self._responses: Dict[object, Response] = {}
        self._consumed = [0] * len(self.replicas)
        self.retries = 0
        self.hedges = 0
        self.migrations = 0
        self.duplicate_responses = 0
        # recovery bookkeeping for the chaos bench: first DEAD
        # declaration, first migration, first post-migration token
        self.first_dead: Optional[Tuple[int, float]] = None
        self.first_migration: Optional[Tuple[int, float]] = None
        self.first_resume: Optional[Tuple[int, float]] = None
        self._resume_watch: Dict[object, Tuple[int, int]] = {}
        r = registry if registry is not None \
            else self.replicas[0].metrics.registry
        self._c_retries = r.counter(
            "serving_retries_total",
            "placement retries after a failed or shed attempt")
        self._c_hedges = r.counter(
            "serving_hedges_total", "hedged duplicate dispatches")
        self._c_migrations = r.counter(
            "serving_migrations_total",
            "in-flight requests migrated off a dead replica")
        self._g_health = r.gauge(
            "serving_replica_health",
            "replica health (0 healthy, 1 suspect, 2 dead, 3 recovering, "
            "4 draining, 5 removed)",
            labelnames=("replica",))
        self._g_degraded = r.gauge(
            "serving_degraded_level",
            "graceful-degradation ladder level (0 normal .. 3 shed)")
        self._c_trans = r.counter(
            "serving_replica_transitions_total",
            "health state-machine transitions by edge — flapping "
            "(healthy<->suspect cycles) vs clean deaths",
            labelnames=("from", "to"))
        self._g_degraded.set(0)
        self._set_health_gauges()

    # -- health state machine ------------------------------------------------

    def health(self, i: int) -> ReplicaHealth:
        return self._state[i].health

    def _transition(self, i: int, new: ReplicaHealth) -> None:
        st = self._state[i]
        if st.health is new:
            return
        old = st.health.value
        self.health_log.append((self._tick, i, old, new.value))
        # "from" is a Python keyword — label kwargs go through a splat
        self._c_trans.inc(**{"from": old, "to": new.value})
        reg = getattr(self.replicas[i].metrics, "registry", None)
        if reg is not None:
            # into the REPLICA's stream, so a merged fleet report can
            # attribute health history per replica
            reg.event("replica_health", replica=i, state=new.value,
                      previous=old)
        if self.recorder is not None:
            self.recorder.record(f"replica{i}", "health_transition",
                                 tick=self._tick, old=old,
                                 new=new.value)
        st.health = new
        if new is ReplicaHealth.DEAD:
            if self.first_dead is None:
                self.first_dead = (self._tick, self.clock())
            self._on_dead(i)
            if self.recorder is not None:
                # cut the black box AFTER migration so the snapshot
                # carries the re-placement decisions too
                self.recorder.trigger("replica_dead", replica=i,
                                      tick=self._tick)

    def _miss(self, i: int) -> None:
        st = self._state[i]
        if st.health is ReplicaHealth.DRAINING:
            # never dead while draining: the drain already migrated the
            # work off; a death verdict would migrate it a second time
            st.misses += 1
            return
        st.ok_streak = 0
        st.misses += 1
        if st.health is ReplicaHealth.RECOVERING:
            self._transition(i, ReplicaHealth.DEAD)     # relapse
        elif st.health is ReplicaHealth.HEALTHY \
                and st.misses >= self.suspect_after:
            self._transition(i, ReplicaHealth.SUSPECT)
        elif st.health is ReplicaHealth.SUSPECT \
                and st.misses >= self.dead_after:
            self._transition(i, ReplicaHealth.DEAD)

    def _beat(self, i: int) -> None:
        st = self._state[i]
        if st.health is ReplicaHealth.DRAINING:
            st.misses = 0        # sticky: only the lifecycle exits it
            return
        st.misses = 0
        if st.health is ReplicaHealth.SUSPECT and not st.slow:
            self._transition(i, ReplicaHealth.HEALTHY)
        elif st.health is ReplicaHealth.DEAD:
            st.ok_streak = 0
            self._transition(i, ReplicaHealth.RECOVERING)
        elif st.health is ReplicaHealth.RECOVERING:
            st.ok_streak += 1
            if st.ok_streak >= self.recover_after:
                self._transition(i, ReplicaHealth.HEALTHY)

    def _update_slow(self, durations: Dict[int, float]) -> None:
        """Relative straggler detection: a replica whose tick ran
        ``slow_factor``× the peer median for ``slow_after`` consecutive
        ticks goes SUSPECT (excluded from new placements, still served
        and hedged around) and returns to HEALTHY when it normalizes.
        Slowness never escalates to DEAD — a slow replica heartbeats."""
        if len(durations) < 2:
            return
        med = float(np.median(list(durations.values())))
        floor = max(med, self.slow_floor_s)
        for i, dt in durations.items():
            st = self._state[i]
            if dt > self.slow_factor * floor:
                st.slow_streak += 1
                if st.slow_streak >= self.slow_after \
                        and st.health is ReplicaHealth.HEALTHY:
                    st.slow = True
                    self._transition(i, ReplicaHealth.SUSPECT)
            else:
                st.slow_streak = 0
                if st.slow and st.health is ReplicaHealth.SUSPECT:
                    st.slow = False
                    self._transition(i, ReplicaHealth.HEALTHY)
                st.slow = False

    def _set_health_gauges(self) -> None:
        for i, st in enumerate(self._state):
            self._g_health.set(HEALTH_INDEX[st.health], replica=str(i))

    # -- placement -----------------------------------------------------------

    def _eligible(self, i, eng, burn) -> bool:
        if self._state[i].health is not ReplicaHealth.HEALTHY:
            return False
        return super()._eligible(i, eng, burn)

    def _ctx_cap(self) -> int:
        max_seq = min((getattr(e, "max_seq", 1 << 30)
                       for _, e in self._live()), default=1 << 30)
        return int(max_seq * self.ladder.ctx_cap_frac)

    def _fleet_trace(self):
        """Any live replica's trace lane for router-level marks
        (retry/degrade) — replica 0 may be a tombstone after a
        capacity removal."""
        for _, e in self._live():
            return e.trace
        return None

    def _drain_retry_hint(self) -> float:
        """Depth-scaled Retry-After for DRAINING sheds: proportional
        to the remaining work on the least-loaded draining replica, so
        the client returns roughly when the drain completes and fresh
        placements (or re-admission after rollback) are possible."""
        loads = [e.queue_depth + e.active_requests
                 for i, e in self._live()
                 if self._state[i].health is ReplicaHealth.DRAINING]
        if not loads:
            return self._retry_after_hint()
        return 0.05 * (1.0 + min(loads) / max(self.max_queue_depth, 1))

    def submit(self, request: Request) -> int:
        now = self.clock()
        if self.ladder is not None:
            if self.ladder.level >= 3:
                self.shed_requests += 1
                self._c_shed.inc()
                self._flow_shed(request, ShedReason.DEGRADED)
                raise RequestShed(
                    "degraded to shed level; retry after backoff",
                    reason=ShedReason.DEGRADED,
                    retry_after_s=self._retry_after_hint())
            if self.ladder.level >= 2 \
                    and len(request.prompt) > self._ctx_cap():
                self.shed_requests += 1
                self._c_shed.inc()
                self._flow_shed(request, ShedReason.CONTEXT_CAP)
                raise RequestShed(
                    f"degraded context cap {self._ctx_cap()} tokens",
                    reason=ShedReason.CONTEXT_CAP,
                    retry_after_s=self._retry_after_hint())
        self._dispatch_ctx(request)
        i = self._try_place(request)
        if i is None:
            if self.retry_budget > 0:
                self._queue_retry(request, [], attempts=1, now=now)
                return -1
            self.shed_requests += 1
            self._c_shed.inc()
            healthy = any(s.health is ReplicaHealth.HEALTHY
                          for s in self._state)
            draining = any(s.health is ReplicaHealth.DRAINING
                           for s in self._state)
            if healthy:
                reason, hint = ShedReason.OVERLOAD, \
                    self._retry_after_hint()
            elif draining:
                # capacity shift in progress: tell the client WHEN the
                # drain should be over, not just that it was refused
                reason, hint = ShedReason.DRAINING, \
                    self._drain_retry_hint()
            else:
                reason, hint = ShedReason.NO_HEALTHY_REPLICA, \
                    self._retry_after_hint()
            self._flow_shed(request, reason)
            raise RequestShed("no eligible replica", reason=reason,
                              retry_after_s=hint)
        self._inflight[request.request_id] = _InFlight(request, i, now)
        if self.recorder is not None:
            self.recorder.record("router", "place",
                                 request_id=request.request_id,
                                 replica=i, tick=self._tick)
        return i

    def _queue_retry(self, request: Request, progress: List[int],
                     attempts: int, now: float) -> None:
        backoff = self.retry_base_s * (2.0 ** max(attempts - 1, 0))
        backoff *= 1.0 + self.retry_jitter * float(self._rng.uniform())
        self._retry.append(_PendingRetry(request, list(progress),
                                         attempts, now + backoff))

    def _alive(self, i: int) -> bool:
        return self._state[i].health is not ReplicaHealth.DEAD

    def _pick_target(self, exclude: int = -1) -> Optional[int]:
        """Least-loaded HEALTHY replica for migrated/hedged work —
        health-gated only; the overload gate does not apply to work the
        fleet already accepted."""
        best, best_load = None, None
        for i, eng in self._live():
            if i == exclude \
                    or self._state[i].health is not ReplicaHealth.HEALTHY:
                continue
            load = eng.queue_depth + eng.active_requests
            if best is None or load < best_load:
                best, best_load = i, load
        return best

    # -- capacity lifecycle --------------------------------------------------

    def begin_drain(self, i: int) -> None:
        """Start an orderly drain of replica ``i`` for a capacity
        shift: it stops taking placements (DRAINING is never eligible),
        its queued + in-flight work migrates to healthy peers NOW via
        the same export/adopt machinery a death uses (token-bitwise
        resume), and the heartbeat machine will never mark it dead —
        see :class:`ReplicaHealth`.  Idempotent while draining."""
        if self.replicas[i] is None:
            raise ValueError(f"replica {i} was removed")
        st = self._state[i]
        if st.health is ReplicaHealth.DRAINING:
            return
        if st.health is ReplicaHealth.DEAD:
            raise ValueError(
                f"replica {i} is dead; drain is for live exits")
        st.slow = False
        st.misses = 0
        st.slow_streak = 0
        self._transition(i, ReplicaHealth.DRAINING)
        self._drain_from(i)
        self._set_health_gauges()

    def cancel_drain(self, i: int) -> None:
        """Shift-rollback path: a draining replica returns to HEALTHY.
        Work already migrated off stays where it landed — migration is
        exactly-once, and pulling it back would risk duplication."""
        st = self._state[i]
        if self.replicas[i] is not None \
                and st.health is ReplicaHealth.DRAINING:
            st.misses = 0
            st.ok_streak = 0
            self._transition(i, ReplicaHealth.HEALTHY)
            self._set_health_gauges()

    def drained(self, i: int) -> bool:
        """True when nothing is left on replica ``i``: empty engine
        queue + active set, and no in-flight entry (primary or hedge)
        still pointing at it."""
        eng = self.replicas[i]
        if eng is None:
            return True
        if eng._queue or eng._active:
            return False
        return not any(fl.replica == i or fl.hedge_replica == i
                       for fl in self._inflight.values())

    def remove_replica(self, i: int):
        """Detach replica ``i`` and return its engine (the capacity
        controller keeps it for rollback re-add).  The slot becomes a
        ``None`` tombstone so indices in ``_state`` / ``_consumed`` /
        in-flight records stay valid; finished responses are harvested
        first and any straggler work is exported to peers."""
        eng = self.replicas[i]
        if eng is None:
            raise ValueError(f"replica {i} already removed")
        self._collect()
        self._drain_from(i)
        self._transition(i, ReplicaHealth.REMOVED)
        self.replicas[i] = None
        self._set_health_gauges()
        if self.recorder is not None:
            self.recorder.record("router", "remove_replica", replica=i,
                                 tick=self._tick)
        return eng

    def add_replica(self, engine) -> int:
        """Attach ``engine`` as a serving replica, reusing the first
        tombstone slot (else appending); returns its index.  Responses
        already inside the engine's done list count as consumed — an
        engine re-added on rollback must not re-deliver them
        (exactly-once)."""
        slot = next((j for j, e in enumerate(self.replicas)
                     if e is None), None)
        if slot is None:
            slot = len(self.replicas)
            self.replicas.append(engine)
            self._state.append(_ReplicaState())
            self._consumed.append(len(engine._done))
            self.health_log.append((self._tick, slot, "absent",
                                    "healthy"))
            self._c_trans.inc(**{"from": "absent", "to": "healthy"})
        else:
            self.replicas[slot] = engine
            self._state[slot] = _ReplicaState()
            self._consumed[slot] = len(engine._done)
            self.health_log.append((self._tick, slot, "removed",
                                    "healthy"))
            self._c_trans.inc(**{"from": "removed", "to": "healthy"})
        self._tracing = self._tracing or (
            getattr(getattr(engine, "trace", None), "tracer", None)
            is not None)
        self._set_health_gauges()
        if self.recorder is not None:
            self.recorder.record("router", "add_replica", replica=slot,
                                 tick=self._tick)
        return slot

    # -- migration -----------------------------------------------------------

    def _on_dead(self, i: int) -> None:
        self._drain_from(i)

    def _drain_from(self, i: int) -> None:
        """Move replica ``i``'s queued + in-flight work to peers:
        export with generated-so-far tokens, adopt elsewhere — the
        resumed streams are token-bitwise the uninterrupted ones."""
        eng = self.replicas[i]
        now = self.clock()
        for req, progress in eng.export_inflight():
            rid = req.request_id
            if rid in self._responses:
                continue                     # already answered elsewhere
            fl = self._inflight.get(rid)
            if fl is not None and fl.hedge_replica is not None:
                other = fl.hedge_replica if fl.replica == i else fl.replica
                if other != i and self._alive(other):
                    # the surviving copy is promoted; nothing to migrate
                    fl.replica = other
                    fl.hedge_replica = None
                    continue
            self._migrate(req, progress, src=i, now=now)

    def _migrate(self, req: Request, progress: List[int], src: int,
                 now: float) -> None:
        rid = req.request_id
        target = self._pick_target(exclude=src)
        if target is None:
            # nowhere to go right now: park it; a recovery or drain
            # will place it, so the request is delayed, never lost
            self._inflight.pop(rid, None)
            self._queue_retry(req, progress, attempts=0, now=now)
            return
        eng = self.replicas[target]
        if len(req.prompt) + len(progress) >= eng.max_seq:
            # the single-engine preemption edge, fleet-wide: context no
            # longer fits a fresh admission anywhere useful
            self._router_finish(req, progress, "preempted")
            return
        if req.trace is not None:
            # next causal hop: the adopting replica's enqueue/resume
            # flow events carry the bumped counter
            req.trace.next_hop()
        try:
            eng.adopt(req, list(progress))
        except (QueueFull, ValueError):
            self._inflight.pop(rid, None)
            self._queue_retry(req, progress, attempts=0, now=now)
            return
        self.migrations += 1
        self._c_migrations.inc()
        eng.trace.migrate(rid, src, target)
        if self.recorder is not None:
            self.recorder.record("router", "migrate", request_id=rid,
                                 src=src, dst=target, tick=self._tick,
                                 progress=len(progress))
        if self.first_migration is None:
            self.first_migration = (self._tick, now)
        self._resume_watch[rid] = (target, len(progress))
        fl = self._inflight.get(rid)
        if fl is None:
            self._inflight[rid] = _InFlight(req, target, now)
        else:
            fl.replica = target
            fl.hedge_replica = None

    def _router_finish(self, req: Request, tokens: List[int],
                       reason: str) -> None:
        self._inflight.pop(req.request_id, None)
        self._responses[req.request_id] = Response(
            req.request_id, list(req.prompt), list(tokens), reason)
        if req.trace is not None and req.trace.started:
            # terminal at the ROUTER (shed/preempted) — no engine will
            # close this flow
            emit_flow(self._router_tracer(), req.trace, "finish",
                      final=True, request_id=req.request_id,
                      reason=reason)
        if self.recorder is not None:
            self.recorder.record("router", "router_finish",
                                 request_id=req.request_id,
                                 reason=reason, tick=self._tick)

    # -- response collection -------------------------------------------------

    def _collect(self) -> None:
        for i, eng in self._live():
            done = eng._done
            while self._consumed[i] < len(done):
                resp = done[self._consumed[i]]
                self._consumed[i] += 1
                rid = resp.request_id
                if rid in self._responses:
                    self.duplicate_responses += 1
                    continue
                self._responses[rid] = resp
                if self.recorder is not None:
                    self.recorder.record(f"replica{i}", "response",
                                         request_id=rid,
                                         reason=resp.finish_reason,
                                         tick=self._tick)
                self._resume_watch.pop(rid, None)
                fl = self._inflight.pop(rid, None)
                if fl is not None and fl.hedge_replica is not None:
                    loser = (fl.hedge_replica if i == fl.replica
                             else fl.replica)
                    if loser != i:
                        self.replicas[loser].cancel(rid)

    def _check_resumed(self) -> None:
        if self.first_resume is not None or not self._resume_watch:
            return
        for rid, (rep, baseline) in list(self._resume_watch.items()):
            eng = self.replicas[rep]
            if eng is None:
                self._resume_watch.pop(rid, None)
                continue
            for st in eng._active.values():
                if st.request.request_id == rid \
                        and len(st.generated) > baseline:
                    self.first_resume = (self._tick, self.clock())
                    return
            if rid in self._responses:
                self._resume_watch.pop(rid, None)

    # -- hedging + retries ---------------------------------------------------

    def _hedge_pass(self) -> None:
        if self.hedge_after_s is None:
            return
        now = self.clock()
        for rid, fl in list(self._inflight.items()):
            if fl.hedge_replica is not None \
                    or now - fl.submitted_t < self.hedge_after_s:
                continue
            src_eng = self.replicas[fl.replica]
            if src_eng is None \
                    or rid in src_eng.metrics.ttft:
                continue                     # already past the TTFT tail
            target = self._pick_target(exclude=fl.replica)
            if target is None:
                continue
            try:
                self.replicas[target].submit(
                    dataclasses.replace(fl.request))
            except (QueueFull, ValueError):
                continue
            fl.hedge_replica = target
            self.hedges += 1
            self._c_hedges.inc()
            self.replicas[target].trace.hedge(rid, target)
            if self.recorder is not None:
                self.recorder.record("router", "hedge", request_id=rid,
                                     replica=target, tick=self._tick)

    def _retry_pass(self) -> None:
        now = self.clock()
        # swap first: _queue_retry calls made during this pass append to
        # the fresh list and survive into the next tick
        pending, self._retry = self._retry, []
        for pr in pending:
            rid = pr.request.request_id
            if rid in self._responses:
                continue                     # e.g. finished as preempted
            if pr.next_t > now:
                self._retry.append(pr)
                continue
            self.retries += 1
            self._c_retries.inc()
            tr = self._fleet_trace()
            if tr is not None:
                tr.retry(rid, pr.attempts)
            if self.recorder is not None:
                self.recorder.record("router", "retry", request_id=rid,
                                     attempt=pr.attempts,
                                     tick=self._tick)
            if pr.progress:
                # in-flight work is never shed by the budget: _migrate
                # places it, finishes it ("preempted"), or re-queues it
                # with fresh backoff — delayed, never lost
                self._migrate(pr.request, pr.progress, src=-1, now=now)
                continue
            i = self._try_place(pr.request)
            if i is not None:
                self._inflight[rid] = _InFlight(pr.request, i, now)
                continue
            pr.attempts += 1
            if pr.attempts > self.retry_budget:
                self.shed_requests += 1
                self._c_shed.inc()
                self._router_finish(pr.request, pr.progress, "shed")
                continue
            self._queue_retry(pr.request, pr.progress, pr.attempts, now)

    # -- degradation ---------------------------------------------------------

    def _degrade_pass(self) -> None:
        if self.ladder is None:
            return
        live = self._live()
        if not live:
            return
        if self.ladder.burn_source is not None:
            # per-pool signal (disaggregation): degrade on the pool
            # whose pressure the ladder's actions actually relieve
            burn = float(self.ladder.burn_source())
        else:
            burn = max(self._burn(e) for _, e in live)
        old = self.ladder.level
        lvl = self.ladder.update(burn, self.clock())
        if lvl == old:
            return
        self._g_degraded.set(lvl)
        tr = self._fleet_trace()
        if tr is not None:
            tr.degrade(lvl)
        if self.recorder is not None:
            self.recorder.record("router", "degrade", old=old, new=lvl,
                                 burn=burn, tick=self._tick)
            if lvl > old:
                self.recorder.trigger("ladder_escalation", level=lvl,
                                      burn=burn, tick=self._tick)
        for _, eng in live:
            if getattr(eng, "spec", None) is not None:
                eng.spec_enabled = lvl < 1
        if lvl >= 2 and old < 2:
            for _, eng in live:
                pool = getattr(eng, "pool", None)
                if pool is not None:
                    pool.flush_prefixes()

    # -- the fleet tick ------------------------------------------------------

    def step(self) -> bool:
        """One fleet round: faults → heartbeats/health → collect →
        resumed-token watch → hedges → retries → degradation.  True
        while any replica, retry or in-flight request has work."""
        self._tick += 1
        t = self._tick
        busy = False
        durations: Dict[int, float] = {}
        for i, eng in self._live():
            kinds: Dict[str, ServingFault] = {}
            if self.injector is not None:
                kinds = {f.kind: f for f in self.injector.activate(t, i)}
            if self.recorder is not None:
                for k in kinds:
                    self.recorder.record(f"replica{i}", "fault",
                                         fault=k, tick=t)
            eng.injected_faults = frozenset(
                k for k in kinds
                if k in ("reject_admission", "kv_pool_exhaustion"))
            if "replica_crash" in kinds or "stuck_decode" in kinds:
                # no heartbeat: a crash answers nothing; a stuck decode
                # would hang the health probe just the same
                busy = busy or bool(eng._active or eng._queue)
                self._miss(i)
                continue
            t0 = self.clock()
            try:
                busy = eng.step() or busy
            except Exception:
                self._miss(i)
                continue
            slow = kinds.get("slow_replica")
            if slow is not None:
                self._advance_clock(float(slow.magnitude) or 0.05)
            durations[i] = self.clock() - t0
            self._beat(i)
            if self.recorder is not None:
                # per-tick load deltas per replica — the "metric
                # deltas" lane of the black box
                self.recorder.record(f"replica{i}", "tick",
                                     tick=t, queue=eng.queue_depth,
                                     active=eng.active_requests,
                                     dur_s=durations[i])
        self._update_slow(durations)
        self._collect()
        self._check_resumed()
        self._hedge_pass()
        self._retry_pass()
        self._degrade_pass()
        self._set_health_gauges()
        return busy or bool(self._retry) or bool(self._inflight)

    def _advance_clock(self, dt: float) -> None:
        if hasattr(self.clock, "advance"):
            self.clock.advance(dt)
        else:                                # pragma: no cover - realtime
            time.sleep(dt)

    @property
    def pending(self) -> int:
        """Accepted requests not yet terminal (exactly-once sentinel:
        0 on a drained fleet)."""
        return len(self._inflight) + len(self._retry)

    def run(self, max_steps: Optional[int] = None) -> List[Response]:
        """Drive :meth:`step` to drain.  With permanent whole-fleet
        faults injected, pass ``max_steps`` — a fleet with zero
        heartbeating replicas can never finish parked retries."""
        steps = 0
        while True:
            busy = self.step()
            steps += 1
            if not busy and not any(e._queue or e._active
                                    for _, e in self._live()):
                break
            if max_steps is not None and steps >= max_steps:
                break
        return self.completed

    @property
    def completed(self) -> List[Response]:
        """Deduplicated responses across the fleet (engine-produced plus
        router-terminal ``shed``/``preempted``), completion order."""
        self._collect()
        return list(self._responses.values())

    def recovery_report(self) -> dict:
        """Detection → migration → first-resumed-token timeline of the
        first replica death (ticks and clock seconds; None entries mean
        the event never happened)."""
        def row(v):
            return None if v is None else {"tick": v[0], "t": v[1]}
        return {"first_dead": row(self.first_dead),
                "first_migration": row(self.first_migration),
                "first_resumed_token": row(self.first_resume)}
