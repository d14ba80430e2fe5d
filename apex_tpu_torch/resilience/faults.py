"""Deterministic fault injection for the resilience test harness.

A :class:`FaultInjector` owns a schedule of :class:`Fault` events —
either written out explicitly or generated from a seed + per-kind rates
(:meth:`FaultInjector.from_seed`), so a CI sweep can replay the exact
same failure sequence on every run.  Kinds:

=================== =========================================================
``nan_grads``       every gradient leaf becomes NaN (device-side, in-jit)
``inf_loss``        the loss becomes +inf (device-side, in-jit)
``grad_spike``      gradients scaled by ``magnitude`` (default 64x)
``preempt_at_step`` :class:`Preemption` raised before the step runs — the
                    SIGTERM/maintenance-event analogue
``corrupt_checkpoint`` the checkpoint committed at that step has payload
                    bytes flipped post-commit (a torn write the manifest
                    hash must catch)
``slow_host``       the host sleeps ``magnitude`` seconds before the step
                    (straggler simulation; surfaced in step timings)
``topology_change`` the pod shrinks/grows at that step: ``magnitude`` > 0
                    names the new dp degree, 0 asks the elastic trainer to
                    toggle shrink-to-half / grow-back; consumed via
                    :meth:`FaultInjector.check_topology_change`
``capacity_change`` a train<->serve capacity shift in flight at that step
                    fails: ``magnitude`` selects the failure mode (0/1
                    mid-shift crash, 2 stuck drain, 3 failed re-shard — see
                    ``resilience.capacity.fault_mode``); consumed
                    via :meth:`FaultInjector.check_capacity_change` by the
                    :class:`~resilience.capacity.CapacityController`
``dcn_fault``       a cross-pod (DCN) activation/cotangent transfer at that
                    step drops/times out: the MPMD channel raises the
                    retryable :class:`apex_tpu_torch.mpmd.DcnTimeout`; consumed
                    (recorded + removed) via :meth:`FaultInjector.check_dcn`
                    so the engine's resend succeeds
``cost_drift``      the machine's communication profile drifts at that
                    step: ``magnitude`` scales the true link alpha-beta
                    coefficients (0 = default 2x slower; < 1 = links
                    recovering); consumed via
                    :meth:`FaultInjector.check_cost_drift` by the
                    :class:`~resilience.autopilot.ParallelismAutopilot`,
                    which must DETECT it from refitted telemetry — the
                    fault moves the environment, never the detector
``plan_regression`` the next adopted plan measures slower than predicted:
                    ``magnitude`` inflates the commit-gate step times
                    (0 = default 2x) so the gate must roll the adoption
                    back; consumed via
                    :meth:`FaultInjector.check_plan_regression` when an
                    adoption starts
=================== =========================================================

Every new kind is appended LAST so :meth:`FaultInjector.from_seed`
schedules for the pre-existing kinds are byte-identical to before it
existed — ``seeded_schedule`` consumes no rng state for rate-0 kinds
(asserted by ``tests/test_capacity.py`` for ``capacity_change``,
``tests/test_mpmd.py`` for ``dcn_fault``, and
``tests/test_autopilot.py`` for ``cost_drift``/``plan_regression``).

The in-jit kinds are injected as DATA, not control flow:
:meth:`grad_flags` returns three scalars the guarded train step folds in
with ``jnp.where``, so one compiled program serves both clean and
faulty steps and injection never perturbs compilation caches.

Port of ``apex_tpu/resilience/faults.py``; it imports no JAX.  The
serving fleet uses ``seeded_schedule``, the KV channel ``check_dcn``, the
capacity controllers ``check_capacity_change``, the guarded step
``grad_flags`` / ``check_preempt`` / ``maybe_slow_host``, the checkpoint
``should_corrupt``, the elastic trainer ``check_topology_change`` /
``check_preempt``, and the
:class:`~apex_tpu_torch.resilience.autopilot.ParallelismAutopilot`
``check_cost_drift`` (at every tick) / ``check_plan_regression`` (when an
adoption starts).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

FAULT_KINDS = ("nan_grads", "inf_loss", "grad_spike", "preempt_at_step",
               "corrupt_checkpoint", "slow_host", "topology_change",
               "capacity_change", "dcn_fault", "cost_drift",
               "plan_regression")

# the serving-side fault kinds live in apex_tpu_torch.serving.fleet
# (SERVING_FAULT_KINDS); its ServingFaultInjector generates schedules
# from the same seeded_schedule stream below — one discipline for
# training-step faults and replica-tick faults


def seeded_schedule(seed: int, n_steps: int, keys, rates) -> list:
    """Shared deterministic event stream: for each step and key IN THE
    GIVEN ORDER, an event fires with probability ``rates[key]`` under
    one ``RandomState(seed)`` stream — same seed, same schedule, always.
    Returns ``[(step, key), ...]``.  A rate of 0.0 consumes no stream
    state, so adding a never-firing kind cannot shift the schedule of
    the others."""
    rng = np.random.RandomState(seed)
    out = []
    for step in range(n_steps):
        for key in keys:
            r = rates.get(key, 0.0)
            if r > 0.0 and rng.uniform() < r:
                out.append((step, key))
    return out


class Preemption(RuntimeError):
    """Raised by :meth:`FaultInjector.check_preempt` — the injected
    equivalent of the scheduler killing the worker.  Train loops let it
    propagate (a real preemption gives no chance to clean up); recovery
    is restart + :meth:`CheckpointManager.restore`."""

    def __init__(self, step: int):
        super().__init__(f"injected preemption at step {step}")
        self.step = step


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``magnitude`` is the spike factor for
    ``grad_spike``, the sleep seconds for ``slow_host``, the target
    dp degree for ``topology_change`` (0 = auto shrink/grow toggle),
    and the failure mode for ``capacity_change``.

    ``once=True`` makes the fault fire a single time: it is removed
    from the schedule when consumed, so steps RE-RUN after a guard
    rollback execute clean — the model of a state-dependent anomaly
    (loss blowup) that the rollback actually cures.  A step-keyed fault
    that re-fires forever would pin a K-consecutive-anomaly rollback in
    a restore/re-fire loop; ``once`` is what lets the day-in-the-life
    sim exercise a rollback that terminates."""
    step: int
    kind: str
    magnitude: float = 0.0
    once: bool = False

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError("fault step must be >= 0")


class FaultInjector:
    """Deterministic fault schedule threaded through train + IO paths."""

    def __init__(self, schedule: Iterable[Fault] = ()):
        self.schedule: Tuple[Fault, ...] = tuple(schedule)
        self._by_step: Dict[int, List[Fault]] = {}
        for f in self.schedule:
            self._by_step.setdefault(f.step, []).append(f)
        self.log: List[Tuple[int, str]] = []   # (step, kind) as applied

    @classmethod
    def from_seed(cls, seed: int, n_steps: int,
                  rates: Optional[Dict[str, float]] = None, *,
                  spike_magnitude: float = 64.0,
                  slow_host_s: float = 0.01) -> "FaultInjector":
        """Random-but-reproducible schedule: for each step and kind,
        a fault fires with probability ``rates[kind]`` under a
        ``RandomState(seed)`` stream — same seed, same schedule, always."""
        rates = dict(rates or {})
        bad = set(rates) - set(FAULT_KINDS)
        if bad:
            raise ValueError(f"unknown fault kinds in rates: {sorted(bad)}")
        faults = []
        for step, kind in seeded_schedule(seed, n_steps, FAULT_KINDS,
                                          rates):
            mag = (spike_magnitude if kind == "grad_spike"
                   else slow_host_s if kind == "slow_host" else 0.0)
            faults.append(Fault(step, kind, mag))
        return cls(faults)

    # -- queries -------------------------------------------------------------

    def faults_at(self, step: int) -> Tuple[Fault, ...]:
        return tuple(self._by_step.get(step, ()))

    def _find(self, step: int, kind: str) -> Optional[Fault]:
        for f in self._by_step.get(step, ()):
            if f.kind == kind:
                return f
        return None

    def _consume(self, step: int, kind: str) -> Optional[Fault]:
        """Find + record; ``once`` faults leave the schedule so a
        rolled-back re-run of the same step executes clean."""
        f = self._find(step, kind)
        if f is None:
            return None
        self.record(step, kind)
        if f.once:
            self._by_step[step].remove(f)
        return f

    def record(self, step: int, kind: str) -> None:
        """Append to the applied-fault log (callers record at the point
        the fault actually lands, so the log is the ground truth tests
        assert against)."""
        self.log.append((int(step), kind))

    # -- train-loop hooks ----------------------------------------------------

    def grad_flags(self, step: int) -> Dict[str, float]:
        """The in-jit injection scalars for this step:
        ``{"nan_grads": 0/1, "inf_loss": 0/1, "spike_scale": s}`` —
        identity values (0, 0, 1) on clean steps.  Folded into the
        guarded step with ``jnp.where``; see
        :class:`~apex_tpu_torch.resilience.guard.GuardedTrainStep`."""
        out = {"nan_grads": 0.0, "inf_loss": 0.0, "spike_scale": 1.0}
        if self._consume(step, "nan_grads"):
            out["nan_grads"] = 1.0
        if self._consume(step, "inf_loss"):
            out["inf_loss"] = 1.0
        spike = self._consume(step, "grad_spike")
        if spike:
            out["spike_scale"] = float(spike.magnitude or 64.0)
        return out

    def check_preempt(self, step: int) -> None:
        if self._consume(step, "preempt_at_step"):
            raise Preemption(step)

    def check_topology_change(self, step: int) -> Optional[Fault]:
        """The scheduled ``topology_change`` at ``step``, if any —
        recorded on consumption; the elastic trainer turns it into a
        re-plan BEFORE the step runs (the step executes on the new
        topology, matching a maintenance event's grace window)."""
        f = self._find(step, "topology_change")
        if f is not None:
            self.record(step, "topology_change")
        return f

    def check_capacity_change(self, step: int) -> Optional[Fault]:
        """The scheduled ``capacity_change`` at ``step``, if any —
        consumed (recorded + removed) so one scheduled fault fails one
        shift: the capacity controller's retry after the rollback must
        be able to succeed.  ``magnitude`` selects the failure mode;
        see ``apex_tpu_torch.resilience.capacity.fault_mode``."""
        f = self._find(step, "capacity_change")
        if f is not None:
            self.record(step, "capacity_change")
            self._by_step[step].remove(f)
        return f

    def check_dcn(self, step: int) -> Optional[Fault]:
        """The scheduled ``dcn_fault`` at ``step``, if any — consumed
        (recorded + removed) so one scheduled fault drops one cross-pod
        transfer: the MPMD channel's retry of the same send must be
        able to succeed.  ``magnitude`` is reserved for failure-mode
        selection (0 = dropped/timed-out send)."""
        f = self._find(step, "dcn_fault")
        if f is not None:
            self.record(step, "dcn_fault")
            self._by_step[step].remove(f)
        return f

    def _consume_due(self, step: int, kind: str) -> Optional[Fault]:
        """The EARLIEST scheduled ``kind`` at or before ``step``, if
        any — consumed (recorded at its scheduled step + removed).
        Window-tolerant where :meth:`_consume` is exact-step: the
        autopilot polls at controller ticks, which land between
        training steps, so a fault scheduled "at step 24" must still be
        seen when the poll happens at step 26."""
        for s in sorted(self._by_step):
            if s > step:
                break
            for f in self._by_step[s]:
                if f.kind == kind:
                    self.record(s, kind)
                    self._by_step[s].remove(f)
                    return f
        return None

    def check_cost_drift(self, step: int) -> Optional[Fault]:
        """The scheduled ``cost_drift`` due by ``step``, if any —
        consumed so one scheduled fault drifts the environment once.
        ``magnitude`` scales the drifted environment's alpha-beta
        coefficients relative to the current profile (0 = 2x)."""
        return self._consume_due(step, "cost_drift")

    def check_plan_regression(self, step: int) -> Optional[Fault]:
        """The scheduled ``plan_regression`` due by ``step``, if any —
        consumed at adoption start so one scheduled fault fails one
        commit gate: the autopilot's next adoption after the rollback
        must be able to succeed.  ``magnitude`` inflates the gate's
        measured step times (0 = 2x)."""
        return self._consume_due(step, "plan_regression")

    def maybe_slow_host(self, step: int) -> None:
        f = self._find(step, "slow_host")
        if f:
            self.record(step, "slow_host")
            time.sleep(float(f.magnitude or 0.01))

    # -- checkpoint-IO hook --------------------------------------------------

    def should_corrupt(self, step: int) -> bool:
        """True when the checkpoint committed at ``step`` must be
        corrupted post-commit (the manager calls :meth:`record`
        itself, after the bytes are actually flipped)."""
        return self._find(step, "corrupt_checkpoint") is not None
