"""SLO-aware multi-replica router: admission, placement, shedding.

One :class:`Router` fronts N independent engine replicas (contiguous or
paged — anything with the :class:`~apex_tpu_torch.inference.InferenceEngine`
surface).  Placement and admission read two signals per replica:

* **queue pressure** — ``queue_depth + active_requests``, the classic
  least-loaded signal; a replica at ``max_queue_depth`` queued requests
  is ineligible outright (its own bounded queue would reject anyway —
  the router just refuses earlier and cheaper).
* **SLO burn rate** — ``max`` over the replica's
  :class:`~apex_tpu_torch.observability.slo.SLOTarget`\\ s of the short-window
  error-budget burn (:meth:`SLOMonitor.burn_rate`).  A replica burning
  ≥ ``burn_threshold`` with ANY backlog is ineligible: it is already
  missing its latency objectives, so adding load converts one slow
  replica into globally blown SLOs.  (Burn with an EMPTY queue does not
  shed — an idle replica's stale burn history should not refuse the
  request that would be served instantly.)

When every replica is ineligible the request is SHED —
:class:`RequestShed` raised to the caller, who got an answer in
microseconds instead of a timeout in seconds.  Shedding is the SLO
mechanism, not a failure: dropping the marginal request is what keeps
the admitted ones inside their objectives (the loadgen's ``--overload``
runs demonstrate exactly this trade).

Scheduling stays host-side and cooperative: :meth:`step` advances every
replica one engine tick (round-robin), :meth:`run` drives to drain.

Port of ``apex_tpu/serving/router.py``; it imports no JAX.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

from apex_tpu_torch.inference.engine import QueueFull, Request, Response
from apex_tpu_torch.observability.fleetobs import TraceContext, emit_flow
from apex_tpu_torch.observability.spans import Tracer


class ShedReason(enum.Enum):
    """Machine-readable reason a request was refused — the enum a
    client maps to its own backoff/retry policy (and the loadgen's
    per-reason outcome report keys off)."""
    OVERLOAD = "overload"                    # every replica over limits
    NO_HEALTHY_REPLICA = "no_healthy_replica"  # fleet: none HEALTHY
    CONTEXT_CAP = "context_cap"              # degradation L2 prompt cap
    DEGRADED = "degraded"                    # degradation L3: shed all
    RETRY_BUDGET_EXHAUSTED = "retry_budget_exhausted"
    DRAINING = "draining"                    # fleet: capacity shift drain


class RequestShed(RuntimeError):
    """The request was refused at the door; the caller got an answer in
    microseconds instead of a timeout in seconds.

    Carries a machine-readable :class:`ShedReason` and a
    ``retry_after_s`` hint (the serving analogue of HTTP 429's
    ``Retry-After``) so clients back off *by policy* instead of
    guessing; ``tools/loadgen.py --client-retries`` honors it with
    jittered backoff."""

    def __init__(self, msg: str = "request shed", *,
                 reason: ShedReason = ShedReason.OVERLOAD,
                 retry_after_s: float = 0.05):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


class Router:
    """SLO-aware admission over a set of engine replicas."""

    def __init__(self, replicas: Sequence, *,
                 max_queue_depth: int = 8,
                 burn_threshold: float = 14.4,
                 burn_window_s: float = 60.0,
                 registry=None,
                 tracer: Optional[Tracer] = None):
        if not replicas:
            raise ValueError("need at least one replica")
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        self.replicas = list(replicas)
        self.max_queue_depth = max_queue_depth
        self.burn_threshold = burn_threshold
        self.burn_window_s = burn_window_s
        self.shed_requests = 0
        # the router's own trace lane (dispatch/shed flow events); a
        # TraceContext is minted whenever ANY tracer exists in the
        # deployment, so engine-side flows link up even without a
        # router tracer
        self.tracer = tracer
        self._tracing = tracer is not None or any(
            getattr(getattr(e, "trace", None), "tracer", None) is not None
            for e in self.replicas)
        r = registry if registry is not None \
            else self.replicas[0].metrics.registry
        self._c_submitted = r.counter(
            "router_submitted_total", "requests placed, by replica",
            labelnames=("replica",))
        self._c_shed = r.counter(
            "router_shed_total",
            "requests refused with every replica overloaded")
        self._g_depth = r.gauge(
            "router_queue_depth", "replica queue depth at placement",
            labelnames=("replica",))
        self._g_burn = r.gauge(
            "router_burn_rate",
            "replica max short-window SLO burn at placement",
            labelnames=("replica",))

    # -- signals -------------------------------------------------------------

    def _live(self):
        """(index, engine) pairs skipping tombstones — a replica
        removed by the fleet's capacity lifecycle leaves ``None`` in
        its slot so every other index-keyed structure stays valid."""
        return [(i, e) for i, e in enumerate(self.replicas)
                if e is not None]

    def _burn(self, engine) -> float:
        """Max short-window burn across the replica's SLO targets (0.0
        when the replica has no SLO monitor attached)."""
        slo = getattr(engine.metrics, "slo", None)
        if slo is None or not slo.targets:
            return 0.0
        return max(slo.burn_rate(t, self.burn_window_s)
                   for t in slo.targets)

    def _overloaded(self, engine, burn: float) -> bool:
        if engine.queue_depth >= self.max_queue_depth:
            return True
        return burn >= self.burn_threshold and engine.queue_depth >= 1

    def _eligible(self, i: int, engine, burn: float) -> bool:
        """Placement eligibility hook — subclasses narrow it (the fleet
        router additionally requires the replica to be HEALTHY)."""
        return not self._overloaded(engine, burn)

    def _retry_after_hint(self) -> float:
        """Heuristic Retry-After: half a queue-drain's worth per queued
        request on the least-loaded replica — deeper backlog, longer
        hint, so backed-off clients return staggered, not in a thundering
        herd (the loadgen additionally jitters it)."""
        live = self._live()
        if not live:
            return 0.05 * 2.0
        depth = min(e.queue_depth for _, e in live)
        return 0.05 * (1.0 + depth / max(self.max_queue_depth, 1))

    # -- admission -----------------------------------------------------------

    def _dispatch_ctx(self, request: Request) -> Optional[TraceContext]:
        """Mint the request's :class:`TraceContext` (once — retries
        reuse it) and stamp the router's dispatch flow event."""
        if not self._tracing:
            return None
        if request.trace is None:
            request.trace = TraceContext.mint(request.request_id)
        emit_flow(self.tracer, request.trace, "dispatch",
                  request_id=request.request_id)
        return request.trace

    def _router_tracer(self) -> Optional[Tracer]:
        """The tracer router-level flow events land on: the router's
        own, else any replica's (a started chain must still close when
        only the engines are traced)."""
        if self.tracer is not None:
            return self.tracer
        for _, e in self._live():
            t = getattr(getattr(e, "trace", None), "tracer", None)
            if t is not None:
                return t
        return None

    def _flow_shed(self, request: Request, reason: "ShedReason") -> None:
        """Terminate a shed request's flow at the router (it never
        reaches an engine, so nothing else will)."""
        if request.trace is not None and request.trace.started:
            emit_flow(self._router_tracer(), request.trace, "finish",
                      final=True, request_id=request.request_id,
                      reason="shed", shed_reason=reason.value)

    def _try_place(self, request: Request) -> Optional[int]:
        """Place on the best eligible replica; replica index, or None
        with nowhere to go (the :class:`QueueFull` race — an eligible
        replica's own bounded queue filling concurrently — just moves
        on to the next candidate)."""
        scored = []
        for i, eng in self._live():
            burn = self._burn(eng)
            self._g_depth.set(eng.queue_depth, replica=str(i))
            self._g_burn.set(burn, replica=str(i))
            if not self._eligible(i, eng, burn):
                continue
            scored.append((eng.queue_depth + eng.active_requests, burn, i))
        for _, _, i in sorted(scored):
            try:
                self.replicas[i].submit(request)
            except QueueFull:
                continue
            self._c_submitted.inc(replica=str(i))
            return i
        return None

    def submit(self, request: Request) -> int:
        """Place ``request`` on the best eligible replica; returns the
        replica index.  Raises :class:`RequestShed` when no replica is
        eligible."""
        self._dispatch_ctx(request)
        i = self._try_place(request)
        if i is not None:
            return i
        self.shed_requests += 1
        self._c_shed.inc()
        self._flow_shed(request, ShedReason.OVERLOAD)
        raise RequestShed(
            f"all {len(self.replicas)} replicas overloaded "
            f"(max_queue_depth={self.max_queue_depth}, "
            f"burn_threshold={self.burn_threshold})",
            reason=ShedReason.OVERLOAD,
            retry_after_s=self._retry_after_hint())

    # -- scheduling ----------------------------------------------------------

    def step(self) -> bool:
        """Advance every replica one engine tick; True while any has
        (or may have) work."""
        busy = False
        for _, eng in self._live():
            busy = eng.step() or busy
        return busy

    def run(self, max_steps: Optional[int] = None) -> List[Response]:
        """Drive :meth:`step` to drain (or ``max_steps``); returns all
        completed responses across replicas."""
        steps = 0
        while any(e._queue or e._active for _, e in self._live()):
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.completed

    @property
    def queue_depth(self) -> int:
        return sum(e.queue_depth for _, e in self._live())

    @property
    def active_requests(self) -> int:
        return sum(e.active_requests for _, e in self._live())

    @property
    def completed(self) -> List[Response]:
        out: List[Response] = []
        for _, eng in self._live():
            out.extend(eng.completed)
        return out
