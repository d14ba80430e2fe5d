"""Per-request lifecycle tracing for the continuous-batching engine.

The serving engine's latency story is per-REQUEST, not per-thread: a
request waits in the queue, gets one prefill, then shares batched decode
steps with whatever else is in flight.  :class:`RequestTracer` threads
the request id through that lifecycle —

    enqueue -> admit -> first_token -> decode ticks -> finish

— recording raw clock timestamps on the hot path (a dict write or an
int increment; no event objects, no locks of its own) and materializing
everything ONCE, at request completion:

* correlated async spans into a :class:`~apex_tpu_torch.observability.Tracer`
  (``queue_wait`` / ``prefill`` / ``decode`` nested under one
  ``request`` slice per flow id), so a single Perfetto load shows where
  each request's latency went, interleaved with the host spans;
* the queue-wait and decode-ticks series into
  :class:`~apex_tpu_torch.utils.profiling.ServingMetrics` — sourced from the
  trace's timestamps instead of ad-hoc ones;
* a bounded deque of :class:`RequestRecord` rows from which TTFT and
  TPOT are DERIVED quantities (``ttft = t_first - t_enqueue``,
  ``tpot = decode_s / ticks``), not separately measured ones.

The tracer is always on inside the engine; with no ``tracer=`` attached
the finish path only updates the record deque and metrics, so the
default overhead stays within the bench gate (<2% on the decode loop).

Port of ``apex_tpu/observability/request_trace.py``; it imports no JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

from apex_tpu_torch.observability.fleetobs import TraceContext, emit_flow
from apex_tpu_torch.observability.spans import Tracer


@dataclasses.dataclass
class _Live:
    t_enqueue: float
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    ticks: int = 0                 # decode ticks (tokens after the first)
    ctx: Optional[TraceContext] = None   # fleet-wide causal identity


@dataclasses.dataclass
class RequestRecord:
    """One completed request's latency attribution, all in seconds of
    the tracer's clock.  ``ttft``/``tpot`` are derived from the phase
    timestamps: ``ttft_s = queue_wait_s + prefill_s`` and ``tpot_s``
    averages the decode phase over its ticks."""
    request_id: object
    reason: str
    t_enqueue: float
    t_finish: float
    queue_wait_s: float
    prefill_s: Optional[float]     # None: never admitted
    decode_s: Optional[float]      # None: never produced a first token
    ticks: int
    error: Optional[str] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.prefill_s is None or self.decode_s is None:
            return None
        return self.queue_wait_s + self.prefill_s

    @property
    def tpot_s(self) -> Optional[float]:
        if self.decode_s is None or not self.ticks:
            return None
        return self.decode_s / self.ticks


class RequestTracer:
    """Lifecycle bookkeeping for in-flight requests.

    ``tracer`` (a :class:`spans.Tracer`) is optional; when given, its
    clock becomes THE clock so request slices and host spans share a
    timeline, and each finished request emits nested async trace events
    on flow id ``request_id``.  ``metrics`` (a ``ServingMetrics``)
    receives ``request_admitted(id, queue_wait)`` at admission and
    ``request_decode_ticks(id, ticks)`` at completion.  Not thread-safe
    beyond what the engine needs (all lifecycle calls happen on the
    engine's step thread).
    """

    def __init__(self, clock=time.monotonic, *,
                 tracer: Optional[Tracer] = None,
                 metrics=None, keep: int = 512):
        self.clock = tracer.clock if tracer is not None else clock
        self.tracer = tracer
        self.metrics = metrics
        self._live: dict = {}
        self.records: collections.deque = collections.deque(maxlen=keep)

    # -- lifecycle (hot path: timestamps only) -------------------------------

    def enqueue(self, request_id,
                ctx: Optional[TraceContext] = None) -> None:
        self._live[request_id] = _Live(t_enqueue=self.clock(), ctx=ctx)
        self._flow(ctx, "enqueue", request_id=request_id)

    def admit(self, request_id) -> None:
        st = self._live.get(request_id)
        if st is None:              # pragma: no cover - defensive
            return
        st.t_admit = self.clock()
        if self.metrics is not None:
            self.metrics.request_admitted(request_id,
                                          st.t_admit - st.t_enqueue)
        self._flow(st.ctx, "admit", request_id=request_id)

    def first_token(self, request_id) -> None:
        st = self._live.get(request_id)
        if st is not None:
            st.t_first = self.clock()
            self._flow(st.ctx, "first_token", request_id=request_id)

    def resumed(self, request_id) -> None:
        """A migrated/preempted request re-entered decode with prior
        progress intact — a flow step, so the cross-replica arrow
        lands on the adopting replica's lane."""
        st = self._live.get(request_id)
        if st is not None:
            self._flow(st.ctx, "resume", request_id=request_id)

    def _flow(self, ctx, phase, *, final=False, **args) -> None:
        if self.tracer is not None:
            emit_flow(self.tracer, ctx, phase, final=final, **args)

    def decode_tick(self, request_id) -> None:
        st = self._live.get(request_id)
        if st is not None:
            st.ticks += 1

    def requeue(self, request_id) -> None:
        """A preemption sent this in-flight request back to the queue.
        The live entry stays open (the request's lifecycle continues
        through re-admission — phase timestamps keep accumulating into
        the SAME record), so this only marks the event on the timeline."""
        if self.tracer is not None:
            self.tracer.instant("request_requeued", request_id=request_id)

    # fleet events (FleetRouter): marks on the timeline, same idiom as
    # requeue — the request's own lifecycle record keeps accumulating

    def retry(self, request_id, attempt: int = 0) -> None:
        """The fleet re-attempted placement after a failed or shed one."""
        if self.tracer is not None:
            self.tracer.instant("request_retry", request_id=request_id,
                                attempt=attempt)

    def migrate(self, request_id, src: int, dst: int) -> None:
        """The request moved off a dead replica onto a healthy one."""
        if self.tracer is not None:
            self.tracer.instant("request_migrated", request_id=request_id,
                                src=src, dst=dst)

    def hedge(self, request_id, replica: int) -> None:
        """A duplicate copy was dispatched for tail-latency cover."""
        if self.tracer is not None:
            self.tracer.instant("request_hedged", request_id=request_id,
                                replica=replica)

    def degrade(self, level: int) -> None:
        """The fleet's degradation ladder changed level."""
        if self.tracer is not None:
            self.tracer.instant("serving_degraded", level=level)

    @property
    def pending(self) -> int:
        """Requests enqueued but not yet finished (leak sentinel)."""
        return len(self._live)

    # -- completion: materialize spans + record ------------------------------

    def finish(self, request_id, reason: str,
               error: Optional[str] = None) -> Optional[RequestRecord]:
        st = self._live.pop(request_id, None)
        if st is None:
            return None
        now = self.clock()
        # phase boundaries; a request can die in any phase, and the
        # open phase absorbs the time up to `now` so the spans tile
        # the request slice exactly
        queue_end = st.t_admit if st.t_admit is not None else now
        prefill_s = None
        if st.t_admit is not None:
            prefill_end = st.t_first if st.t_first is not None else now
            prefill_s = prefill_end - st.t_admit
        decode_s = (now - st.t_first) if st.t_first is not None else None
        rec = RequestRecord(
            request_id=request_id, reason=reason,
            t_enqueue=st.t_enqueue, t_finish=now,
            queue_wait_s=queue_end - st.t_enqueue,
            prefill_s=prefill_s, decode_s=decode_s,
            ticks=st.ticks, error=error)
        self.records.append(rec)
        if self.metrics is not None and st.t_admit is not None:
            self.metrics.request_decode_ticks(request_id, st.ticks)
        # "migrated" is a flow STEP (the chain continues on the
        # adopting replica); every other reason terminates the flow
        self._flow(st.ctx,
                   "migrate_out" if reason == "migrated" else "finish",
                   final=reason != "migrated",
                   request_id=request_id, reason=reason)
        tr = self.tracer
        if tr is not None:
            args = {"reason": reason, "ticks": st.ticks}
            if error:
                args["error"] = error
            tr.async_span("request", request_id, st.t_enqueue,
                          now - st.t_enqueue, **args)
            tr.async_span("queue_wait", request_id, st.t_enqueue,
                          rec.queue_wait_s)
            if prefill_s is not None:
                tr.async_span("prefill", request_id, st.t_admit, prefill_s)
            if decode_s is not None:
                tr.async_span("decode", request_id, st.t_first, decode_s,
                              ticks=st.ticks)
        return rec

    # -- derived aggregates --------------------------------------------------

    def summary(self) -> dict:
        """Derived-latency percentiles over the retained records."""
        recs = list(self.records)
        ttft = [r.ttft_s for r in recs if r.ttft_s is not None]
        tpot = [r.tpot_s for r in recs if r.tpot_s is not None]
        qw = [r.queue_wait_s for r in recs]

        def pct(xs, q):
            if not xs:
                return 0.0
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]

        return {
            "requests": len(recs),
            "ttft_p50_s": pct(ttft, 0.5),
            "ttft_p95_s": pct(ttft, 0.95),
            "tpot_p50_s": pct(tpot, 0.5),
            "queue_wait_p50_s": pct(qw, 0.5),
            "queue_wait_p95_s": pct(qw, 0.95),
        }
