"""Serving metrics — port of ``ServingMetrics`` from
``apex_tpu/utils/profiling.py``.

Plain Python, with the JAX class's recording methods, ``summary()`` keys
and ``serving_*`` registry series.  The rest of that module (annotations,
device traces, memory stats, program hashes) is not ported yet.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Optional


class ServingMetrics:
    """Host-side serving observability for the continuous-batching engine.

    Tracks, per request, time-to-first-token (submit → first sampled
    token, i.e. including queueing + prefill) and per-token decode
    latencies; plus per-step slot occupancy samples for the engine as a
    whole.  ``clock`` is injectable (tests pass a fake counter) and
    defaults to ``time.monotonic``.  All aggregation is lazy —
    :meth:`summary` computes percentiles over whatever has been recorded.

    Since the observability PR this is a thin wrapper over a
    :class:`~apex_tpu_torch.observability.MetricsRegistry` — every recording
    ALSO feeds registry counters/histograms (``serving_*`` series), so
    an engine's metrics export as Prometheus text or a JSONL stream
    alongside training telemetry.  Pass a shared ``registry`` to merge
    serving and training series into one sink; the public recording API
    and :meth:`summary` values are unchanged (summary still computes
    exact percentiles over the raw samples, not histogram buckets).

    Per-request transient state (``_submitted``/``_last_token``) is
    dropped when a request reaches ANY terminal state — finished,
    evicted, errored or timed out — so a long-running engine no longer
    leaks an entry per request that finished without tokens.

    Memory is BOUNDED: raw-sample retention (``ttft`` /
    ``token_latencies`` / ``occupancy`` / ``queue_waits`` /
    ``decode_ticks``) keeps the most recent ``max_samples`` entries —
    :meth:`summary` percentiles are exact over that window, while the
    registry histograms (fixed buckets) and counters aggregate the full
    run.  A serving process that runs for weeks holds O(max_samples)
    state, not O(requests).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 registry: Optional[Any] = None, *,
                 slo: Optional[Any] = None,
                 max_samples: int = 4096):
        from apex_tpu_torch.observability.registry import MetricsRegistry

        self.clock = clock
        self.registry = registry if registry is not None \
            else MetricsRegistry(clock=clock)
        self.slo = slo                   # optional observability.SLOMonitor
        self.max_samples = max_samples
        self._submitted: dict = {}       # request_id -> submit time
        self._last_token: dict = {}      # request_id -> last token time
        self.ttft: dict = collections.OrderedDict()   # request_id -> s
        self.token_latencies: collections.deque = \
            collections.deque(maxlen=max_samples)
        self.occupancy: collections.deque = \
            collections.deque(maxlen=max_samples)  # (active, total)/step
        self.queue_waits: collections.deque = \
            collections.deque(maxlen=max_samples)  # enqueue->admit, s
        self.decode_ticks: collections.deque = \
            collections.deque(maxlen=max_samples)  # ticks per request
        self._first_tokens = 0           # requests that reached a token
        self.tokens_emitted = 0
        self.evicted = 0                 # deadline evictions (active+queued)
        self.errors = 0                  # poison requests quarantined
        self.timeouts = 0                # per-request timeout expiries
        self.requeued = 0                # preemption requeues (non-terminal)
        self.migrated = 0                # moved to another replica (fleet)
        self.cancelled = 0               # hedge losers withdrawn (fleet)
        self._started: float | None = None
        r = self.registry
        self._c_requests = r.counter("serving_requests_total",
                                     "requests submitted")
        self._c_finished = r.counter(
            "serving_finished_total", "requests reaching a terminal "
            "state, by reason", labelnames=("reason",))
        self._c_tokens = r.counter("serving_tokens_total",
                                   "tokens sampled")
        self._h_ttft = r.histogram("serving_ttft_seconds",
                                   "submit -> first token")
        self._h_latency = r.histogram("serving_token_latency_seconds",
                                      "inter-token decode latency")
        self._g_occupancy = r.gauge("serving_slot_occupancy",
                                    "active/total slots (last step)")
        self._g_queue = r.gauge("serving_active_requests",
                                "requests currently admitted")
        self._h_queue_wait = r.histogram(
            "serving_queue_wait_seconds",
            "enqueue -> admission wait (from the request trace)")
        self._h_ticks = r.histogram(
            "serving_decode_ticks",
            "decode ticks per request (from the request trace)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        self._c_requeued = r.counter(
            "serving_requests_requeued_total",
            "in-flight requests requeued by an engine preemption")

    def request_submitted(self, request_id) -> None:
        self._submitted[request_id] = self.clock()
        if self._started is None:
            self._started = self._submitted[request_id]
        self._c_requests.inc()

    def first_token(self, request_id) -> None:
        now = self.clock()
        ttft = now - self._submitted.get(request_id, now)
        self.ttft[request_id] = ttft
        while len(self.ttft) > self.max_samples:
            self.ttft.popitem(last=False)
        self._last_token[request_id] = now
        self._first_tokens += 1
        self.tokens_emitted += 1
        self._h_ttft.observe(ttft)
        self._c_tokens.inc()
        if self.slo is not None:
            self.slo.observe("ttft", ttft)

    def token(self, request_id) -> None:
        now = self.clock()
        prev = self._last_token.get(request_id)
        if prev is not None:
            self.token_latencies.append(now - prev)
            self._h_latency.observe(now - prev)
            if self.slo is not None:
                self.slo.observe("token_latency", now - prev)
        self._last_token[request_id] = now
        self.tokens_emitted += 1
        self._c_tokens.inc()

    def request_admitted(self, request_id, queue_wait_s: float) -> None:
        """Admission edge, fed by the request trace: ``queue_wait_s`` is
        the measured enqueue→admit wait on the trace's clock."""
        self.queue_waits.append(queue_wait_s)
        self._h_queue_wait.observe(queue_wait_s)
        if self.slo is not None:
            self.slo.observe("queue_wait", queue_wait_s)

    def request_decode_ticks(self, request_id, ticks: int) -> None:
        """Decode ticks a completed request consumed (request trace)."""
        self.decode_ticks.append(int(ticks))
        self._h_ticks.observe(ticks)

    def step(self, active_slots: int, total_slots: int) -> None:
        self.occupancy.append((active_slots, total_slots))
        self._g_occupancy.set(active_slots / total_slots
                              if total_slots else 0.0)
        self._g_queue.set(active_slots)

    def _terminal(self, request_id, reason: str) -> None:
        # terminal-state cleanup: without these pops a request that
        # finished without tokens leaked its _submitted/_last_token
        # entries for the life of the engine
        self._submitted.pop(request_id, None)
        self._last_token.pop(request_id, None)
        self._c_finished.inc(reason=reason)

    def request_finished(self, request_id, reason: str = "done") -> None:
        """A request completed normally (eos / length).  Drops its
        transient state and counts the terminal reason."""
        self._terminal(request_id, reason)

    def request_evicted(self, request_id) -> None:
        """A request hit its deadline — mid-decode or still queued.
        Without this the slot simply vanished from the stats (a request
        that never reached first_token left no trace in ``summary``)."""
        self.evicted += 1
        self._terminal(request_id, "evicted")

    def request_error(self, request_id) -> None:
        """A poison request was quarantined (its sampling/decode raised);
        the engine finished it with ``reason="error"`` instead of dying."""
        self.errors += 1
        self._terminal(request_id, "error")

    def request_timeout(self, request_id) -> None:
        """A request exceeded its per-request ``timeout`` budget
        (distinct from absolute-``deadline`` eviction)."""
        self.timeouts += 1
        self._terminal(request_id, "timeout")

    def request_requeued(self, request_id) -> None:
        """An in-flight request was requeued by an engine preemption.
        NON-terminal: the request's transient state (TTFT bookkeeping,
        token-latency chain) survives — it will be re-admitted and its
        next token lands in the same per-request series."""
        self.requeued += 1
        self._c_requeued.inc()

    def request_migrated(self, request_id) -> None:
        """The fleet moved this request to another replica (this
        engine's replica was declared dead).  Terminal FOR THIS ENGINE —
        the adopting replica restarts the request's transient state; the
        fleet-level count lives in ``serving_migrations_total``."""
        self.migrated += 1
        self._terminal(request_id, "migrated")

    def request_cancelled(self, request_id) -> None:
        """The fleet withdrew this request without a Response (the
        losing copy of a hedged dispatch)."""
        self.cancelled += 1
        self._terminal(request_id, "cancelled")

    @property
    def pending_requests(self) -> int:
        """Requests submitted but not yet terminal (leak sentinel:
        returns to 0 on an idle engine)."""
        return len(self._submitted)

    @staticmethod
    def _pct(xs, q):
        if not xs:
            return 0.0
        xs = sorted(xs)
        i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
        return xs[i]

    def summary(self) -> dict:
        elapsed = (self.clock() - self._started) if self._started else 0.0
        occ = ([a / t for a, t in self.occupancy if t]
               if self.occupancy else [])
        return {
            "requests": self._first_tokens,
            "tokens": self.tokens_emitted,
            "evicted": self.evicted,
            "errors": self.errors,
            "timeouts": self.timeouts,
            "requeued": self.requeued,
            "migrated": self.migrated,
            "cancelled": self.cancelled,
            "tokens_per_s": (self.tokens_emitted / elapsed
                             if elapsed > 0 else 0.0),
            "ttft_p50_s": self._pct(list(self.ttft.values()), 0.5),
            "ttft_max_s": max(self.ttft.values()) if self.ttft else 0.0,
            "token_latency_p50_s": self._pct(self.token_latencies, 0.5),
            "token_latency_p90_s": self._pct(self.token_latencies, 0.9),
            "queue_wait_p50_s": self._pct(self.queue_waits, 0.5),
            "decode_ticks_p50": self._pct(self.decode_ticks, 0.5),
            "slot_occupancy_mean": (sum(occ) / len(occ)) if occ else 0.0,
        }
