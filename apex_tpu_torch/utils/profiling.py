"""Serving metrics — port of ``ServingMetrics`` from
``apex_tpu/utils/profiling.py``.

Plain Python, with the JAX class's recording methods and ``summary()``
keys.  The metrics registry (Prometheus/JSONL export) and the SLO monitor
it feeds in the JAX package wait for the observability slice.
"""

from __future__ import annotations

import collections
import time
from typing import Callable


class ServingMetrics:
    """Host-side serving observability for the continuous-batching engine.

    Per request: time to first token (submit → first sampled token, i.e.
    queueing + prefill) and inter-token latencies; per step: slot
    occupancy.  ``clock`` is injectable.  Raw samples keep the most recent
    ``max_samples`` entries; :meth:`summary` computes exact percentiles
    over that window.  Per-request transient state is dropped at any
    terminal state.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 max_samples: int = 4096):
        self.clock = clock
        self.max_samples = max_samples
        self._submitted: dict = {}       # request_id -> submit time
        self._last_token: dict = {}      # request_id -> last token time
        self.ttft: dict = collections.OrderedDict()   # request_id -> s
        self.token_latencies = collections.deque(maxlen=max_samples)
        self.occupancy = collections.deque(maxlen=max_samples)
        self.queue_waits = collections.deque(maxlen=max_samples)
        self.decode_ticks = collections.deque(maxlen=max_samples)
        self._first_tokens = 0
        self.tokens_emitted = 0
        self.evicted = 0
        self.errors = 0
        self.timeouts = 0
        self.requeued = 0
        self.migrated = 0
        self.cancelled = 0
        self._started = None

    def request_submitted(self, request_id) -> None:
        self._submitted[request_id] = self.clock()
        if self._started is None:
            self._started = self._submitted[request_id]

    def first_token(self, request_id) -> None:
        now = self.clock()
        self.ttft[request_id] = now - self._submitted.get(request_id, now)
        while len(self.ttft) > self.max_samples:
            self.ttft.popitem(last=False)
        self._last_token[request_id] = now
        self._first_tokens += 1
        self.tokens_emitted += 1

    def token(self, request_id) -> None:
        now = self.clock()
        prev = self._last_token.get(request_id)
        if prev is not None:
            self.token_latencies.append(now - prev)
        self._last_token[request_id] = now
        self.tokens_emitted += 1

    def request_admitted(self, request_id, queue_wait_s: float) -> None:
        """Admission edge: ``queue_wait_s`` is the enqueue → admit wait."""
        self.queue_waits.append(queue_wait_s)

    def request_decode_ticks(self, request_id, ticks: int) -> None:
        """Decode ticks a completed request consumed."""
        self.decode_ticks.append(int(ticks))

    def step(self, active_slots: int, total_slots: int) -> None:
        self.occupancy.append((active_slots, total_slots))

    def _terminal(self, request_id) -> None:
        self._submitted.pop(request_id, None)
        self._last_token.pop(request_id, None)

    def request_finished(self, request_id, reason: str = "done") -> None:
        """A request completed normally (eos / length)."""
        self._terminal(request_id)

    def request_evicted(self, request_id) -> None:
        self.evicted += 1
        self._terminal(request_id)

    def request_error(self, request_id) -> None:
        """A poison request was quarantined (``reason="error"``)."""
        self.errors += 1
        self._terminal(request_id)

    def request_timeout(self, request_id) -> None:
        self.timeouts += 1
        self._terminal(request_id)

    def request_requeued(self, request_id) -> None:
        """Non-terminal: the request will be re-admitted."""
        self.requeued += 1

    def request_migrated(self, request_id) -> None:
        self.migrated += 1
        self._terminal(request_id)

    def request_cancelled(self, request_id) -> None:
        self.cancelled += 1
        self._terminal(request_id)

    @property
    def pending_requests(self) -> int:
        """Requests submitted but not yet terminal (0 on an idle engine)."""
        return len(self._submitted)

    @staticmethod
    def _pct(xs, q):
        if not xs:
            return 0.0
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]

    def summary(self) -> dict:
        elapsed = (self.clock() - self._started) if self._started else 0.0
        occ = [a / t for a, t in self.occupancy if t]
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
