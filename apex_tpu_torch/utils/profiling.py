"""Profiling and observability utilities — port of
``apex_tpu/utils/profiling.py``.

* :func:`annotate` / :func:`range_push` / :func:`range_pop` — named
  ranges: each enters ``torch.profiler.record_function`` under its name
  (and ``torch.cuda.nvtx`` once CUDA is in use), so the ops launched
  inside carry the name on the profiler's timeline; the innermost open
  name (:func:`current_scope`) is the ``scope`` that
  :func:`~apex_tpu_torch.observability.comms.collective_stats` reports for
  a collective, as JAX reads a ``named_scope`` from HLO metadata.
* :func:`trace` — ``torch.profiler.profile`` over the CPU and CUDA
  activities, written as a Chrome trace into a directory.
* :func:`memory_stats` — argument / output / temp bytes of one call: the
  CUDA allocator's bytes around it, or on the CPU the profiler's memory
  events.
* :func:`program_hash` / :func:`assert_same_program` — the sha256 of the
  aten op sequence one call dispatches (the math the host built, as the
  JAX package hashes StableHLO), compared across the ranks of
  :mod:`torch.distributed`.
* :class:`ServingMetrics` — serving observability (TTFT, per-token
  latency, slot occupancy, tokens/s) over the metrics registry.

The JAX package's ``utils/platform.py`` (Pallas or jnp by backend) has its
counterpart in :mod:`apex_tpu_torch.utils.device`; its TPU-only switches
(``set_force_pallas``, ``tpu_compiler_params``) have none.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import threading
import time
import warnings
from typing import Any, Callable, Optional

import torch

_LOCAL = threading.local()           # .stack: this thread's open ranges
_POP_MISMATCH_WARNED = False         # warn-once flag for unmatched pops


class _Range:
    """One open named range: the profiler's ``record_function`` and, once
    CUDA is in use, an nvtx range of the same name."""

    def __init__(self, name: str):
        self.name = name
        self._rf = torch.profiler.record_function(name)
        self._rf.__enter__()
        self._nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(name)

    def close(self) -> None:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(None, None, None)


def range_stack() -> list:
    """This thread's open ranges, innermost last: the live list, so a reader
    on another thread can name the scope this one is in
    (``current_scope(fallback=...)``)."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def range_push(name: str) -> None:
    """``torch.cuda.nvtx.range_push`` equivalent (paired with
    :func:`range_pop`); prefer the :func:`annotate` context manager.

    The push/pop stack is per-thread and pops must nest within their
    thread — interleaving pairs across threads is undefined, as it was
    for nvtx ranges.
    """
    range_stack().append(_Range(name))


def range_pop() -> None:
    """Pop the innermost :func:`range_push` range on this thread.

    An unmatched pop (empty stack) is a caller bug — annotations above
    it are silently mis-nested from that point on — so it warns (once
    per process; nvtx printed an error per event, which floods) instead
    of no-opping invisibly."""
    stack = range_stack()
    if stack:
        stack.pop().close()
        return
    global _POP_MISMATCH_WARNED
    if not _POP_MISMATCH_WARNED:
        _POP_MISMATCH_WARNED = True
        warnings.warn(
            "range_pop() with no matching range_push() on this thread — "
            "push/pop pairs are mis-nested (warning once per process)",
            RuntimeWarning, stacklevel=2)


def range_depth() -> int:
    """Current :func:`range_push` nesting depth on THIS thread (tests
    assert push/pop balance with it)."""
    return len(range_stack())


def current_scope(fallback: Optional[list] = None) -> str:
    """The innermost open range's name on this thread; on a thread with
    none open, the innermost of ``fallback`` (another thread's
    :func:`range_stack`), else "".  On the card the backward pass runs on
    autograd's device thread, so ``collective_stats`` falls back to the
    ranges of the thread that called it: the collectives the backward's
    hooks issue report the range the training loop opened around it."""
    top = (range_stack() or fallback or [])[-1:]   # another thread may pop
    return top[0].name if top else ""


@contextlib.contextmanager
def annotate(name: str):
    """Named-range context manager: the ops launched inside carry ``name``
    on the profiler's timeline, and collectives issued inside report it
    as their scope."""
    r = _Range(name)
    stack = range_stack()
    stack.append(r)
    try:
        yield
    finally:
        if stack and stack[-1] is r:
            stack.pop()
        elif r in stack:
            stack.remove(r)
        r.close()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where there is a card) and write a Chrome trace into ``log_dir``
    (Perfetto and chrome://tracing open it).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> dict:
    """{storage pointer: bytes} over the tensors' distinct storages."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[st.data_ptr()] = st.nbytes()
    return out


def memory_stats(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return its memory use in bytes:
    ``argument`` (the arguments' tensors), ``output`` (the result's),
    ``alias`` (output bytes that share storage with an argument), ``temp``
    (the peak allocated during the call above what was allocated before it
    and the new outputs: live activations and workspaces) and
    ``generated_code`` — always 0 here: eager PyTorch compiles no program
    whose code size JAX's ``memory_analysis`` reports.

    With a CUDA tensor among the arguments the CUDA allocator's counters
    are read around the call (after a synchronize); otherwise the CPU
    allocations and frees ``torch.profiler`` records (``profile_memory``)
    are summed in order.
    """
    ins = _storage_bytes(_tensors((args, kwargs)))
    cuda = any(t.is_cuda for t in _tensors((args, kwargs)))
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                profile_memory=True) as prof:
            out = fn(*args, **kwargs)
        events = sorted((e for e in prof.profiler.kineto_results.events()
                         if e.name() == "[memory]"),
                        key=lambda e: e.start_ns())
        cur = peak = 0
        for e in events:
            cur += e.nbytes()
            peak = max(peak, cur)
    outs = _storage_bytes(_tensors(out))
    alias = sum(b for p, b in outs.items() if p in ins)
    output = sum(outs.values())
    return {"argument": sum(ins.values()), "output": output,
            "temp": max(0, peak - (output - alias)), "alias": alias,
            "generated_code": 0}


_VALUE_TYPES = (bool, int, float, complex, str, type(None), torch.dtype,
                torch.layout, torch.memory_format)


def _op_signature(func, args, kwargs, out) -> str:
    """One dispatched op as text: its name, then each argument — a tensor
    as its shape and dtype (not its device or values), a number, string
    or dtype as its repr, any other object (a device, a boxed process
    group) as its type — and the outputs' shapes and dtypes."""
    from torch.utils._pytree import tree_leaves

    def one(x):
        if isinstance(x, torch.Tensor):
            return f"{x.dtype}{list(x.shape)}"
        if isinstance(x, _VALUE_TYPES):
            return repr(x)
        return type(x).__name__
    ins = ",".join(one(x) for x in tree_leaves((args, kwargs)))
    outs = ",".join(one(x) for x in tree_leaves(out))
    return f"{func}({ins})->({outs})"


def program_hash(fn: Callable, *args, **kwargs) -> str:
    """sha256 of the aten op sequence that one call ``fn(*args,
    **kwargs)`` dispatches (each op's name and its arguments' shapes and
    dtypes, recorded by a ``TorchDispatchMode``).

    The call runs once.  The value is a fingerprint of the MATH the host
    built — the JAX package hashes the StableHLO text the same way — so
    the same sources on every rank hash identically, on any device; the
    profiler's named ranges are left out.  The hand-written kernels enter
    through ``ctypes`` and dispatch no aten op; the allocations of their
    outputs do.
    """
    from torch.utils._python_dispatch import TorchDispatchMode

    h = hashlib.sha256()

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.namespace == "profiler":    # ranges, not math
                return out
            h.update(_op_signature(func, args, kwargs, out).encode())
            h.update(b"\n")
            return out

    with _Record():
        fn(*args, **kwargs)
    return h.hexdigest()


def assert_same_program(fn_or_hash: Any, *args, **kwargs) -> str:
    """Multi-process divergence guard (SURVEY §5: "same program hash on
    all hosts" in place of race detection).

    Pass either a precomputed hash string or ``(fn, *args)``.  With
    :mod:`torch.distributed` initialised over more than one rank the hash
    is all-gathered over the default group and every value must agree;
    otherwise it is a pass-through.  Returns the (verified) hash.
    """
    h = (fn_or_hash if isinstance(fn_or_hash, str)
         else program_hash(fn_or_hash, *args, **kwargs))
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, h)
        for rank, other in enumerate(gathered):
            if other != h:
                raise AssertionError(
                    f"program hash divergence: rank {dist.get_rank()} has "
                    f"{h}, rank {rank} has {other} — the ranks built "
                    "different programs")
    return h


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
