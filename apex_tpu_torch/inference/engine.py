"""Continuous-batching serving engine for GPT decode — port of
``apex_tpu/inference/engine.py``.

Host-side orchestration over two device programs, ``GPTModel.prefill``
(one per admitted request, prompt padded to a power-of-two bucket) and ONE
batched ``GPTModel.decode_step`` whose batch dimension is the cache slot
table:

* admission — while slots are free and requests are queued, each request
  gets one prefill whose K/V lands in its slot and whose last-position
  logits give the first token;
* decode — every step runs ALL slots; inactive slots compute garbage that
  is never read;
* completion — eos / ``max_new_tokens`` / cache exhaustion free the slot;
  a request past its ``deadline`` is EVICTED mid-flight with whatever it
  has generated; a request past its per-request ``timeout`` (a budget
  relative to submission) finishes with ``reason="timeout"``.

``submit`` validates what it can and applies bounded-queue backpressure
(:class:`QueueFull`).  What validation cannot see is QUARANTINED: the
per-request prefill and sampling work is wrapped so a poison request
finishes with ``reason="error"`` and frees its slot instead of raising out
of ``step()``.  A failed kernel launch inside a prefill lands there too,
so a caller that must not tolerate it checks for ``"error"`` responses.

``preempt`` requeues every in-flight request with its progress stashed:
the next admission re-prefills ``prompt + generated`` and resumes the
request's sampling stream at the token index it stopped at.
``export_inflight`` / ``adopt`` are the cross-replica form of the same
requeue (the serving fleet's migration), and ``injected_faults`` is the
fleet's fault hook (``"reject_admission"``, ``"kv_pool_exhaustion"``).
``registry=`` merges the serving series into a shared
:class:`~apex_tpu_torch.observability.MetricsRegistry`; ``tracer=`` turns
on per-request Chrome trace events.  The storage
is a backend behind three hooks (``_init_backend``, ``_release``,
``_cache_advance``): the slot ring here, the paged block pool in
:class:`apex_tpu_torch.serving.PagedInferenceEngine`.  With
``cfg.weight_quant == "int8"`` the engine quantizes the model's weights in
place at init (once; a model already quantized is left as it is, so
several engines can serve one shared model).

``plan=`` (a :class:`~apex_tpu_torch.parallel.plan.ParallelPlan`) is
checked against the model as the JAX engine checks it: serving does not
pipeline, does not take sequence parallelism, and runs the model's
tensor-parallel degree.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.inference.kv_cache import KVCache
from apex_tpu_torch.inference.sampling import (SamplingParams, sample,
                                               stream_generator)
from apex_tpu_torch.observability.fleetobs import TraceContext
from apex_tpu_torch.observability.request_trace import RequestTracer
from apex_tpu_torch.utils.device import resolve_device
from apex_tpu_torch.utils.profiling import ServingMetrics


class QueueFull(RuntimeError):
    """``submit`` refused a request: the bounded queue is at capacity."""


@dataclasses.dataclass
class Request:
    """One generation request.

    ``deadline`` is an absolute value of the engine's ``clock``; a request
    still running past it is evicted.  ``timeout`` is a RELATIVE budget in
    clock units from submission — queued or decoding, a request over
    budget finishes with ``reason="timeout"``.  ``seed`` feeds the
    per-request sampling stream (stochastic modes only), keyed by (seed,
    token index).  ``trace`` is the fleet-wide causal identity
    (:class:`~apex_tpu_torch.observability.TraceContext`): the router
    mints it and it rides the request through retry, hedge and migration.
    """
    request_id: int
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    deadline: Optional[float] = None
    timeout: Optional[float] = None
    seed: int = 0
    trace: Optional[TraceContext] = None


@dataclasses.dataclass
class Response:
    """A completed request: ``tokens`` holds the generated ids (including
    the eos token when one was emitted); ``finish_reason`` is ``"eos"``,
    ``"length"`` (max_new_tokens or cache row exhausted), ``"evicted"``
    (deadline), ``"timeout"`` (per-request budget), ``"error"``
    (quarantined — ``error`` carries the exception message) or
    ``"preempted"`` (the context no longer fits for a resume).  The fleet
    router adds ``"shed"`` (retry budget exhausted)."""
    request_id: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str
    error: Optional[str] = None


@dataclasses.dataclass
class _Active:
    request: Request
    prompt_len: int
    next_token: int        # fed to the next decode step
    position: int          # absolute position next_token is written at
    generated: List[int] = dataclasses.field(default_factory=list)


class InferenceEngine:
    """Continuous batching over a :class:`KVCache` slot ring.

    ``model`` is an :class:`apex_tpu_torch.models.gpt.GPTModel` on
    ``device`` (default ``"cuda"``; raises when CUDA is absent, and when
    the model lives on another device type).  ``weight_bytes`` is the
    device memory of the model's weights as served.
    """

    def __init__(self, model, *, max_slots: int = 8,
                 max_seq: Optional[int] = None, cache_dtype=None,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[ServingMetrics] = None,
                 registry=None, tracer=None,
                 min_prompt_bucket: int = 8,
                 max_queue: Optional[int] = None, device=None, plan=None):
        model._check_decode_supported()
        cfg = model.cfg
        if plan is not None:
            # decode runs one stage deep and token-at-a-time: of the plan,
            # only the tp degree applies, and it must match the model
            if plan.pp > 1:
                raise ValueError(
                    f"serving does not pipeline: plan.pp={plan.pp}")
            if plan.sequence_parallel:
                raise ValueError(
                    "sequence_parallel shards the seq axis the decode "
                    "path appends to; serve with sequence_parallel=False")
            if plan.tp != cfg.tensor_parallel_size:
                raise ValueError(
                    f"plan.tp={plan.tp} does not match the model's "
                    f"tensor_parallel_size={cfg.tensor_parallel_size}; "
                    "build the model from the same plan "
                    "(GPTConfig(plan=plan))")
        self.plan = plan
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type:
            raise ValueError(f"InferenceEngine on {self.device} was given a "
                             f"model on {model_device}")
        self.model = model
        if cfg.weight_quant == "int8" and not model.quantized:
            from apex_tpu_torch.models.gpt import quantize_decode_params
            model.load_quantized_(quantize_decode_params(model.state_dict()))
        self.weight_bytes = sum(t.numel() * t.element_size()
                                for t in model.state_dict().values())
        self.clock = clock
        # `registry` merges this engine's serving series into a shared
        # MetricsRegistry; ignored when `metrics` is given
        self.metrics = metrics or ServingMetrics(clock, registry=registry)
        # `tracer` turns on per-request Chrome trace events; the lifecycle
        # bookkeeping is always on and feeds the queue-wait / decode-ticks
        # series
        self.trace = RequestTracer(clock=clock, tracer=tracer,
                                   metrics=self.metrics)
        self._min_bucket = min_prompt_bucket
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        self.max_queue = max_queue
        self._queue: collections.deque = collections.deque()
        # the serving fleet's fault hooks, set per tick
        # ("reject_admission" fails submit with QueueFull,
        # "kv_pool_exhaustion" stalls admission); empty in normal runs
        self.injected_faults: frozenset = frozenset()
        self._active: dict = {}          # slot -> _Active
        self._submit_time: dict = {}     # request_id -> submit clock value
        self._progress: dict = {}        # request_id -> tokens generated
                                         # before a preemption requeue
        self._done: List[Response] = []
        self._init_backend(max_slots, max_seq or cfg.max_seq_len,
                           cache_dtype or cfg.dtype)
        # cache-accounting gauges: the router and admission policies read
        # capacity in bytes, not slots
        self._g_kv_free = self.metrics.registry.gauge(
            "serving_kv_free_bytes", "free KV-cache bytes")
        self._g_kv_occ = self.metrics.registry.gauge(
            "serving_kv_occupancy",
            "fraction of KV-cache capacity in use (token-granular)")
        self._export_cache_gauges()

    def _init_backend(self, max_slots: int, max_seq: int,
                      cache_dtype) -> None:
        """Backend hook: build the KV store (the contiguous slot ring here;
        the paged engine overrides it with the block pool)."""
        cfg = self.model.cfg
        self.cache = KVCache(max_slots, cfg.num_layers, max_seq,
                             cfg.local_heads, cfg.head_dim, cache_dtype,
                             device=self.device)
        self.max_seq = self.cache.max_seq

    def _export_cache_gauges(self) -> None:
        self._g_kv_free.set(self.cache.free_bytes())
        self._g_kv_occ.set(self.cache.occupancy())

    # -- request lifecycle ---------------------------------------------------

    def _validate(self, request: Request) -> None:
        """Reject statically-checkable poison at the door."""
        if not 0 < len(request.prompt) < self.max_seq:
            raise ValueError(
                f"prompt length {len(request.prompt)} must be in "
                f"(0, {self.max_seq}) to leave room for decode")
        vocab = self.model.cfg.vocab_size
        for t in request.prompt:
            if not isinstance(t, (int, np.integer)) or not 0 <= t < vocab:
                raise ValueError(
                    f"prompt token {t!r} is not an int in [0, {vocab})")
        if not isinstance(request.max_new_tokens, (int, np.integer)) \
                or request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens {request.max_new_tokens!r} must be a "
                "positive int")
        if not isinstance(request.sampling, SamplingParams):
            raise ValueError(
                f"sampling must be a SamplingParams, got "
                f"{type(request.sampling).__name__}")
        if request.eos_id is not None and not isinstance(
                request.eos_id, (int, np.integer)):
            raise ValueError(f"eos_id {request.eos_id!r} must be an int")
        if request.timeout is not None and not request.timeout > 0:
            raise ValueError(
                f"timeout {request.timeout!r} must be positive")

    def submit(self, request: Request) -> None:
        """Validate and enqueue; raises :class:`QueueFull` when the
        bounded queue is at capacity."""
        self._validate(request)
        if "reject_admission" in self.injected_faults:
            raise QueueFull("injected fault: admission rejected at this "
                            "replica")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"submit queue is full ({len(self._queue)}/"
                f"{self.max_queue}); retry after step() drains it")
        self._submit_time[request.request_id] = self.clock()
        self.metrics.request_submitted(request.request_id)
        self.trace.enqueue(request.request_id, ctx=request.trace)
        self._queue.append(request)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_requests(self) -> int:
        return len(self._active)

    def _bucket(self, n: int) -> int:
        b = self._min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def _sample(self, req: Request, logits_row, token_index: int) -> int:
        if req.sampling.greedy:
            return int(np.argmax(logits_row))
        gen = stream_generator(req.seed, token_index)
        return int(sample(torch.from_numpy(logits_row), req.sampling, gen))

    def _release(self, slot: int, st: Optional[_Active]) -> None:
        """Backend hook: return ``slot``'s KV storage."""
        self.cache.free(slot)

    def _finish(self, slot: int, st: _Active, reason: str,
                error: Optional[str] = None) -> None:
        self._release(slot, st)
        del self._active[slot]
        self._finish_response(st.request, st.generated, reason, error)

    def _finish_response(self, req: Request, generated: List[int],
                         reason: str, error: Optional[str] = None) -> None:
        """Completion tail of active AND still-queued requests: metrics,
        trace and the Response record."""
        self._submit_time.pop(req.request_id, None)
        self._progress.pop(req.request_id, None)
        if reason == "evicted":
            self.metrics.request_evicted(req.request_id)
        elif reason == "timeout":
            self.metrics.request_timeout(req.request_id)
        elif reason == "error":
            self.metrics.request_error(req.request_id)
        else:
            self.metrics.request_finished(req.request_id, reason)
        self.trace.finish(req.request_id, reason, error=error)
        self._done.append(Response(req.request_id, list(req.prompt),
                                   list(generated), reason, error=error))

    def _maybe_finish(self, slot: int, st: _Active) -> bool:
        req = st.request
        if req.eos_id is not None and st.generated[-1] == req.eos_id:
            self._finish(slot, st, "eos")
        elif len(st.generated) >= req.max_new_tokens:
            self._finish(slot, st, "length")
        elif st.position >= self.max_seq:
            self._finish(slot, st, "length")      # cache row exhausted
        else:
            return False
        return True

    def _evict_expired(self) -> None:
        now = self.clock()

        def expired(req):
            # deadline wins when both trip the same tick: "no longer
            # wanted" is the stronger statement than "over budget"
            if req.deadline is not None and now >= req.deadline:
                return "evicted"
            if req.timeout is not None:
                t0 = self._submit_time.get(req.request_id)
                if t0 is not None and now - t0 >= req.timeout:
                    return "timeout"
            return None

        for slot in [s for s in sorted(self._active)
                     if expired(self._active[s].request)]:
            st = self._active[slot]
            self._finish(slot, st, expired(st.request))
        keep: collections.deque = collections.deque()
        while self._queue:
            req = self._queue.popleft()
            reason = expired(req)
            if reason:
                # a requeued request keeps its partial progress
                self._finish_response(
                    req, list(self._progress.get(req.request_id, [])),
                    reason)
            else:
                keep.append(req)
        self._queue = keep

    def preempt(self) -> int:
        """Requeue every in-flight request instead of dropping it: each
        slot is freed, its generated tokens stashed, and the request goes
        back to the FRONT of the queue (lowest slot first); the next
        admission re-prefills ``prompt + generated`` and resumes the
        sampling stream at the token index it stopped at, so greedy and
        seeded outputs are unchanged by the interruption.  A request whose
        context no longer fits finishes with ``reason="preempted"``.
        Returns the number requeued."""
        requeued = 0
        for slot in sorted(self._active, reverse=True):
            requeued += self._preempt_slot(slot)
        return requeued

    def _preempt_slot(self, slot: int) -> int:
        """Requeue one in-flight request (the paged engine also calls it to
        reclaim blocks under pool pressure).  Returns 1 when requeued, 0
        when the request had to finish instead."""
        st = self._active[slot]
        req = st.request
        if len(req.prompt) + len(st.generated) >= self.max_seq:
            self._finish(slot, st, "preempted")
            return 0
        self._release(slot, st)
        del self._active[slot]
        self._progress[req.request_id] = list(st.generated)
        self.metrics.request_requeued(req.request_id)
        self.trace.requeue(req.request_id)
        self._queue.appendleft(req)
        return 1

    def adopt(self, request: Request, progress: Sequence[int] = ()) -> None:
        """Admit a request migrated from another replica: ``progress`` is
        the tokens it already streamed there.  Validation and backpressure
        are :meth:`submit`'s; the next admission re-prefills ``prompt +
        progress`` and resumes the sampling stream at ``len(progress)`` —
        the cross-replica form of the preemption requeue, token for token
        for the same reason."""
        if len(request.prompt) + len(progress) >= self.max_seq:
            raise ValueError(
                f"context {len(request.prompt)} + {len(progress)} does "
                f"not fit max_seq={self.max_seq}; finish with "
                "reason='preempted' instead of adopting")
        self.submit(request)
        if progress:
            self._progress[request.request_id] = list(progress)

    def export_inflight(self) -> List:
        """Strip every in-flight and queued request off this engine for
        cross-replica migration; returns ``[(request, generated)]`` in
        ascending slot order, then the waiting queue.  ``generated`` is
        what was already streamed to the client, so a replica that dies
        without warning still leaves its requests recoverable: a healthy
        replica :meth:`adopt` s each one.  On THIS engine each request
        ends with reason ``"migrated"`` (metrics and trace, no
        Response)."""
        out = []
        for slot in sorted(self._active):
            st = self._active[slot]
            out.append((st.request, list(st.generated)))
        for slot in sorted(self._active, reverse=True):
            st = self._active.pop(slot)
            self._release(slot, st)
        while self._queue:
            req = self._queue.popleft()
            out.append((req, list(self._progress.get(req.request_id, []))))
        for req, _ in out:
            rid = req.request_id
            self._submit_time.pop(rid, None)
            self._progress.pop(rid, None)
            self.metrics.request_migrated(rid)
            self.trace.finish(rid, "migrated")
        return out

    def cancel(self, request_id) -> bool:
        """Withdraw one request with NO Response: frees its slot or queue
        entry.  Returns False when the id is not on this engine."""
        for slot, st in list(self._active.items()):
            if st.request.request_id == request_id:
                self._release(slot, st)
                del self._active[slot]
                break
        else:
            hit = next((r for r in self._queue
                        if r.request_id == request_id), None)
            if hit is None:
                return False
            self._queue.remove(hit)
        self._submit_time.pop(request_id, None)
        self._progress.pop(request_id, None)
        self.metrics.request_cancelled(request_id)
        self.trace.finish(request_id, "cancelled")
        return True

    def _admitted(self, req: Request, resumed: bool) -> None:
        """Trace of an admission (the trace feeds the queue-wait series
        of a first admission)."""
        if not resumed:
            self.trace.admit(req.request_id)

    def _first_token(self, req: Request, resumed: bool) -> None:
        """Metrics of the token a prefill samples: a resumed request's
        TTFT already happened, its token joins the throughput series."""
        if resumed:
            self.metrics.token(req.request_id)
            self.trace.decode_tick(req.request_id)
            self.trace.resumed(req.request_id)
        else:
            self.metrics.first_token(req.request_id)
            self.trace.first_token(req.request_id)

    def _prefill_context(self, ctx: List[int]):
        """One prefill of ``ctx`` padded to its bucket: ``(logits, kv)``."""
        toks = np.zeros((1, self._bucket(len(ctx))), np.int64)
        toks[0, :len(ctx)] = ctx
        return self.model.prefill(torch.from_numpy(toks).to(self.device))

    def _admit(self) -> None:
        if "kv_pool_exhaustion" in self.injected_faults:
            return                      # injected: no capacity to admit
        while self._queue and self.cache.free_slots:
            req = self._queue.popleft()
            slot = self.cache.allocate()
            prev = self._progress.pop(req.request_id, None)
            self._admitted(req, prev is not None)
            try:
                ctx = list(req.prompt) + (prev or [])
                clen = len(ctx)
                logits, kv = self._prefill_context(ctx)
                self.cache.write_prompt(slot, kv[:, :, 0], clen)
                nxt = self._sample(req, logits[0, clen - 1].cpu().numpy(),
                                   len(prev or []))
            except Exception as e:          # quarantine: free the slot,
                self.cache.free(slot)       # fail ONE request, keep going
                self._finish_response(req, list(prev or []), "error",
                                      error=f"{type(e).__name__}: {e}")
                continue
            self._first_token(req, prev is not None)
            st = _Active(req, len(req.prompt), next_token=nxt, position=clen,
                         generated=(prev or []) + [nxt])
            self._active[slot] = st
            self._maybe_finish(slot, st)

    # -- the decode loop -----------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: evict, admit, one batched decode step.
        Returns True while there is (or may be) work left."""
        self._evict_expired()
        self._admit()
        self._export_cache_gauges()
        if not self._active:
            return bool(self._queue)
        n = self.cache.slots
        tokens = np.zeros((n,), np.int64)
        positions = np.zeros((n,), np.int32)
        for slot, st in self._active.items():
            tokens[slot] = st.next_token
            positions[slot] = st.position
        logits, self.cache.data = self.model.decode_step(
            torch.from_numpy(tokens).to(self.device), self.cache.data,
            torch.from_numpy(positions).to(self.device))
        self.metrics.step(len(self._active), n)
        self._advance_slots(sorted(self._active), logits.cpu().numpy())
        return bool(self._active or self._queue)

    def _cache_advance(self, slot: int, st: _Active) -> None:
        """Backend hook: record that the fed token's K/V is cached."""
        self.cache.advance(slot)

    def _advance_slots(self, slots: Sequence[int], logits_np) -> None:
        """Sample each row at its stream index, append, and run the
        completion checks."""
        for slot in slots:
            st = self._active[slot]
            self._cache_advance(slot, st)      # the fed token is cached now
            try:
                tok = self._sample(st.request, logits_np[slot],
                                   len(st.generated))
            except Exception as e:      # poison sampling config detonated
                self._finish(slot, st, "error",
                             error=f"{type(e).__name__}: {e}")
                continue
            self.metrics.token(st.request.request_id)
            self.trace.decode_tick(st.request.request_id)
            st.generated.append(tok)
            st.next_token = tok
            st.position += 1
            self._maybe_finish(slot, st)

    def run(self, max_steps: Optional[int] = None) -> List[Response]:
        """Drive :meth:`step` until every submitted request completes
        (or ``max_steps``); returns responses in completion order."""
        steps = 0
        while self._queue or self._active:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return list(self._done)

    @property
    def completed(self) -> List[Response]:
        return list(self._done)
