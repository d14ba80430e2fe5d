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
* completion — eos / ``max_new_tokens`` / cache exhaustion free the slot.

``submit`` validates what it can and applies bounded-queue backpressure
(:class:`QueueFull`).  What validation cannot see is QUARANTINED: the
per-request prefill and sampling work is wrapped so a poison request
finishes with ``reason="error"`` and frees its slot instead of raising out
of ``step()``.  A failed kernel launch inside a prefill lands there too,
so a caller that must not tolerate it checks for ``"error"`` responses.

``preempt`` requeues every in-flight request with its progress stashed:
the next admission re-prefills ``prompt + generated`` and resumes the
request's sampling stream at the token index it stopped at.  The storage
is a backend behind three hooks (``_init_backend``, ``_release``,
``_cache_advance``): the slot ring here, the paged block pool in
:class:`apex_tpu_torch.serving.PagedInferenceEngine`.  With
``cfg.weight_quant == "int8"`` the engine quantizes the model's weights in
place at init (once; a model already quantized is left as it is).

Deadline/timeout eviction, ``adopt``, ``export_inflight``, the
injected-fault hooks and the request tracer wait for later slices.
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
from apex_tpu_torch.utils.device import resolve_device
from apex_tpu_torch.utils.profiling import ServingMetrics


class QueueFull(RuntimeError):
    """``submit`` refused a request: the bounded queue is at capacity."""


@dataclasses.dataclass
class Request:
    """One generation request.  ``seed`` feeds the per-request sampling
    stream (stochastic modes only), keyed by (seed, token index)."""
    request_id: int
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    seed: int = 0


@dataclasses.dataclass
class Response:
    """A completed request: ``tokens`` holds the generated ids (including
    the eos token when one was emitted); ``finish_reason`` is ``"eos"``,
    ``"length"`` (max_new_tokens or cache row exhausted) or ``"error"``
    (quarantined — ``error`` carries the exception message)."""
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
                 min_prompt_bucket: int = 8,
                 max_queue: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type:
            raise ValueError(f"InferenceEngine on {self.device} was given a "
                             f"model on {model_device}")
        cfg = model.cfg
        self.model = model
        if cfg.weight_quant == "int8" and not model.quantized:
            from apex_tpu_torch.models.gpt import quantize_decode_params
            model.load_quantized_(quantize_decode_params(model.state_dict()))
        self.weight_bytes = sum(t.numel() * t.element_size()
                                for t in model.state_dict().values())
        self.clock = clock
        self.metrics = metrics or ServingMetrics(clock)
        self._min_bucket = min_prompt_bucket
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None: unbounded)")
        self.max_queue = max_queue
        self._queue: collections.deque = collections.deque()
        self._active: dict = {}          # slot -> _Active
        self._submit_time: dict = {}     # request_id -> submit clock value
        self._progress: dict = {}        # request_id -> tokens generated
                                         # before a preemption requeue
        self._done: List[Response] = []
        self._init_backend(max_slots, max_seq or cfg.max_seq_len,
                           cache_dtype or cfg.dtype)

    def _init_backend(self, max_slots: int, max_seq: int,
                      cache_dtype) -> None:
        """Backend hook: build the KV store (the contiguous slot ring here;
        the paged engine overrides it with the block pool)."""
        cfg = self.model.cfg
        self.cache = KVCache(max_slots, cfg.num_layers, max_seq,
                             cfg.local_heads, cfg.head_dim, cache_dtype,
                             device=self.device)
        self.max_seq = self.cache.max_seq

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

    def submit(self, request: Request) -> None:
        """Validate and enqueue; raises :class:`QueueFull` when the
        bounded queue is at capacity."""
        self._validate(request)
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"submit queue is full ({len(self._queue)}/"
                f"{self.max_queue}); retry after step() drains it")
        self._submit_time[request.request_id] = self.clock()
        self.metrics.request_submitted(request.request_id)
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
        # ticks = decode steps that produced a token (the first token
        # comes from the prefill)
        self.metrics.request_decode_ticks(st.request.request_id,
                                          len(st.generated) - 1)
        self._finish_response(st.request, st.generated, reason, error)

    def _finish_response(self, req: Request, generated: List[int],
                         reason: str, error: Optional[str] = None) -> None:
        self._submit_time.pop(req.request_id, None)
        self._progress.pop(req.request_id, None)
        if reason == "error":
            self.metrics.request_error(req.request_id)
        else:
            self.metrics.request_finished(req.request_id, reason)
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
        self._queue.appendleft(req)
        return 1

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
        return True

    def _admitted(self, req: Request, resumed: bool) -> None:
        """Metrics of an admission: the queue wait of a first admission."""
        if not resumed:
            self.metrics.request_admitted(
                req.request_id,
                self.clock() - self._submit_time[req.request_id])

    def _first_token(self, req: Request, resumed: bool) -> None:
        """Metrics of the token a prefill samples: a resumed request's
        TTFT already happened, its token joins the throughput series."""
        if resumed:
            self.metrics.token(req.request_id)
        else:
            self.metrics.first_token(req.request_id)

    def _prefill_context(self, ctx: List[int]):
        """One prefill of ``ctx`` padded to its bucket: ``(logits, kv)``."""
        toks = np.zeros((1, self._bucket(len(ctx))), np.int64)
        toks[0, :len(ctx)] = ctx
        return self.model.prefill(torch.from_numpy(toks).to(self.device))

    def _admit(self) -> None:
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
        """One engine iteration: admit, one batched decode step.  Returns
        True while there is (or may be) work left."""
        self._admit()
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
