"""Paged continuous-batching engine: the serving tier — port of
``apex_tpu/serving/engine.py``.

:class:`PagedInferenceEngine` subclasses the contiguous
:class:`~apex_tpu_torch.inference.InferenceEngine` and swaps only the
memory backend and the per-tick device plan; the request lifecycle
(validation, backpressure, quarantine, preemption-requeue, metrics) and
the sampling stream are inherited.  Paged decode attention equals the
contiguous decode on the gathered pool (on the card the two kernels share
one body), which is why greedy and seeded outputs are token for token the
contiguous engine's, while memory goes from ``slots * max_seq`` rows to
blocks allocated on demand, with prefix sharing.

* **Paged KV + prefix sharing** (always on): admission acquires blocks
  from :class:`~apex_tpu_torch.serving.PagedKVCache`; a prompt sharing a
  cached full-block prefix skips its KV writes (and, under chunked
  prefill, its forward).  When the pool runs dry mid-decode the engine
  preempts the most recently admitted request (release its blocks,
  requeue it with its progress, recompute later), reusing ``preempt()``.
* **Chunked prefill** (``chunked_prefill=True``): prompts run in
  scheduler-budgeted chunks mixed into decode ticks instead of one
  prefill at admission.  The chunk forward is another compute schedule
  than the bucketed prefill, so its logits are close to, not bitwise,
  the contiguous engine's.
* **Speculative decoding** (``speculative=SpeculativeConfig(...)``): see
  :mod:`apex_tpu_torch.serving.speculative`.
* **Int8 KV** (``kv_quant="int8"``, with chunked prefill): the pool is
  :class:`~apex_tpu_torch.serving.QuantizedPagedKVCache`; every token's
  insert requantizes its block, so the pool state does not depend on how
  the scheduler sliced a prompt.

* **The disaggregated handoff** (``prefill_only=True``, ``export_kv``,
  ``adopt_kv``): a prefill-only replica parks each request after its
  chunked prefill; ``export_kv`` ships the raw storage of the blocks that
  back its context (a :class:`KvHandoff`) and ``adopt_kv`` installs them
  on a decode replica, which resumes without re-running prefill —
  bitwise, because paged decode only reads the storage the payload is a
  literal copy of (see :mod:`apex_tpu_torch.serving.disagg`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from apex_tpu_torch.inference.engine import (InferenceEngine, QueueFull,
                                             Request, _Active)
from apex_tpu_torch.inference.kv_cache import KVCache
from apex_tpu_torch.serving.paged_kv import (PagedKVCache,
                                             QuantizedPagedKVCache)
from apex_tpu_torch.serving.scheduler import TickScheduler
from apex_tpu_torch.serving.speculative import SpeculativeConfig


@dataclasses.dataclass
class KvHandoff:
    """A request's KV state in flight between engines — what
    :meth:`PagedInferenceEngine.export_kv` produces and
    :meth:`PagedInferenceEngine.adopt_kv` installs.

    ``payload`` is the exporting pool's raw block storage
    (:meth:`PagedKVCache.export_blocks` — ``data``, plus ``scales`` for
    the int8 pool), ``kv_tokens`` the ``kv_len`` tokens it backs
    (``prompt + generated[:-1]`` — ``generated[-1]`` is the next token
    to FEED, whose KV the first decode step writes), and ``kind`` /
    ``block_size`` the storage tags the adopting pool must match for a
    bitwise install."""
    request: Request
    generated: List[int]
    kv_len: int
    kv_tokens: List[int]
    payload: dict
    block_size: int
    kind: str
    src_replica: int = -1

    def nbytes(self) -> int:
        """Bytes the handoff moves (block storage only)."""
        return int(sum(v.numel() * v.element_size()
                       for v in self.payload.values()))


@dataclasses.dataclass
class _ChunkPrefill:
    """Progress of one chunked prefill: ``ctx`` is the full context (prompt
    + requeued progress), ``done`` how many positions already hold KV
    (starting at the trie-shared prefix, which is never re-run)."""
    ctx: List[int]
    done: int
    prev_len: int       # generated-so-far count (resume stream index)


class PagedInferenceEngine(InferenceEngine):
    """Continuous batching over a paged block pool.  Takes the contiguous
    engine's keywords (``max_slots``, ``max_seq``, ``cache_dtype``,
    ``device``, ...) beside its own."""

    def __init__(self, model, *, block_size: int = 8,
                 num_blocks: Optional[int] = None,
                 share_prefixes: bool = True,
                 chunked_prefill: bool = False,
                 scheduler: Optional[TickScheduler] = None,
                 speculative: Optional[SpeculativeConfig] = None,
                 kv_quant: Optional[str] = None,
                 prefill_only: bool = False,
                 **kw):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', "
                             f"got {kv_quant!r}")
        if kv_quant is not None and speculative is not None:
            raise ValueError(
                "kv_quant is incompatible with speculative decoding: the "
                "verify chunk consumes INTERMEDIATE chunk logits, which "
                "later proposals' block requantization perturbs — only the "
                "final row of a quantized chunk is schedule-invariant")
        if kv_quant is not None and not chunked_prefill:
            raise ValueError(
                "kv_quant requires chunked_prefill=True: the chunked path "
                "appends+requantizes per token, which is what makes "
                "re-prefill (migration/preemption resume) bitwise on a "
                "quantized cache; monolithic prefill quantizes each block "
                "one-shot and cannot replay decode's per-token history")
        if prefill_only and not chunked_prefill:
            raise ValueError("prefill_only requires chunked_prefill=True "
                             "(prefill replicas run chunked prefill only)")
        self._block_size = block_size
        self._num_blocks = num_blocks
        self._share_prefixes = share_prefixes
        self.chunked_prefill = chunked_prefill
        self.kv_quant = kv_quant
        self.prefill_only = prefill_only
        self.scheduler = scheduler or TickScheduler()
        self.spec = speculative
        # runtime switch over the configured speculative path: the fleet's
        # degradation ladder turns it off under SLO burn and back on when
        # the burn clears (exact-match acceptance makes it token-invisible)
        self.spec_enabled = True
        self.spec_proposed = 0
        self.spec_accepted = 0
        super().__init__(model, **kw)

    @property
    def _spec_active(self) -> bool:
        return self.spec is not None and self.spec_enabled

    # -- backend -------------------------------------------------------------

    def _init_backend(self, max_slots: int, max_seq: int,
                      cache_dtype) -> None:
        cfg = self.model.cfg
        bs = self._block_size
        if max_seq % bs:
            raise ValueError(
                f"max_seq ({max_seq}) must be a multiple of block_size "
                f"({bs}) — equal logical depth is what keeps paged "
                "attention bitwise-identical to the contiguous cache")
        self.max_seq = max_seq
        self.max_slots = max_slots
        self.max_blocks = max_seq // bs
        if self._num_blocks is None:
            # as roomy as the contiguous ring it replaces (+ garbage block)
            self._num_blocks = 1 + max_slots * self.max_blocks
        pool_cls = (QuantizedPagedKVCache if self.kv_quant == "int8"
                    else PagedKVCache)
        self.pool = pool_cls(
            self._num_blocks, bs, cfg.num_layers, cfg.local_heads,
            cfg.head_dim, cache_dtype, share_prefixes=self._share_prefixes,
            device=self.device, registry=self.metrics.registry)
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._seqs: dict = {}            # slot -> PagedSequence
        self._tables = np.zeros((max_slots, self.max_blocks), np.int32)
        self._prefilling: dict = {}      # slot -> _ChunkPrefill
        self._prefill_order: List[int] = []
        self._handoff_ready: List[int] = []   # parked prefill_only slots
        self._admit_stamp: dict = {}     # slot -> admission counter
        self._admitted_count = 0
        if self.spec is not None:
            self.spec.validate_against(self.model)
            dcfg = self.spec.model.cfg
            # the draft keeps a plain contiguous ring on the same slot ids
            self._draft_cache = KVCache(max_slots, dcfg.num_layers, max_seq,
                                        dcfg.local_heads, dcfg.head_dim,
                                        cache_dtype, device=self.device)
            r = self.metrics.registry
            self._c_spec_prop = r.counter(
                "serving_spec_proposed_total", "draft tokens proposed")
            self._c_spec_acc = r.counter(
                "serving_spec_accepted_total",
                "draft tokens matching the canonical stream")

    def _export_cache_gauges(self) -> None:
        self._g_kv_free.set(self.pool.free_bytes())
        self._g_kv_occ.set(self.pool.occupancy())

    def _dev(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _release(self, slot: int, st) -> None:
        seq = self._seqs.pop(slot, None)
        if seq is not None:
            self.pool.release(seq)
        self._tables[slot] = 0
        self._prefilling.pop(slot, None)
        if slot in self._prefill_order:
            self._prefill_order.remove(slot)
        if slot in self._handoff_ready:
            self._handoff_ready.remove(slot)
        self._admit_stamp.pop(slot, None)
        self._free_slots.append(slot)

    def _cache_advance(self, slot: int, st: _Active) -> None:
        # called before the fed token is appended: it sits at st.position
        self._seqs[slot].num_tokens = st.position + 1

    # -- admission -----------------------------------------------------------

    def _admit(self) -> None:
        if "kv_pool_exhaustion" in self.injected_faults:
            return                      # injected: no blocks to admit with
        while self._queue and self._free_slots:
            req = self._queue[0]
            prev = self._progress.get(req.request_id)
            ctx = list(req.prompt) + (prev or [])
            seq = self.pool.acquire(ctx)
            if seq is None:
                # pool exhausted even after trie eviction: wait for
                # decode completions to free blocks
                break
            self._queue.popleft()
            self._progress.pop(req.request_id, None)
            slot = self._free_slots.pop()
            self._admitted_count += 1
            self._admit_stamp[slot] = self._admitted_count
            self._admitted(req, prev is not None)
            clen = len(ctx)
            self._seqs[slot] = seq
            self._tables[slot] = self.pool.table_row(seq, self.max_blocks)
            if self.chunked_prefill:
                # all device work deferred to budgeted chunks; the slot is
                # active (preemptable) but not yet decoding
                self._active[slot] = _Active(
                    req, len(req.prompt), next_token=-1, position=clen,
                    generated=list(prev or []))
                self._prefilling[slot] = _ChunkPrefill(
                    ctx, seq.shared_tokens, len(prev or []))
                self._prefill_order.append(slot)
                continue
            try:
                # monolithic prefill: the contiguous engine's bucketing,
                # program and logits
                logits, kv = self._prefill_context(ctx)
                self.pool.write_context_kv(seq, kv[:, :, 0], clen)
                self.pool.register_prefix(seq, ctx)
                self._draft_admit(slot, ctx)
                nxt = self._sample(req, logits[0, clen - 1].cpu().numpy(),
                                   len(prev or []))
            except Exception as e:          # quarantine, as in the base
                self._release(slot, None)
                self._finish_response(req, list(prev or []), "error",
                                      error=f"{type(e).__name__}: {e}")
                continue
            self._first_token(req, prev is not None)
            st = _Active(req, len(req.prompt), next_token=nxt,
                         position=clen, generated=(prev or []) + [nxt])
            self._active[slot] = st
            self._maybe_finish(slot, st)

    def _draft_admit(self, slot: int, ctx: List[int]) -> None:
        if self.spec is None:
            return
        toks = np.zeros((1, self._bucket(len(ctx))), np.int64)
        toks[0, :len(ctx)] = ctx
        _, kv = self.spec.model.prefill(self._dev(toks))
        self._draft_cache.write_prompt(slot, kv[:, :, 0], len(ctx))

    # -- pool pressure -------------------------------------------------------

    def _grow(self, slot: int, n_tokens: int) -> bool:
        """Extend ``slot``'s table to ``n_tokens`` positions, preempting the
        most recently admitted OTHER request while the pool (and the trie's
        evictable tail) cannot supply blocks."""
        seq = self._seqs[slot]
        while not self.pool.ensure_capacity(seq, n_tokens):
            victims = [s for s in self._admit_stamp if s != slot
                       and s in self._active]
            if not victims:
                return False
            self._preempt_slot(max(victims, key=self._admit_stamp.get))
        self._tables[slot] = self.pool.table_row(seq, self.max_blocks)
        return True

    # -- the tick loop -------------------------------------------------------

    def step(self) -> bool:
        """One tick: admit, run the scheduler's prefill chunks, then one
        batched decode (or speculative) round.  Returns True while there
        is (or may be) work left."""
        self._evict_expired()
        self._admit()
        self._export_cache_gauges()
        if not self._active:
            return bool(self._queue)
        decoding = [s for s in self._active if s not in self._prefilling
                    and s not in self._handoff_ready]
        if self._prefilling:
            plan = self.scheduler.plan(
                len(decoding),
                [(s, len(self._prefilling[s].ctx) - self._prefilling[s].done)
                 for s in self._prefill_order],
                self.spec.num_tokens if (self._spec_active and decoding)
                else 0)
            for slot, n in plan.chunks.items():
                if slot in self._prefilling:     # may have been preempted
                    self._run_prefill_chunk(slot, n)
        decoding = sorted(s for s in self._active
                          if s not in self._prefilling
                          and s not in self._handoff_ready)
        if decoding:
            if self._spec_active:
                self._spec_round(decoding)
            else:
                self._decode_round(decoding)
        return bool(self._active or self._queue)

    def _decode_round(self, decoding: List[int]) -> None:
        for slot in list(decoding):
            if slot in self._active and not self._grow(
                    slot, self._active[slot].position + 1):
                self._preempt_slot(slot)     # cannot even hold one more
        decoding = [s for s in decoding if s in self._active]
        if not decoding:
            return
        n = self.max_slots
        tokens = np.zeros((n,), np.int64)
        positions = np.zeros((n,), np.int32)
        for slot in decoding:
            st = self._active[slot]
            tokens[slot] = st.next_token
            positions[slot] = st.position
        # a slot that is not decoding (its prefill still chunking, or
        # parked for a handoff) feeds token 0 at position 0: its row must
        # point at the garbage block, or that write lands on its real
        # position 0
        tables = np.zeros_like(self._tables)
        tables[decoding] = self._tables[decoding]
        tok, tbl, pos = (self._dev(tokens), self._dev(tables),
                         self._dev(positions))
        if self.kv_quant == "int8":
            logits, _, _ = self.model.decode_step_paged_quant(
                tok, self.pool.data, self.pool.scales, tbl, pos)
        else:
            logits, _ = self.model.decode_step_paged(tok, self.pool.data,
                                                     tbl, pos)
        self.metrics.step(len(decoding), n)
        self._advance_slots(decoding, logits.cpu().numpy())

    # -- chunked prefill -----------------------------------------------------

    def _chunk_forward(self, toks, tables, pos, wb, wo):
        """The chunk forward on the pool (in place); returns the logits
        ``(rows, chunk, vocab)`` on the host."""
        args = [self._dev(a) for a in (toks, tables, pos, wb, wo)]
        if self.kv_quant == "int8":
            logits, _, _ = self.model.decode_chunk_quant(
                args[0], self.pool.data, self.pool.scales, *args[1:])
        else:
            logits, _ = self.model.decode_chunk(args[0], self.pool.data,
                                                *args[1:])
        return logits.cpu().numpy()

    def _run_prefill_chunk(self, slot: int, n: int) -> None:
        cs = self._prefilling[slot]
        st = self._active[slot]
        seq = self._seqs[slot]
        bs = self.pool.block_size
        start = cs.done
        end = min(start + n, len(cs.ctx))
        c = end - start
        pad = self._bucket(c)
        toks = np.zeros((1, pad), np.int64)
        pos = np.zeros((1, pad), np.int32)
        wb = np.zeros((1, pad), np.int32)    # pad rows -> garbage block 0
        wo = np.zeros((1, pad), np.int32)
        toks[0, :c] = cs.ctx[start:end]
        for j in range(c):
            p = start + j
            pos[0, j] = p
            wb[0, j] = seq.block_ids[p // bs]
            wo[0, j] = p % bs
        try:
            logits = self._chunk_forward(toks, self._tables[slot:slot + 1],
                                         pos, wb, wo)
            cs.done = end
            if end < len(cs.ctx):
                return
            # prefill complete: publish, admit the draft, first token
            self.pool.register_prefix(seq, cs.ctx)
            self._draft_admit(slot, cs.ctx)
            nxt = self._sample(st.request, logits[0, c - 1], cs.prev_len)
        except Exception as e:              # quarantine
            self._finish(slot, st, "error",
                         error=f"{type(e).__name__}: {e}")
            return
        self._first_token(st.request, cs.prev_len > 0)
        st.next_token = nxt
        st.generated.append(nxt)
        del self._prefilling[slot]
        self._prefill_order.remove(slot)
        if not self._maybe_finish(slot, st) and self.prefill_only:
            # disaggregated prefill replica: park the request (no decode
            # steps here) until the fleet ships its KV with export_kv
            self._handoff_ready.append(slot)

    # -- the disaggregated KV handoff ----------------------------------------

    def handoffs_ready(self) -> List[tuple]:
        """``(slot, request_id)`` pairs parked after a completed prefill on
        a ``prefill_only`` engine, ascending slot — the export queue the
        disaggregated fleet drains each tick."""
        return [(s, self._active[s].request.request_id)
                for s in sorted(self._handoff_ready)]

    def export_kv(self, request_id) -> KvHandoff:
        """Strip ``request_id`` off this engine WITH its KV blocks.  The
        :class:`KvHandoff` carries a copy of every block backing ``kv_len =
        position`` valid positions (the KV of ``prompt + generated[:-1]``),
        so :meth:`adopt_kv` resumes without re-running prefill.  The copy
        is a gather into fresh device memory, queued on the stream before
        any later write, so the blocks can be reused as soon as this
        returns.  Terminal on this engine like a migration: reason
        ``"migrated"``, no Response.  Raises KeyError when the id is not
        active here and ValueError while its prefill is still chunking."""
        slot = next((s for s, st in self._active.items()
                     if st.request.request_id == request_id), None)
        if slot is None:
            raise KeyError(f"request {request_id!r} is not active on "
                           "this engine")
        if slot in self._prefilling:
            raise ValueError(
                f"request {request_id!r} is mid-prefill; its KV is "
                "incomplete — export_inflight() re-prefills instead")
        st = self._active[slot]
        seq = self._seqs[slot]
        kv_len = st.position
        ids = seq.block_ids[:self.pool.blocks_for(kv_len)]
        handoff = KvHandoff(
            request=st.request,
            generated=list(st.generated),
            kv_len=kv_len,
            kv_tokens=list(st.request.prompt) + list(st.generated[:-1]),
            payload=self.pool.export_blocks(ids),
            block_size=self.pool.block_size,
            kind=self.pool.kind)
        st = self._active.pop(slot)
        self._release(slot, st)
        rid = st.request.request_id
        self._submit_time.pop(rid, None)
        self._progress.pop(rid, None)
        self.metrics.request_migrated(rid)
        self.trace.finish(rid, "migrated")
        return handoff

    def adopt_kv(self, handoff: KvHandoff) -> int:
        """Install a shipped-KV request: acquire blocks for its
        ``kv_tokens``, copy the payload into them, and resume decode at
        ``position = kv_len`` feeding ``generated[-1]`` — no re-prefill.
        The storage tags (``kind``, ``block_size``) must match: a
        mismatch goes through the re-prefill fallback (:meth:`adopt`).
        Admission is immediate: raises :class:`QueueFull` when no slot or
        no blocks are free, ValueError on a tag or context misfit.
        Returns the slot."""
        req = handoff.request
        if handoff.kind != self.pool.kind:
            raise ValueError(
                f"handoff cache kind {handoff.kind!r} does not match "
                f"this pool ({self.pool.kind!r}); re-prefill via adopt()")
        if handoff.block_size != self.pool.block_size:
            raise ValueError(
                f"handoff block_size {handoff.block_size} does not "
                f"match this pool ({self.pool.block_size})")
        if len(req.prompt) + len(handoff.generated) >= self.max_seq:
            raise ValueError(
                f"context {len(req.prompt)} + {len(handoff.generated)} "
                f"does not fit max_seq={self.max_seq}; finish with "
                "reason='preempted' instead of adopting")
        self._validate(req)
        if "reject_admission" in self.injected_faults:
            raise QueueFull("injected fault: admission rejected at this "
                            "replica")
        if not self._free_slots:
            raise QueueFull("no free decode slot for the KV handoff; "
                            "retry after step() completes one")
        seq = self.pool.acquire(handoff.kv_tokens)
        if seq is None:
            raise QueueFull("no free blocks for the KV handoff; retry "
                            "after decode completions release some")
        # trie-shared prefix blocks already hold the same KV (published by
        # an earlier adopt of the same prefix): copy only the fresh tail
        start = seq.shared_tokens // self.pool.block_size
        self.pool.import_blocks(
            seq.block_ids[start:],
            {k: v[start:] for k, v in handoff.payload.items()})
        self.pool.register_prefix(seq, handoff.kv_tokens)
        slot = self._free_slots.pop()
        self._admitted_count += 1
        self._admit_stamp[slot] = self._admitted_count
        self._seqs[slot] = seq
        self._tables[slot] = self.pool.table_row(seq, self.max_blocks)
        rid = req.request_id
        self._submit_time[rid] = self.clock()
        self.metrics.request_submitted(rid)
        self.trace.enqueue(rid, ctx=req.trace)
        self.trace.admit(rid)
        self.trace.resumed(rid)
        self._draft_admit(slot, handoff.kv_tokens)
        st = _Active(req, len(req.prompt),
                     next_token=handoff.generated[-1],
                     position=handoff.kv_len,
                     generated=list(handoff.generated))
        self._active[slot] = st
        self._maybe_finish(slot, st)
        return slot

    # -- speculative decoding ------------------------------------------------

    def _spec_round(self, decoding: List[int]) -> None:
        k = self.spec.num_tokens
        for slot in list(decoding):
            if slot in self._active and not self._grow(
                    slot,
                    min(self._active[slot].position + k + 1, self.max_seq)):
                self._preempt_slot(slot)
        decoding = [s for s in decoding if s in self._active]
        if not decoding:
            return
        n = self.max_slots
        draft = self.spec.model
        # 1) the draft proposes k tokens, sampling with the SAME (seed,
        #    index) stream the target replays
        dtok = np.zeros((n,), np.int64)
        dpos = np.zeros((n,), np.int32)
        for s in decoding:
            st = self._active[s]
            dtok[s] = st.next_token
            dpos[s] = st.position
        proposals = np.zeros((n, k), np.int64)
        data = self._draft_cache.data
        cur = dtok
        for j in range(k):
            dlogits, _ = draft.decode_step(self._dev(cur), data,
                                           self._dev(dpos + j))
            dl = dlogits.cpu().numpy()
            for s in decoding:
                st = self._active[s]
                try:
                    proposals[s, j] = self._sample(
                        st.request, dl[s], len(st.generated) + j)
                except Exception:
                    # a poison sampling config detonates identically in
                    # the verify loop, where quarantine handles it
                    proposals[s, j] = 0
            cur = proposals[:, j]
        # one write-only step: after a full accept the next round starts at
        # p+k+1, so the draft needs d_k's KV at p+k
        draft.decode_step(self._dev(cur), data, self._dev(dpos + k))
        # 2) one (k+1)-wide target chunk verifies [t, d1..dk]
        c = k + 1
        toks = np.zeros((n, c), np.int64)
        pos = np.zeros((n, c), np.int32)
        wb = np.zeros((n, c), np.int32)
        wo = np.zeros((n, c), np.int32)
        bs = self.pool.block_size
        lim = {}
        for s in decoding:
            st = self._active[s]
            seq = self._seqs[s]
            toks[s] = [st.next_token] + list(proposals[s])
            lim[s] = min(c, self.max_seq - st.position)
            for j in range(lim[s]):
                p = st.position + j
                pos[s, j] = p
                wb[s, j] = seq.block_ids[p // bs]
                wo[s, j] = p % bs
        vl = self._chunk_forward(toks, self._tables, pos, wb, wo)
        self.metrics.step(len(decoding), n)
        # 3) exact-match acceptance: consume canonical tokens while the
        #    draft predicted them; the first mismatch (or the bonus final
        #    sample) ends the round
        for s in decoding:
            st = self._active[s]
            seq = self._seqs[s]
            for j in range(lim[s]):
                try:
                    tok = self._sample(st.request, vl[s, j],
                                       len(st.generated))
                except Exception as e:
                    self._finish(s, st, "error",
                                 error=f"{type(e).__name__}: {e}")
                    break
                self.metrics.token(st.request.request_id)
                self.trace.decode_tick(st.request.request_id)
                st.generated.append(tok)
                st.next_token = tok
                st.position += 1
                seq.num_tokens = st.position
                if self._maybe_finish(s, st):
                    break
                if j == lim[s] - 1:
                    break
                self.spec_proposed += 1
                self._c_spec_prop.inc()
                if tok != proposals[s, j]:
                    break               # rejected KV stays masked garbage
                self.spec_accepted += 1
                self._c_spec_acc.inc()

    @property
    def spec_accept_rate(self) -> float:
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)
