"""Paged (block) KV cache with ref-counted copy-on-write prefix sharing —
port of ``apex_tpu/serving/paged_kv.py``.

KV lives in a pool of fixed-size blocks, one device tensor

    ``(num_blocks, layers, 2, block_size, kv_heads, head_dim)``

and each request owns an ordered *block table* mapping logical position
``p`` to ``(table[p // block_size], p % block_size)``.  Admission allocates
``ceil(len / block_size)`` blocks instead of a whole ``max_seq`` row.

Prefix sharing: full blocks of prompt tokens are keyed in a radix trie
(node key = the block's token tuple).  A request whose prompt starts with
an already-cached block chain shares those blocks (refcount + 1) instead of
rewriting them.  The trie holds one reference per cached block, so blocks
outlive the request that produced them and are reclaimed lazily: when the
free list runs dry, least-recently-matched leaves are evicted.

Copy-on-write: writes only ever target blocks with refcount 1.  The serve
loop guarantees this structurally (shared blocks are full prefix blocks;
appends go to the exclusive tail); :meth:`PagedKVCache.fork` and
:meth:`PagedKVCache.ensure_writable` expose the general mechanism.

Block 0 is the *garbage block*: inactive decode rows point their whole
table at it, so their writes never touch a live block.

Bookkeeping is host-side Python; the pool tensor is updated in place (the
JAX pool is rebound on every write).  ``registry=`` publishes the pool's
``serving_paged_*`` gauges and counters, labelled by the pool's ``name``.
``export_blocks`` / ``import_blocks`` copy raw block storage between two
pools of the same ``kind`` (the disaggregated KV handoff).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.flash_attention import quantize_kv_blocks
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32


class _TrieNode:
    """One cached full block: ``key`` is the block's token tuple, keyed
    under the parent (the path from the root spells the prefix)."""

    __slots__ = ("key", "block", "parent", "children", "stamp")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_TrieNode"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _TrieNode] = {}
        self.stamp = 0


class PagedSequence:
    """A request's view of the pool: its block table and valid length.

    ``block_ids[i]`` backs logical positions ``[i*bs, (i+1)*bs)``;
    ``shared_tokens`` is the prefix length served from the trie at acquire
    time (those blocks arrived with KV already written).
    """

    __slots__ = ("block_ids", "num_tokens", "shared_tokens")

    def __init__(self, block_ids: List[int], num_tokens: int,
                 shared_tokens: int):
        self.block_ids = block_ids
        self.num_tokens = num_tokens
        self.shared_tokens = shared_tokens


class PagedKVCache:
    """Block pool + block tables + prefix trie for paged decode."""

    kind = "paged"                  # handoff compatibility tag

    def __init__(self, num_blocks: int, block_size: int, layers: int,
                 kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 share_prefixes: bool = True, device=None, registry=None,
                 name: str = "pool0"):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved garbage block)")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.data = torch.zeros(
            (num_blocks, layers, 2, block_size, kv_heads, head_dim),
            dtype=dtype, device=resolve_device(device))
        self.block_size = block_size
        self.share_prefixes = share_prefixes
        self.name = name
        # block 0 is reserved: never allocated, never freed
        self._ref = np.zeros((num_blocks,), np.int32)
        self._ref[0] = 1
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._root = _TrieNode((), 0, None)  # sentinel; holds no block
        self._clock = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.evicted_blocks = 0
        self.cow_copies = 0
        self._g_free = self._g_used = self._g_shared = None
        self._c_hits = self._c_evict = self._c_cow = None
        if registry is not None:
            self._g_free = registry.gauge(
                "serving_paged_blocks_free", "free pool blocks", ["cache"])
            self._g_used = registry.gauge(
                "serving_paged_blocks_used", "allocated pool blocks",
                ["cache"])
            self._g_shared = registry.gauge(
                "serving_paged_blocks_shared",
                "blocks referenced more than once (prefix sharing / COW)",
                ["cache"])
            self._c_hits = registry.counter(
                "serving_paged_prefix_hit_tokens_total",
                "prompt tokens served from the prefix trie", ["cache"])
            self._c_evict = registry.counter(
                "serving_paged_evicted_blocks_total",
                "cached prefix blocks reclaimed under memory pressure",
                ["cache"])
            self._c_cow = registry.counter(
                "serving_paged_cow_total", "copy-on-write block copies",
                ["cache"])
        self._update_gauges()

    # -- accounting ----------------------------------------------------------

    @property
    def num_blocks(self) -> int:
        return self.data.shape[0]

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1          # minus the garbage block

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.usable_blocks - len(self._free)

    @property
    def shared_blocks(self) -> int:
        return int(np.sum(self._ref[1:] > 1))

    @property
    def block_bytes(self) -> int:
        return self.data[0].numel() * self.data.element_size()

    def free_bytes(self) -> int:
        return self.free_blocks * self.block_bytes

    def used_bytes(self) -> int:
        return self.used_blocks * self.block_bytes

    def occupancy(self) -> float:
        return self.used_blocks / self.usable_blocks

    def stats(self) -> Dict[str, Any]:
        return {"free_blocks": self.free_blocks,
                "used_blocks": self.used_blocks,
                "shared_blocks": self.shared_blocks,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_lookup_tokens": self.prefix_lookup_tokens,
                "evicted_blocks": self.evicted_blocks,
                "cow_copies": self.cow_copies}

    def _update_gauges(self) -> None:
        if self._g_free is not None:
            self._g_free.set(self.free_blocks, cache=self.name)
            self._g_used.set(self.used_blocks, cache=self.name)
            self._g_shared.set(self.shared_blocks, cache=self.name)

    # -- block-level plumbing ------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _alloc_block(self) -> int:
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def _deref(self, bid: int) -> None:
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)

    def _reserve(self, n: int) -> bool:
        """Make ``n`` blocks available, evicting cached prefixes LRU-first
        if the free list is short.  False when even a drained trie cannot
        supply them."""
        while len(self._free) < n:
            if not self._evict_one():
                return False
        return True

    def _evict_one(self) -> bool:
        """Drop the least-recently-matched trie *leaf* whose block only the
        trie holds (leaf-first: a parent is never reclaimed under a live
        child)."""
        victim = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (node is not self._root and not node.children
                    and self._ref[node.block] == 1):
                if victim is None or node.stamp < victim.stamp:
                    victim = node
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        self._deref(victim.block)
        self.evicted_blocks += 1
        if self._c_evict is not None:
            self._c_evict.inc(cache=self.name)
        return True

    def flush_prefixes(self) -> int:
        """Drop the ENTIRE prefix trie at once (the degradation ladder's
        level 2: shed cached state before shedding requests).  Blocks
        still held by live sequences survive until those release;
        trie-only blocks return to the free list now.  Returns the number
        of trie nodes dropped."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self._deref(node.block)
            dropped += 1
        self._root.children = {}
        self.evicted_blocks += dropped
        if self._c_evict is not None and dropped:
            self._c_evict.inc(dropped, cache=self.name)
        self._update_gauges()
        return dropped

    # -- sequence lifecycle --------------------------------------------------

    def acquire(self, tokens: Sequence[int]) -> Optional[PagedSequence]:
        """Claim blocks for a context of ``tokens``: the longest full-block
        prefix in the trie (capped so at least one token is left to run),
        then fresh exclusive blocks for the rest.  None when the pool
        cannot supply them even after eviction."""
        n = len(tokens)
        if n < 1:
            raise ValueError("cannot acquire an empty context")
        bs = self.block_size
        shared: List[int] = []
        if self.share_prefixes:
            node = self._root
            for i in range((n - 1) // bs):
                child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
                if child is None:
                    break
                child.stamp = self._tick()
                shared.append(child.block)
                node = child
        shared_tokens = len(shared) * bs
        fresh_needed = self.blocks_for(n - shared_tokens)
        if not self._reserve(fresh_needed):
            return None
        blocks = shared + [self._alloc_block() for _ in range(fresh_needed)]
        for bid in shared:
            self._ref[bid] += 1
        self.prefix_hit_tokens += shared_tokens
        self.prefix_lookup_tokens += n
        if self._c_hits is not None and shared_tokens:
            self._c_hits.inc(shared_tokens, cache=self.name)
        self._update_gauges()
        return PagedSequence(blocks, n, shared_tokens)

    def register_prefix(self, seq: PagedSequence,
                        tokens: Sequence[int]) -> None:
        """Publish ``seq``'s full context blocks into the trie (after their
        KV is written); each new node takes one trie reference."""
        if not self.share_prefixes:
            return
        bs = self.block_size
        node = self._root
        for i in range(len(tokens) // bs):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(key, seq.block_ids[i], node)
                node.children[key] = child
                self._ref[seq.block_ids[i]] += 1
            child.stamp = self._tick()
            node = child
        self._update_gauges()

    def release(self, seq: PagedSequence) -> None:
        """Drop ``seq``'s references (trie-published blocks stay cached)."""
        for bid in seq.block_ids:
            self._deref(bid)
        seq.block_ids = []
        seq.num_tokens = 0
        self._update_gauges()

    def ensure_capacity(self, seq: PagedSequence, n_tokens: int) -> bool:
        """Grow ``seq``'s table to cover ``n_tokens`` positions with fresh
        exclusive blocks.  False when the pool is exhausted."""
        need = self.blocks_for(n_tokens) - len(seq.block_ids)
        if need <= 0:
            return True
        if not self._reserve(need):
            return False
        seq.block_ids.extend(self._alloc_block() for _ in range(need))
        self._update_gauges()
        return True

    def ensure_writable(self, seq: PagedSequence, block_index: int) -> int:
        """Copy-on-write: make ``seq.block_ids[block_index]`` exclusively
        owned before a write; returns the (possibly new) block id.  Raises
        MemoryError when the pool cannot supply the copy."""
        bid = seq.block_ids[block_index]
        if self._ref[bid] == 1:
            return bid
        if not self._reserve(1):
            raise MemoryError("pool exhausted during copy-on-write")
        new = self._alloc_block()
        self.data[new] = self.data[bid]
        self._ref[bid] -= 1
        seq.block_ids[block_index] = new
        self.cow_copies += 1
        if self._c_cow is not None:
            self._c_cow.inc(cache=self.name)
        self._update_gauges()
        return new

    def fork(self, seq: PagedSequence) -> PagedSequence:
        """Clone ``seq`` sharing every block; writers call
        :meth:`ensure_writable` on the tail block before appending."""
        for bid in seq.block_ids:
            self._ref[bid] += 1
        self._update_gauges()
        return PagedSequence(list(seq.block_ids), seq.num_tokens,
                             seq.shared_tokens)

    # -- KV movement ---------------------------------------------------------

    def write_context_kv(self, seq: PagedSequence, kv,
                         context_len: int) -> None:
        """Install prefilled KV into ``seq``'s exclusive blocks.

        ``kv``: ``(layers, 2, s, kv_heads, head_dim)`` for one sequence
        (``s`` may be bucket-padded beyond ``context_len``).  The shared
        prefix ``[0, seq.shared_tokens)`` is skipped: those blocks already
        hold the KV of the prefill that published them.
        """
        bs = self.block_size
        start = seq.shared_tokens        # block-aligned by construction
        if context_len <= start:
            return
        full_end = (context_len // bs) * bs
        if full_end > start:
            ids = torch.tensor(seq.block_ids[start // bs:full_end // bs],
                               device=self.data.device)
            sl = kv[:, :, start:full_end].to(self.data.dtype)
            sl = sl.reshape(sl.shape[0], 2, len(ids), bs, *sl.shape[3:])
            self.data[ids] = sl.permute(2, 0, 1, 3, 4, 5)
        rem = context_len - full_end
        if rem > 0:
            bid = seq.block_ids[full_end // bs]
            self.data[bid, :, :, :rem] = kv[:, :, full_end:context_len].to(
                self.data.dtype)

    def table_row(self, seq: Optional[PagedSequence],
                  max_blocks: int) -> np.ndarray:
        """``seq``'s block table padded with the garbage block (0), or the
        all-garbage row of an inactive slot."""
        row = np.zeros((max_blocks,), np.int32)
        if seq is not None:
            row[:len(seq.block_ids)] = seq.block_ids
        return row

    # -- cross-pool handoff (serving.disagg) ----------------------------------

    def _ids(self, block_ids: Sequence[int]) -> torch.Tensor:
        return torch.tensor(list(block_ids), dtype=torch.long,
                            device=self.data.device)

    def export_blocks(self, block_ids: Sequence[int]) -> Dict[str, Any]:
        """Copy ``block_ids``'s raw storage into fresh tensors on the
        pool's device — the payload a KV handoff ships.  The gather is
        queued on the current stream, so a later write into these blocks
        cannot reach the copy.  :meth:`import_blocks` on a pool of the
        same :attr:`kind` installs it bitwise."""
        return {"data": self.data.index_select(0, self._ids(block_ids))}

    def import_blocks(self, block_ids: Sequence[int],
                      payload: Dict[str, Any]) -> None:
        """Install an :meth:`export_blocks` payload into ``block_ids``
        (blocks that THIS pool owns exclusively)."""
        self.data.index_copy_(0, self._ids(block_ids),
                              payload["data"].to(self.data.device,
                                                 self.data.dtype))


class QuantizedPagedKVCache(PagedKVCache):
    """Int8 scale-per-block paged KV cache: int8 blocks with one f32 scale
    per ``(block, layer, k/v, head)``.

    Bookkeeping is inherited; storage differs:

    * The pool is int8 whatever ``dtype`` (the compute dtype the
      attention dequantizes into is f32, as in JAX).
    * **Zero-on-alloc**: an allocated block is zeroed (scales 1.0), so
      positions past a sequence's length are exact zeros and whole-block
      requantization on append is deterministic whatever the block held
      before.
    * Copy-on-write copies the scales with the block.
    * Shared blocks are never requantized (writers only touch exclusive
      blocks), so a published prefix block's quantization is frozen.
    """

    kind = "paged_int8"

    def __init__(self, num_blocks: int, block_size: int, layers: int,
                 kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 share_prefixes: bool = True, device=None, registry=None,
                 name: str = "pool0"):
        super().__init__(num_blocks, block_size, layers, kv_heads,
                         head_dim, dtype=torch.int8,
                         share_prefixes=share_prefixes, device=device,
                         registry=registry, name=name)
        self.compute_dtype = dtype
        self.scales = torch.ones((num_blocks, layers, 2, kv_heads),
                                 dtype=_f32, device=self.data.device)
        if registry is not None:
            ref_bytes = (self.data[0].numel()
                         * torch.empty((), dtype=dtype).element_size())
            registry.gauge(
                "serving_kv_quant_compression_ratio",
                "quantized block bytes (incl. scales) over the compute-"
                "dtype block bytes", ["cache"]).set(
                    self.block_bytes / ref_bytes, cache=self.name)

    @property
    def block_bytes(self) -> int:
        return (self.data[0].numel() * self.data.element_size()
                + self.scales[0].numel() * self.scales.element_size())

    def _alloc_block(self) -> int:
        bid = super()._alloc_block()
        self.data[bid] = 0               # zero-on-alloc (class docstring)
        self.scales[bid] = 1.0
        return bid

    def ensure_writable(self, seq: PagedSequence, block_index: int) -> int:
        old = seq.block_ids[block_index]
        new = super().ensure_writable(seq, block_index)
        if new != old:
            self.scales[new] = self.scales[old]
        return new

    def write_context_kv(self, seq: PagedSequence, kv,
                         context_len: int) -> None:
        """One-shot per-block quantization of a monolithic prefill's KV
        (chunked prefill and decode requantize per appended token instead;
        the two are each deterministic but not bitwise equal)."""
        bs = self.block_size
        start = seq.shared_tokens        # block-aligned by construction
        if context_len <= start:
            return
        ids = seq.block_ids[start // bs:self.blocks_for(context_len)]
        lyr, two = kv.shape[:2]
        sl = torch.zeros((lyr, two, len(ids) * bs, *kv.shape[3:]),
                         dtype=_f32, device=self.data.device)
        sl[:, :, :context_len - start] = kv[:, :, start:context_len].to(_f32)
        blocks = sl.reshape(lyr, two, len(ids), bs, *sl.shape[3:]).permute(
            2, 0, 1, 3, 4, 5)            # (n, layers, 2, bs, h, d)
        q8, sc = quantize_kv_blocks(blocks)
        idx = torch.tensor(ids, device=self.data.device)
        self.data[idx] = q8
        self.scales[idx] = sc

    def export_blocks(self, block_ids: Sequence[int]) -> Dict[str, Any]:
        ids = self._ids(block_ids)
        return {"data": self.data.index_select(0, ids),
                "scales": self.scales.index_select(0, ids)}

    def import_blocks(self, block_ids: Sequence[int],
                      payload: Dict[str, Any]) -> None:
        ids = self._ids(block_ids)
        self.data.index_copy_(0, ids, payload["data"].to(self.data.device,
                                                         torch.int8))
        self.scales.index_copy_(0, ids, payload["scales"].to(
            self.scales.device, _f32))
