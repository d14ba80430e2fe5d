"""Preallocated KV-cache ring with slot allocation — port of
``apex_tpu/inference/kv_cache.py``.

One device tensor holds every sequence's cache:
``(slots, layers, 2, max_seq, kv_heads, head_dim)`` — axis 2 is K/V.  The
slot axis doubles as the decode batch dimension, so admission is slot
allocation and nothing is ever reshaped or compacted.  The tensor is
updated in place (``write_prompt`` here, the K/V writes inside
``GPTModel.decode_step``); slot bookkeeping (free list, per-slot lengths)
is host-side numpy.  Typically bf16, with attention accumulating in f32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.utils.device import resolve_device


class KVCache:
    """Slot-table KV cache for continuous-batching decode."""

    def __init__(self, slots: int, layers: int, max_seq: int,
                 kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                 device=None):
        if slots <= 0 or max_seq <= 0:
            raise ValueError("slots and max_seq must be positive")
        self.data = torch.zeros(
            (slots, layers, 2, max_seq, kv_heads, head_dim), dtype=dtype,
            device=resolve_device(device))
        self.lengths = np.zeros((slots,), np.int32)
        # LIFO free list popping the lowest slot first keeps tests and
        # traces readable; correctness doesn't depend on the order
        self._free = list(range(slots - 1, -1, -1))

    @property
    def slots(self) -> int:
        return self.data.shape[0]

    @property
    def max_seq(self) -> int:
        return self.data.shape[3]

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.slots - len(self._free)

    @property
    def slot_bytes(self) -> int:
        """Device-memory footprint of one slot row."""
        return self.data[0].numel() * self.data.element_size()

    def free_bytes(self) -> int:
        """Bytes of cache capacity no request is holding (free slots)."""
        return len(self._free) * self.slot_bytes

    def used_bytes(self) -> int:
        """Bytes covered by valid entries (token-granular)."""
        return int(self.lengths.sum()) * self.slot_bytes // self.max_seq

    def occupancy(self) -> float:
        """Fraction of total cache capacity holding valid tokens."""
        return float(self.lengths.sum()) / (self.slots * self.max_seq)

    def allocate(self) -> Optional[int]:
        """Claim a free slot id, or None when fully occupied."""
        if not self._free:
            return None
        return self._free.pop()

    def free(self, slot: int) -> None:
        """Return ``slot`` to the pool; its rows stay until overwritten."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        self.lengths[slot] = 0
        self._free.append(slot)

    def write_prompt(self, slot: int, kv, length: int) -> None:
        """Install a prefilled prompt into ``slot``.

        ``kv``: ``(layers, 2, s, kv_heads, head_dim)`` from
        :meth:`~apex_tpu_torch.models.gpt.GPTModel.prefill` (one sequence),
        cast to the cache dtype.  ``s`` may exceed ``length`` (bucket-padded
        prompts): the padded rows are masked by ``length``.
        """
        s = kv.shape[2]
        if s > self.max_seq:
            raise ValueError(
                f"prompt length {s} exceeds cache max_seq {self.max_seq}")
        if not 0 < length <= s:
            raise ValueError(f"length {length} not in (0, {s}]")
        self.data[slot, :, :, :s] = kv.to(self.data.dtype)
        self.lengths[slot] = length

    def advance(self, slot: int) -> None:
        """Record one decoded token in ``slot`` (the device-side write
        happened inside ``decode_step``)."""
        self.lengths[slot] += 1
