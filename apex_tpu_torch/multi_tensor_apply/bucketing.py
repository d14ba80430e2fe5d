"""Tensor list -> packed ``(rows, 128)`` buckets — port of
``apex_tpu/multi_tensor_apply/bucketing.py``.

The JAX package packs a list of same-dtype tensors into one lane-aligned
``(rows, 128)`` buffer: each tensor zero-padded to a multiple of
``LANE = 128`` elements (so a row never spans two tensors), the rows then
padded to a multiple of ``block_rows``.  On the port that layout is the
ZeRO optimizers' sharding unit (:mod:`apex_tpu_torch.parallel.
distributed_optimizer`: with ``block_rows * world`` rows a bucket splits
into ``world`` equal shards of whole rows) and the compressed all-reduce's
(one quantization block a row).  The arithmetic is the JAX package's, so a
bucket's rows, and each rank's shard of them, are JAX's row for row.

The kernels themselves take lists of tensors where they lie
(``csrc/multi_tensor.cuh``): a shard's rows of one tensor are one
contiguous view, a *segment* (:func:`shard_segments`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

LANE = 128
# rows a bucket is padded to a multiple of (the JAX package's Pallas block)
DEFAULT_BLOCK_ROWS = 512


class BucketMeta(NamedTuple):
    """Static description of a packed bucket."""

    shapes: tuple          # original tensor shapes
    dtype: torch.dtype     # bucket dtype
    sizes: tuple           # original element counts
    padded_sizes: tuple    # per-tensor counts padded to LANE
    row_offsets: tuple     # starting row of each tensor in the packed buffer
    nrows: int             # total rows including block padding
    block_rows: int


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if len(shape) else 1


def bucket_meta(shapes: Sequence[tuple], dtype,
                block_rows: int = DEFAULT_BLOCK_ROWS) -> BucketMeta:
    sizes = tuple(_numel(s) for s in shapes)
    padded = tuple(_round_up(max(s, 1), LANE) for s in sizes)
    row_offsets, off = [], 0
    for p in padded:
        row_offsets.append(off)
        off += p // LANE
    nrows = _round_up(max(off, 1), block_rows)
    return BucketMeta(tuple(tuple(s) for s in shapes), dtype, sizes, padded,
                      tuple(row_offsets), nrows, block_rows)


def used_rows(meta: BucketMeta) -> int:
    """Rows holding tensor data (the rest is block padding)."""
    return meta.row_offsets[-1] + meta.padded_sizes[-1] // LANE


def flatten_bucket(tensors: Sequence[torch.Tensor], meta: BucketMeta,
                   out: torch.Tensor = None) -> torch.Tensor:
    """Pack same-shape-as-``meta`` tensors into one ``(nrows, 128)`` buffer
    of ``meta.dtype`` (``out`` when given), zeros in every padding slot."""
    device = tensors[0].device
    if out is None:
        out = torch.empty((meta.nrows, LANE), dtype=meta.dtype, device=device)
    flat = out.view(-1)
    used = used_rows(meta) * LANE
    for t, size, row, padded in zip(tensors, meta.sizes, meta.row_offsets,
                                    meta.padded_sizes):
        start = row * LANE
        flat[start:start + size].copy_(t.reshape(-1))
        if padded != size:
            flat[start + size:start + padded].zero_()
    flat[used:].zero_()
    return out


def unflatten_bucket(data: torch.Tensor, meta: BucketMeta) -> list:
    """The tensors of a packed buffer, as views in their shapes."""
    flat = data.reshape(-1)
    return [flat[row * LANE:row * LANE + size].view(shape)
            for shape, size, row in zip(meta.shapes, meta.sizes,
                                        meta.row_offsets)]


def row_tensor_ids(meta: BucketMeta) -> np.ndarray:
    """int32 ``(nrows,)`` map from packed row to tensor index.  Padding
    rows past the last tensor map to the last tensor id; their data is
    zero so they add nothing to segment reductions."""
    ids = np.zeros(meta.nrows, dtype=np.int32)
    for i, (row, padded) in enumerate(zip(meta.row_offsets,
                                          meta.padded_sizes)):
        ids[row:row + padded // LANE] = i
    ids[used_rows(meta):] = len(meta.shapes) - 1
    return ids


class Segment(NamedTuple):
    """The rows ``[start, stop)`` of a shard (shard-local rows) that hold
    tensor ``index``'s rows ``[start + lo, stop + lo)`` of the bucket."""

    index: int
    start: int
    stop: int


def shard_segments(meta: BucketMeta, lo: int, hi: int) -> list:
    """The tensors' pieces in the bucket rows ``[lo, hi)`` (a rank's
    shard), in tensor order, with shard-local row ranges; block padding
    past the last tensor belongs to none."""
    out = []
    for i, (row, padded) in enumerate(zip(meta.row_offsets,
                                          meta.padded_sizes)):
        start, stop = max(row, lo), min(row + padded // LANE, hi)
        if start < stop:
            out.append(Segment(i, start - lo, stop - lo))
    return out


def split_by_message_size(shapes: Sequence[tuple], dtype,
                          message_size: int) -> list:
    """Partition tensor indices into contiguous groups of at most
    ``message_size`` BYTES each (apex's bucket cap), sized by each tensor's
    LANE-padded footprint in ``dtype``; a tensor larger than the cap gets
    a group of its own (tensors are never torn across buckets)."""
    if message_size <= 0:
        raise ValueError(f"message_size must be positive, got {message_size}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    groups: list = []
    cur: list = []
    cur_bytes = 0
    for i, shape in enumerate(shapes):
        nbytes = _round_up(max(_numel(shape), 1), LANE) * itemsize
        if cur and cur_bytes + nbytes > message_size:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        groups.append(cur)
    return groups


def group_by_dtype(tensors: Sequence[torch.Tensor]) -> dict:
    """Tensor indices by dtype, in order of first appearance."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def segment_views(buf: torch.Tensor, segments) -> list:
    """The 1-D views of a ``(rows, 128)`` shard buffer that the segments
    cover (one list entry per segment, for the multi-tensor kernels)."""
    flat = buf.view(-1)
    return [flat[s.start * LANE:s.stop * LANE] for s in segments]


def flatten_rows(tensors: Sequence[torch.Tensor], meta: BucketMeta, lo: int,
                 hi: int, dtype=None) -> torch.Tensor:
    """Rows ``[lo, hi)`` of :func:`flatten_bucket` of ``tensors`` (in
    ``dtype``, else ``meta.dtype``), packing only those rows."""
    out = torch.zeros((hi - lo, LANE), dtype=dtype or meta.dtype,
                      device=tensors[0].device)
    flat = out.view(-1)
    for s in shard_segments(meta, lo, hi):
        first = (s.start + lo - meta.row_offsets[s.index]) * LANE
        n = min(meta.sizes[s.index] - first, (s.stop - s.start) * LANE)
        if n > 0:
            flat[s.start * LANE:s.start * LANE + n].copy_(
                tensors[s.index].reshape(-1)[first:first + n])
    return out
