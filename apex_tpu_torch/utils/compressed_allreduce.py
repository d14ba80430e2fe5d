"""Block-quantized collectives — port of
``apex_tpu/utils/compressed_allreduce.py`` (EQuARX-style compressed
all-reduce, arXiv:2506.17615).

The all-reduce is a reduce-scatter and an all-gather over the packed
``(rows, 128)`` layout of :mod:`apex_tpu_torch.multi_tensor_apply.
bucketing`; each hop's payload is quantized per 128-element row (one int8
value per element and one f32 scale per row) or cast to bf16, and the
dequantization and the sum across ranks run in f32 ("quantized transport,
f32 accumulation").  ``allreduce_dtype`` in
:class:`~apex_tpu_torch.parallel.DistributedDataParallel` and the ZeRO
optimizers picks the transport:

=============  ==========================================================
``None``/f32   ``reduce_scatter_tensor`` / ``all_reduce`` — the exact path
``bf16``       a bf16 payload, f32 accumulation
``int8``       an int8 payload and an f32 scale per row, f32 accumulation
=============  ==========================================================

The quantized reduce-scatter is an ``all_to_all`` of the quantized shards
followed by a sum of the ``world`` dequantized shards in rank order, in
f32: one quantization per producer.  The quantization rounds as the JAX
package's does where it runs, compiled inside ``shard_map`` (``round``
half to even of ``x / scale``, with ``scale = max|x| * f32(1 / 127)``:
XLA folds the division by the constant 127 into a product with its f32
reciprocal; 1 for an all-zero row).  Callers pad to a multiple of
``world`` rows (:func:`pad_rows`); zero rows quantize to exact zeros.

The collectives take ``axis_name=`` or ``process_group=``
(:mod:`apex_tpu_torch.transformer.parallel_state`); without a group they
are identities (with one rank the quantized modes still round their
payload, as the JAX collectives do over an axis of size 1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.multi_tensor_apply.bucketing import LANE
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.collectives import (all_reduce_, check_backend,
                                              tree_map)

_f32 = torch.float32

# 1/127 rounded to f32, as the compiled JAX quantization multiplies by it
_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))

#: transports accepted by every ``allreduce_dtype`` knob
MODES = (None, "f32", "bf16", "int8")


def check_mode(mode):
    """Normalize / validate an ``allreduce_dtype`` value (None == "f32")."""
    if mode in (None, "f32", torch.float32):
        return None
    if mode in ("bf16", torch.bfloat16):
        return "bf16"
    if mode in ("int8", torch.int8):
        return "int8"
    raise ValueError(
        f"allreduce_dtype={mode!r} not supported; choose one of "
        "None/'f32' (exact), 'bf16', 'int8'")


# -- per-row int8 codec --------------------------------------------------------

def quantize_int8(x):
    """Symmetric int8 quantization over the last axis (a block a row of
    128 in the packed buffers).  Returns ``(q, scale)``: ``q`` int8 in
    [-127, 127], ``scale`` f32 shaped like ``x`` with the last axis 1;
    all-zero blocks get scale 1, so they come back exact zeros."""
    x = x.to(_f32)
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) * _INV_127
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    """f32 reconstruction of :func:`quantize_int8` output."""
    return q.to(_f32) * scale


def pad_rows(x, multiple: int):
    """Zero-pad axis 0 of ``(rows, LANE)`` to a multiple of ``multiple``."""
    rows = x.shape[0]
    target = -(-rows // multiple) * multiple
    if target == rows:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, target - rows))


# -- collectives ---------------------------------------------------------------

def _group_and_world(axis_name, process_group, world_size):
    group = ps.resolve_group(axis_name, process_group)
    world = ps.group_size(group)
    if world_size is not None and int(world_size) != world:
        raise ValueError(f"world_size={world_size} but the group has {world} "
                         "ranks")
    return group, world


def _all_to_all_rows(x, group):
    if group is None:
        return x
    check_backend(x, group, "all_to_all")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _all_gather_rows(x, group):
    if group is None:
        return x
    check_backend(x, group, "all_gather")
    world = dist.get_world_size(group)
    out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _sum_in_rank_order(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def reduce_scatter(x, axis_name=ps.DATA_AXIS, world_size=None, mode=None, *,
                   process_group=None):
    """Reduce-scatter a packed ``(rows, 128)`` buffer: returns this rank's
    ``(rows / world, 128)`` shard of the SUM across ranks, in ``x.dtype``.
    ``rows`` must be a multiple of the world size.  ``mode=None``/``"f32"``
    is ``reduce_scatter_tensor``; the quantized modes send compressed
    payloads by ``all_to_all`` and sum the dequantized shards in f32."""
    mode = check_mode(mode)
    group, world = _group_and_world(axis_name, process_group, world_size)
    rows = x.shape[0]
    if rows % world:
        raise ValueError(
            f"reduce_scatter: rows={rows} not divisible by "
            f"world_size={world}; pad with pad_rows() first")
    local = rows // world
    if mode is None:
        if group is None:
            return x.clone()
        check_backend(x, group, "reduce_scatter")
        out = torch.empty((local,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out
    if mode == "bf16":
        parts = _all_to_all_rows(x.to(torch.bfloat16), group).to(_f32)
    else:
        q, s = quantize_int8(x)
        parts = dequantize_int8(_all_to_all_rows(q, group),
                                _all_to_all_rows(s, group))
    total = _sum_in_rank_order(parts.reshape(world, local, x.shape[1]))
    return total.to(x.dtype)


def all_gather_rows(x, axis_name=ps.DATA_AXIS, mode=None, *,
                    process_group=None):
    """All-gather shards along axis 0 (the inverse of
    :func:`reduce_scatter`'s layout): the ``(world * local_rows, 128)``
    concatenation in ``x.dtype``; the quantized modes compress the outgoing
    shard once."""
    mode = check_mode(mode)
    group = ps.resolve_group(axis_name, process_group)
    if mode is None:
        out = _all_gather_rows(x, group)
        return out.clone() if group is None else out
    if mode == "bf16":
        return _all_gather_rows(x.to(torch.bfloat16), group).to(x.dtype)
    q, s = quantize_int8(x)
    return dequantize_int8(_all_gather_rows(q, group),
                           _all_gather_rows(s, group)).to(x.dtype)


def psum_rows(x, mode, *, process_group):
    """Compressed all-reduce (SUM) of a packed ``(rows, 128)`` buffer over
    ``process_group``: the rows in f32, padded to a multiple of the world
    size, reduce-scattered and all-gathered (two quantizations of each
    row); returned in ``x.dtype``."""
    world = ps.group_size(process_group)
    rows = x.shape[0]
    flat = pad_rows(x.to(_f32), world)
    shard = reduce_scatter(flat, mode=mode, process_group=process_group,
                           axis_name=None)
    full = all_gather_rows(shard, mode=mode, process_group=process_group,
                           axis_name=None)
    return full[:rows].to(x.dtype)


def psum_compressed(x, axis_name=ps.DATA_AXIS, world_size=None, mode=None, *,
                    process_group=None):
    """All-reduce (SUM) one tensor with compressed transport; the result
    has ``x``'s shape and dtype.  ``mode=None``/``"f32"`` is a plain
    ``all_reduce``; otherwise the tensor is laid out in LANE rows and
    reduced by :func:`psum_rows`."""
    mode = check_mode(mode)
    group, _ = _group_and_world(axis_name, process_group, world_size)
    if mode is None:
        return all_reduce_(x.clone(), group)
    flat = x.reshape(-1).to(_f32)
    n = flat.numel()
    rows = -(-n // LANE)
    flat = torch.nn.functional.pad(flat, (0, rows * LANE - n))
    full = psum_rows(flat.reshape(rows, LANE), mode, process_group=group)
    return full.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def psum_tree_compressed(tree, axis_name=ps.DATA_AXIS, world_size=None,
                         mode=None, strict: bool = False, *,
                         process_group=None):
    """Compressed :func:`~apex_tpu_torch.utils.collectives.
    psum_if_varying`: every floating tensor of ``tree`` takes
    :func:`psum_compressed`; non-float tensors, and every tensor under the
    exact mode, take the exact all-reduce.  ``strict`` is accepted as
    there (every rank's tensor is its own)."""
    del strict
    mode = check_mode(mode)
    group, world = _group_and_world(axis_name, process_group, world_size)

    def one(v):
        if mode is None or not v.is_floating_point():
            return all_reduce_(v.clone(), group)
        return psum_compressed(v, world_size=world, mode=mode,
                               process_group=group, axis_name=None)

    return tree_map(one, tree)
