"""Tensor-list multi-tensor ops — port of
``apex_tpu/multi_tensor_apply/functional.py``.

The ``amp_C.multi_tensor_*`` entry points as used through apex's
``multi_tensor_applier``: lists of tensors of any shapes and dtypes go to
one multi-tensor launch set (:mod:`apex_tpu_torch.ops.multi_tensor`) over
the tensors themselves.  The JAX package packs each dtype into one
``(rows, 128)`` buffer first (a TPU lane layout); the CUDA launch table
takes the tensors where they lie, so nothing is packed or grouped by dtype.
The returned ``found_inf`` is the functional form of apex's overflow
buffer.
"""

from __future__ import annotations

from typing import Sequence

import torch

from apex_tpu_torch.ops.multi_tensor import (CHUNK, multi_tensor_axpby_,
                                             multi_tensor_scale_,
                                             multi_tensor_sumsq)

__all__ = ["MultiTensorApply", "multi_tensor_applier", "multi_tensor_scale",
           "multi_tensor_axpby", "multi_tensor_l2norm"]


def multi_tensor_scale(tensors: Sequence[torch.Tensor], scale,
                       out_dtype=None, out=None):
    """``out_i = tensor_i * scale`` for all i; returns ``(outs,
    found_inf)``.  ``out`` (a list of tensors, which may be ``tensors``
    itself) receives the results in place; otherwise new tensors of
    ``out_dtype`` (default: each input's dtype) are made.  Reference:
    ``csrc/multi_tensor_scale_kernel.cu`` (amp unscale, master-grad
    copies)."""
    tensors = list(tensors)
    if out is None:
        out = [torch.empty_like(t, dtype=out_dtype or t.dtype)
               for t in tensors]
    found_inf = multi_tensor_scale_(tensors, list(out), scale)
    return list(out), found_inf


def multi_tensor_axpby(a, xs: Sequence[torch.Tensor], b,
                       ys: Sequence[torch.Tensor], out_dtype=None, out=None):
    """``out_i = a*x_i + b*y_i`` (in f32) for all i; returns ``(outs,
    found_inf)``, the flag taken on the outputs.  ``out`` (a list of
    tensors, which may be ``xs`` or ``ys``) receives the results in place;
    otherwise new tensors of ``out_dtype`` (default: each x's dtype) are
    made.  x and y may differ in dtype.  Reference:
    ``csrc/multi_tensor_axpby_kernel.cu`` (kernel #16)."""
    xs, ys = list(xs), list(ys)
    if len(xs) != len(ys):
        raise ValueError("multi_tensor_axpby: xs and ys differ in length")
    if out is None:
        out = [torch.empty_like(x, dtype=out_dtype or x.dtype) for x in xs]
    found_inf = multi_tensor_axpby_(xs, ys, list(out), a, b)
    return list(out), found_inf


def multi_tensor_l2norm(tensors: Sequence[torch.Tensor],
                        per_tensor: bool = False):
    """Global L2 norm over all tensors (and per-tensor norms if asked).

    Returns ``(norm, per_tensor_norms, found_inf)``: f32 device scalars,
    ``per_tensor_norms`` an f32 ``(n,)`` tensor in input order or None.
    Reference: ``csrc/multi_tensor_l2norm_kernel.cu`` (per-tensor variant =
    apex's ``per_tensor_python=True``)."""
    total, per, found_inf = multi_tensor_sumsq(list(tensors), per_tensor)
    return (torch.sqrt(total), None if per is None else torch.sqrt(per),
            found_inf)


class MultiTensorApply:
    """apex ``multi_tensor_apply.MultiTensorApply``:
    ``multi_tensor_applier(op, noop_flag, tensor_lists, *args)`` with each
    op's list convention (scale: ``[in, out]``, axpby: ``[x, y, out]``,
    l2norm: ``[in]``).  The results are returned as by the functional ops
    (``noop_flag`` is not written: the found-inf flag is returned); an
    ``out`` list is written in place, as apex writes it.  The kernels'
    chunk is fixed at 64K elements
    (:data:`~apex_tpu_torch.ops.multi_tensor.CHUNK`, apex's usual
    ``2048 * 32``): another ``chunk_size`` raises."""

    available = True
    warned = False

    def __init__(self, chunk_size: int = CHUNK):
        if int(chunk_size) != CHUNK:
            raise ValueError(f"MultiTensorApply: the kernels' chunk is fixed "
                             f"at {CHUNK} elements, not {chunk_size}")
        self.chunk_size = CHUNK

    def __call__(self, op, noop_flag, tensor_lists, *args, **kwargs):
        if op is multi_tensor_scale:
            out = tensor_lists[1] if len(tensor_lists) > 1 else None
            return op(tensor_lists[0], *args, out=out, **kwargs)
        if op is multi_tensor_axpby:
            out = tensor_lists[2] if len(tensor_lists) > 2 else None
            return op(args[0], tensor_lists[0], args[1], tensor_lists[1],
                      *args[2:], out=out, **kwargs)
        if op is multi_tensor_l2norm:
            return op(tensor_lists[0], *args, **kwargs)
        return op(tensor_lists, *args, **kwargs)


multi_tensor_applier = MultiTensorApply()
