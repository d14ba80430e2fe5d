"""Fused scale + mask + softmax — port of ``apex_tpu/ops/softmax.py``
(apex's Megatron ``scaled_masked_softmax``,
``scaled_upper_triang_masked_softmax`` and the generic fallback).

Plain PyTorch: the JAX package has no kernel here either (XLA fuses the
chain).  What the fused op keeps is its memory behaviour: each form is an
autograd Function whose backward reads only the saved output,
``dx = (dy - sum(dy * y)) * y * scale`` in f32, never the scores.  The
softmax runs in f32 and returns the input's dtype.  Masks follow apex: a
boolean mask broadcastable to the scores with True = masked out, filled
with -10000 before the softmax; the causal form builds its
upper-triangular pattern itself.
"""

from __future__ import annotations

import torch

_f32 = torch.float32
MASK_FILL = -10000.0

__all__ = ["scaled_masked_softmax", "scaled_softmax",
           "scaled_upper_triang_masked_softmax",
           "generic_scaled_masked_softmax", "MASK_FILL"]


def _causal_mask(sq, sk, device):
    """True where key ``k`` lies after query ``q`` (aligned at the end:
    ``k > q + sk - sq``)."""
    return torch.ones((sq, sk), dtype=torch.bool,
                      device=device).triu_(sk - sq + 1)


def _softmax_bwd(y, dy, scale):
    yf, dyf = y.to(_f32), dy.to(_f32)
    dx = (dyf - torch.sum(dyf * yf, dim=-1, keepdim=True)) * yf * scale
    return dx.to(dy.dtype)


class _ScaledMaskedSoftmax(torch.autograd.Function):
    """``softmax(where(mask, -10000, scale * x))`` over the last axis;
    ``mask`` None for no mask; ``causal`` builds the upper-triangular
    one."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        xs = x.to(_f32) * scale
        if causal:
            mask = _causal_mask(x.shape[-2], x.shape[-1], x.device)
        if mask is not None:
            xs = torch.where(mask, MASK_FILL, xs)
        y = torch.softmax(xs, dim=-1).to(x.dtype)
        ctx.scale = scale
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return _softmax_bwd(y, dy, ctx.scale), None, None, None


def scaled_masked_softmax(x, mask, scale=1.0):
    """``softmax(scale*x masked_fill(mask, -10000))`` over the last axis.

    x: ``(b, np, sq, sk)`` attention scores; mask: broadcastable boolean,
    True = masked (apex ``ScaledMaskedSoftmax``)."""
    return _ScaledMaskedSoftmax.apply(x, mask, float(scale), False)


def scaled_softmax(x, scale=1.0):
    """No-mask variant (apex ``ScaledSoftmax``)."""
    return _ScaledMaskedSoftmax.apply(x, None, float(scale), False)


def scaled_upper_triang_masked_softmax(x, scale=1.0):
    """Causal softmax for ``(b, sq, sk)`` scores (apex
    ``ScaledUpperTriangMaskedSoftmax``): position q attends to k ≤ q."""
    return _ScaledMaskedSoftmax.apply(x, None, float(scale), True)


def generic_scaled_masked_softmax(x, mask, scale=1.0):
    """Arbitrary-shape fallback (apex ``generic_scaled_masked_softmax``)."""
    return _ScaledMaskedSoftmax.apply(x, mask, float(scale), False)
