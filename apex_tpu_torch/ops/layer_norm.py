"""Fused LayerNorm / RMSNorm — port of ``apex_tpu/ops/layer_norm.py``.

Rows are normalized over the last (hidden) axis with the E[x^2] - E[x]^2
variance form in f32, exactly as the JAX kernels and their jnp fallback do.

* :func:`layer_norm_fwd` is the forward kernel wrapper: a CPU tensor takes
  :func:`layer_norm_fwd_reference`, a CUDA tensor launches
  ``csrc/layer_norm_fwd.cu`` (the counterpart of the Pallas ``_fwd_kernel``).
* :func:`layer_norm_bwd` is the backward kernel wrapper: a CPU tensor takes
  :func:`layer_norm_bwd_reference`, a CUDA tensor launches
  ``csrc/layer_norm_bwd.cu`` (the counterpart of ``_bwd_kernel``): dx plus
  per-block dgamma/dbeta partials, reduced across blocks in a second pass.

The affine ops are a :class:`torch.autograd.Function` over the two.  Like
the JAX custom VJP it saves the input, or with ``memory_efficient=True``
the output ``y``, from which the backward rebuilds the normalized value as
``(y - beta) / gamma`` (RMS: ``y / gamma``; a zero gamma is guarded).
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

# rows of dy/x each block of the backward kernel reduces into one partial
# dgamma/dbeta row (csrc/layer_norm_bwd.cu)
LN_BWD_ROWS_PER_BLOCK = 16

__all__ = ["layer_norm_fwd", "layer_norm_fwd_reference", "layer_norm_bwd",
           "layer_norm_bwd_reference", "fused_layer_norm_affine",
           "fused_rms_norm_affine", "fused_layer_norm", "fused_rms_norm"]


def layer_norm_fwd_reference(x, weight, bias, eps: float, rms: bool):
    """Plain PyTorch version of the kernel.  ``x``: ``(rows, hidden)``;
    ``weight``/``bias``: ``(hidden,)`` f32 (``bias`` may be None).  Returns
    ``(y in x.dtype, mean (rows, 1) f32, rstd (rows, 1) f32)``."""
    xf = x.to(_f32)
    inv_h = 1.0 / x.shape[1]
    ms = torch.sum(xf * xf, dim=1, keepdim=True) * inv_h
    if rms:
        mean = torch.zeros((x.shape[0], 1), dtype=_f32, device=x.device)
        rstd = torch.rsqrt(ms + eps)
        xhat = xf * rstd
    else:
        mean = torch.sum(xf, dim=1, keepdim=True) * inv_h
        rstd = torch.rsqrt(ms - mean * mean + eps)
        xhat = (xf - mean) * rstd
    y = xhat * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype), mean, rstd


def _check_vectors(kernel, hidden, device, **vectors):
    for name, t in vectors.items():
        if t is None:
            continue
        if (t.dtype != _f32 or t.shape != (hidden,) or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be a contiguous f32 "
                             f"({hidden},) tensor on {device}")


def _check_rows(kernel, x, **others):
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{kernel}: x must be a contiguous (rows, hidden) "
                         f"tensor, got shape {tuple(x.shape)}")
    for name, t in others.items():
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be a contiguous "
                             f"{tuple(x.shape)} {x.dtype} tensor on "
                             f"{x.device}")


def layer_norm_fwd(x, weight, bias, eps: float, rms: bool):
    """LayerNorm (``rms=False``) or RMSNorm forward over the rows of ``x``.

    Same contract as :func:`layer_norm_fwd_reference`.  On a CUDA tensor
    the kernel runs (``x`` contiguous f32/bf16/f16, ``weight``/``bias``
    contiguous f32 on the same device); anything else it does not take
    raises.
    """
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, weight, bias, eps, rms)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x.device}")
    _check_rows("layer_norm_fwd", x)
    rows, hidden = x.shape
    _check_vectors("layer_norm_fwd", hidden, x.device, weight=weight,
                   bias=bias)
    code = _kernels.dtype_code(x, "layer_norm_fwd")
    y = torch.empty_like(x)
    mean = torch.empty((rows, 1), dtype=_f32, device=x.device)
    rstd = torch.empty((rows, 1), dtype=_f32, device=x.device)
    rc = _kernels.lib().apex_layer_norm_fwd(
        x.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps), int(rms),
        code, _kernels.stream())
    _kernels.check(rc, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0


def _xhat(res, weight, bias, mean, rstd, rms: bool, from_y: bool):
    """The normalized value, rebuilt from the saved residual (f32)."""
    resf = res.to(_f32)
    if from_y:
        y = resf - bias if bias is not None else resf
        # a zero gamma would give 0/0: guarded as in the JAX backward
        return y / torch.where(weight == 0.0, torch.ones_like(weight),
                               weight)
    return resf * rstd if rms else (resf - mean) * rstd


def layer_norm_bwd_reference(dy, res, weight, bias, mean, rstd, rms: bool,
                             from_y: bool):
    """Plain PyTorch version of the backward kernel (``_ln_bwd_math``).

    ``dy``, ``res``: ``(rows, hidden)`` of one dtype — ``res`` is the
    forward's input ``x``, or its output ``y`` when ``from_y``;
    ``weight``/``bias``: ``(hidden,)`` f32 (``bias`` is read only when
    ``from_y``); ``mean``/``rstd``: ``(rows, 1)`` f32 from the forward.
    Returns ``(dx in dy.dtype, dgamma (hidden,) f32, dbeta (hidden,) f32)``.
    """
    dyf = dy.to(_f32)
    xhat = _xhat(res, weight, bias, mean, rstd, rms, from_y)
    inv_h = 1.0 / dy.shape[1]
    wdy = dyf * weight
    c1 = torch.sum(wdy * xhat, dim=1, keepdim=True) * inv_h
    if rms:
        dx = (wdy - xhat * c1) * rstd
    else:
        c2 = torch.sum(wdy, dim=1, keepdim=True) * inv_h
        dx = (wdy - xhat * c1 - c2) * rstd
    return (dx.to(dy.dtype), torch.sum(dyf * xhat, dim=0),
            torch.sum(dyf, dim=0))


def layer_norm_bwd(dy, res, weight, bias, mean, rstd, rms: bool,
                   from_y: bool):
    """LayerNorm / RMSNorm backward over the rows of ``dy``.

    Same contract as :func:`layer_norm_bwd_reference`.  On a CUDA tensor
    the kernel runs: ``dy`` and ``res`` contiguous and of one dtype
    (f32/bf16/f16), the vectors contiguous f32, ``mean``/``rstd``
    contiguous ``(rows, 1)`` f32.  Each block of
    ``LN_BWD_ROWS_PER_BLOCK`` rows writes one f32 dgamma/dbeta partial
    row, and a second kernel sums the partials over blocks in a fixed
    order: no atomics, so a run repeats bit for bit.
    """
    if dy.device.type == "cpu":
        return layer_norm_bwd_reference(dy, res, weight, bias, mean, rstd,
                                        rms, from_y)
    if dy.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd: unsupported device {dy.device}")
    _check_rows("layer_norm_bwd", dy, res=res)
    rows, hidden = dy.shape
    _check_vectors("layer_norm_bwd", hidden, dy.device, weight=weight,
                   bias=bias if from_y else None)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.dtype != _f32 or t.numel() != rows or t.device != dy.device
                or not t.is_contiguous()):
            raise ValueError(f"layer_norm_bwd: {name} must be a contiguous "
                             f"({rows}, 1) f32 tensor on {dy.device}")
    code = _kernels.dtype_code(dy, "layer_norm_bwd")
    n_parts = max(1, -(-rows // LN_BWD_ROWS_PER_BLOCK))
    dx = torch.empty_like(dy)
    parts = torch.empty((2, n_parts, hidden), dtype=_f32, device=dy.device)
    sums = torch.empty((2, hidden), dtype=_f32, device=dy.device)
    rc = _kernels.lib().apex_layer_norm_bwd(
        dy.data_ptr(), res.data_ptr(), weight.data_ptr(),
        None if bias is None or not from_y else bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), parts.data_ptr(),
        sums.data_ptr(), rows, hidden, LN_BWD_ROWS_PER_BLOCK, int(rms),
        int(from_y), code, _kernels.stream())
    _kernels.check(rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, sums[0], sums[1]


layer_norm_bwd.launches = 0


class _NormAffine(torch.autograd.Function):
    """``y = norm(x) * gamma (+ beta)`` over ``(rows, hidden)`` with the
    kernel pair as forward and backward (the JAX ``_norm_affine`` VJP)."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps, rms, memory_efficient):
        y2, mean, rstd = layer_norm_fwd(x2, weight, bias, eps, rms)
        ctx.rms = rms
        ctx.from_y = memory_efficient
        ctx.has_bias = bias is not None
        ctx.save_for_backward(y2 if memory_efficient else x2, weight, bias,
                              mean, rstd)
        return y2

    @staticmethod
    def backward(ctx, dy2):
        res, weight, bias, mean, rstd = ctx.saved_tensors
        dy2 = dy2.to(res.dtype).contiguous()
        dx, dw, db = layer_norm_bwd(dy2, res, weight, bias, mean, rstd,
                                    ctx.rms, ctx.from_y)
        return dx, dw, db if ctx.has_bias else None, None, None, None


def _norm_affine(x, weight, bias, eps: float, rms: bool,
                 memory_efficient: bool = False):
    hidden = weight.numel()
    x2 = x.reshape(-1, hidden).contiguous()
    y2 = _NormAffine.apply(
        x2, weight.reshape(-1).to(_f32),
        None if bias is None else bias.reshape(-1).to(_f32), eps, rms,
        bool(memory_efficient))
    return y2.reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape=None, eps=1e-5,
                            memory_efficient=False):
    """apex ``fused_layer_norm_affine``: LN over the trailing dims with
    learnable gamma/beta; ``memory_efficient`` saves the output instead of
    the input for the backward."""
    return _norm_affine(x, weight, bias, float(eps), False, memory_efficient)


def fused_rms_norm_affine(x, weight, normalized_shape=None, eps=1e-5,
                          memory_efficient=False):
    """apex ``fused_rms_norm_affine``: RMSNorm with learnable gamma."""
    return _norm_affine(x, weight, None, float(eps), True, memory_efficient)


def _hidden(normalized_shape) -> int:
    hidden = 1
    for d in normalized_shape:
        hidden *= d
    return hidden


def fused_layer_norm(x, normalized_shape, eps=1e-5):
    """Non-affine LN (apex ``fused_layer_norm``)."""
    hidden = _hidden(normalized_shape)
    w = torch.ones((hidden,), dtype=_f32, device=x.device)
    b = torch.zeros((hidden,), dtype=_f32, device=x.device)
    return _norm_affine(x, w, b, float(eps), False)


def fused_rms_norm(x, normalized_shape, eps=1e-5):
    """Non-affine RMSNorm."""
    w = torch.ones((_hidden(normalized_shape),), dtype=_f32, device=x.device)
    return _norm_affine(x, w, None, float(eps), True)
