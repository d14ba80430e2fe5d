"""Fused LayerNorm / RMSNorm forward — port of ``apex_tpu/ops/layer_norm.py``.

Rows are normalized over the last (hidden) axis with the E[x^2] - E[x]^2
variance form in f32, exactly as the JAX kernel and its jnp fallback do.
:func:`layer_norm_fwd` is the kernel wrapper: a CPU tensor takes
:func:`layer_norm_fwd_reference`, a CUDA tensor launches
``csrc/layer_norm_fwd.cu`` (the counterpart of the Pallas ``_fwd_kernel``).

Forward only in this slice: the backward kernel (``_bwd_kernel``) comes
with the training slice, so the ops refuse inputs that need a gradient.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

__all__ = ["layer_norm_fwd", "layer_norm_fwd_reference",
           "fused_layer_norm_affine", "fused_rms_norm_affine",
           "fused_layer_norm", "fused_rms_norm"]


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


def layer_norm_fwd(x, weight, bias, eps: float, rms: bool):
    """LayerNorm (``rms=False``) or RMSNorm forward over the rows of ``x``.

    Same contract as :func:`layer_norm_fwd_reference`.  On a CUDA tensor
    the kernel runs (``x`` contiguous f32/bf16/f16, ``weight``/``bias``
    contiguous f32 on the same device); anything else it does not take
    raises.
    """
    _no_grad_check(x, weight, bias)
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, weight, bias, eps, rms)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("layer_norm_fwd: x must be a contiguous (rows, "
                         f"hidden) tensor, got shape {tuple(x.shape)}")
    rows, hidden = x.shape
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if (t.dtype != _f32 or t.shape != (hidden,) or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"layer_norm_fwd: {name} must be a contiguous "
                             f"f32 ({hidden},) tensor on {x.device}")
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


def _no_grad_check(*tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "apex_tpu_torch normalization is forward-only until the training "
            "slice ports the backward kernel; call it under torch.no_grad()")


def _norm_affine(x, weight, bias, eps: float, rms: bool):
    hidden = weight.numel()
    x2 = x.reshape(-1, hidden).contiguous()
    y2, _, _ = layer_norm_fwd(
        x2, weight.reshape(-1).to(_f32),
        None if bias is None else bias.reshape(-1).to(_f32), eps, rms)
    return y2.reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape=None, eps=1e-5,
                            memory_efficient=False):
    """apex ``fused_layer_norm_affine``: LN over the trailing dims with
    learnable gamma/beta (``memory_efficient`` only changes what the
    backward saves, and there is no backward yet)."""
    return _norm_affine(x, weight, bias, float(eps), False)


def fused_rms_norm_affine(x, weight, normalized_shape=None, eps=1e-5,
                          memory_efficient=False):
    """apex ``fused_rms_norm_affine``: RMSNorm with learnable gamma."""
    return _norm_affine(x, weight, None, float(eps), True)


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
