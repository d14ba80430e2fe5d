"""Fused LayerNorm / RMSNorm — port of ``apex_tpu/ops/layer_norm.py``.

Rows are normalized over the last (hidden) axis with the E[x^2] - E[x]^2
variance form in f32, exactly as the JAX kernels and their jnp fallback do.

* :func:`layer_norm_fwd` is the forward kernel wrapper: a CPU tensor takes
  :func:`layer_norm_fwd_reference`, a CUDA tensor launches
  ``csrc/layer_norm_fwd.cu`` (the counterpart of the Pallas ``_fwd_kernel``)
  with the body :func:`layer_norm_fwd_path` picks: a row per warp held in
  registers, or a block per row for any other shape.
* :func:`layer_norm_bwd` is the backward kernel wrapper: a CPU tensor takes
  :func:`layer_norm_bwd_reference`, a CUDA tensor launches
  ``csrc/layer_norm_bwd.cu`` (the counterpart of ``_bwd_kernel``) with the
  body :func:`layer_norm_bwd_path` picks (a row per warp held in
  registers, or a block per tile of rows): dx plus per-block dgamma/dbeta
  partials (:func:`layer_norm_bwd_parts`), reduced across blocks in a
  second pass.

The affine ops are a :class:`torch.autograd.Function` over the two.  Like
the JAX custom VJP it saves the input, or with ``memory_efficient=True``
the output ``y``, from which the backward rebuilds the normalized value as
``(y - beta) / gamma`` (RMS: ``y / gamma``; a zero gamma is guarded).
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

# rows of dy/x each block of the backward's block body reduces into one
# partial dgamma/dbeta row (csrc/layer_norm_bwd.cu)
LN_BWD_ROWS_PER_BLOCK = 16
# warps of a block of the backward's row-per-warp body, the row elements a
# lane holds in registers and the blocks resident on an SM
# (csrc/layer_norm_bwd.cu kLnBwdWarps, kLnBwdMaxLaneElems,
# kLnBwdBlocksPerSm)
LN_BWD_WARPS = 8
LN_BWD_LANE_ELEMS = 32
LN_BWD_BLOCKS_PER_SM = 2
# row elements a lane of the forward's row-per-warp body holds in registers
# (csrc/layer_norm_fwd.cu kLnMaxLaneElems)
LN_FWD_LANE_ELEMS = 32

__all__ = ["layer_norm_fwd", "layer_norm_fwd_reference",
           "layer_norm_fwd_path", "layer_norm_bwd",
           "layer_norm_bwd_reference", "layer_norm_bwd_path",
           "layer_norm_bwd_parts", "fused_layer_norm_affine",
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


def _warp_path(hidden, dtype, aligned, lane_elems):
    per_vec = 16 // dtype.itemsize
    if not aligned or hidden % per_vec:
        return 0
    nv = -(-hidden // (32 * per_vec))
    return nv if nv * per_vec <= lane_elems else 0


def layer_norm_fwd_path(hidden: int, dtype: torch.dtype, aligned: bool) -> int:
    """The forward kernel's body for rows of ``hidden`` elements of
    ``dtype``: the 16-byte vectors each lane holds in the row-per-warp body
    (a row split into ``16 / itemsize``-element vectors, vector ``v`` on
    lane ``v % 32``), or 0 for the block-per-row body.  The row-per-warp
    body needs ``aligned`` (x, weight and bias on the 16-byte grid), hidden
    a whole number of vectors and at most :data:`LN_FWD_LANE_ELEMS`
    elements a lane (hidden <= 1024 in every dtype)."""
    return _warp_path(hidden, dtype, aligned, LN_FWD_LANE_ELEMS)


def layer_norm_bwd_path(hidden: int, dtype: torch.dtype, aligned: bool) -> int:
    """The backward kernel's body, by the forward's rule
    (:func:`layer_norm_fwd_path`) with :data:`LN_BWD_LANE_ELEMS`: the
    16-byte vectors each lane holds in the row-per-warp body, or 0 for the
    block body.  ``aligned``: dy, the residual, dx, weight and (read under
    ``from_y``) bias on the 16-byte grid."""
    return _warp_path(hidden, dtype, aligned, LN_BWD_LANE_ELEMS)


def layer_norm_bwd_parts(rows: int, nv: int, sms: int) -> int:
    """Blocks of the backward kernel, one f32 dgamma/dbeta partial row
    each: for the row-per-warp body (``nv`` > 0) one wave of at most
    :data:`LN_BWD_BLOCKS_PER_SM` blocks an SM (``sms`` SMs), their
    :data:`LN_BWD_WARPS` warps striding over the rows (warp ``k`` of block
    ``b`` takes rows ``b * LN_BWD_WARPS + k``, then every ``parts *
    LN_BWD_WARPS`` rows); for the block body one block per
    :data:`LN_BWD_ROWS_PER_BLOCK` rows."""
    if nv:
        return max(1, min(-(-rows // LN_BWD_WARPS),
                          sms * LN_BWD_BLOCKS_PER_SM))
    return max(1, -(-rows // LN_BWD_ROWS_PER_BLOCK))


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
    nv = layer_norm_fwd_path(hidden, x.dtype, all(
        t.data_ptr() % 16 == 0 for t in (x, weight, bias) if t is not None))
    y = torch.empty_like(x)
    mean = torch.empty((rows, 1), dtype=_f32, device=x.device)
    rstd = torch.empty((rows, 1), dtype=_f32, device=x.device)
    rc = _kernels.lib().apex_layer_norm_fwd(
        x.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps), int(rms),
        code, nv, _kernels.stream())
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
    contiguous ``(rows, 1)`` f32, with the body
    :func:`layer_norm_bwd_path` picks.  Each block
    (:func:`layer_norm_bwd_parts`) writes one f32 dgamma/dbeta partial
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
    dx = torch.empty_like(dy)
    nv = layer_norm_bwd_path(hidden, dy.dtype, all(
        t.data_ptr() % 16 == 0 for t in (dy, res, dx, weight,
                                         bias if from_y else None)
        if t is not None))
    n_parts = layer_norm_bwd_parts(rows, nv,
                                   _kernels.sm_count(dy.device.index))
    parts = torch.empty((2, n_parts, hidden), dtype=_f32, device=dy.device)
    sums = torch.empty((2, hidden), dtype=_f32, device=dy.device)
    rc = _kernels.lib().apex_layer_norm_bwd(
        dy.data_ptr(), res.data_ptr(), weight.data_ptr(),
        None if bias is None or not from_y else bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), parts.data_ptr(),
        sums.data_ptr(), rows, hidden, n_parts, int(rms), int(from_y), code,
        nv, _kernels.stream())
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
