"""Fused LM-head cross entropy without logits — port of
``apex_tpu/ops/lm_head.py``.

Per token ``i`` with target ``y``: ``loss_i = lse_i - x_i . W_y`` with
``lse_i = logsumexp_v(x_i . W_v)``.  The ``(N, V)`` logits never reach
device memory: the forward keeps an online logsumexp over vocab tiles, and
the backward recomputes ``p = exp(x . W_v - lse)`` tile by tile from the
saved per-token ``lse``.  With upstream cotangent ``g``:
``dS = (p - onehot(y)) g``, ``dX = dS W`` and ``dW = dS^T X``.

Three kernel wrappers, each with its plain PyTorch version beside it:

* :func:`lm_head_fwd` (``csrc/lm_head_fwd.cu``, the Pallas ``_fwd_kernel``)
  returns ``(loss, lse)``; a CPU tensor takes :func:`lm_head_fwd_reference`;
* :func:`lm_head_dx` (``csrc/lm_head_bwd.cu``, ``_dx_kernel``); a CPU tensor
  takes :func:`lm_head_dx_reference`;
* :func:`lm_head_dw` (``csrc/lm_head_bwd.cu``, ``_dw_kernel``); a CPU tensor
  takes :func:`lm_head_dw_reference`.

:func:`fused_linear_cross_entropy` is the public op, a
:class:`torch.autograd.Function` over the three.  The plain versions take
the kernels' own casts (operands in :func:`_dot_dtype`, ``dS`` rounded to
it before the two backward products); the materialized reference the tests
hold everything to is :func:`fused_linear_cross_entropy_reference`.

The JAX signature's ``block_t`` / ``block_v`` are TPU tile sizes that only
change the order of f32 sums; the port drops them.  The CUDA kernels fix
their own tiles (32 rows of the resident operand, 64 of the streamed one)
and the forward's split of the vocab (``apex_lm_head_fwd_splits``).

A bf16 pair runs on the tensor cores.  Any other pair (f32, f16, or a
mixed pair, for which :func:`_dot_dtype` gives f32) runs the kernels' f32
instantiation, the reference's own math (f32 products, no rounding of
``dS``), on the same tiles with the products on the FMA units: on an H100
its bound is 15x the bf16 one (67 against 989 TFLOPS), and at GPT-350M's
head it takes about ten times the f32 head GEMMs and cross entropy of
``fused_lm_head=False`` (PERF.md), so an f32 model trains faster on the
card without the fused head.  The JAX package routes f16 to its
materialized reference (Mosaic has no f16).
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

# the bf16 tensor-core kernels keep whole rows of their operand tiles in
# shared memory (csrc/lm_head.cuh kHMax; the C entry points refuse more too)
MMA_MAX_HIDDEN = 1024

__all__ = ["fused_linear_cross_entropy",
           "fused_linear_cross_entropy_reference", "lm_head_fwd",
           "lm_head_fwd_reference", "lm_head_dx", "lm_head_dx_reference",
           "lm_head_dw", "lm_head_dw_reference"]


def _dot_dtype(x_dtype, w_dtype):
    """Operand dtype for the logit dots: bf16 only when BOTH operands are
    bf16 (accumulation stays f32); a mixed or f32 pair computes in f32, so
    that f32 hidden states with a bf16 tied embedding keep their operand
    precision in the loss and both gradient products (ADVICE round 5 of
    the JAX package).  f16 operands also compute in f32."""
    if x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16:
        return torch.bfloat16
    return _f32


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def fused_linear_cross_entropy_reference(x, w, targets):
    """Materialized reference: ``-log_softmax(x @ w.T)[targets]`` in f32."""
    logits = x.to(_f32) @ w.to(_f32).t()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, targets.reshape(-1, 1).long())[:, 0]


def _scores(x, w):
    """``x . W^T`` in f32 from operands rounded to :func:`_dot_dtype` (the
    products of two bf16 values are exact in f32, as on the tensor cores)."""
    dt = _dot_dtype(x.dtype, w.dtype)
    return x.to(dt).to(_f32) @ w.to(dt).to(_f32).t(), dt


def _hit(targets, v):
    """``(N, V)`` bool: column ``v`` is the row's target; a target outside
    ``[0, V)`` matches no column."""
    cols = torch.arange(v, device=targets.device)
    return cols[None, :] == targets.reshape(-1, 1).long()


def lm_head_fwd_reference(x, w, targets):
    """Plain version of the forward kernel: ``(loss, lse)``, both ``(N,)``
    f32.  A row whose target is outside ``[0, V)`` has loss ``lse``."""
    s, _ = _scores(x, w)
    lse = torch.logsumexp(s, dim=1)
    tgt = torch.sum(torch.where(_hit(targets, w.shape[0]), s, 0.0), dim=1)
    return lse - tgt, lse


def _ds(x, w, targets, lse, g):
    """``dS = (exp(S - lse) - onehot) g`` in f32, rounded to the operand
    dtype as the kernels round it before the backward products."""
    s, dt = _scores(x, w)
    p = torch.exp(s - lse.reshape(-1, 1))
    ds = (p - _hit(targets, w.shape[0]).to(_f32)) * g.to(_f32).reshape(-1, 1)
    return ds.to(dt).to(_f32), dt


def lm_head_dx_reference(x, w, targets, lse, g):
    """Plain version of the dX kernel: ``dS W`` in x's dtype."""
    ds, dt = _ds(x, w, targets, lse, g)
    return (ds @ w.to(dt).to(_f32)).to(x.dtype)


def lm_head_dw_reference(x, w, targets, lse, g):
    """Plain version of the dW kernel: ``dS^T X`` in w's dtype."""
    ds, dt = _ds(x, w, targets, lse, g)
    return (ds.t() @ x.to(dt).to(_f32)).to(w.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _use_mma(x, w):
    return _dot_dtype(x.dtype, w.dtype) == torch.bfloat16


def _check_operands(kernel, x, w, targets):
    """Shapes, dtypes, device and layout the CUDA kernels take; returns
    ``(targets as int32, (x dtype code, w dtype code))``."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{kernel}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be (N, H) and (V, H)")
    if targets.shape != (x.shape[0],):
        raise ValueError(f"{kernel}: targets must be ({x.shape[0]},), got "
                         f"{tuple(targets.shape)}")
    if not (x.is_cuda and w.device == x.device
            and targets.device == x.device):
        raise ValueError(f"{kernel}: x, w and targets must be on one CUDA "
                         f"device, got {x.device}, {w.device}, "
                         f"{targets.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{kernel}: x and w must be contiguous")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise TypeError(f"{kernel}: targets must be integers")
    codes = (_kernels.dtype_code(x, kernel), _kernels.dtype_code(w, kernel))
    if _use_mma(x, w):
        h = x.shape[1]
        if h % 8 or h > MMA_MAX_HIDDEN:
            raise NotImplementedError(
                f"{kernel}: the bf16 kernels take a hidden size that is a "
                f"multiple of 8 and at most {MMA_MAX_HIDDEN}, got {h}")
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError(f"{kernel}: x and w must be 16-byte aligned")
    return targets.to(torch.int32).contiguous(), codes


def _check_rows(kernel, n, device, **rows):
    for name, t in rows.items():
        if (t.dtype != _f32 or t.shape != (n,) or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be a contiguous ({n},) "
                             f"f32 tensor on {device}")


def lm_head_fwd(x, w, targets):
    """Forward kernel wrapper: ``x`` ``(N, H)``, ``w`` ``(V, H)``,
    ``targets`` ``(N,)`` int.  Returns ``(loss, lse)``, both ``(N,)`` f32.
    Two launches: the split online logsumexp, then the fixed-order combine
    of its per-split partials (both counted).  A CPU tensor takes
    :func:`lm_head_fwd_reference`."""
    if x.device.type == "cpu":
        return lm_head_fwd_reference(x, w, targets)
    tgt, (cx, cw) = _check_operands("lm_head_fwd", x, w, targets)
    n, h = x.shape
    v = w.shape[0]
    loss = torch.empty(n, dtype=_f32, device=x.device)
    lse = torch.empty(n, dtype=_f32, device=x.device)
    if n == 0:
        return loss, lse
    lib = _kernels.lib()
    splits = lib.apex_lm_head_fwd_splits(n, v, _kernels.sm_count(x.device.index or 0))
    partials = torch.empty((3, splits, n), dtype=_f32, device=x.device)
    rc = lib.apex_lm_head_fwd(
        x.data_ptr(), w.data_ptr(), tgt.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), partials.data_ptr(), n, v, h, splits, cx, cw,
        _kernels.stream())
    _kernels.check(rc, "lm_head_fwd")
    lm_head_fwd.launches += 2
    return loss, lse


lm_head_fwd.launches = 0


def _bwd(kernel, entry, x, w, targets, lse, g, out):
    tgt, (cx, cw) = _check_operands(kernel, x, w, targets)
    n, h = x.shape
    _check_rows(kernel, n, x.device, lse=lse, g=g)
    if out.numel() == 0:
        return out
    rc = getattr(_kernels.lib(), entry)(
        x.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
        g.data_ptr(), out.data_ptr(), n, w.shape[0], h, cx, cw,
        _kernels.stream())
    _kernels.check(rc, kernel)
    return out


def lm_head_dx(x, w, targets, lse, g):
    """dX kernel wrapper: ``dS W`` with ``dS`` recomputed from ``lse``
    (``(N,)`` f32) and scaled by the per-token cotangent ``g`` (``(N,)``
    f32).  Returns ``(N, H)`` in x's dtype.  A CPU tensor takes
    :func:`lm_head_dx_reference`."""
    if x.device.type == "cpu":
        return lm_head_dx_reference(x, w, targets, lse, g)
    out = _bwd("lm_head_dx", "apex_lm_head_dx", x, w, targets, lse, g,
               torch.empty_like(x))
    lm_head_dx.launches += out.numel() > 0
    return out


lm_head_dx.launches = 0


def lm_head_dw(x, w, targets, lse, g):
    """dW kernel wrapper: ``dS^T X``, each row of W's gradient summed over
    all tokens by one block in a fixed order (no atomics).  Returns
    ``(V, H)`` in w's dtype.  A CPU tensor takes
    :func:`lm_head_dw_reference`."""
    if x.device.type == "cpu":
        return lm_head_dw_reference(x, w, targets, lse, g)
    out = torch.empty_like(w)
    if x.shape[0] == 0:
        return out.zero_()
    out = _bwd("lm_head_dw", "apex_lm_head_dw", x, w, targets, lse, g, out)
    lm_head_dw.launches += out.numel() > 0
    return out


lm_head_dw.launches = 0


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """Forward kernel, then the dX and dW kernels (the JAX ``_fused``
    custom VJP).  Saves ``(x, w, targets, lse)``."""

    @staticmethod
    def forward(ctx, x, w, targets):
        loss, lse = lm_head_fwd(x, w, targets)
        ctx.save_for_backward(x, w, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        g = g.to(_f32).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = lm_head_dx(x, w, targets, lse, g)
        if ctx.needs_input_grad[1]:
            dw = lm_head_dw(x, w, targets, lse, g)
        return dx, dw, None


def fused_linear_cross_entropy(x, w, targets):
    """Per-token cross entropy of the tied LM head WITHOUT materializing
    logits.

    ``x``: ``(N, H)`` hidden states; ``w``: ``(V, H)`` (the tied
    embedding); ``targets``: ``(N,)`` int (a target outside ``[0, V)``
    matches no column: that row's loss is its logsumexp).  Returns the
    per-token loss ``(N,)`` f32, differentiable in ``x`` and ``w``.
    Memory is O(N·H + V·H) instead of O(N·V).
    """
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"fused_linear_cross_entropy: x {tuple(x.shape)} "
                         f"and w {tuple(w.shape)} must be (N, H) and (V, H)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_linear_cross_entropy: unsupported device "
                         f"{x.device}")
    return _FusedLinearCrossEntropy.apply(x, w, targets.reshape(-1))
