"""Fused LM-head cross entropy without logits — port of
``apex_tpu/ops/lm_head.py``.

Per token ``i`` with target ``y``: ``loss_i = lse_i - x_i . W_y`` with
``lse_i = logsumexp_v(x_i . W_v)``.  The ``(N, V)`` logits never reach
device memory: the forward reduces each vocab tile's scores to per-row
partials of the logsumexp and combines them, and the backward recomputes
``p = exp(x . W_v - lse)`` from the saved per-token ``lse``, one vocab
chunk at a time.  With upstream cotangent
``g``: ``dS = (p - onehot(y)) g``, ``dX = dS W`` and ``dW = dS^T X``.

Kernel wrappers, each with its plain PyTorch version beside it:

* :func:`lm_head_fwd` (``csrc/lm_head_fwd.cu``, the Pallas ``_fwd_kernel``)
  returns ``(loss, lse)``; a CPU tensor takes :func:`lm_head_fwd_reference`;
* :func:`lm_head_dx` (``csrc/lm_head_bwd.cu``, ``_dx_kernel``); a CPU tensor
  takes :func:`lm_head_dx_reference`;
* :func:`lm_head_dw` (``csrc/lm_head_bwd.cu``, ``_dw_kernel``); a CPU tensor
  takes :func:`lm_head_dw_reference`;
* :func:`lm_head_bwd`, both backward kernels in one call (``(dX, dW)``,
  the JAX ``_bwd_impl``); a CPU tensor takes :func:`lm_head_bwd_reference`.

On the card the forward is one launch of the tiled GEMM of
``csrc/gemm.cuh``, ``x W^T``, whose epilogue reduces each row of each
column tile of the scores to a partial (max, sum of exponentials, target
score), then a launch that combines each row's partials in tile order.
The backward is launches of the same GEMM over the chunks of
:func:`bwd_chunk_plan`: per chunk
``dS_c`` from ``x W_c^T`` (its epilogue takes the softmax and the target),
then ``dX += dS_c W_c`` (summed in f32 across chunks, rounded to x's dtype
once) and ``dW_c = dS_c^T x``.  :func:`lm_head_bwd` computes ``dS_c``
once for both; :func:`lm_head_dx` and :func:`lm_head_dw` alone each run
their own (``csrc/lm_head_bwd.cu``'s header).

:func:`fused_linear_cross_entropy` is the public op, a
:class:`torch.autograd.Function` over the kernels.  The plain versions
take the kernels' own casts (operands in :func:`_dot_dtype`, ``dS``
rounded to it before the two backward products); the materialized
reference the tests hold everything to is
:func:`fused_linear_cross_entropy_reference`.

The JAX signature's ``block_t`` / ``block_v`` are TPU tile sizes that only
change the order of f32 sums; the port drops them.  The forward's column
tiles are the GEMM's (``apex_lm_head_fwd_tiles``).

A bf16 pair runs on the tensor cores (TMA + ``wgmma``), or off TMA's
16-byte grid (a hidden size that is not a multiple of 8, an unaligned
operand) on the GEMM's FMA tile in f32 arithmetic.  Any other pair (f32,
f16, or a mixed pair, for which :func:`_dot_dtype` gives f32) runs the
reference's own math (f32 products, no rounding of ``dS``) on operands the
wrappers cast to f32 (exact), on the GEMM's FMA tile.  On an H100 that
bound is 15x the bf16 one (67 against 989 TFLOPS), and a logit-free f32
backward (three products) cannot beat the two of ``fused_lm_head=False``
(PERF.md).  The JAX package routes f16 to its materialized reference
(Mosaic has no f16).  Both directions take any hidden size and alignment.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

# the backward's dS scratch: one vocab chunk of at most this many bytes
DS_CHUNK_BYTES = 128 * 2 ** 20
# chunk widths are multiples of CHUNK_GRID (csrc/lm_head_bwd.cu kChunkGrid:
# dS's rows stay 16-byte multiples), and of the GEMM's wide tile where that
# fits the byte cap
CHUNK_GRID = 64
CHUNK_TILE = 256

__all__ = ["fused_linear_cross_entropy",
           "fused_linear_cross_entropy_reference", "lm_head_fwd",
           "lm_head_fwd_reference", "lm_head_dx", "lm_head_dx_reference",
           "lm_head_dw", "lm_head_dw_reference", "lm_head_bwd",
           "lm_head_bwd_reference", "bwd_chunk_plan"]


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


def lm_head_bwd_reference(x, w, targets, lse, g):
    """Plain version of the whole backward: ``(dX, dW)`` as
    :func:`lm_head_dx_reference` and :func:`lm_head_dw_reference` give
    them, from one ``dS``."""
    ds, dt = _ds(x, w, targets, lse, g)
    return ((ds @ w.to(dt).to(_f32)).to(x.dtype),
            (ds.t() @ x.to(dt).to(_f32)).to(w.dtype))


# ---------------------------------------------------------------------------
# the backward's vocab chunks
# ---------------------------------------------------------------------------

def _round_up(a, b):
    return -(-a // b) * b


class ChunkPlan(NamedTuple):
    """The backward's vocab chunks: ``width`` columns each (the dS
    scratch is ``(N, width)``), ``chunks`` as ``(v0, valid, padded)``:
    columns ``[v0, v0 + valid)`` of the vocab, ``padded`` (``valid``
    rounded up to :data:`CHUNK_GRID`) columns of dS."""
    width: int
    chunks: tuple

    def launches(self, call):
        """(``lm_head_dx``, ``lm_head_dw``) launches of one ``"dx"``,
        ``"dw"`` or ``"bwd"`` call: per chunk dS and dX, dS and dW, or dS
        and dX on the first with dW on the second."""
        per = dict(dx=(2, 0), dw=(0, 2), bwd=(2, 1))[call]
        return tuple(len(self.chunks) * k for k in per)


def bwd_chunk_plan(n, v, ds_itemsize):
    """Chunks of a vocab of ``v`` columns for ``n`` tokens whose dS takes
    ``ds_itemsize`` bytes an entry: ``width`` the largest multiple of
    :data:`CHUNK_TILE` (of :data:`CHUNK_GRID` where the cap is narrower,
    at least one grid) with ``n * width * ds_itemsize <=``
    :data:`DS_CHUNK_BYTES`, then evened out over the chunks that many
    columns need.  8192 bf16 tokens: 8192 columns at most, 7 chunks of
    GPT-350M's 50304 and 4 of BERT-large's 30528."""
    cap = DS_CHUNK_BYTES // (max(n, 1) * ds_itemsize)
    unit = CHUNK_TILE if cap >= CHUNK_TILE else CHUNK_GRID
    cap = max(CHUNK_GRID, cap // unit * unit)
    count = max(1, -(-v // cap))
    width = min(cap, _round_up(-(-max(v, 1) // count), unit))
    chunks = tuple((v0, min(width, v - v0),
                    _round_up(min(width, v - v0), CHUNK_GRID))
                   for v0 in range(0, v, width))
    return ChunkPlan(width, chunks)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

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
    Two launches: the product with its per-tile row partials, then the
    fixed-order combine (both counted).  A CPU tensor takes
    :func:`lm_head_fwd_reference`."""
    if x.device.type == "cpu":
        return lm_head_fwd_reference(x, w, targets)
    tgt, _ = _check_operands("lm_head_fwd", x, w, targets)
    n, h = x.shape
    v = w.shape[0]
    loss = torch.empty(n, dtype=_f32, device=x.device)
    lse = torch.empty(n, dtype=_f32, device=x.device)
    if n == 0:
        return loss, lse
    dt = _dot_dtype(x.dtype, w.dtype)
    # every pair but bf16 / bf16 runs on f32 operands (exact casts: JAX
    # casts inside its kernel)
    xo, wo = x.to(dt), w.to(dt)
    code = _kernels.DTYPE_CODES[dt]
    lib = _kernels.lib()
    tiles = lib.apex_lm_head_fwd_tiles(xo.data_ptr(), wo.data_ptr(), v, h,
                                       code)
    partials = torch.empty((3, tiles, n), dtype=_f32, device=x.device)
    rc = lib.apex_lm_head_fwd(
        xo.data_ptr(), wo.data_ptr(), tgt.data_ptr(), loss.data_ptr(),
        lse.data_ptr(), partials.data_ptr(), n, v, h, tiles, code,
        _kernels.stream())
    _kernels.check(rc, "lm_head_fwd")
    lm_head_fwd.launches += 2
    return loss, lse


lm_head_fwd.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bwd(kernel, x, w, targets, lse, g, want_dx, want_dw):
    """One ``apex_lm_head_bwd`` call: per chunk of :func:`bwd_chunk_plan`
    the dS launch, then dX's if ``want_dx`` and dW's if ``want_dw``.
    Returns ``(dx, dw, plan)``, None where not asked (plan None: nothing
    launched, at zero tokens, vocab or hidden size)."""
    tgt, _ = _check_operands(kernel, x, w, targets)
    n, h = x.shape
    v = w.shape[0]
    _check_rows(kernel, n, x.device, lse=lse, g=g)
    dx = torch.empty_like(x) if want_dx else None
    dw = torch.empty_like(w) if want_dw else None
    if n == 0 or v == 0 or h == 0:
        return (None if dx is None else dx.zero_(),
                None if dw is None else dw.zero_(), None)
    dt = _dot_dtype(x.dtype, w.dtype)
    # every pair but bf16 / bf16 runs on f32 operands (exact casts: JAX
    # casts inside its kernels), and keeps dS in f32
    xo, wo = x.to(dt), w.to(dt)
    plan = bwd_chunk_plan(n, v, dt.itemsize)
    ds = torch.empty(n * plan.width, dtype=dt, device=x.device)
    partial = None
    if want_dx and len(plan.chunks) > 1:
        partial = torch.empty((n, h), dtype=_f32, device=x.device)
    codes = _kernels.DTYPE_CODES
    rc = _kernels.lib().apex_lm_head_bwd(
        xo.data_ptr(), wo.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
        g.data_ptr(), _ptr(dx), _ptr(dw), ds.data_ptr(), _ptr(partial), n,
        v, h, plan.width, codes[dt], codes[x.dtype], codes[w.dtype],
        _kernels.stream())
    _kernels.check(rc, kernel)
    return dx, dw, plan


def _count(plan, call):
    if plan is not None:
        dx, dw = plan.launches(call)
        lm_head_dx.launches += dx
        lm_head_dw.launches += dw


def lm_head_dx(x, w, targets, lse, g):
    """dX kernel wrapper: ``dS W`` with ``dS`` recomputed from ``lse``
    (``(N,)`` f32) and scaled by the per-token cotangent ``g`` (``(N,)``
    f32).  Returns ``(N, H)`` in x's dtype.  Two launches a vocab chunk,
    both counted: dS, then dX.  A CPU tensor takes
    :func:`lm_head_dx_reference`."""
    if x.device.type == "cpu":
        return lm_head_dx_reference(x, w, targets, lse, g)
    dx, _, plan = _bwd("lm_head_dx", x, w, targets, lse, g, True, False)
    _count(plan, "dx")
    return dx


lm_head_dx.launches = 0


def lm_head_dw(x, w, targets, lse, g):
    """dW kernel wrapper: ``dS^T X``, each entry summed over all tokens by
    one block in a fixed order (no atomics).  Returns ``(V, H)`` in w's
    dtype.  Two launches a vocab chunk, both counted: dS, then dW.  A CPU
    tensor takes :func:`lm_head_dw_reference`."""
    if x.device.type == "cpu":
        return lm_head_dw_reference(x, w, targets, lse, g)
    _, dw, plan = _bwd("lm_head_dw", x, w, targets, lse, g, False, True)
    _count(plan, "dw")
    return dw


lm_head_dw.launches = 0


def lm_head_bwd(x, w, targets, lse, g):
    """The whole backward in one call: ``(dX, dW)``, each as
    :func:`lm_head_dx` and :func:`lm_head_dw` give it (the same bits),
    with dS computed once a vocab chunk: dS and dX count on
    ``lm_head_dx.launches``, dW on ``lm_head_dw.launches``.  A CPU tensor
    takes :func:`lm_head_bwd_reference`."""
    if x.device.type == "cpu":
        return lm_head_bwd_reference(x, w, targets, lse, g)
    dx, dw, plan = _bwd("lm_head_bwd", x, w, targets, lse, g, True, True)
    _count(plan, "bwd")
    return dx, dw


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """Forward kernel, then the backward kernels, in one
    :func:`lm_head_bwd` call where both gradients are needed (the JAX
    ``_fused`` custom VJP).  Saves ``(x, w, targets, lse)``."""

    @staticmethod
    def forward(ctx, x, w, targets):
        loss, lse = lm_head_fwd(x, w, targets)
        ctx.save_for_backward(x, w, targets, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        g = g.to(_f32).contiguous()
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_dx and need_dw:
            dx, dw = lm_head_bwd(x, w, targets, lse, g)
        elif need_dx:
            dx = lm_head_dx(x, w, targets, lse, g)
        elif need_dw:
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
