"""Int8 weight GEMM, the decode path's weight-bytes half — port of
``apex_tpu/ops/quant_gemm.py``.

* :func:`quantize_weight`: per-output-row symmetric int8 over the ``(out,
  in)`` weight layout, ``scale = amax(|row|) / 127`` (an all-zero row gets
  scale 1.0, so zeros round-trip exactly), ``round(w / scale)`` clipped to
  ``[-127, 127]``.  Bitwise the JAX function's output for the same f32
  weights, and deterministic.
* :func:`quant_gemm`: ``y = x @ dequant(w8, scale)^T`` in f32 over
  ``(..., k)``.  A CUDA tensor launches ``csrc/quant_gemm.cu``
  (counterpart of the Pallas ``_qgemm_kernel``), the kernel that
  :func:`qgemm_plan` names for the shape: bf16 or f32 x with ``k % 16 ==
  0`` and 16-byte aligned operands runs ``qgemm_tma`` (TMA + ``wgmma``,
  tokens on wgmma's N side, the int8 weights dequantized in registers as
  wgmma's A; f32 x as three bf16 parts, :func:`split_bf16x3_reference`,
  summed in f32, the scale applied after the sum); other shapes, a
  decode step's shorter contractions and f16 x take the ``mma.sync``
  kernels (bf16) and FMA tiles (f32 / f16).  A CPU tensor takes
  :func:`quant_gemm_reference`, the JAX reference's op order (dequantize
  to f32, cast to x's dtype, ``x @ w.T``, then f32).  Forward only: int8
  weights have no gradient.

The JAX signature's ``block_n`` / ``block_k`` are TPU tile sizes that only
change the order of f32 sums; the port drops them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

__all__ = ["quantize_weight", "dequantize_weight", "quant_gemm",
           "quant_gemm_reference", "QgemmPlan", "qgemm_plan",
           "qgemm_plan_for",
           "split_bf16x3_reference", "quant_gemm_split_reference"]

# csrc/quant_gemm.cu `QKernel` codes of the plan's kernels
QGEMM_KERNELS = {"qgemm_tma": 0, "qgemm_bf16_rows16": 1,
                 "qgemm_bf16_tiles": 2, "qgemm_fma": 3}
QGEMM_TMA_BN = (8, 16, 32, 64, 128)   # tokens per block of qgemm_tma
QGEMM_TMA_ROWS = 128                  # weight rows per block
QGEMM_TMA_BK = 64                     # contraction per stage
QGEMM_MAX_SPLIT = 8                   # blocks of a k-split cluster
QGEMM_NARROW_MIN_BN = 64              # the narrowest tile a wide one halves to
H100_SMS = 132                        # the planner's SM count off the card
# bf16 x of at most 16 rows (a decode step) takes the register-fed mma.sync
# kernel up to this contraction: faster there than the TMA kernel's setup
# (GPT-350M's qkv / proj / fc1, PERF.md §6); fc2 (k 4096) takes TMA
QGEMM_ROWS16_MAX_K = 1024


class QgemmPlan(NamedTuple):
    """The kernel one call takes: ``kernel`` (a ``QGEMM_KERNELS`` name);
    on ``qgemm_tma`` the tokens per block ``bn``, the k-split cluster size
    ``ks`` and the bf16 ``parts`` of x (3: f32 x split in three)."""
    kernel: str
    bn: int = 0
    ks: int = 1
    parts: int = 1


def quantize_weight(w):
    """``(out, in) -> (int8 (out, in), f32 (out,))`` per-output-row
    symmetric quantization; the per-element error is at most
    ``scale / 2``."""
    if w.ndim != 2:
        raise ValueError(f"quantize_weight expects a 2D (out, in) weight, "
                         f"got shape {tuple(w.shape)}")
    w32 = w.detach().to(_f32)
    amax = w32.abs().amax(dim=1)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_weight(w8, scale):
    """``w8 * scale[:, None]`` in f32, the reconstruction every consumer
    (kernel, reference, embedding gather) replays."""
    return w8.to(_f32) * scale[:, None].to(_f32)


def quant_gemm_reference(x, w8, scale):
    """Plain version on 2D ``x``: the f32 weight per output row, cast to
    x's dtype, ``x @ w.T`` (a bf16 product rounds its output to bf16, as
    the JAX reference's), returned in f32."""
    w = dequantize_weight(w8, scale)
    return (x @ w.to(x.dtype).t()).to(_f32)


def qgemm_plan(m, n, k, dtype, aligned, sms=H100_SMS, slots=None):
    """The kernel of a ``(m, k) x (n, k)^T`` call with x of ``dtype``;
    ``aligned``: w8 (and bf16 x, with its row pitch) on TMA's 16-byte
    grid.  Pure Python, by shape alone (no call falls back on failure):

    * bf16 x of at most 16 rows with ``k <= QGEMM_ROWS16_MAX_K``:
      ``qgemm_bf16_rows16`` (a decode step's qkv, proj, fc1);
    * bf16 or f32 x, ``aligned``, ``k`` a positive multiple of 16:
      ``qgemm_tma`` with ``bn`` the least of 8, 16, ..., 128 that holds
      ``m`` tokens (128 above), and a k split ``ks`` (1, 2, 4 or 8)
      doubled while each rank keeps at least two 64-wide k steps and every
      block fits on the card at once: ``sms`` blocks, or ``slots(bn,
      parts, ks)`` for clusters of ``ks`` (the card's count: a cluster's
      blocks share a GPC, so not every SM takes one).  A decode step's
      fc2 (1024 rows) gives 8 tiles of 128 rows.  Where the blocks fill
      at most half the card, tiles of half as many tokens (not below
      ``QGEMM_NARROW_MIN_BN``) if they give more blocks;
    * other bf16: the ``mma.sync`` kernels ``qgemm_bf16_rows16`` (m <=
      16) or ``qgemm_bf16_tiles``; other f32 and all f16: ``qgemm_fma``.
    """
    if dtype == torch.bfloat16 and m <= 16 and k <= QGEMM_ROWS16_MAX_K:
        return QgemmPlan("qgemm_bf16_rows16")
    if dtype in (torch.bfloat16, torch.float32) and aligned and k > 0 \
            and k % 16 == 0:
        parts = 1 if dtype == torch.bfloat16 else 3
        bn = next((b for b in QGEMM_TMA_BN if b >= m), QGEMM_TMA_BN[-1])
        ks = _split(m, n, k, bn, parts, sms, slots)
        # half the card idle: tiles of half the tokens (a prefill's proj
        # and fc2, 1024 weight rows at 512 tokens: 64 blocks, 128 narrow)
        if bn >= 2 * QGEMM_NARROW_MIN_BN and 2 * _blocks(m, n, bn, ks) <= sms:
            ks2 = _split(m, n, k, bn // 2, parts, sms, slots)
            if _blocks(m, n, bn // 2, ks2) > _blocks(m, n, bn, ks):
                bn, ks = bn // 2, ks2
        return QgemmPlan("qgemm_tma", bn, ks, parts)
    if dtype == torch.bfloat16:
        return QgemmPlan("qgemm_bf16_rows16" if m <= 16
                         else "qgemm_bf16_tiles")
    return QgemmPlan("qgemm_fma")


def _blocks(m, n, bn, ks):
    return -(-m // bn) * -(-n // QGEMM_TMA_ROWS) * ks


def _split(m, n, k, bn, parts, sms, slots):
    """The k split of qgemm_tma's tiles of ``bn`` tokens: doubled from 1
    while each rank keeps two 64-wide k steps and the card holds every
    block at once."""
    steps = -(-k // QGEMM_TMA_BK)
    ks = 1
    while 2 * ks <= QGEMM_MAX_SPLIT and steps >= 4 * ks:
        room = sms if slots is None else slots(bn, parts, 2 * ks)
        if _blocks(m, n, bn, 2 * ks) > room:
            break
        ks *= 2
    return ks


def split_bf16x3_reference(x):
    """f32 ``x`` as three bf16 parts ``(3, *x.shape)``, the plain version
    of the kernel's split pass: hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid) (each difference exact in f32), so hi + mid + lo is
    x to 2^-24 relative (bf16's subnormal step below its normal range).  A
    non-finite x rides in hi with mid = lo = 0; a finite x past bf16's
    largest finite gets the truncated hi."""
    x = x.to(_f32)
    hi = x.to(torch.bfloat16)
    big = torch.isinf(hi) & torch.isfinite(x)
    if bool(big.any()):
        cut = (x.view(torch.int32) & -65536).view(_f32)
        hi = torch.where(big, cut.to(torch.bfloat16), hi)
    fin = torch.isfinite(x)
    r1 = torch.where(fin, x - hi.to(_f32), 0.0)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(_f32)).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def quant_gemm_split_reference(x, w8, scale):
    """What ``qgemm_tma`` computes for f32 ``x``, in plain PyTorch: the
    three bf16 parts against the exact bf16 integers of ``w8``, summed in
    f32 (lo, mid, hi), the row scale applied after the sum."""
    q = w8.to(_f32).t()
    parts = split_bf16x3_reference(x).to(_f32)
    acc = parts[2] @ q + parts[1] @ q + parts[0] @ q
    return acc * scale.to(_f32)[None, :]


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _cluster_slots(index, bn, parts, ks):
    """The blocks of ``qgemm_tma`` in clusters of ``ks`` that card
    ``index`` holds at once (``cudaOccupancyMaxActiveClusters``)."""
    with torch.cuda.device(index):
        got = _kernels.lib().apex_quant_gemm_slots(bn, parts, ks)
    if got <= 0:
        raise RuntimeError(f"quant_gemm: no occupancy for bn {bn}, parts "
                           f"{parts}, clusters of {ks}")
    return got


@functools.lru_cache(maxsize=None)
def _plan_on(index, m, n, k, dtype, aligned):
    return qgemm_plan(m, n, k, dtype, aligned, _sm_count(index),
                      functools.partial(_cluster_slots, index))


def qgemm_plan_for(x2, w8):
    """:func:`qgemm_plan` of a call on the card: ``x2`` the 2-D ``(m, k)``
    CUDA operand (last dim contiguous), ``w8`` contiguous."""
    aligned = w8.data_ptr() % 16 == 0 and (
        x2.dtype == _f32 or (x2.data_ptr() % 16 == 0
                             and x2.stride(0) * x2.element_size() % 16 == 0))
    return _plan_on(x2.device.index or 0, x2.shape[0], w8.shape[0],
                    w8.shape[1], x2.dtype, aligned)


def quant_gemm(x, w8, scale):
    """``x @ dequant(w8, scale)^T`` over ``(..., k)``; returns f32
    ``(..., out)``.

    ``w8`` is int8 ``(out_features, in_features)`` with ``scale`` f32
    ``(out_features,)`` from :func:`quantize_weight`.  On CUDA ``x`` may
    be float32, bfloat16 or float16 with any leading dims; ``w8`` and
    ``scale`` must lie on x's device.
    """
    if w8.dtype != torch.int8:
        raise ValueError(f"w8 must be int8, got {w8.dtype}")
    if x.shape[-1] != w8.shape[1]:
        raise ValueError(f"x features {x.shape[-1]} != w8 in-dim "
                         f"{w8.shape[1]}")
    if tuple(scale.shape) != (w8.shape[0],):
        raise ValueError(f"scale shape {tuple(scale.shape)} != "
                         f"({w8.shape[0]},)")
    lead = x.shape[:-1]
    n, k = w8.shape
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        return quant_gemm_reference(x2, w8, scale).reshape(*lead, n)
    kernel = "quant_gemm"
    if not (x.device.type == "cuda" and w8.device == x.device
            and scale.device == x.device):
        raise ValueError(f"{kernel}: x, w8 and scale must be on one CUDA "
                         f"device, got {x.device}, {w8.device}, "
                         f"{scale.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{kernel} is a serving op with no backward; call it under "
            "torch.no_grad() (train with weight_quant=None)")
    code = _kernels.dtype_code(x, kernel)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    w8 = w8.contiguous()
    scale = scale.to(_f32).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=_f32, device=x.device)
    if m == 0:
        return y.reshape(*lead, n)
    plan = qgemm_plan_for(x2, w8)
    parts = (torch.empty((3, m, k), dtype=torch.bfloat16, device=x.device)
             if plan.parts == 3 else None)
    rc = _kernels.lib().apex_quant_gemm(
        x2.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if parts is None else parts.data_ptr(), m, n, k, x2.stride(0),
        QGEMM_KERNELS[plan.kernel], plan.bn, plan.ks, code,
        _kernels.stream())
    _kernels.check(rc, kernel)
    quant_gemm.launches += 1
    return y.reshape(*lead, n)


quant_gemm.launches = 0
