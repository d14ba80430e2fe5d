"""Int8 weight GEMM, the decode path's weight-bytes half — port of
``apex_tpu/ops/quant_gemm.py``.

* :func:`quantize_weight`: per-output-row symmetric int8 over the ``(out,
  in)`` weight layout, ``scale = amax(|row|) / 127`` (an all-zero row gets
  scale 1.0, so zeros round-trip exactly), ``round(w / scale)`` clipped to
  ``[-127, 127]``.  Bitwise the JAX function's output for the same f32
  weights, and deterministic.
* :func:`quant_gemm`: ``y = x @ dequant(w8, scale)^T`` in f32 over
  ``(..., k)``.  A CUDA tensor launches ``csrc/quant_gemm.cu``
  (counterpart of the Pallas ``_qgemm_kernel``: each weight dequantized in
  registers to f32, rounded to x's dtype, f32 accumulation; bf16 x on the
  tensor cores, f32 / f16 x on the FMA units); a CPU tensor takes
  :func:`quant_gemm_reference`, the JAX reference's op order (dequantize
  to f32, cast to x's dtype, ``x @ w.T``, then f32).  Forward only: int8
  weights have no gradient.

The JAX signature's ``block_n`` / ``block_k`` are TPU tile sizes that only
change the order of f32 sums; the port drops them.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

__all__ = ["quantize_weight", "dequantize_weight", "quant_gemm",
           "quant_gemm_reference"]


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
    row_bytes = x2.stride(0) * x2.element_size()
    vec_x = int(x2.data_ptr() % 16 == 0 and row_bytes % 16 == 0)
    vec_w = int(w8.data_ptr() % 16 == 0 and k % 16 == 0)
    rc = _kernels.lib().apex_quant_gemm(
        x2.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n,
        k, x2.stride(0), vec_x, vec_w, code, _kernels.stream())
    _kernels.check(rc, kernel)
    quant_gemm.launches += 1
    return y.reshape(*lead, n)


quant_gemm.launches = 0
