"""Flash attention forward and single-query decode attention — port of
``apex_tpu/ops/flash_attention.py`` (the parts the serving path runs).

* :func:`flash_attention` over ``(batch, heads, seq, head_dim)``: causal or
  not, optional per-batch ``kv_seqlens``.  A CUDA tensor launches
  ``csrc/flash_fwd.cu`` (counterpart of the Pallas ``_fwd_kernel``); a CPU
  tensor takes :func:`flash_attention_reference`.
* :func:`flash_attention_decode`: one query token per sequence against a
  ``(batch, max_seq, heads, head_dim)`` cache masked by ``cache_lens``.  A
  CUDA tensor launches ``csrc/flash_decode.cu`` (counterpart of the Pallas
  ``_decode_kernel``); a CPU tensor takes
  :func:`flash_attention_decode_reference`.

Both keep the JAX numerics: f32 scores and accumulation whatever the input
dtype, the finite mask value ``_MASK`` and the ``l == 0`` guard, so a fully
masked row yields 0.  Forward only: the backward kernels and probability
dropout come with the training slice.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32
_MASK = -1e30  # finite "minus infinity": exp(_MASK - m) == 0, no NaNs

# head dims the CUDA kernels are instantiated for
FLASH_HEAD_DIMS = (16, 32, 64)
DECODE_HEAD_DIMS = (16, 32, 64, 128)

__all__ = ["flash_attention", "flash_attention_reference", "flash_fwd",
           "flash_attention_decode", "flash_attention_decode_reference"]


def _no_grad_check(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "apex_tpu_torch attention is forward-only until the training "
            "slice ports the backward kernels; call it under torch.no_grad()")


def _softmax_scale(softmax_scale, head_dim) -> float:
    return float(softmax_scale if softmax_scale is not None
                 else head_dim ** -0.5)


def flash_attention_reference(q, k, v, causal=False, softmax_scale=None,
                              kv_seqlens=None):
    """Materialized-scores reference with the kernel's masking semantics
    (f32 scores; a fully masked row yields 0)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = _softmax_scale(softmax_scale, d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(_f32), k.to(_f32)) * scale
    k_pos = torch.arange(sk, device=q.device)
    if kv_seqlens is None:
        valid = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=q.device)
    else:
        valid = (k_pos[None, :] < kv_seqlens.to(q.device)[:, None]
                 )[:, None, None, :]
    if causal:
        valid = valid & (k_pos[None, None, None, :]
                         <= torch.arange(sq, device=q.device)[None, None, :,
                                                              None])
    s = torch.where(valid, s, _MASK)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _check_last_dim(name, t):
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last (head_dim) axis must be "
                         "contiguous")


def flash_fwd(q, k, v, causal: bool, softmax_scale: float, kv_seqlens=None):
    """Launch the CUDA flash-attention forward kernel.

    ``q``: ``(b, h, sq, d)``, ``k``/``v``: ``(b, h, sk, d)``, any strides
    with a contiguous last axis.  Returns ``(o, lse)``: ``o`` is
    ``(b, h, sq, d)`` in q's dtype, laid out as a ``(b, sq, h, d)``
    contiguous buffer so that the caller's ``transpose(1, 2).reshape``
    back to ``(b, sq, h*d)`` copies nothing; ``lse`` is the per-row
    logsumexp ``(b*h, sq)`` f32 (kept for the training slice's backward).
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_fwd: q, k and v must share one dtype")
    if not all(t.is_cuda and t.device == q.device for t in (k, v)):
        raise ValueError("flash_fwd: q, k and v must be on one CUDA device")
    if d not in FLASH_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_fwd: head_dim {d} (kernel built for {FLASH_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_last_dim(f"flash_fwd {name}", t)
    code = _kernels.dtype_code(q, "flash_fwd")
    lens = None
    if kv_seqlens is not None:
        lens = kv_seqlens.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError(f"flash_fwd: kv_seqlens must be ({b},)")
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b * h, sq), dtype=_f32, device=q.device)
    rc = _kernels.lib().apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), None if lens is None else lens.data_ptr(),
        b, h, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        float(softmax_scale), int(bool(causal)), code, _kernels.stream())
    _kernels.check(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_attention(q, k, v, causal=False, softmax_scale=None,
                    kv_seqlens=None, dropout=0.0, dropout_seed=None):
    """Fused attention over ``(batch, heads, seq, head_dim)`` operands.

    ``causal=True`` applies the upper-triangular mask (requires
    ``sq == sk``); ``kv_seqlens`` is an optional ``(batch,)`` int tensor of
    valid key lengths; ``softmax_scale`` defaults to ``head_dim**-0.5``.
    Returns ``(b, h, sq, d)`` in q's dtype.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if causal and sq != sk:
        raise ValueError("causal flash attention requires sq == sk")
    if not 0.0 <= float(dropout) < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {dropout}")
    if dropout > 0.0:
        raise NotImplementedError(
            "fused attention dropout comes with the training slice (the "
            "counter-hash keep mask and backward kernels); serving runs "
            "with dropout=0")
    _no_grad_check(q, k, v)
    scale = _softmax_scale(softmax_scale, d)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, kv_seqlens)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    o, _ = flash_fwd(q, k, v, causal, scale, kv_seqlens)
    return o


# ---------------------------------------------------------------------------
# single-query decode path (KV-cache inference)
# ---------------------------------------------------------------------------

def flash_attention_decode_reference(q, k_cache, v_cache, cache_lens,
                                     softmax_scale=None):
    """Materialized single-query reference over the cache layout.

    ``q``: ``(batch, heads, head_dim)``; ``k_cache``/``v_cache``:
    ``(batch, max_seq, heads, head_dim)``; ``cache_lens``: ``(batch,)``
    valid lengths.  Scores and the PV reduction run in f32 whatever the
    cache dtype.
    """
    b, S, h, d = k_cache.shape
    scale = _softmax_scale(softmax_scale, d)
    s = torch.einsum("bhd,bshd->bhs", q.to(_f32), k_cache.to(_f32)) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < cache_lens.to(q.device)[:, None])[:, None, :]
    s = torch.where(valid, s, _MASK)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)
    o = torch.einsum("bhs,bshd->bhd", p, v_cache.to(_f32))
    return o.to(q.dtype)


def flash_attention_decode(q, k_cache, v_cache, cache_lens,
                           softmax_scale=None):
    """Single-token decode attention against a KV cache.

    ``q``: ``(batch, heads, head_dim)``; ``k_cache``/``v_cache``:
    ``(batch, max_seq, heads, head_dim)`` — the cache INCLUDING the current
    token's K/V; ``cache_lens``: ``(batch,)`` int valid lengths.  Returns
    ``(batch, heads, head_dim)`` in q's dtype.

    On CUDA the caches may be strided views (``cache[:, layer, 0]`` of the
    engine's slot ring): the kernel reads them through their strides and
    nothing is copied; only the last axis must be contiguous, and q and
    the caches must share a dtype.
    """
    _no_grad_check(q, k_cache, v_cache)
    b, h, d = q.shape
    S = k_cache.shape[1]
    scale = _softmax_scale(softmax_scale, d)
    if q.device.type == "cpu":
        return flash_attention_decode_reference(q, k_cache, v_cache,
                                                cache_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_decode: unsupported device "
                         f"{q.device}")
    if k_cache.shape != (b, S, h, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_attention_decode: q {tuple(q.shape)} and "
                         f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} disagree")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("flash_attention_decode: q and the caches must share "
                        f"one dtype on CUDA, got {q.dtype}, {k_cache.dtype}")
    if not all(t.is_cuda and t.device == q.device
               for t in (k_cache, v_cache)):
        raise ValueError("flash_attention_decode: q and the caches must be "
                         "on one CUDA device")
    if d not in DECODE_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_decode: head_dim {d} (kernel built for "
            f"{DECODE_HEAD_DIMS})")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _check_last_dim(f"flash_attention_decode {name}", t)
    lens = cache_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"flash_attention_decode: cache_lens must be ({b},)")
    code = _kernels.dtype_code(q, "flash_attention_decode")
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    rc = _kernels.lib().apex_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        lens.data_ptr(), b, h, S, d,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(1), scale, code, _kernels.stream())
    _kernels.check(rc, "flash_attention_decode")
    flash_attention_decode.launches += 1
    return o


flash_attention_decode.launches = 0
