"""Flash attention (forward, backward, fused dropout) and single-query decode
attention — port of ``apex_tpu/ops/flash_attention.py``.

* :func:`flash_attention` over ``(batch, heads, seq, head_dim)``: causal or
  not, optional per-batch ``kv_seqlens``, optional probability dropout.  It
  is a :class:`torch.autograd.Function` over three kernel wrappers:
  :func:`flash_fwd` (``csrc/flash_fwd.cu``, the Pallas ``_fwd_kernel``),
  which also returns the per-row logsumexp, and :func:`flash_attention_dq`
  / :func:`flash_attention_dkv` (``csrc/flash_bwd_dq.cu`` /
  ``csrc/flash_bwd_dkv.cu``, the Pallas ``_dq_kernel`` / ``_dkv_kernel``),
  which recompute the probabilities from that logsumexp.  A CPU tensor takes
  each wrapper's plain version.  In bf16 the three kernels run on the
  tensor cores (``mma.sync`` over ``cp.async`` tiles); f32 and f16 run on
  the FMA units.  Every CUDA operand (q, k, v, dO)
  starts on a 16-byte boundary and has batch, head and seq strides that are
  multiples of 8 elements (the wrappers raise ``ValueError`` otherwise), as
  the model's split projections do.
* :func:`flash_attention_decode`: one query token per sequence against a
  ``(batch, max_seq, heads, head_dim)`` cache masked by ``cache_lens``.  A
  CUDA tensor launches ``csrc/flash_decode.cu`` (counterpart of the Pallas
  ``_decode_kernel``); a CPU tensor takes
  :func:`flash_attention_decode_reference`.  Forward only.
* :func:`flash_attention_decode_paged`: the same over a paged block pool
  through a block table.  A CUDA tensor launches
  ``csrc/flash_decode_paged.cu`` (counterpart of the Pallas
  ``_decode_paged_kernel``; the body is ``csrc/decode.cuh``, shared with
  the contiguous kernel); a CPU tensor takes
  :func:`flash_attention_decode_paged_reference`.  The chunk (multi-query)
  and int8-pool variants are plain PyTorch on every device, as in JAX.

All keep the JAX numerics: f32 scores and accumulation whatever the input
dtype, the finite mask value ``_MASK`` and the ``l == 0`` guard, so a fully
masked row yields 0.

Dropout is the JAX counter hash, bit for bit: the keep/(1-rate) factor of
``(seed, batch*head, q_pos, k_pos)`` is pure uint32 arithmetic, so the
kernels regenerate the mask of the forward in the backward, and the port
draws the very mask the TPU draws.  The softmax denominator sums the
undropped probabilities (the saved logsumexp is dropout-free); the factor
touches only the PV product, and in the backward dP and, for dV, P.
"""

from __future__ import annotations

import ctypes

import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32
_MASK = -1e30  # finite "minus infinity": exp(_MASK - m) == 0, no NaNs
_U32 = 0xFFFFFFFF

# head dims the CUDA kernels are instantiated for
FLASH_HEAD_DIMS = (16, 32, 64)
DECODE_HEAD_DIMS = (16, 32, 64, 128)
# keys per chunk of the decode kernels' split-K pass (csrc/decode.cuh
# kDecodeSplit): a row is cut at 0, DECODE_SPLIT, ... whatever the cache
DECODE_SPLIT = 128

__all__ = ["flash_attention", "flash_attention_reference", "flash_fwd",
           "flash_fwd_reference", "flash_attention_dq",
           "flash_attention_dq_reference", "flash_attention_dkv",
           "flash_attention_dkv_reference", "dropout_keep_scale",
           "flash_attention_decode", "flash_attention_decode_reference",
           "gather_paged_kv", "flash_attention_decode_paged",
           "flash_attention_decode_paged_reference",
           "flash_attention_chunk_paged", "quantize_kv_blocks",
           "dequantize_kv_blocks", "gather_paged_kv_quant",
           "flash_attention_decode_paged_quant",
           "flash_attention_chunk_paged_quant"]


# ---------------------------------------------------------------------------
# fused probability dropout: the JAX counter hash in int64 arithmetic
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` (an int, or an int64
    tensor): the product is split at 16 bits of ``c`` so that no partial
    product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(x):
    """lowbias32 avalanche mix (JAX ``_mix32``) on uint32 values held in an
    int or an int64 tensor."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _u32(v):
    """An int, or an int tensor (as int64), in ``[0, 2**32)``: the bits of
    a JAX int32 ``astype(uint32)`` (a seed wraps modulo 2**32).  Ints stay
    Python ints, so no host-to-device copy is made (the plain versions can
    run inside a CUDA graph capture)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _U32
    return int(v) & _U32


def _dropout_hash(seed, bh, q_pos, k_pos):
    """uint32 hash of (seed, batch*head index, q position, k position), as
    int64 (the JAX ``_dropout_hash``); at least one of the positions is a
    tensor."""
    h = _mix32(_u32(bh) ^ _mix32(_u32(seed)))
    h = _mix32(h ^ _u32(q_pos))
    return _mix32(h ^ _u32(k_pos))


def _keep_threshold(rate: float) -> int:
    """uint32 threshold with P(hash >= threshold) = 1 - rate."""
    return min(max(int(round(rate * 2.0 ** 32)), 0), 2 ** 32 - 1)


def _keep_scale(rate: float) -> float:
    """The keep factor 1/(1-rate), rounded to f32 as the kernels use it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=_f32))


def _keep_scale_tile(seed, bh, qi, ki, block_q, block_k, rate):
    """``(block_q, block_k)`` f32 tile of keep/(1-rate) factors at absolute
    positions ``qi*block_q + i``, ``ki*block_k + j``."""
    q_pos = qi * block_q + torch.arange(block_q)[:, None]
    k_pos = ki * block_k + torch.arange(block_k)[None, :]
    return _keep_where(_dropout_hash(seed, bh, q_pos, k_pos), rate)


def _keep_where(h, rate):
    """keep/(1-rate) where the hash clears the threshold, else 0 (f32)."""
    return torch.where(h >= _keep_threshold(rate), _keep_scale(rate),
                       0.0).to(_f32)


def dropout_keep_scale(seed, n_bh, sq, sk, rate, device=None):
    """Dense ``(n_bh, sq, sk)`` f32 keep-scale matrix: the mask the fused
    kernels regenerate per tile, materialized (for the plain versions and
    for parity tests).  ``seed``: an int."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    bh = torch.arange(n_bh, device=dev)[:, None, None]
    q_pos = torch.arange(sq, device=dev)[None, :, None]
    k_pos = torch.arange(sk, device=dev)[None, None, :]
    return _keep_where(_dropout_hash(seed, bh, q_pos, k_pos), rate)


def _dropout_args(rate: float, seed):
    """``(on, threshold, keep_scale, seed)`` for a kernel's C interface."""
    if rate <= 0.0:
        return 0, ctypes.c_uint32(0), 1.0, ctypes.c_uint32(0)
    return (1, ctypes.c_uint32(_keep_threshold(rate)), _keep_scale(rate),
            ctypes.c_uint32(int(seed) & _U32))


def _dropout_mask(rate, seed, b, h, sq, sk, device):
    if rate <= 0.0:
        return None
    return dropout_keep_scale(seed, b * h, sq, sk, rate,
                              device).reshape(b, h, sq, sk)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _softmax_scale(softmax_scale, head_dim) -> float:
    return float(softmax_scale if softmax_scale is not None
                 else head_dim ** -0.5)


def _valid(b, sq, sk, causal, kv_seqlens, device):
    """``(b, 1, sq, sk)`` bool: key inside ``kv_seqlens`` and (causal) not
    after the query."""
    k_pos = torch.arange(sk, device=device)
    if kv_seqlens is None:
        valid = torch.ones((b, 1, 1, sk), dtype=torch.bool, device=device)
    else:
        valid = (k_pos[None, :] < kv_seqlens.to(device)[:, None]
                 )[:, None, None, :]
    if causal:
        valid = valid & (k_pos[None, None, None, :]
                         <= torch.arange(sq, device=device)[None, None, :,
                                                            None])
    return valid


def _scores(q, k, scale):
    return torch.einsum("bhqd,bhkd->bhqk", q.to(_f32), k.to(_f32)) * scale


def flash_attention_reference(q, k, v, causal=False, softmax_scale=None,
                              kv_seqlens=None, key_padding_mask=None,
                              dropout=0.0, generator=None, dropout_mask=None):
    """Materialized-scores reference with the kernel's masking semantics
    (f32 scores; a fully masked row yields 0), and the one path for what
    the kernels cannot express: an arbitrary ``key_padding_mask``
    (``(b, sk)`` bool, True = masked out, apex's convention), which
    ``contrib.multihead_attn`` takes only when its caller passes one.

    Dropout: ``dropout_mask`` is an explicit ``(b, h, sq, sk)`` keep-scale
    matrix multiplied into the probabilities (how the fused kernel's hash
    mask is replayed); else ``dropout`` > 0 draws a Bernoulli keep mask
    from ``generator`` (a :class:`torch.Generator` on q's device), the
    JAX ``dropout_rng`` variant, which ``contrib.multihead_attn``'s
    materialized path takes."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = _softmax_scale(softmax_scale, d)
    valid = _valid(b, sq, sk, causal, kv_seqlens, q.device)
    if key_padding_mask is not None:
        valid = valid & ~key_padding_mask.to(q.device, torch.bool)[
            :, None, None, :]
    s = torch.where(valid, _scores(q, k, scale), _MASK)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)
    if dropout_mask is not None:
        p = p * dropout_mask.to(p.dtype)
    elif dropout > 0.0:
        if generator is None:
            raise ValueError("dropout > 0 needs a generator")
        keep = torch.rand(p.shape, generator=generator,
                          device=p.device) < 1.0 - dropout
        p = torch.where(keep, p / (1.0 - dropout), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def flash_fwd_reference(q, k, v, causal, softmax_scale, kv_seqlens=None,
                        dropout=0.0, dropout_seed=None):
    """Plain version of :func:`flash_fwd`: ``(o, lse)`` with ``lse`` the
    dropout-free logsumexp of the masked scores, ``(b*h, sq)`` f32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    valid = _valid(b, sq, sk, causal, kv_seqlens, q.device)
    s = torch.where(valid, _scores(q, k, softmax_scale), _MASK)
    lse = torch.logsumexp(s, dim=-1).reshape(b * h, sq)
    mask = _dropout_mask(float(dropout), dropout_seed, b, h, sq, sk,
                         q.device)
    o = flash_attention_reference(q, k, v, causal, softmax_scale, kv_seqlens,
                                  dropout_mask=mask)
    return o, lse


def _recompute_p(q, k, lse, causal, scale, kv_seqlens):
    """p = exp(q k^T * scale - lse) with the forward's mask re-applied
    (the JAX ``_recompute_p``); ``lse`` is ``(b*h, sq)``."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    valid = _valid(b, sq, sk, causal, kv_seqlens, q.device)
    lse4 = lse.reshape(b, h, sq, 1)
    return torch.where(valid, torch.exp(_scores(q, k, scale) - lse4), 0.0)


def _ds(p, q, v, do, delta, scale, mask):
    """dS = P * (D * (dO V^T) - delta) * scale, f32."""
    b, h, sq, _ = q.shape
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(_f32), v.to(_f32))
    if mask is not None:
        dp = dp * mask
    return p * (dp - delta.reshape(b, h, sq, 1)) * scale


def flash_attention_dq_reference(q, k, v, do, lse, delta, causal,
                                 softmax_scale, kv_seqlens=None, dropout=0.0,
                                 dropout_seed=None):
    """Plain version of the dq kernel (JAX ``_dq_kernel``): dS rounded to
    k's dtype before the dS K product, as the kernel rounds it."""
    b, h, sq, _ = q.shape
    mask = _dropout_mask(float(dropout), dropout_seed, b, h, sq, k.shape[2],
                         q.device)
    p = _recompute_p(q, k, lse, causal, softmax_scale, kv_seqlens)
    ds = _ds(p, q, v, do, delta, softmax_scale, mask)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).to(_f32),
                      k.to(_f32))
    return dq.to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, causal,
                                  softmax_scale, kv_seqlens=None, dropout=0.0,
                                  dropout_seed=None):
    """Plain version of the dk/dv kernel (JAX ``_dkv_kernel``): P*D rounded
    to dO's dtype before the dV product, dS to q's before the dK product."""
    b, h, sq, _ = q.shape
    mask = _dropout_mask(float(dropout), dropout_seed, b, h, sq, k.shape[2],
                         q.device)
    p = _recompute_p(q, k, lse, causal, softmax_scale, kv_seqlens)
    pd = p if mask is None else p * mask
    dv = torch.einsum("bhqk,bhqd->bhkd", pd.to(do.dtype).to(_f32),
                      do.to(_f32))
    ds = _ds(p, q, v, do, delta, softmax_scale, mask)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).to(_f32),
                      q.to(_f32))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_last_dim(name, t):
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last (head_dim) axis must be "
                         "contiguous")


def _check_aligned(kernel, **operands):
    """The bf16 flash kernels stage their operands in shared memory with
    16-byte ``cp.async`` copies, so each operand must start on a 16-byte
    boundary and its batch, head and seq strides (of the axes longer than
    one) must be multiples of 8 elements.  The model's ``(b, s, h, 3*hd)``
    projection split at hd 16, 32 or 64 qualifies; the rule holds for every
    dtype."""
    for name, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte "
                             f"boundary (data_ptr % 16 = {t.data_ptr() % 16})")
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if any(st % 8 for st in strides):
            raise ValueError(f"{kernel}: {name}'s batch, head and seq strides "
                             f"must be multiples of 8 elements, got "
                             f"{tuple(t.stride()[:3])}")


def _check_decode_aligned(kernel, **operands):
    """The decode kernels read q, K and V 16 bytes a lane, so each operand
    must start on a 16-byte boundary and the stride of each axis longer
    than one, but the last, must be a multiple of 16 bytes.  The model's
    q (a split of the qkv projection) and the ring's and the pool's
    per-layer views qualify at every dtype and head dim of
    ``DECODE_HEAD_DIMS``."""
    for name, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte "
                             f"boundary (data_ptr % 16 = {t.data_ptr() % 16})")
        size = t.element_size()
        if any(st * size % 16 for st, n in zip(t.stride()[:-1], t.shape[:-1])
               if n > 1):
            raise ValueError(f"{kernel}: {name}'s strides must be multiples "
                             f"of 16 bytes, got {tuple(t.stride())} in "
                             f"{size}-byte elements")


def _decode_workspace(b, h, d, positions, device):
    """The f32 chunk partials (acc[D], m, l) of the split pass:
    ``(n_split, workspace)`` for rows of up to ``positions`` keys."""
    n_split = -(-positions // DECODE_SPLIT)
    return n_split, torch.empty(b * h * n_split * (d + 2), dtype=_f32,
                                device=device)


def _check_operands(kernel, q, k, v, do=None):
    """Shapes, dtype, device and layout a CUDA flash kernel takes."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape or (
            do is not None and do.shape != q.shape):
        raise ValueError(f"{kernel}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    ops = (q, k, v) if do is None else (q, k, v, do)
    if any(t.dtype != q.dtype for t in ops):
        raise TypeError(f"{kernel}: q, k, v (and do) must share one dtype")
    if not all(t.is_cuda and t.device == q.device for t in ops):
        raise ValueError(f"{kernel}: q, k, v (and do) must be on one CUDA "
                         f"device, got {q.device}")
    if d not in FLASH_HEAD_DIMS:
        raise NotImplementedError(
            f"{kernel}: head_dim {d} (kernel built for {FLASH_HEAD_DIMS})")
    names = ("q", "k", "v", "do")
    for name, t in zip(names, ops):
        _check_last_dim(f"{kernel} {name}", t)
    _check_aligned(kernel, **dict(zip(names, ops)))
    return _kernels.dtype_code(q, kernel)


def _lens(kernel, kv_seqlens, b, device):
    if kv_seqlens is None:
        return None
    lens = kv_seqlens.to(device=device, dtype=torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"{kernel}: kv_seqlens must be ({b},)")
    return lens


def _check_rowstats(kernel, n_rows, device, **stats):
    for name, t in stats.items():
        if (t.dtype != _f32 or t.numel() != n_rows or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be a contiguous "
                             f"(b*h, sq) f32 tensor on {device}")


def _like_heads_interleaved(x):
    """An empty ``(b, h, s, d)`` tensor laid out as a contiguous
    ``(b, s, h, d)`` buffer, the layout of the model's projections."""
    b, h, s, d = x.shape
    return torch.empty((b, s, h, d), dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def _strides(*tensors):
    return [st for t in tensors for st in t.stride()[:3]]


def flash_fwd(q, k, v, causal: bool, softmax_scale: float, kv_seqlens=None,
              dropout: float = 0.0, dropout_seed=None):
    """Flash-attention forward kernel wrapper.

    ``q``: ``(b, h, sq, d)``, ``k``/``v``: ``(b, h, sk, d)``, any strides
    with a contiguous last axis.  Returns ``(o, lse)``: ``o`` is
    ``(b, h, sq, d)`` in q's dtype, laid out as a ``(b, sq, h, d)``
    contiguous buffer so that the caller's ``transpose(1, 2).reshape``
    back to ``(b, sq, h*d)`` copies nothing; ``lse`` is the per-row
    dropout-free logsumexp ``(b*h, sq)`` f32 the backward reads.  A CPU
    tensor takes :func:`flash_fwd_reference`.
    """
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, softmax_scale,
                                   kv_seqlens, dropout, dropout_seed)
    code = _check_operands("flash_fwd", q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    lens = _lens("flash_fwd", kv_seqlens, b, q.device)
    o = _like_heads_interleaved(q)
    lse = torch.empty((b * h, sq), dtype=_f32, device=q.device)
    rc = _kernels.lib().apex_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), None if lens is None else lens.data_ptr(),
        b, h, sq, sk, d, *_strides(q, k, v, o),
        float(softmax_scale), int(bool(causal)),
        *_dropout_args(float(dropout), dropout_seed), code,
        _kernels.stream())
    _kernels.check(rc, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_attention_dq(q, k, v, do, lse, delta, causal, softmax_scale,
                       kv_seqlens=None, dropout=0.0, dropout_seed=None):
    """dq kernel wrapper: ``dq = dS K`` with P recomputed from ``lse``.

    ``q``/``do``: ``(b, h, sq, d)``, ``k``/``v``: ``(b, h, sk, d)`` (any
    strides with a contiguous last axis, one dtype); ``lse``, ``delta``
    (= rowsum(dO * O)): ``(b*h, sq)`` f32.  Returns ``dq`` in q's dtype,
    laid out like :func:`flash_fwd`'s ``o``.  A CPU tensor takes
    :func:`flash_attention_dq_reference`.
    """
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta, causal,
                                            softmax_scale, kv_seqlens,
                                            dropout, dropout_seed)
    code = _check_operands("flash_attention_dq", q, k, v, do)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_rowstats("flash_attention_dq", b * h * sq, q.device, lse=lse,
                    delta=delta)
    lens = _lens("flash_attention_dq", kv_seqlens, b, q.device)
    dq = _like_heads_interleaved(q)
    rc = _kernels.lib().apex_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        None if lens is None else lens.data_ptr(), b, h, sq, sk, d,
        *_strides(q, k, v, do, dq), float(softmax_scale),
        int(bool(causal)), *_dropout_args(float(dropout), dropout_seed),
        code, _kernels.stream())
    _kernels.check(rc, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, causal, softmax_scale,
                        kv_seqlens=None, dropout=0.0, dropout_seed=None):
    """dk/dv kernel wrapper: ``dV = (P*D)^T dO``, ``dK = dS^T Q``.

    Same operands as :func:`flash_attention_dq`.  Returns ``(dk, dv)`` in
    k's and v's dtype, laid out like :func:`flash_fwd`'s ``o``.  A CPU
    tensor takes :func:`flash_attention_dkv_reference`.
    """
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta, causal,
                                             softmax_scale, kv_seqlens,
                                             dropout, dropout_seed)
    code = _check_operands("flash_attention_dkv", q, k, v, do)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_rowstats("flash_attention_dkv", b * h * sq, q.device, lse=lse,
                    delta=delta)
    lens = _lens("flash_attention_dkv", kv_seqlens, b, q.device)
    dk = _like_heads_interleaved(k)
    dv = _like_heads_interleaved(v)
    rc = _kernels.lib().apex_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if lens is None else lens.data_ptr(), b, h, sq, sk, d,
        *_strides(q, k, v, do, dk, dv), float(softmax_scale),
        int(bool(causal)), *_dropout_args(float(dropout), dropout_seed),
        code, _kernels.stream())
    _kernels.check(rc, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, then the dq and dk/dv kernels (the JAX ``_flash``
    custom VJP).  Saves the inputs, ``o`` and ``lse``; ``delta =
    rowsum(dO * O)`` is taken in f32 outside the kernels, as in JAX."""

    @staticmethod
    def forward(ctx, q, k, v, kv_seqlens, causal, scale, rate, seed):
        o, lse = flash_fwd(q, k, v, causal, scale, kv_seqlens, rate, seed)
        ctx.args = (causal, scale, rate, seed)
        ctx.save_for_backward(q, k, v, o, lse, kv_seqlens)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_seqlens = ctx.saved_tensors
        causal, scale, rate, seed = ctx.args
        b, h, sq, _ = q.shape
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = torch.sum(do.to(_f32) * o.to(_f32), dim=-1).reshape(b * h,
                                                                    sq)
        dq = flash_attention_dq(q, k, v, do, lse, delta, causal, scale,
                                kv_seqlens, rate, seed)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, causal, scale,
                                     kv_seqlens, rate, seed)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal=False, softmax_scale=None,
                    kv_seqlens=None, dropout=0.0, dropout_seed=None):
    """Fused attention over ``(batch, heads, seq, head_dim)`` operands.

    ``causal=True`` applies the upper-triangular mask (requires
    ``sq == sk``); ``kv_seqlens`` is an optional ``(batch,)`` int tensor of
    valid key lengths; ``softmax_scale`` defaults to ``head_dim**-0.5``.
    ``dropout`` > 0 drops probabilities with the counter-hash mask of
    ``(dropout_seed, b*h, q_pos, k_pos)``; ``dropout_seed`` is an int
    (wrapped modulo 2**32).  Returns ``(b, h, sq, d)`` in q's dtype;
    differentiable in q, k and v.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if causal and sq != sk:
        raise ValueError("causal flash attention requires sq == sk")
    rate = float(dropout)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {dropout}")
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout > 0 needs dropout_seed")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, kv_seqlens, bool(causal),
                                 _softmax_scale(softmax_scale, d), rate,
                                 None if rate == 0.0 else int(dropout_seed))


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
    return _decode_math(q, k_cache, v_cache, cache_lens,
                        _softmax_scale(softmax_scale, q.shape[-1]))


def _decode_math(q, k_cache, v_cache, cache_lens, scale):
    """The masked single-query attention of the decode reference (also the
    int8 paged path's attention, which owns no kernel)."""
    S = k_cache.shape[1]
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
    """Single-token decode attention against a KV cache (forward only).

    ``q``: ``(batch, heads, head_dim)``; ``k_cache``/``v_cache``:
    ``(batch, max_seq, heads, head_dim)`` — the cache INCLUDING the current
    token's K/V; ``cache_lens``: ``(batch,)`` int valid lengths.  Returns
    ``(batch, heads, head_dim)`` in q's dtype.

    On CUDA the caches may be strided views (``cache[:, layer, 0]`` of the
    engine's slot ring): the kernel reads them through their strides and
    nothing is copied; only the last axis must be contiguous, q and the
    caches must share a dtype and be 16-byte aligned
    (:func:`_check_decode_aligned`).  One call is one counted launch of
    ``csrc/flash_decode.cu``: its split-K pass over chunks of
    ``DECODE_SPLIT`` keys into an f32 workspace, then the combine.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise NotImplementedError(
            "flash_attention_decode is a serving op with no backward; call "
            "it under torch.no_grad()")
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
    _check_decode_aligned("flash_attention_decode", q=q, k_cache=k_cache,
                          v_cache=v_cache)
    lens = cache_lens.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"flash_attention_decode: cache_lens must be ({b},)")
    code = _kernels.dtype_code(q, "flash_attention_decode")
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    n_split, work = _decode_workspace(b, h, d, S, q.device)
    rc = _kernels.lib().apex_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        lens.data_ptr(), work.data_ptr(), b, h, S, d, n_split,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(1), scale, code, _kernels.stream())
    _kernels.check(rc, "flash_attention_decode")
    flash_attention_decode.launches += 1
    return o


flash_attention_decode.launches = 0


# ---------------------------------------------------------------------------
# paged decode (the serving tier's block pool)
# ---------------------------------------------------------------------------

def gather_paged_kv(pool, block_tables):
    """Materialize a paged cache as the contiguous layout.

    ``pool``: ``(num_blocks, block_size, heads, head_dim)`` (one layer, one
    of K/V); ``block_tables``: ``(batch, max_blocks)`` int.  Returns
    ``(batch, max_blocks * block_size, heads, head_dim)``: position ``p``
    of row ``b`` is ``pool[table[b, p // bs], p % bs]``.
    """
    b, nb = block_tables.shape
    bs, h, d = pool.shape[1:]
    return pool[block_tables.long()].reshape(b, nb * bs, h, d)


def flash_attention_decode_paged_reference(q, k_pool, v_pool, block_tables,
                                           cache_lens, softmax_scale=None):
    """Plain version of the paged decode: gather the table, then the
    contiguous decode reference, exactly the JAX off-TPU path."""
    return flash_attention_decode_reference(
        q, gather_paged_kv(k_pool, block_tables),
        gather_paged_kv(v_pool, block_tables), cache_lens, softmax_scale)


def flash_attention_decode_paged(q, k_pool, v_pool, block_tables, cache_lens,
                                 softmax_scale=None):
    """Single-token decode attention over a paged KV pool (forward only).

    ``q``: ``(batch, heads, head_dim)``; ``k_pool``/``v_pool``:
    ``(num_blocks, block_size, heads, head_dim)``, one layer's K (or V)
    blocks of :class:`apex_tpu_torch.serving.PagedKVCache`;
    ``block_tables``: ``(batch, max_blocks)`` int physical block per
    logical block (rows padded with the garbage block 0); ``cache_lens``:
    ``(batch,)`` valid lengths.  Semantics are
    :func:`flash_attention_decode` on the gathered contiguous cache.

    A CUDA tensor launches ``csrc/flash_decode_paged.cu`` (counterpart of
    the Pallas ``_decode_paged_kernel``), which reads each chunk's table
    entries once and never gathers; the pools may be strided views
    (``pool[:, layer, 0]``), only the last axis contiguous, 16-byte
    aligned, and the block size a power of two.  It shares the contiguous
    kernel's split-K body, so its output is bitwise the contiguous
    kernel's on the gathered cache.  A CPU tensor takes
    :func:`flash_attention_decode_paged_reference`.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pool, v_pool)):
        raise NotImplementedError(
            "flash_attention_decode_paged is a serving op with no backward; "
            "call it under torch.no_grad()")
    kernel = "flash_attention_decode_paged"
    b, h, d = q.shape
    scale = _softmax_scale(softmax_scale, d)
    if q.device.type == "cpu":
        return flash_attention_decode_paged_reference(
            q, k_pool, v_pool, block_tables, cache_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {q.device}")
    n_blocks, bs = k_pool.shape[:2]
    if (k_pool.shape != (n_blocks, bs, h, d)
            or v_pool.shape != k_pool.shape):
        raise ValueError(f"{kernel}: q {tuple(q.shape)} and pools "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)} "
                         "disagree")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError(f"{kernel}: q and the pools must share one dtype on "
                        f"CUDA, got {q.dtype}, {k_pool.dtype}")
    if not all(t.device == q.device
               for t in (k_pool, v_pool, block_tables, cache_lens)):
        raise ValueError(f"{kernel}: q, the pools, the tables and the "
                         "lengths must be on one CUDA device")
    if d not in DECODE_HEAD_DIMS:
        raise NotImplementedError(
            f"{kernel}: head_dim {d} (kernel built for {DECODE_HEAD_DIMS})")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _check_last_dim(f"{kernel} {name}", t)
    _check_decode_aligned(kernel, q=q, k_pool=k_pool, v_pool=v_pool)
    if bs & (bs - 1):
        raise ValueError(f"{kernel}: block_size {bs} is not a power of two "
                         "(a chunk of the kernel covers DECODE_SPLIT / "
                         "block_size table entries)")
    if block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{kernel}: block_tables must be ({b}, max_blocks)")
    tables = block_tables.to(torch.int32).contiguous()
    lens = cache_lens.to(torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"{kernel}: cache_lens must be ({b},)")
    code = _kernels.dtype_code(q, kernel)
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    max_blocks = tables.shape[1]
    n_split, work = _decode_workspace(b, h, d, max_blocks * bs, q.device)
    rc = _kernels.lib().apex_flash_decode_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), o.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), work.data_ptr(), b, h, d,
        n_blocks, bs, max_blocks, n_split, q.stride(0), q.stride(1),
        k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
        v_pool.stride(0), v_pool.stride(1), v_pool.stride(2),
        o.stride(0), o.stride(1), scale, code, _kernels.stream())
    _kernels.check(rc, kernel)
    flash_attention_decode_paged.launches += 1
    return o


flash_attention_decode_paged.launches = 0


def _causal_chunk_math(q, k, v, q_positions, scale):
    """Masked multi-query attention over gathered ``(b, S, h, d)`` K/V:
    key ``kp`` is visible to query ``j`` iff ``kp <= q_positions[:, j]``."""
    S = k.shape[1]
    s = torch.einsum("bhcd,bshd->bhcs", q.to(_f32), k.to(_f32)) * scale
    valid = (torch.arange(S, device=q.device)[None, None, None, :]
             <= q_positions.to(q.device)[:, None, :, None])
    s = torch.where(valid, s, _MASK)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)
    o = torch.einsum("bhcs,bshd->bhcd", p, v.to(_f32))
    return o.to(q.dtype)


def flash_attention_chunk_paged(q, k_pool, v_pool, block_tables,
                                q_positions, softmax_scale=None):
    """Multi-query decode attention over a paged pool (chunked prefill and
    speculative verification).

    ``q``: ``(batch, heads, chunk, head_dim)``; ``q_positions``: ``(batch,
    chunk)`` each query's absolute position; causality over the whole
    cached context.  The chunk's own K/V must be in the pool before the
    call.  Plain PyTorch on every device, as the JAX package's masked
    gather: no kernel is owed for it.
    """
    scale = _softmax_scale(softmax_scale, q.shape[-1])
    return _causal_chunk_math(q, gather_paged_kv(k_pool, block_tables),
                              gather_paged_kv(v_pool, block_tables),
                              q_positions, scale)


def quantize_kv_blocks(blocks):
    """Int8 scale-per-block quantization of KV blocks.

    ``blocks``: ``(..., block_size, heads, head_dim)`` float.  One f32
    scale per block and head (``amax / 127``; 1.0 for an all-zero block,
    so it dequantizes to exact zeros).  Returns ``(q8, scales)``: int8 of
    ``blocks.shape`` and f32 of ``blocks.shape[:-3] + (heads,)``; bitwise
    the JAX function's output for the same f32 blocks.
    """
    x = blocks.to(_f32)
    amax = x.abs().amax(dim=(-3, -1))
    scale = amax / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q8 = torch.clamp(torch.round(x / scale[..., None, :, None]), -127, 127)
    return q8.to(torch.int8), scale


def dequantize_kv_blocks(q8, scales, dtype=_f32):
    """Inverse of :func:`quantize_kv_blocks`: ``q8`` ``(..., block_size,
    heads, head_dim)`` int8, ``scales`` ``(..., heads)`` f32."""
    return (q8.to(_f32) * scales[..., None, :, None]).to(dtype)


def gather_paged_kv_quant(pool, scales, block_tables, dtype=_f32):
    """:func:`gather_paged_kv` for an int8 pool: gather the table's blocks
    and their ``(num_blocks, heads)`` scales, dequantize only what was
    gathered; ``(batch, max_blocks * block_size, heads, head_dim)`` in
    ``dtype``."""
    b, nb = block_tables.shape
    bs, h, d = pool.shape[1:]
    tbl = block_tables.long()
    return dequantize_kv_blocks(pool[tbl], scales[tbl], dtype).reshape(
        b, nb * bs, h, d)


def flash_attention_decode_paged_quant(q, k_pool, v_pool, k_scales, v_scales,
                                       block_tables, cache_lens,
                                       softmax_scale=None):
    """Single-token decode attention over an int8 paged pool: the gather
    dequantizes into f32, then the masked decode math.  Plain PyTorch on
    every device, as in the JAX package."""
    scale = _softmax_scale(softmax_scale, q.shape[-1])
    return _decode_math(
        q, gather_paged_kv_quant(k_pool, k_scales, block_tables),
        gather_paged_kv_quant(v_pool, v_scales, block_tables), cache_lens,
        scale)


def flash_attention_chunk_paged_quant(q, k_pool, v_pool, k_scales, v_scales,
                                      block_tables, q_positions,
                                      softmax_scale=None):
    """:func:`flash_attention_chunk_paged` over an int8 pool (chunked
    prefill on a quantized cache).  Plain PyTorch on every device."""
    scale = _softmax_scale(softmax_scale, q.shape[-1])
    return _causal_chunk_math(
        q, gather_paged_kv_quant(k_pool, k_scales, block_tables),
        gather_paged_kv_quant(v_pool, v_scales, block_tables), q_positions,
        scale)
