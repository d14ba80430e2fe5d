"""Rotary positional embedding — port of ``apex_tpu/ops/rope.py``.

Plain PyTorch: the JAX package has no kernel here either (XLA fuses the
rotate-half pattern into its neighbours).  Math in f32, result cast back to
the input's dtype, as in the JAX ``_apply``.  Autograd differentiates it:
through the f32 product, the backward is the JAX custom VJP's analytic
rotation by -theta, and the tables get no gradient when they need none.
"""

from __future__ import annotations

import torch

_f32 = torch.float32

__all__ = ["rope_freqs", "fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached",
           "fused_apply_rotary_pos_emb_thd",
           "fused_apply_rotary_pos_emb_at_positions"]


def _rotate_half(t):
    d = t.shape[-1] // 2
    return torch.cat([-t[..., d:], t[..., :d]], dim=-1)


def _apply(t, cos, sin):
    rot_dim = cos.shape[-1]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    tf = t_rot.to(_f32)
    out = (tf * cos + _rotate_half(tf) * sin).to(t.dtype)
    if t_pass.shape[-1]:
        out = torch.cat([out, t_pass], dim=-1)
    return out


def fused_apply_rotary_pos_emb(t, freqs, transpose_output_memory=False):
    """RoPE on ``t`` of layout ``(seq, batch, head, dim)`` with ``freqs``
    ``(seq, 1, 1, rot_dim)`` (apex ``fused_apply_rotary_pos_emb``).  With
    ``transpose_output_memory`` the result keeps the same shape but is laid
    out batch-major in memory, as apex's kernel writes it."""
    f = freqs.to(_f32)
    out = _apply(t, torch.cos(f), torch.sin(f))
    if transpose_output_memory:
        out = out.transpose(0, 1).contiguous().transpose(0, 1)
    return out


def fused_apply_rotary_pos_emb_cached(t, cos_cached, sin_cached):
    """RoPE on ``t`` of layout ``(seq, batch, head, dim)`` with precomputed
    ``(seq, 1, 1, rot_dim)`` cos/sin tables (apex ``..._cached``)."""
    return _apply(t, cos_cached.to(_f32), sin_cached.to(_f32))


def fused_apply_rotary_pos_emb_thd(t, cu_seqlens, freqs):
    """RoPE on packed variable-length input ``(total_tokens, head, dim)``
    whose sequence ``i`` spans ``cu_seqlens[i]:cu_seqlens[i+1]``; positions
    restart at each sequence's start (apex
    ``fused_apply_rotary_pos_emb_thd``).  ``freqs``: ``(max_seq, ...,
    rot_dim)``."""
    total = t.shape[0]
    index = torch.arange(total, dtype=cu_seqlens.dtype, device=t.device)
    seq_id = torch.searchsorted(cu_seqlens, index, right=True) - 1
    local = index - cu_seqlens[seq_id]
    f = freqs.to(_f32).reshape(freqs.shape[0], -1)[local]
    f = f.reshape(total, *([1] * (t.dim() - 2)), f.shape[-1])
    return _apply(t, torch.cos(f), torch.sin(f))


def fused_apply_rotary_pos_emb_at_positions(t, cos_cached, sin_cached,
                                            positions):
    """RoPE at explicit per-row positions — the decode-step form.

    ``t``: ``(batch, head, dim)``; ``cos_cached``/``sin_cached``:
    ``(max_seq, 1, 1, rot_dim)``; ``positions``: ``(batch,)`` int.
    """
    rot_dim = cos_cached.shape[-1]
    cos = cos_cached.to(_f32).reshape(-1, rot_dim)[positions]
    sin = sin_cached.to(_f32).reshape(-1, rot_dim)[positions]
    return _apply(t, cos[:, None, :], sin[:, None, :])


def rope_freqs(seq_len, rot_dim, base=10000.0, dtype=_f32, device=None):
    """Standard RoPE frequency table ``(seq, 1, 1, rot_dim)``."""
    inv = 1.0 / (base ** (torch.arange(0, rot_dim, 2, dtype=_f32,
                                       device=device) / rot_dim))
    t = torch.arange(seq_len, dtype=_f32, device=device)
    f = torch.outer(t, inv)
    f = torch.cat([f, f], dim=-1)
    return f.reshape(seq_len, 1, 1, rot_dim).to(dtype)
