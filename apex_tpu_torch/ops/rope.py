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

__all__ = ["rope_freqs", "fused_apply_rotary_pos_emb_cached",
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


def fused_apply_rotary_pos_emb_cached(t, cos_cached, sin_cached):
    """RoPE on ``t`` of layout ``(seq, batch, head, dim)`` with precomputed
    ``(seq, 1, 1, rot_dim)`` cos/sin tables (apex ``..._cached``)."""
    return _apply(t, cos_cached.to(_f32), sin_cached.to(_f32))


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
