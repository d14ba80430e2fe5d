"""Fused multi-head attention modules — port of
``apex_tpu/contrib/multihead_attn/__init__.py`` (apex
``SelfMultiheadAttn`` / ``EncdecMultiheadAttn``).

Activations are ``(seq, batch, hidden)``; the packed projections are
``nn.Linear``\\ s with apex's ``(out, in)`` weights (``in_proj`` 3H x H,
``kv_proj`` 2H x H).  ``include_norm_add=True`` layer-norms the query
before the projection (the port's ``FusedLayerNorm``: #1 / #2 on the card)
and adds the raw query to the output.

The core is :func:`apex_tpu_torch.ops.flash_attention.flash_attention`
(the forward kernel #3, the dq and dk/dv kernels #4 / #5 in the backward)
over ``(batch, heads, seq, head_dim)`` views of the projections, with
optional ``kv_seqlens``.  Probability dropout is the kernels' counter-hash
mask of an int ``dropout_seed``: the seed the JAX module draws from its
key (``jax.random.randint(key, (), 0, 2**31 - 1)``), so both packages
drop the same probabilities for the same int.  Only a caller's
``key_padding_mask`` takes the materialized path,
:func:`~apex_tpu_torch.ops.flash_attention.flash_attention_reference`,
whose dropout is a Bernoulli mask from a ``torch.Generator`` seeded with
the int (the reference draws from its key there), so that path drops
other probabilities than the kernels for the same seed, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.utils.device import resolve_device

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn"]

_f32 = torch.float32


def _linear(lin, x):
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _attend(q, k, v, heads, kv_seqlens, key_padding_mask, dropout,
            dropout_seed):
    """q / k / v: (s, b, hidden) -> (s, b, hidden)."""
    sq, b, hidden = q.shape
    sk = k.shape[0]
    d = hidden // heads
    # (s, b, h*d) -> (b, h, s, d): views, no copy
    qh = q.reshape(sq, b, heads, d).permute(1, 2, 0, 3)
    kh = k.reshape(sk, b, heads, d).permute(1, 2, 0, 3)
    vh = v.reshape(sk, b, heads, d).permute(1, 2, 0, 3)
    if kv_seqlens is not None:
        kv_seqlens = torch.as_tensor(kv_seqlens, device=q.device)
    if key_padding_mask is not None:
        # arbitrary masks need materialized probabilities, and their
        # dropout is a Bernoulli draw seeded by the int, as the reference
        # draws from its key on this path
        generator = None
        if dropout > 0.0:
            generator = torch.Generator(device=q.device).manual_seed(
                int(dropout_seed))
        ctx = fa.flash_attention_reference(
            qh, kh, vh, kv_seqlens=kv_seqlens,
            key_padding_mask=key_padding_mask, dropout=dropout,
            generator=generator)
    else:
        ctx = fa.flash_attention(qh, kh, vh, kv_seqlens=kv_seqlens,
                                 dropout=dropout, dropout_seed=dropout_seed)
    return ctx.permute(2, 0, 1, 3).reshape(sq, b, hidden)


class _MultiheadBase(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout, bias, include_norm_add,
                 impl, param_dtype, device):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.dropout = float(dropout)
        self.include_norm_add = bool(include_norm_add)
        self.impl = impl
        self._dev = resolve_device(device)
        self._kw = dict(bias=bool(bias), device=self._dev, dtype=param_dtype)
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(embed_dim, param_dtype=param_dtype,
                                          device=self._dev)

    def init_params(self, generator=None):
        """apex's init: xavier-uniform projection weights, zero biases
        (the LayerNorm at weight 1, bias 0); returns the module."""
        with torch.no_grad():
            for lin in self.children():
                if isinstance(lin, nn.Linear):
                    bound = (6.0 / (lin.in_features
                                    + lin.out_features)) ** 0.5
                    lin.weight.copy_(torch.rand(
                        lin.weight.shape, generator=generator)
                        .mul_(2 * bound).sub_(bound))
                    if lin.bias is not None:
                        lin.bias.zero_()
        return self

    def _dropout(self, is_training, dropout_seed):
        dropout = self.dropout if is_training else 0.0
        if dropout > 0.0 and dropout_seed is None:
            raise ValueError(
                "dropout > 0 with is_training=True needs dropout_seed")
        return dropout

    def _norm(self, query):
        if self.include_norm_add:
            return self.lyr_nrm(query).to(query.dtype)
        return query


class SelfMultiheadAttn(_MultiheadBase):
    """apex ``SelfMultiheadAttn``: packed-QKV fused self attention;
    ``out = m(x)`` with ``x`` of shape ``(seq, batch, hidden)``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 param_dtype=_f32, device=None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, param_dtype, device)
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim, **self._kw)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **self._kw)

    def forward(self, query, key_padding_mask=None, attn_mask=None,
                kv_seqlens=None, is_training=True, dropout_seed=None):
        del attn_mask  # apex's fast path ignores it for self attention too
        dropout = self._dropout(is_training, dropout_seed)
        q, k, v = _linear(self.in_proj, self._norm(query)).chunk(3, dim=-1)
        ctx = _attend(q, k, v, self.num_heads, kv_seqlens, key_padding_mask,
                      dropout, dropout_seed)
        out = _linear(self.out_proj, ctx)
        return out + query if self.include_norm_add else out


class EncdecMultiheadAttn(_MultiheadBase):
    """apex ``EncdecMultiheadAttn``: the query from the decoder, packed KV
    from the encoder memory; ``out = m(query, key)``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 param_dtype=_f32, device=None):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, impl, param_dtype, device)
        self.q_proj = nn.Linear(embed_dim, embed_dim, **self._kw)
        self.kv_proj = nn.Linear(embed_dim, 2 * embed_dim, **self._kw)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **self._kw)

    def forward(self, query, key, key_padding_mask=None, kv_seqlens=None,
                is_training=True, dropout_seed=None):
        dropout = self._dropout(is_training, dropout_seed)
        q = _linear(self.q_proj, self._norm(query))
        k, v = _linear(self.kv_proj, key).chunk(2, dim=-1)
        ctx = _attend(q, k, v, self.num_heads, kv_seqlens, key_padding_mask,
                      dropout, dropout_seed)
        out = _linear(self.out_proj, ctx)
        return out + query if self.include_norm_add else out
