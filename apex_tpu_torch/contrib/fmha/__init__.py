"""FMHA — port of ``apex_tpu/contrib/fmha/__init__.py`` (apex's MLPerf-BERT
fused multi-head attention over packed variable-length sequences).

``fmha(qkv, cu_seqlens, max_s)`` with ``qkv`` of shape ``(total_tokens, 3,
heads, head_dim)``: the packed tokens are scattered to a dense ``(batch,
max_s, 3, heads, head_dim)`` buffer, attended by
:func:`~apex_tpu_torch.ops.flash_attention.flash_attention` over its
``(batch, heads, max_s, head_dim)`` views with per-row ``kv_seqlens`` (on
the card #3, and #4 / #5 in the backward), and gathered back.  Padded
query rows are computed and dropped; keys past a row's length contribute
nothing, as in the packed kernels.  ``causal`` and probability dropout
(the kernels' counter-hash mask of an int ``dropout_seed``, the seed the
JAX function draws from its key) are supported.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["fmha", "FMHAFun"]


def _token_coords(cu_seqlens, total):
    """Per-token (batch row, offset) of the packed layout."""
    tok = torch.arange(total, device=cu_seqlens.device,
                       dtype=cu_seqlens.dtype)
    row = torch.searchsorted(cu_seqlens, tok, right=True) - 1
    return row, tok - cu_seqlens[row]


def fmha(qkv, cu_seqlens, max_s, p_dropout=0.0, is_training=True,
         causal=False, dropout_seed=None):
    """Packed fused MHA: ``qkv (total, 3, h, d)`` -> ``(total, h, d)``.

    ``cu_seqlens``: ``(batch+1,)`` cumulative sequence starts (apex's
    convention); ``max_s``: the dense buffer's sequence length (at least
    the longest sequence).
    """
    total, three, h, d = qkv.shape
    if three != 3:
        raise ValueError("qkv must be (total, 3, heads, head_dim)")
    cu_seqlens = torch.as_tensor(cu_seqlens, device=qkv.device).long()
    b = cu_seqlens.shape[0] - 1
    lens = (cu_seqlens[1:] - cu_seqlens[:-1]).to(torch.int32)
    row, off = _token_coords(cu_seqlens, total)
    # padded slots stay zero and are masked by kv_seqlens in the kernel
    dense = qkv.new_zeros((b, max_s) + tuple(qkv.shape[1:]))
    dense = dense.index_put((row, off), qkv)
    q, k, v = (dense[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    if p_dropout > 0.0 and is_training:
        if dropout_seed is None:
            raise ValueError("p_dropout > 0 needs dropout_seed")
    else:
        p_dropout, dropout_seed = 0.0, None
    ctx = flash_attention(q, k, v, causal=causal, kv_seqlens=lens,
                          dropout=p_dropout, dropout_seed=dropout_seed)
    return ctx.permute(0, 2, 1, 3)[row, off]         # (total, h, d)


class FMHAFun:
    """The reference's autograd-function handle:
    ``FMHAFun.apply(qkv, cu_seqlens, seqlens, p_dropout, max_s,
    is_training)``."""

    @staticmethod
    def apply(qkv, cu_seqlens, seqlens, p_dropout, max_s,
              is_training=True, dropout_seed=None):
        del seqlens  # derivable from cu_seqlens (the reference passes both)
        return fmha(qkv, cu_seqlens, max_s, p_dropout, is_training,
                    dropout_seed=dropout_seed)
