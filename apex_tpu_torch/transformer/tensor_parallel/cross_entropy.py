"""Vocab-parallel cross entropy at world size 1 — port of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``.

Plain PyTorch (the JAX package has no kernel here either): an
:class:`torch.autograd.Function` with the JAX custom VJP's forward and its
analytic backward ``softmax - onehot`` (label smoothing by apex's formula),
in f32 whatever the logits' dtype.  The forward saves ``exp(x - max)`` and
its row sums, as JAX does.  A world size above 1 (the vocab sharded over a
tensor-parallel group) comes with the multi-GPU slice and raises.
"""

from __future__ import annotations

from typing import Optional

import torch

_f32 = torch.float32

__all__ = ["vocab_parallel_cross_entropy"]


class _VocabParallelCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, label_smoothing):
        x = logits.to(_f32)
        vocab = x.shape[-1]
        x = x - torch.amax(x, dim=-1, keepdim=True)
        exp_x = torch.exp(x)
        sum_exp = torch.sum(exp_x, dim=-1)
        in_range = (target >= 0) & (target < vocab)
        safe_t = torch.where(in_range, target, torch.zeros_like(target))
        picked = torch.gather(x, -1, safe_t[..., None])[..., 0]
        picked = torch.where(in_range, picked, torch.zeros_like(picked))
        log_z = torch.log(sum_exp)
        loss = log_z - picked
        if label_smoothing > 0.0:
            # apex: s_adj = s * V/(V-1), loss = (1-s_adj)*nll + s_adj *
            # mean_i(log_z - logit_i)
            s_adj = label_smoothing * vocab / (vocab - 1)
            smooth = log_z - torch.sum(x, dim=-1) / vocab
            loss = (1.0 - s_adj) * loss + s_adj * smooth
        ctx.label_smoothing = label_smoothing
        ctx.logits_dtype = logits.dtype
        ctx.save_for_backward(exp_x, sum_exp, in_range, safe_t)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        exp_x, sum_exp, in_range, safe_t = ctx.saved_tensors
        vocab = exp_x.shape[-1]
        grad = exp_x / sum_exp[..., None]
        hit = in_range.to(_f32)
        if ctx.label_smoothing > 0.0:
            s_adj = ctx.label_smoothing * vocab / (vocab - 1)
            grad.scatter_add_(-1, safe_t[..., None],
                              (-(1.0 - s_adj) * hit)[..., None])
            grad -= s_adj / vocab
        else:
            grad.scatter_add_(-1, safe_t[..., None], -hit[..., None])
        grad *= dloss.to(_f32)[..., None]
        return grad.to(ctx.logits_dtype), None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing: float = 0.0,
                                 world_size: Optional[int] = None):
    """Per-token loss ``(...)`` f32 for logits ``(..., vocab)`` and int
    targets ``(...)``.  ``label_smoothing`` in ``[0, 1)``."""
    if (world_size or 1) != 1:
        raise NotImplementedError(
            "vocab-parallel cross entropy over a tensor-parallel group "
            "(world_size > 1) comes with the multi-GPU slice of "
            "apex_tpu_torch")
    label_smoothing = float(label_smoothing)
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got "
                         f"{label_smoothing}")
    return _VocabParallelCrossEntropy.apply(vocab_parallel_logits, target,
                                            label_smoothing)
