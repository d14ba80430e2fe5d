"""Vocab-parallel cross entropy — port of
``apex_tpu/transformer/tensor_parallel/cross_entropy.py``.

Plain PyTorch (the JAX package has no kernel here either): a
:class:`torch.autograd.Function` with the JAX custom VJP's forward and its
analytic backward ``softmax - onehot`` (label smoothing by apex's formula),
in f32 whatever the logits' dtype.  The logits' last dim is this rank's
shard of the vocab over the group of ``axis_name`` (``model`` by default;
the whole vocab where the axis is one rank): the row maxima are
all-reduced with MAX, the sums of exponentials, the target's logit (each
rank picks it only when the target falls in its vocab range) and, under
label smoothing, the logit sums over the global vocab with SUM.  The
backward needs no collective.  The forward saves ``exp(x - max)`` and its
row sums, as JAX does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    TENSOR_AXIS, axis_group)
from apex_tpu_torch.utils.collectives import check_backend

_f32 = torch.float32

__all__ = ["vocab_parallel_cross_entropy"]


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    if group is not None:
        check_backend(x, group, "vocab_parallel_cross_entropy")
        dist.all_reduce(x, op=op, group=group)
    return x


class _VocabParallelCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, label_smoothing, group):
        x = logits.to(_f32)
        part = x.shape[-1]
        world = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        gmax = _all_reduce(torch.amax(x, dim=-1), group, dist.ReduceOp.MAX)
        x = x - gmax[..., None]
        exp_x = torch.exp(x)
        sum_exp = _all_reduce(torch.sum(exp_x, dim=-1), group)
        local_t = target - rank * part
        in_range = (local_t >= 0) & (local_t < part)
        safe_t = torch.where(in_range, local_t, torch.zeros_like(local_t))
        picked = torch.gather(x, -1, safe_t[..., None])[..., 0]
        picked = _all_reduce(
            torch.where(in_range, picked, torch.zeros_like(picked)), group)
        log_z = torch.log(sum_exp)
        loss = log_z - picked
        if label_smoothing > 0.0:
            # apex: s_adj = s * V/(V-1), loss = (1-s_adj)*nll + s_adj *
            # mean_i(log_z - logit_i), the mean over the global vocab
            vocab = part * world
            s_adj = label_smoothing * vocab / (vocab - 1)
            logit_sum = _all_reduce(torch.sum(x, dim=-1), group)
            smooth = log_z - logit_sum / vocab
            loss = (1.0 - s_adj) * loss + s_adj * smooth
        ctx.label_smoothing = label_smoothing
        ctx.vocab = part * world
        ctx.logits_dtype = logits.dtype
        ctx.save_for_backward(exp_x, sum_exp, in_range, safe_t)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        exp_x, sum_exp, in_range, safe_t = ctx.saved_tensors
        vocab = ctx.vocab
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
        return grad.to(ctx.logits_dtype), None, None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing: float = 0.0,
                                 axis_name: str = TENSOR_AXIS):
    """Per-token loss ``(...)`` f32 for logits ``(..., vocab / t)`` (this
    rank's vocab shard over ``axis_name``) and int targets ``(...)``
    (global vocab ids).  ``label_smoothing`` in ``[0, 1)``;
    ``axis_name=None`` for the serial form."""
    label_smoothing = float(label_smoothing)
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got "
                         f"{label_smoothing}")
    return _VocabParallelCrossEntropy.apply(
        vocab_parallel_logits, target, label_smoothing,
        axis_group(axis_name))
