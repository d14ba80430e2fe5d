"""Fused softmax + cross entropy — port of ``apex_tpu/ops/xentropy.py``
(apex ``contrib/xentropy``).

Plain PyTorch: the JAX package has no kernel here either.  What the fused
op keeps is its memory behaviour: the forward computes the loss from the
row maximum and log-sum-exp without keeping the softmax, and the backward
rebuilds ``softmax - onehot`` from the saved log-sum-exp.  The autograd
Function saves what JAX's ``_xent_fwd`` keeps: the logits (the op's own
input), the labels with the ignored ones set to 0, the valid-row mask and
the ``(N,)`` log-sum-exp.  Label smoothing as apex:
``loss = (1 - s) * nll + s * (lse - mean(logits))``.
"""

from __future__ import annotations

import torch

_f32 = torch.float32

__all__ = ["softmax_cross_entropy_loss", "SoftmaxCrossEntropyLoss"]


class _SoftmaxCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, smoothing, ignore_index,
                half_to_float):
        x = logits.to(_f32)
        lse = torch.logsumexp(x, dim=-1)
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        nll = lse - torch.gather(x, 1, safe[:, None])[:, 0]
        if smoothing > 0.0:
            loss = (1.0 - smoothing) * nll + smoothing * (
                lse - torch.mean(x, dim=-1))
        else:
            loss = nll
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        ctx.smoothing = smoothing
        ctx.save_for_backward(logits, safe, valid, lse)
        return loss if half_to_float else loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, valid, lse = ctx.saved_tensors
        s = ctx.smoothing
        n, c = logits.shape
        grad = torch.exp(logits.to(_f32) - lse[:, None])
        rows = torch.arange(n, device=logits.device)
        grad[rows, labels] -= 1.0 - s
        if s > 0.0:
            grad -= s / c
        scale = torch.where(valid, dloss.to(_f32), torch.zeros_like(lse))
        return (grad * scale[:, None]).to(logits.dtype), None, None, None, \
            None


def softmax_cross_entropy_loss(logits, labels, smoothing=0.0,
                               ignore_index=-100, half_to_float=False):
    """Per-example loss ``(N,)`` for logits ``(N, C)`` and int labels
    ``(N,)``; apex ``SoftmaxCrossEntropyLoss.apply`` semantics (rows whose
    label is ``ignore_index`` give zero loss and zero gradient).  The loss
    is computed in f32 and returned in the logits' dtype, or in f32 with
    ``half_to_float``."""
    return _SoftmaxCrossEntropy.apply(logits, labels, float(smoothing),
                                      int(ignore_index), bool(half_to_float))


class SoftmaxCrossEntropyLoss:
    """apex ``contrib.xentropy.SoftmaxCrossEntropyLoss`` (its static
    ``apply``)."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=-100,
              half_to_float=False):
        return softmax_cross_entropy_loss(logits, labels, smoothing,
                                          padding_idx, half_to_float)
