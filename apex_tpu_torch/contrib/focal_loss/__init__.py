"""Sigmoid focal loss — port of ``apex_tpu/contrib/focal_loss/__init__.py``
(apex ``focal_loss_cuda.forward``).

Integer class targets with ``-1`` meaning background (no positive class)
and ``-2`` meaning an ignored anchor; the loss is summed over all anchors
and divided by ``max(num_positives_sum, 1)`` (the JAX normalisation, not
a mean).  One chain of PyTorch ops: the JAX function has no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["focal_loss", "FocalLoss"]

_f32 = torch.float32


def focal_loss(cls_output, cls_targets, num_positives_sum,
               num_real_classes=None, alpha=0.25, gamma=2.0,
               label_smoothing=0.0):
    """``cls_output``: ``(..., C)`` raw logits; ``cls_targets``: ``(...)``
    int class ids in ``[0, C)``, ``-1`` background, ``-2`` ignored.
    Returns the scalar ``sum(loss) / max(num_positives_sum, 1)``."""
    num_classes = cls_output.shape[-1]
    if num_real_classes is None:
        num_real_classes = num_classes
    x = cls_output.to(_f32)
    t = cls_targets.to(torch.int64)
    onehot = F.one_hot(torch.where(t < 0, num_classes, t),
                       num_classes + 1)[..., :num_classes].to(_f32)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + 0.5 * label_smoothing
    p = torch.sigmoid(x)
    # the numerically stable BCE with logits
    bce = torch.clamp(x, min=0.0) - x * onehot + torch.log1p(
        torch.exp(-x.abs()))
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    a_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    loss = a_t * (1.0 - p_t) ** gamma * bce
    # zero the padded (fake) classes and the ignored anchors
    if num_real_classes < num_classes:
        loss = loss * (torch.arange(num_classes, device=x.device)
                       < num_real_classes)
    loss = loss * (t != -2)[..., None]
    denom = torch.as_tensor(num_positives_sum, dtype=_f32, device=x.device)
    return loss.sum() / torch.clamp(denom, min=1.0)


class FocalLoss:
    """The autograd-function surface (``FocalLoss.apply``)."""

    @staticmethod
    def apply(cls_output, cls_targets_at_level, num_positives_sum,
              num_real_classes, alpha, gamma, label_smoothing=0.0):
        return focal_loss(cls_output, cls_targets_at_level,
                          num_positives_sum, num_real_classes, alpha,
                          gamma, label_smoothing)
