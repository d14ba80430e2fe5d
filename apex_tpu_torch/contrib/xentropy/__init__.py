"""apex ``contrib.xentropy`` (the implementation is
:mod:`apex_tpu_torch.ops.xentropy`)."""

from apex_tpu_torch.ops.xentropy import (SoftmaxCrossEntropyLoss,
                                         softmax_cross_entropy_loss)

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy_loss"]
