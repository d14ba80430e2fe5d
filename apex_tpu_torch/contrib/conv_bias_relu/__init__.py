"""Conv + bias (+ ReLU / + mask) — port of
``apex_tpu/contrib/conv_bias_relu/__init__.py`` (apex's four cudnn-frontend
fused autograd functions).

The reference's layouts stay at the surface: NHWC activations, HWIO
weights, symmetric ``padding`` and a square ``stride``.  Inside, the
activation is viewed channels-last as NCHW and the weight as OIHW, so
``F.conv2d`` runs cuDNN's channels-last convolution (as
:mod:`apex_tpu_torch.models.resnet` does); the epilogues are PyTorch ops,
as the JAX functions are XLA fusions with no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ConvBiasReLU", "ConvBias", "ConvBiasMaskReLU",
           "ConvFrozenScaleBiasReLU"]


def _conv(x, w, stride, padding):
    """NHWC x, HWIO w -> NHWC y."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def ConvBias(x, weight, bias, padding=0, stride=1):
    """conv + per-channel bias (reference ``ConvBias.apply``)."""
    return _conv(x, weight, stride, padding) + bias.to(x.dtype)


def ConvBiasReLU(x, weight, bias, padding=0, stride=1):
    """conv + bias + relu (reference ``ConvBiasReLU.apply``)."""
    return torch.relu(ConvBias(x, weight, bias, padding, stride))


def ConvBiasMaskReLU(x, weight, bias, mask, padding=0, stride=1):
    """conv + bias + elementwise mask + relu (reference
    ``ConvBiasMaskReLU.apply``; the mask is the dropout / DropBlock mask
    made upstream)."""
    y = ConvBias(x, weight, bias, padding, stride)
    return torch.relu(y * mask.to(y.dtype))


def ConvFrozenScaleBiasReLU(x, weight, scale, bias, padding=0, stride=1):
    """conv + frozen-BN folded scale / bias + relu (reference
    ``ConvFrozenScaleBiasReLU.apply``)."""
    y = _conv(x, weight, stride, padding)
    return torch.relu(y * scale.to(y.dtype) + bias.to(y.dtype))
