"""FusedLayerNorm / FusedRMSNorm modules — port of
``apex_tpu/normalization/fused_layer_norm.py``.

``nn.Module``\\ s holding their own parameters.  ``MixedFused*`` keeps the
parameters in f32 and returns the input's dtype (apex's
``MixedFusedLayerNorm``).  Trainable: the backward is the LayerNorm
backward kernel (see :mod:`apex_tpu_torch.ops.layer_norm`), and
``memory_efficient=True`` saves the output instead of the input for it.
"""

from __future__ import annotations

import numbers

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                           fused_layer_norm_affine,
                                           fused_rms_norm,
                                           fused_rms_norm_affine)
from apex_tpu_torch.utils.device import resolve_device

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]


def _normalize_shape(normalized_shape):
    if isinstance(normalized_shape, numbers.Integral):
        return (int(normalized_shape),)
    return tuple(int(d) for d in normalized_shape)


class FusedLayerNorm(nn.Module):
    """Layer norm over the trailing ``normalized_shape`` dims.

    Parity: ``apex.normalization.FusedLayerNorm(normalized_shape, eps,
    elementwise_affine, memory_efficient)``; weight 1 and bias 0 at init.
    """

    rms = False

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 memory_efficient=False, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.normalized_shape = _normalize_shape(normalized_shape)
        self.eps = float(eps)
        self.elementwise_affine = bool(elementwise_affine)
        self.memory_efficient = bool(memory_efficient)
        if self.elementwise_affine:
            dev = resolve_device(device)
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=dev))
            self.bias = None if self.rms else nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=param_dtype, device=dev))

    def forward(self, x, param_map=None):
        """``param_map``, when given, is applied to the weight and the bias
        before they are used (the models wrap them in
        ``copy_to_tensor_model_parallel_region`` under sequence
        parallelism)."""
        if self.elementwise_affine:
            weight, bias = self.weight, self.bias
            if param_map is not None:
                weight = param_map(weight)
                bias = None if bias is None else param_map(bias)
            if self.rms:
                return fused_rms_norm_affine(
                    x, weight, self.normalized_shape, self.eps,
                    self.memory_efficient)
            return fused_layer_norm_affine(
                x, weight, bias, self.normalized_shape, self.eps,
                self.memory_efficient)
        if self.rms:
            return fused_rms_norm(x, self.normalized_shape, self.eps)
        return fused_layer_norm(x, self.normalized_shape, self.eps)


class FusedRMSNorm(FusedLayerNorm):
    """RMSNorm (no mean subtraction, no bias) — apex ``FusedRMSNorm``."""

    rms = True


class MixedFusedLayerNorm(FusedLayerNorm):
    """f32 params with low-precision IO (apex ``MixedFusedLayerNorm``)."""

    def __init__(self, normalized_shape, eps=1e-5, device=None, **kwargs):
        kwargs.pop("elementwise_affine", None)
        kwargs.pop("param_dtype", None)
        super().__init__(normalized_shape, eps=eps, elementwise_affine=True,
                         param_dtype=torch.float32, device=device, **kwargs)

    def forward(self, x, param_map=None):
        return super().forward(x, param_map).to(x.dtype)


class MixedFusedRMSNorm(MixedFusedLayerNorm):
    rms = True
