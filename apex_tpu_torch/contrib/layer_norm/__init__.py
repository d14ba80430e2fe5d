"""FastLayerNorm — port of ``apex_tpu/contrib/layer_norm/__init__.py``.

The module and the function over the port's fused LayerNorm: on the card
the forward kernel (#1, ``csrc/layer_norm_fwd.cu``) and the backward (#2,
``csrc/layer_norm_bwd.cu``), with no hidden-size whitelist.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine

__all__ = ["FastLayerNorm", "fast_layer_norm"]


def fast_layer_norm(x, weight, bias, epsilon=1e-5):
    return fused_layer_norm_affine(x, weight, bias, eps=epsilon)


class FastLayerNorm(FusedLayerNorm):
    """apex ``contrib.layer_norm.FastLayerNorm(hidden_size, eps)``."""

    def __init__(self, hidden_size, eps=1e-5, param_dtype=torch.float32,
                 device=None):
        super().__init__(hidden_size, eps=eps, elementwise_affine=True,
                         param_dtype=param_dtype, device=device)
