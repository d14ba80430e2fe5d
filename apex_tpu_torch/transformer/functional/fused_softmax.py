"""FusedScaleMaskSoftmax — port of
``apex_tpu/transformer/functional/fused_softmax.py``.

apex dispatches between its causal, masked and generic CUDA kernels by
shape (with a sequence limit of 4K); the ops of
:mod:`apex_tpu_torch.ops.softmax` have no such limit, so the dispatch is on
the mask type alone.  ``input_in_fp16`` / ``input_in_bf16`` and
``scaled_masked_softmax_fusion`` are kept for constructor parity;
``mask_func`` and ``softmax_in_fp32`` behave as in apex.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.ops.softmax import (MASK_FILL, _causal_mask,
                                        scaled_masked_softmax, scaled_softmax,
                                        scaled_upper_triang_masked_softmax)
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = ["FusedScaleMaskSoftmax"]


class FusedScaleMaskSoftmax(nn.Module):
    """``forward(x, mask=None)`` over ``(b, np, sq, sk)`` scores."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = True,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        super().__init__()
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError(
                "both fp16 and bf16 flags cannot be active at the same "
                "time.")  # apex parity
        if scale is not None and not softmax_in_fp32:
            raise RuntimeError(
                "softmax should be in fp32 when scaled")  # apex parity
        self.attn_mask_type = attn_mask_type
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = 1.0 if scale is None else float(scale)

    def forward(self, x, mask=None):
        causal = self.attn_mask_type == AttnMaskType.causal
        if not self.softmax_in_fp32:
            # apex's non-fp32 path: the softmax in the input dtype
            xs = x * self.scale
            if causal:
                xs = torch.where(_causal_mask(x.shape[-2], x.shape[-1],
                                              x.device), MASK_FILL, xs)
            elif mask is not None:
                xs = (self.mask_func(xs, mask) if self.mask_func is not None
                      else torch.where(mask, MASK_FILL, xs))
            return torch.softmax(xs, dim=-1)
        if causal:
            # apex's kernel takes (b * np, sq, sk)
            b, np_, sq, sk = x.shape
            y = scaled_upper_triang_masked_softmax(
                x.reshape(b * np_, sq, sk), self.scale)
            return y.reshape(b, np_, sq, sk)
        if mask is not None:
            if self.mask_func is not None:
                xm = self.mask_func(x.to(torch.float32) * self.scale, mask)
                return scaled_masked_softmax(xm, None, 1.0).to(x.dtype)
            return scaled_masked_softmax(x, mask, self.scale)
        return scaled_softmax(x, self.scale)
