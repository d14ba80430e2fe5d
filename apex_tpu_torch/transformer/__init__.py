"""Megatron-style transformer building blocks (world size 1 in this
slice)."""

from apex_tpu_torch.transformer.enums import (AttnMaskType, AttnType,
                                              LayerType, ModelType)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
