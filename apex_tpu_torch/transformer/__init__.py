"""Megatron-style transformer building blocks: tensor parallelism at world
size 1; :mod:`.parallel_state` maps the mesh axes to process groups."""

from apex_tpu_torch.transformer.enums import (AttnMaskType, AttnType,
                                              LayerType, ModelType)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
