"""Megatron-style transformer building blocks: :mod:`.tensor_parallel`
(tensor and sequence parallelism over the ``model`` process group);
:mod:`.parallel_state` maps the mesh axes to process groups."""

from apex_tpu_torch.transformer.enums import (AttnMaskType, AttnType,
                                              LayerType, ModelType)

__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
