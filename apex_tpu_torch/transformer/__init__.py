"""Megatron-style transformer building blocks (reference:
``apex/transformer/__init__.py``): :mod:`.tensor_parallel` (tensor and
sequence parallelism over the ``model`` process group),
:mod:`.pipeline_parallel` (the ring pipeline over ``pipe``),
:mod:`.context_parallel` (ring / Ulysses attention over ``context``),
:mod:`.expert_parallel` (the mixture-of-experts FFN over ``expert``);
:mod:`.parallel_state` maps the mesh axes to process groups."""

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer import tensor_parallel
from apex_tpu_torch.transformer import pipeline_parallel
from apex_tpu_torch.transformer import context_parallel
from apex_tpu_torch.transformer import expert_parallel
from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
    ConstantNumMicroBatches,
    RampupBatchsizeNumMicroBatches,
)
from apex_tpu_torch.transformer.enums import (AttnMaskType, AttnType,
                                              LayerType, ModelType)

__all__ = [
    "parallel_state",
    "tensor_parallel",
    "pipeline_parallel",
    "context_parallel",
    "expert_parallel",
    "build_num_microbatches_calculator",
    "ConstantNumMicroBatches",
    "RampupBatchsizeNumMicroBatches",
    "AttnMaskType",
    "AttnType",
    "LayerType",
    "ModelType",
]
