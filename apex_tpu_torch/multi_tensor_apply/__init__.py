"""Multi-tensor apply — port of ``apex_tpu/multi_tensor_apply`` without
its ``(rows, 128)`` packing (``bucketing.py`` is a TPU lane layout; the
CUDA launch table of ``csrc/multi_tensor.cuh`` takes the tensors where
they lie)."""
from apex_tpu_torch.multi_tensor_apply.functional import (
    MultiTensorApply,
    multi_tensor_applier,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
)

__all__ = [
    "MultiTensorApply",
    "multi_tensor_applier",
    "multi_tensor_scale",
    "multi_tensor_axpby",
    "multi_tensor_l2norm",
]
