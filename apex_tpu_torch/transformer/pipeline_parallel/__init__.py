"""Micro-batch schedules (no pipelining in this slice)."""
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining,
)

__all__ = ["forward_backward_no_pipelining"]
