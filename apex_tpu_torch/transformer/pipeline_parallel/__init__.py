"""Pipeline parallelism: the ring engine (1F1B and interleaved) over the
``pipe`` process group, its stage-to-stage hops, and apex's schedules."""
from apex_tpu_torch.transformer.pipeline_parallel.ring import (
    JobInfo,
    bubble_fraction,
    pipeline_forward,
    pipeline_schedule_step,
    pipeline_value_and_grad,
    schedule_ticks,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    get_forward_backward_func,
    forward_backward_no_pipelining,
    forward_backward_pipelining_without_interleaving,
    forward_backward_pipelining_with_interleaving,
)
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication

__all__ = [
    "JobInfo",
    "bubble_fraction",
    "get_forward_backward_func",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "pipeline_forward",
    "pipeline_schedule_step",
    "pipeline_value_and_grad",
    "schedule_ticks",
    "p2p_communication",
]
