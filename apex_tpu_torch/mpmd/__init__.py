"""apex_tpu_torch.mpmd — port of ``apex_tpu.mpmd``: cross-pod MPMD pipeline
parallelism.

Across pods there is no shared program: each pipeline stage is its own
program (:class:`StageProgram`, one :class:`torch.device` a stage), a
host-driven schedule (:mod:`~apex_tpu_torch.mpmd.schedule`) orders the work,
and stage boundaries move through an explicit DCN channel
(:class:`LocalDcnChannel` / retryable :class:`DcnTimeout`, which the
disaggregated serving fleet also ships KV blocks over).  The
:class:`MpmdPipeline` engine binds them; at ``dp == 1`` its loss and
gradients are bit for bit the port's ring engine's
(:func:`~apex_tpu_torch.models.gpt.pipeline_step`) at the same stage
count.  :mod:`apex_tpu_torch.observability.anatomy` reconstructs its traced
steps into measured timelines.

Plans: set ``n_pods > 1`` on a :class:`~apex_tpu_torch.parallel.plan.
ParallelPlan`.  Tensor parallelism inside a stage (``tp > 1``, and so
heterogeneous per-pod ``stage_plans``) is not ported (``ROADMAP.md`` queue
A, item 17's leftover).
"""

from apex_tpu_torch.mpmd.channel import DcnTimeout, Edge, LocalDcnChannel
from apex_tpu_torch.mpmd.engine import MPMD_PLAN_FILE, MpmdPipeline
from apex_tpu_torch.mpmd.schedule import (SCHEDULES, Op, edge_link_classes,
                                          merge_stage_ops, schedule_1f1b,
                                          schedule_dcn_hiding, simulate,
                                          stage_ops_1f1b, validate_order)
from apex_tpu_torch.mpmd.stage import StageProgram

__all__ = [
    "DcnTimeout", "Edge", "LocalDcnChannel", "MpmdPipeline",
    "MPMD_PLAN_FILE", "StageProgram", "Op", "SCHEDULES",
    "schedule_1f1b", "schedule_dcn_hiding", "stage_ops_1f1b",
    "merge_stage_ops", "validate_order", "edge_link_classes",
    "simulate",
]
