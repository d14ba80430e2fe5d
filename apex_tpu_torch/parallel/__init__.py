"""Data parallelism — port of ``apex_tpu/parallel``: DistributedDataParallel,
Reducer and allreduce_gradients over :mod:`torch.distributed` process
groups, SyncBatchNorm (statistics across the ranks of a group), LARC, and
the ZeRO DistributedFusedAdam / DistributedFusedLAMB on the packed bucket
layout, and ``ParallelPlan``, the one validated parallelism layout the
model configs, the ZeRO optimizers and the serving engine consume."""
from apex_tpu_torch.parallel.distributed import (DEFAULT_DATA_AXIS,
                                                 DistributedDataParallel,
                                                 Reducer,
                                                 allreduce_gradients)
from apex_tpu_torch.parallel.distributed_optimizer import (
    DistributedFusedAdam, DistributedFusedLAMB)
from apex_tpu_torch.parallel.LARC import LARC, larc
from apex_tpu_torch.parallel.plan import PLAN_VERSION, ParallelPlan
from apex_tpu_torch.parallel.sync_batchnorm import (BatchNormState,
                                                    SyncBatchNorm,
                                                    convert_syncbn_model,
                                                    sync_batch_norm)

__all__ = ["PLAN_VERSION", "ParallelPlan", "DistributedDataParallel", "Reducer", "allreduce_gradients",
           "DEFAULT_DATA_AXIS", "DistributedFusedAdam",
           "DistributedFusedLAMB", "BatchNormState", "sync_batch_norm",
           "SyncBatchNorm", "convert_syncbn_model", "LARC", "larc"]
