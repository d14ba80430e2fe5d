"""Data-parallel pieces — port of ``apex_tpu/parallel``: what is ported is
SyncBatchNorm's local path (statistics on one device).  DDP, LARC, the
distributed optimizer and cross-device statistics come with the multi-GPU
slice."""
from apex_tpu_torch.parallel.sync_batchnorm import (BatchNormState,
                                                    SyncBatchNorm,
                                                    convert_syncbn_model,
                                                    sync_batch_norm)

__all__ = ["BatchNormState", "sync_batch_norm", "SyncBatchNorm",
           "convert_syncbn_model"]
