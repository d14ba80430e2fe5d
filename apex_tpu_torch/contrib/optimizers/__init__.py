"""apex.contrib.optimizers — port of ``apex_tpu/contrib/optimizers``:
re-exports.  The ZeRO distributed fused optimizers live in
:mod:`apex_tpu_torch.parallel.distributed_optimizer`; this module keeps the
apex ``apex.contrib.optimizers`` import paths, with the contrib-era
``FusedLamb`` spelling and ``FP16_Optimizer`` (imported on first use)."""

from __future__ import annotations

from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.parallel.distributed_optimizer import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB",
           "FusedAdam", "FusedLamb", "FP16_Optimizer"]

FusedLamb = FusedLAMB                       # the contrib-era spelling


def __getattr__(name):
    if name == "FP16_Optimizer":
        from apex_tpu_torch.fp16_utils import FP16_Optimizer
        return FP16_Optimizer
    raise AttributeError(
        f"module 'apex_tpu_torch.contrib.optimizers' has no attribute "
        f"{name!r}")
