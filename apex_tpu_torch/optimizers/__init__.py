"""Fused optimizers (per-parameter layout): FusedAdam, FusedLAMB and
FusedMixedPrecisionLamb."""
from apex_tpu_torch.optimizers.base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import (FusedLAMB,
                                                  FusedMixedPrecisionLamb)

__all__ = ["FusedOptimizer", "FusedAdam", "FusedLAMB",
           "FusedMixedPrecisionLamb"]
