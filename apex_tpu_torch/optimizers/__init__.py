"""Fused optimizers (per-parameter layout): FusedAdam, FusedLAMB,
FusedMixedPrecisionLamb, FusedSGD, FusedAdagrad and FusedNovoGrad."""
from apex_tpu_torch.optimizers.base import FusedOptimizer
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import (FusedLAMB,
                                                  FusedMixedPrecisionLamb)
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD

__all__ = ["FusedOptimizer", "FusedAdam", "FusedLAMB",
           "FusedMixedPrecisionLamb", "FusedSGD", "FusedAdagrad",
           "FusedNovoGrad"]
