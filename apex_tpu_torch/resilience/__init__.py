"""apex_tpu_torch.resilience — port of ``apex_tpu.resilience``.

* :mod:`~apex_tpu_torch.resilience.checkpoint` — atomic, content-hashed,
  shard-aware checkpointing with a ``latest``-symlink commit protocol and
  async double-buffered writes (:class:`CheckpointManager`); one process
  writes the JAX package's format, and ranks write their own shards;
* :mod:`~apex_tpu_torch.resilience.guard` — :class:`GuardedTrainStep`,
  the loss-scaler overflow skip generalized: NaN/inf and grad-norm-spike
  steps are skipped on the device, K consecutive anomalies roll back to
  the last complete checkpoint;
* :mod:`~apex_tpu_torch.resilience.faults` — :class:`FaultInjector`, the
  deterministic seeded fault schedule (``seeded_schedule`` also drives the
  serving fleet's ``ServingFaultInjector``);
* :mod:`~apex_tpu_torch.resilience.elastic` — :class:`TopologySpec` /
  :class:`ElasticPlan` (a spec resolved onto ranks),
  :func:`reshard_optimizer_state` (ZeRO gather-to-logical -> re-split and
  per-leaf moves across dp changes, f32 bitwise),
  :class:`ZeROGuardAdapter` and :class:`ElasticTrainer`, the
  signal-driven drain -> checkpoint -> re-plan -> re-shard -> resume loop;
* :mod:`~apex_tpu_torch.resilience.capacity` — :class:`CapacityController`
  shifts chips between an :class:`ElasticTrainer` and a serving fleet on
  SLO burn, and :class:`PoolCapacityController` replicas between the
  prefill and decode pools of a disaggregated fleet;
* :mod:`~apex_tpu_torch.resilience.autopilot` —
  :class:`ParallelismAutopilot`: cost-model drift detection over refits,
  re-ranking and gated, reversible plan adoption over an
  :class:`ElasticTrainer` (``ADOPTION_OUTCOMES``).
"""

from apex_tpu_torch.resilience.autopilot import (ADOPTION_OUTCOMES,
                                                 ParallelismAutopilot)
from apex_tpu_torch.resilience.capacity import (CAPACITY_FAULT_MODES,
                                                CapacityBudget,
                                                CapacityController,
                                                PoolCapacityController,
                                                ReshardFailed, fault_mode)
from apex_tpu_torch.resilience.checkpoint import (CheckpointManager,
                                                  CheckpointNotFound,
                                                  ShardedLeaf)
from apex_tpu_torch.resilience.elastic import (ElasticComponents,
                                               ElasticPlan, ElasticSignal,
                                               ElasticTrainer, HostSignals,
                                               TopologySpec,
                                               ZeROGuardAdapter,
                                               reshard_optimizer_state)
from apex_tpu_torch.resilience.faults import (FAULT_KINDS, Fault,
                                              FaultInjector, Preemption,
                                              seeded_schedule)
from apex_tpu_torch.resilience.guard import (GuardedTrainStep, GuardState,
                                             StepResult,
                                             load_optimizer_state,
                                             optimizer_state)

__all__ = ["ADOPTION_OUTCOMES", "CAPACITY_FAULT_MODES", "CapacityBudget",
           "CapacityController", "CheckpointManager", "CheckpointNotFound",
           "ElasticComponents", "ElasticPlan", "ElasticSignal",
           "ElasticTrainer", "FAULT_KINDS", "Fault", "FaultInjector",
           "GuardState", "GuardedTrainStep", "HostSignals",
           "ParallelismAutopilot", "PoolCapacityController", "Preemption",
           "ReshardFailed", "ShardedLeaf", "StepResult", "TopologySpec",
           "ZeROGuardAdapter", "fault_mode", "load_optimizer_state",
           "optimizer_state", "reshard_optimizer_state", "seeded_schedule"]
