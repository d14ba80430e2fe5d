"""apex_tpu_torch.resilience — port of ``apex_tpu.resilience``, so far the
parts the serving fleet needs:

* :mod:`~apex_tpu_torch.resilience.faults` — :class:`FaultInjector`, the
  deterministic seeded fault schedule (``seeded_schedule`` also drives the
  serving fleet's :class:`~apex_tpu_torch.serving.ServingFaultInjector`);
* :mod:`~apex_tpu_torch.resilience.capacity` — the pool half:
  :class:`PoolCapacityController` moves replicas between the prefill and
  decode pools of a disaggregated fleet on their SLO burn.

Checkpointing, the guarded train step, elastic training, the train/serve
``CapacityController`` and the autopilot are not ported yet.
"""

from apex_tpu_torch.resilience.capacity import (CAPACITY_FAULT_MODES,
                                                CapacityBudget,
                                                PoolCapacityController,
                                                ReshardFailed, fault_mode)
from apex_tpu_torch.resilience.faults import (FAULT_KINDS, Fault,
                                              FaultInjector, Preemption,
                                              seeded_schedule)

__all__ = ["CAPACITY_FAULT_MODES", "CapacityBudget", "FAULT_KINDS", "Fault",
           "FaultInjector", "PoolCapacityController", "Preemption",
           "ReshardFailed", "fault_mode", "seeded_schedule"]
