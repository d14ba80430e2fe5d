"""apex_tpu_torch.serving — the serving tier on top of inference (port of
``apex_tpu.serving``).

* :class:`PagedKVCache` — block-pool KV storage with ref-counted,
  radix-trie-keyed prefix sharing and copy-on-write forking;
  :class:`QuantizedPagedKVCache` its int8 scale-per-block variant.
* :class:`PagedInferenceEngine` — continuous batching over the block pool,
  token for token the contiguous engine's, with chunked prefill
  (:class:`TickScheduler` budgets), exact-match speculative decoding
  (:class:`SpeculativeConfig`), the int8 KV pool, and the KV handoff
  (:class:`KvHandoff`) of disaggregated serving.
* :class:`Router` — SLO-burn-aware multi-replica admission with explicit
  shedding (:class:`RequestShed` + :class:`ShedReason`).
* :mod:`apex_tpu_torch.serving.fleet` — fault tolerance: seeded replica
  fault injection (:class:`ServingFaultInjector`), the health-checked
  :class:`FleetRouter` (retry, hedging, cross-replica migration, the
  drain / add / remove replica lifecycle) and the burn-driven
  :class:`DegradationLadder`.
* :mod:`apex_tpu_torch.serving.disagg` — :class:`DisaggregatedFleet`
  fronts a prefill pool and a decode pool and ships each request's KV
  blocks over a :class:`KvChannel`.

``tools/loadgen_torch.py`` drives the fleet under the chaos scenarios.
"""

from apex_tpu_torch.serving.disagg import DisaggregatedFleet, KvChannel
from apex_tpu_torch.serving.engine import KvHandoff, PagedInferenceEngine
from apex_tpu_torch.serving.fleet import (SERVING_FAULT_KINDS,
                                          DegradationLadder, FleetRouter,
                                          ReplicaHealth, ServingFault,
                                          ServingFaultInjector, VirtualClock)
from apex_tpu_torch.serving.paged_kv import (PagedKVCache, PagedSequence,
                                             QuantizedPagedKVCache)
from apex_tpu_torch.serving.router import RequestShed, Router, ShedReason
from apex_tpu_torch.serving.scheduler import TickPlan, TickScheduler
from apex_tpu_torch.serving.speculative import SpeculativeConfig

__all__ = ["DegradationLadder", "DisaggregatedFleet", "FleetRouter",
           "KvChannel", "KvHandoff", "PagedInferenceEngine", "PagedKVCache",
           "PagedSequence", "QuantizedPagedKVCache", "ReplicaHealth",
           "RequestShed", "Router", "SERVING_FAULT_KINDS", "ServingFault",
           "ServingFaultInjector", "ShedReason", "SpeculativeConfig",
           "TickPlan", "TickScheduler", "VirtualClock"]
