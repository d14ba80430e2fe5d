"""apex_tpu_torch.serving — the serving tier on top of inference (port of
``apex_tpu.serving``).

* :class:`PagedKVCache` — block-pool KV storage with ref-counted,
  radix-trie-keyed prefix sharing and copy-on-write forking;
  :class:`QuantizedPagedKVCache` its int8 scale-per-block variant.
* :class:`PagedInferenceEngine` — continuous batching over the block pool,
  token for token the contiguous engine's, with chunked prefill
  (:class:`TickScheduler` budgets), exact-match speculative decoding
  (:class:`SpeculativeConfig`) and the int8 KV pool.

The router, the fault-tolerant fleet and the disaggregated prefill/decode
serving wait for the fleet slice.
"""

from apex_tpu_torch.serving.engine import PagedInferenceEngine
from apex_tpu_torch.serving.paged_kv import (PagedKVCache, PagedSequence,
                                             QuantizedPagedKVCache)
from apex_tpu_torch.serving.scheduler import TickPlan, TickScheduler
from apex_tpu_torch.serving.speculative import SpeculativeConfig

__all__ = ["PagedInferenceEngine", "PagedKVCache", "PagedSequence",
           "QuantizedPagedKVCache", "SpeculativeConfig", "TickPlan",
           "TickScheduler"]
