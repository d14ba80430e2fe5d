"""apex_tpu_torch.inference — KV-cache decode + continuous-batching serving
(port of ``apex_tpu.inference``).

* :class:`KVCache` — a preallocated slot ring
  ``(slots, layers, 2, max_seq, kv_heads, head_dim)``, bf16 with f32
  attention accumulation;
* :class:`SamplingParams` / :func:`sample` — greedy, temperature, top-k,
  top-p;
* :class:`InferenceEngine` — requests admit as slots free (one prefill
  each), then ride one batched ``decode_step`` whose batch dimension is the
  slot table.
"""

from apex_tpu_torch.inference.engine import (InferenceEngine, QueueFull,
                                             Request, Response)
from apex_tpu_torch.inference.kv_cache import KVCache
from apex_tpu_torch.inference.sampling import SamplingParams, sample

__all__ = ["InferenceEngine", "KVCache", "QueueFull", "Request", "Response",
           "SamplingParams", "sample"]
