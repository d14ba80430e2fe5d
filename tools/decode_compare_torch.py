"""One checkout's decode kernels (#6, #7) and the serving paths that run
them, for comparing two checkouts on one card in one call:

    for t in parent . . parent; do python3 tools/decode_compare_torch.py $t; done

It reports the device time per call of #6 and #7 at ``chip_smoke.py``'s
timed serving shape (CUDA-graph replay over the 24 layers' views), each
wrapper's eager call (host overhead included), the host time of one
GPT-350M decode step (8 slots at position 512) on the slot ring and on
the paged pool, and phase 11's contiguous and paged engines serving
``paged_prompts`` (wall seconds, tokens/s).  Each run prints one
``PROBE {json}`` line; ``TREE`` is the root of a checkout (its own
kernels are built there).
"""
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch.inference import InferenceEngine  # noqa: E402
from apex_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_decode, flash_attention_decode_paged)
from apex_tpu_torch.serving import PagedInferenceEngine  # noqa: E402

c.phase_build()
out = {"tree": tree}
gen = torch.Generator().manual_seed(0)
scale = c.HEAD_DIM ** -0.5
layers = c.GPT350M["num_layers"]
lens_np = np.array([1, 97, 512, 1024, 300, 640, 37, 800], np.int32)
lens = torch.from_numpy(lens_np).to("cuda")
q = torch.randn(c.SLOTS, c.HEADS, c.HEAD_DIM, generator=gen).to("cuda", torch.bfloat16)
cache = torch.randn(c.SLOTS, layers, 2, c.MAX_SEQ, c.HEADS, c.HEAD_DIM,
                    generator=gen).to("cuda", torch.bfloat16)
views = [(cache[:, li, 0], cache[:, li, 1]) for li in range(layers)]
out["decode_ms"] = c.time_ms([lambda k=k, v=v: flash_attention_decode(q, k, v, lens, scale)
                              for k, v in views])
out["decode_call_ms"] = c.call_ms(lambda: flash_attention_decode(q, *views[3], lens, scale))
del cache, views
pool = torch.randn(c.PAGED_POOL, layers, 2, c.PAGED_BS, c.HEADS, c.HEAD_DIM,
                   generator=gen).to("cuda", torch.bfloat16)
tables = torch.from_numpy(c.paged_tables(lens_np, np.random.RandomState(7))).to("cuda")
pviews = [(pool[:, li, 0], pool[:, li, 1]) for li in range(layers)]
out["decode_paged_ms"] = c.time_ms([
    lambda k=k, v=v: flash_attention_decode_paged(q, k, v, tables, lens, scale)
    for k, v in pviews])
out["decode_paged_call_ms"] = c.call_ms(
    lambda: flash_attention_decode_paged(q, *pviews[3], tables, lens, scale))
del pool, pviews
torch.cuda.empty_cache()

model = c.build_model("cuda").init_params(torch.Generator().manual_seed(0))
rng = np.random.RandomState(0)
tokens = torch.from_numpy(rng.randint(0, model.cfg.vocab_size, c.SLOTS)).to("cuda")
positions = torch.full((c.SLOTS,), 512, dtype=torch.int32, device="cuda")
ring = torch.zeros((c.SLOTS, layers, 2, c.MAX_SEQ, c.HEADS, c.HEAD_DIM),
                   dtype=model.cfg.dtype, device="cuda")
paged_pool = torch.zeros((c.PAGED_POOL, layers, 2, c.PAGED_BS, c.HEADS, c.HEAD_DIM),
                         dtype=model.cfg.dtype, device="cuda")
step_tables = c.paged_step_tables()
with torch.no_grad():
    out["decode_step_ms"] = 1e3 * c._host_time(
        lambda: model.decode_step(tokens, ring, positions))
    out["decode_step_paged_ms"] = 1e3 * c._host_time(
        lambda: model.decode_step_paged(tokens, paged_pool, step_tables, positions))
del ring, paged_pool
torch.cuda.empty_cache()
prompts = c.paged_prompts(model.cfg.vocab_size)
for tag, engine in (("contiguous", InferenceEngine(model, max_slots=c.SLOTS)),
                    ("paged", PagedInferenceEngine(model, max_slots=c.SLOTS,
                                                   block_size=c.PAGED_BS))):
    run = c.serve_counted(engine, prompts, f"[11] {tag} engine")
    out[f"serve_{tag}"] = dict(wall_s=run["wall_s"], tokens_per_s=run["tokens_per_s"],
                               launches=run["launches"])
    del engine
    torch.cuda.empty_cache()
print("PROBE " + json.dumps(out), flush=True)
