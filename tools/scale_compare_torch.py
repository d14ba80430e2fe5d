"""One checkout's multi-tensor scale (#15), for comparing two checkouts on
one card in one call:

    for t in parent . . parent; do python3 tools/scale_compare_torch.py $t; done

It reports, at the three shapes #15's callers give it, the device time per
call (CUDA-graph replay, ``chip_smoke``'s ``time_ms``; every list is far
above the 50 MB L2, so each replay reads device memory), the launches of
one call, the eager call (host overhead included, ``call_ms``), and
sha256s of the outputs and of the found-inf flag after one call on inputs
from seed 2 (the same in every tree): BERT-large's O2 gradients
(``chip_smoke.bert_param_specs``: 299 tensors, bf16 with f32 LayerNorms)
into lists of the same dtypes by 2**-10 (the unscale); GPT-350M's 291 f32
masters into bf16 copies (FusedAdam's master copy); BERT-large's sizes as
f16 gradients into f32 (apex's fp16 O2 unscale).  Each run prints one
``PROBE {json}`` line; ``TREE`` is the root of a checkout (its own kernels
are built there).
"""
import hashlib
import json
import os
import subprocess
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch.ops import multi_tensor as K  # noqa: E402

c.phase_build()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip()
out = {"tree": tree, "nvidia_smi": smi}
gen = torch.Generator(device="cuda").manual_seed(2)


def rand(shape, std):
    return torch.randn(shape, generator=gen, device="cuda") * std


def sha(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


bert = c.bert_param_specs()
cases = {
    "bert_large_O2_unscale": (
        lambda: [rand(s, 1e-3).to(dt) for s, dt in bert], None, 2.0 ** -10),
    "gpt350m_master_copy": (
        lambda: [rand(s, 0.02) for s in c.gpt350m_shapes()], torch.bfloat16,
        1.0),
    "bert_large_f16_to_f32": (
        lambda: [rand(s, 1.0).half() for s, _ in bert], torch.float32,
        2.0 ** -10)}
for name, (make, odt, sv) in cases.items():
    xs = make()
    outs = [torch.empty_like(x, dtype=odt or x.dtype) for x in xs]
    s = torch.full((), sv, device="cuda")
    K.multi_tensor_scale_.launches = 0
    flag = K.multi_tensor_scale_(xs, outs, s)
    torch.cuda.synchronize()
    out[name] = {
        "tensors": len(xs), "elements": sum(x.numel() for x in xs),
        "launches": K.multi_tensor_scale_.launches,
        "sha256_outputs": sha(outs), "sha256_flag": sha([flag]),
        "flag": float(flag),
        "ms": c.time_ms([lambda: K.multi_tensor_scale_(xs, outs, s)] * 5),
        "call_ms": c.call_ms(lambda: K.multi_tensor_scale_(xs, outs, s),
                             iters=20)}
    del xs, outs
    torch.cuda.empty_cache()
print("PROBE " + json.dumps(out), flush=True)
