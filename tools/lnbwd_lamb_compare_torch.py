"""One checkout's LayerNorm backward (#2), LAMB stage 1 (#20) and
multi-tensor SGD (#19), and a BERT-large O2 step, for comparing two
checkouts on one card in one call:

    for t in parent . . parent; do python3 tools/lnbwd_lamb_compare_torch.py $t; done

It reports the device time per call (CUDA-graph replay, ``chip_smoke``'s
``time_ms``) of #2 at 8192 x 1024 bf16 (LN from x) with one input pair
replayed (it stays in the 50 MB L2) and with six pairs taken in turn (read
from device memory), each beside ``aten.native_layer_norm_backward`` on
the same inputs, and a sha256 of #2's outputs; #20 over BERT-large's O2
list (``chip_smoke.bert_param_specs``: bf16 / f32 gradients, f32 masters)
with its launches, eager call, and sha256s of its u, m and v and of its
chunk partials after one call on inputs from a seed; #19's output hashes
and times over ResNet-50's O1 / O2 lists and GPT-350M's (as
``tools/sgd_ln_compare_torch.py``); then 5 BERT-large O2 + FusedLAMB
steps (bench.py's recipe, phase 7 of ``chip_smoke.py``) after a warm-up:
the median wall (host clock, ending in a sync), and the median device
busy time of 5 more steps, each under ``torch.profiler``, with its
``layer_norm_bwd`` and ``multi_tensor_lamb_stage1`` shares.  Each run
prints one ``PROBE {json}`` line; ``TREE`` is the root of a checkout (its
own kernels are built there).
"""
import hashlib
import json
import os
import statistics
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch.ops import multi_tensor as K  # noqa: E402
from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd,  # noqa: E402
                                           layer_norm_fwd)

c.phase_build()
out = {"tree": tree}
gen = torch.Generator(device="cuda").manual_seed(2)


def rand(shape, std):
    return torch.randn(shape, generator=gen, device="cuda") * std


def sha(tensors):
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# #2 at the training shape, LN from x
rows, hidden = c.TRAIN_ROWS, c.HIDDEN
w = 1 + rand(hidden, 0.1)
b = rand(hidden, 0.1)
w16, b16 = w.bfloat16(), b.bfloat16()
sets = []
for _ in range(6):
    x = rand((rows, hidden), 1.0).bfloat16()
    dy = rand((rows, hidden), 1.0).bfloat16()
    _, mean, rstd = layer_norm_fwd(x, w, b, 1e-5, False)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [hidden], w16, b16,
                                                       1e-5)
    sets.append((dy, x, mean, rstd, lmean, lrstd))


def ln_kernel(t):
    return layer_norm_bwd(t[0], t[1], w, b, t[2], t[3], False, False)


def ln_library(t):
    return torch.ops.aten.native_layer_norm_backward(
        t[0], t[1], [hidden], t[4], t[5], w16, b16, [True, True, True])


row = {"sha256": sha(ln_kernel(sets[0])),
       "ms": c.time_ms(lambda: ln_kernel(sets[0])),
       "library_ms": c.time_ms(lambda: ln_library(sets[0])),
       "ms_l2_cold": c.time_ms([lambda t=t: ln_kernel(t) for t in sets] * 4),
       "library_ms_l2_cold": c.time_ms(
           [lambda t=t: ln_library(t) for t in sets] * 4),
       "call_ms": c.call_ms(lambda: ln_kernel(sets[0]))}
out["layer_norm_bwd_8192"] = row
del sets
torch.cuda.empty_cache()

# #20 over BERT-large's O2 list, step 3, clip 0.5
specs = c.bert_param_specs()
b1, b2 = c.LAMB_BETAS
scal = torch.tensor([b1, b2, 1e-6, c.LAMB_WD, 1 - b1 ** 3, 1 - b2 ** 3, 1.0,
                     0.5, 1 - b1], device="cuda")
noop = torch.tensor(0, dtype=torch.int32, device="cuda")
gs = [rand(s, 1e-3).to(dt) for s, dt in specs]
ps = [rand(s, 0.02).to(dt).float() for s, dt in specs]
ms = [rand(s, 1e-4) for s, _ in specs]
vs = [rand(s, 1e-8).abs() for s, _ in specs]
us = [torch.empty_like(p) for p in ps]
K.multi_tensor_lamb_stage1.launches = 0
usq, psq = K.multi_tensor_lamb_stage1(gs, ps, ms, vs, us, scal, noop)
torch.cuda.synchronize()
row = {"sha256_umv": sha(us + ms + vs), "sha256_partials": sha([usq, psq]),
       "launches": K.multi_tensor_lamb_stage1.launches}
row["ms"] = c.time_ms([lambda: K.multi_tensor_lamb_stage1(
    gs, ps, ms, vs, us, scal, noop)] * 5)
row["call_ms"] = c.call_ms(lambda: K.multi_tensor_lamb_stage1(
    gs, ps, ms, vs, us, scal, noop), iters=10)
out["lamb_stage1_bert_large"] = row
del gs, ps, ms, vs, us, usq, psq
torch.cuda.empty_cache()

# #19, as tools/sgd_ln_compare_torch.py runs it
sgd_scal = torch.tensor([0.1, 1e-4, 0.9, 0.0, 0.5], device="cuda")
lists = {f"resnet50_{lv}": c.resnet50_specs(lv) for lv in ("O1", "O2")}
lists["gpt350m"] = [(tuple(s), torch.float32) for s in c.gpt350m_shapes()]
for name, sgd_specs in lists.items():
    gs = [rand(s, 1e-3).to(dt) for s, dt in sgd_specs]
    ps = [rand(s, 0.05).to(dt).float() for s, dt in sgd_specs]
    cs = [None if dt == torch.float32 else p.to(dt)
          for p, (_, dt) in zip(ps, sgd_specs)]
    bs = [rand(s, 1e-3) for s, _ in sgd_specs]
    K.multi_tensor_sgd.launches = 0
    K.multi_tensor_sgd(gs, ps, bs, cs, sgd_scal, noop)
    torch.cuda.synchronize()
    row = {"sha256": sha(ps + bs + cs),
           "launches": K.multi_tensor_sgd.launches}
    row["ms"] = c.time_ms([lambda: K.multi_tensor_sgd(gs, ps, bs, cs,
                                                      sgd_scal, noop)] * 5)
    out[f"sgd_{name}"] = row
    del gs, ps, cs, bs
    torch.cuda.empty_cache()

# 5 BERT-large O2 + FusedLAMB steps after a warm-up
model, opt, _ = c.build_bert("cuda", dict(c.BERT_LARGE), c.BERT_LR, 0)
tokens, labels = (t.to("cuda") for t in c.mlm_batch(
    c.BERT_LARGE["vocab_size"], (c.BERT_ACCUM, c.BERT_MICRO, c.BERT_SEQ), 0))
c.bert_step(model, opt, tokens, labels)
torch.cuda.synchronize()
walls, losses = [], []
for _ in range(5):
    t0 = time.perf_counter()
    loss = c.bert_step(model, opt, tokens, labels)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    losses.append(float(loss))
busy, ln_ms, lamb_ms = [], [], []
for _ in range(5):
    prof = c._profile_programs(
        {"bert_step": lambda: c.bert_step(model, opt, tokens, labels)},
        [])["bert_step"]
    busy.append(prof["device_busy_ms"])
    ln_ms.append(prof["by_class"].get("layer_norm_bwd", 0.0))
    lamb_ms.append(prof["by_class"].get("multi_tensor_lamb_stage1", 0.0))
out["bert_large_O2_step"] = dict(
    wall_s=statistics.median(walls), wall_s_all=walls, losses=losses,
    device_busy_ms=statistics.median(busy), device_busy_ms_all=busy,
    layer_norm_bwd_ms=statistics.median(ln_ms),
    lamb_stage1_ms=statistics.median(lamb_ms))
print("PROBE " + json.dumps(out), flush=True)
