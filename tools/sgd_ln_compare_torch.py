"""One checkout's multi-tensor SGD (#19) and LayerNorm forward (#1), for
comparing two checkouts on one card in one call:

    for t in parent . . parent; do python3 tools/sgd_ln_compare_torch.py $t; done

It reports the device time per call (CUDA-graph replay, ``chip_smoke``'s
``time_ms``) of #19 over ResNet-50's O1 and O2 parameter lists and
GPT-350M's, with ``torch.optim.SGD(fused=True).step`` on f32 copies timed
in the same run, each wrapper's eager call, and a sha256 of #19's outputs
(parameters, momentum buffers, model copies) after one call on inputs
from a seed, so two checkouts can be shown bitwise equal; then #1 at 8,
512 and 8192 rows of 1024 bf16 (8192 also with six inputs taken in turn,
read from device memory) beside ``F.layer_norm``; then the median wall
of 5 ResNet-50 O2 steps of the ported ImageNet example.  Each run prints
one ``PROBE {json}`` line; ``TREE`` is the root of a checkout (its own
kernels are built there).
"""
import hashlib
import json
import os
import statistics
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch.ops import multi_tensor as K  # noqa: E402
from apex_tpu_torch.ops.layer_norm import layer_norm_fwd  # noqa: E402

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


scal = torch.tensor([0.1, 1e-4, 0.9, 0.0, 0.5], device="cuda")
noop = torch.tensor(0, dtype=torch.int32, device="cuda")
lists = {f"resnet50_{lv}": c.resnet50_specs(lv) for lv in ("O1", "O2")}
lists["gpt350m"] = [(tuple(s), torch.float32) for s in c.gpt350m_shapes()]
for name, specs in lists.items():
    gs = [rand(s, 1e-3).to(dt) for s, dt in specs]
    ps = [rand(s, 0.05).to(dt).float() for s, dt in specs]
    cs = [None if dt == torch.float32 else p.to(dt)
          for p, (_, dt) in zip(ps, specs)]
    bs = [rand(s, 1e-3) for s, _ in specs]
    K.multi_tensor_sgd.launches = 0
    K.multi_tensor_sgd(gs, ps, bs, cs, scal, noop)
    torch.cuda.synchronize()
    row = {"sha256": sha(ps + bs + cs),
           "launches": K.multi_tensor_sgd.launches}
    row["ms"] = c.time_ms([lambda: K.multi_tensor_sgd(gs, ps, bs, cs, scal,
                                                      noop)] * 5)
    row["call_ms"] = c.call_ms(lambda: K.multi_tensor_sgd(gs, ps, bs, cs,
                                                          scal, noop),
                               iters=10)
    lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(lib_ps, gs):
        p.grad = g.float()
    lib = torch.optim.SGD(lib_ps, lr=0.1, momentum=0.9, weight_decay=1e-4,
                          fused=True)
    lib.step()
    row["library_ms"] = c.call_ms(lib.step, iters=10)
    out[f"sgd_{name}"] = row
    del gs, ps, cs, bs, lib, lib_ps
    torch.cuda.empty_cache()

g = torch.Generator().manual_seed(0)
w = (1 + 0.1 * torch.randn(c.HIDDEN, generator=g)).to("cuda")
b = (0.1 * torch.randn(c.HIDDEN, generator=g)).to("cuda")
w16, b16 = w.bfloat16(), b.bfloat16()
for rows in (c.SLOTS, 512, c.TRAIN_ROWS):
    x = torch.randn(rows, c.HIDDEN, generator=g).to("cuda", torch.bfloat16)
    row = {"ms": c.time_ms(lambda: layer_norm_fwd(x, w, b, 1e-5, False)),
           "library_ms": c.time_ms(
               lambda: F.layer_norm(x, (c.HIDDEN,), w16, b16, 1e-5)),
           "call_ms": c.call_ms(lambda: layer_norm_fwd(x, w, b, 1e-5, False))}
    y = layer_norm_fwd(x, w, b, 1e-5, False)
    row["sha256"] = sha(y)
    if rows == c.TRAIN_ROWS:
        xs = [torch.randn(rows, c.HIDDEN, generator=g).to(
            "cuda", torch.bfloat16) for _ in range(6)]
        row["ms_l2_cold"] = c.time_ms(
            [lambda x=x: layer_norm_fwd(x, w, b, 1e-5, False)
             for x in xs] * 4)
        row["library_ms_l2_cold"] = c.time_ms(
            [lambda x=x: F.layer_norm(x, (c.HIDDEN,), w16, b16, 1e-5)
             for x in xs] * 4)
    out[f"ln_{rows}"] = row
torch.cuda.empty_cache()

from apex_tpu_torch.examples.imagenet import main_amp  # noqa: E402
argv = list(c.RESNET_ARGV)
argv[argv.index("--steps") + 1] = "5"
res = main_amp.main(argv + ["--opt-level", "O2"])
out["resnet50_O2_step_s"] = statistics.median(res["step_times_s"])
out["resnet50_O2_step_times_s"] = res["step_times_s"]
out["resnet50_O2_losses"] = [float(x) for x in res["losses"]]
print("PROBE " + json.dumps(out), flush=True)
