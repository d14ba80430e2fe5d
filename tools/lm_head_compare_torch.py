"""One checkout's fused LM head (#8-#10: device time per call of the
forward, dX and dW kernels and of the autograd op's backward at
GPT-350M's and BERT-large's head shapes in bf16, and of the forward at
GPT-350M's in f32) and its phases 5 and 7
(GPT-350M and BERT-large O2 training with the fused head: median step,
peak memory, LM-head launches), for comparing two checkouts on one card
in one call:

    for t in parent . . parent; do python3 tools/lm_head_compare_torch.py $t; done

Each run prints one ``PROBE {json}`` line; ``TREE`` is the root of a
checkout (its own kernels are built there).
"""
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch.ops.lm_head import (  # noqa: E402
    fused_linear_cross_entropy, lm_head_dw, lm_head_dx, lm_head_fwd)

c.phase_build()
out = {"tree": tree}
gen = torch.Generator().manual_seed(0)
bf = torch.bfloat16
for tag, v, masked in (("gpt", 50304, False), ("bert", 30528, True)):
    x, w, t, g = c._lm_head_inputs(gen, 8192, 1024, v, bf, bf, masked)
    _, lse = lm_head_fwd(x, w, t)
    xl, wl = (a.detach().clone().requires_grad_() for a in (x, w))

    def op():
        return fused_linear_cross_entropy(xl, wl, t)

    def op_bwd():
        return torch.autograd.grad(op(), (xl, wl), g)

    ms = {name: c.time_ms([fn] * 20, 5) for name, fn in (
        ("fwd", lambda: lm_head_fwd(x, w, t)),
        ("dx", lambda: lm_head_dx(x, w, t, lse, g)),
        ("dw", lambda: lm_head_dw(x, w, t, lse, g)),
        ("op", op), ("op_fwd_bwd", op_bwd))}
    ms["op_bwd"] = ms["op_fwd_bwd"] - ms["op"]
    out[tag] = ms
    del x, w, t, g, lse, xl, wl
    torch.cuda.empty_cache()
f32 = torch.float32
x, w, t, _ = c._lm_head_inputs(gen, 8192, 1024, 50304, f32, f32)
out["gpt_f32"] = {"fwd": c.time_ms([lambda: lm_head_fwd(x, w, t)] * 3, 3)}
del x, w, t
torch.cuda.empty_cache()
for phase, run in (("5", c.phase_train), ("7", c.phase_bert_train)):
    model, opt, _, _, res = run()
    out[phase] = dict(median_step_s=res["median_step_s"],
                      step_times_s=res["step_times_s"],
                      peak_memory_bytes=res["peak_memory_bytes"],
                      launches={k: v for k, v in res["launches"].items()
                                if k.startswith("lm_head")})
    del model, opt, res
    torch.cuda.empty_cache()
print("PROBE " + json.dumps(out), flush=True)
