"""One checkout's int8 dequant-GEMM (#14) and the int8 serving steps that
run it, for comparing two checkouts on one card in one call:

    for t in parent . . parent; do
        python3 tools/qgemm_compare_torch.py $t
    done

It reports the device time (CUDA-graph replay, ``chip_smoke.time_ms``) of
the 97 calls of one GPT-350M decode step (8 rows) and of one prefill (512
rows): 24 layers of qkv / proj / fc1 / fc2 in bf16, each layer its own
random int8 weights, and the f32 tied head; each of those five shapes
alone, with its eager call (host overhead included); and the host time of
one int8 prefill(512) and one int8 paged decode step (8 slots at position
512) of ``chip_smoke.py``'s GPT-350M.  On a checkout whose
``ops/quant_gemm.py`` has ``qgemm_plan``, it also times the ``mma.sync``
and FMA kernels at the same shapes through the same C entry
(``mma_sync_*``: ``qgemm_bf16_rows16`` at 8 rows, ``qgemm_bf16_tiles`` at
512, ``qgemm_fma`` for the f32 head).
Each run prints one ``PROBE {json}`` line; ``TREE`` is the root of a
checkout (its own kernels are built there).
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
from apex_tpu_torch import _kernels  # noqa: E402
from apex_tpu_torch.inference import InferenceEngine  # noqa: E402
from apex_tpu_torch.ops import quant_gemm as tq  # noqa: E402

c.phase_build()
out = {"tree": tree}
gen = torch.Generator(device="cuda").manual_seed(3)


def weight(n, k):
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    return w8, torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4


def mma_sync(x, w8, scale):
    """The mma.sync or FMA kernel for the shape, through the C entry:
    qgemm_bf16_rows16 (bf16, m <= 16), qgemm_bf16_tiles (bf16) or
    qgemm_fma (f32)."""
    m, k = x.shape
    n = w8.shape[0]
    kind = ("qgemm_fma" if x.dtype == torch.float32 else
            "qgemm_bf16_rows16" if m <= 16 else "qgemm_bf16_tiles")
    y = torch.empty((m, n), dtype=torch.float32, device="cuda")
    rc = _kernels.lib().apex_quant_gemm(
        x.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(), None,
        m, n, k, x.stride(0), tq.QGEMM_KERNELS[kind], 0, 1,
        _kernels.dtype_code(x, "quant_gemm"), _kernels.stream())
    _kernels.check(rc, "quant_gemm")
    return y


layer_shapes, head = c.gpt350m_gemm_shapes()
layers = c.GPT350M["num_layers"]
weights = [[weight(n, k) for n, k in layer_shapes] for _ in range(layers)]
head_w = weight(*head)
variants = {"": tq.quant_gemm}
if hasattr(tq, "qgemm_plan"):
    variants["mma_sync_"] = mma_sync
for tag, m in (("decode", c.SLOTS), ("prefill", 512)):
    xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(
        torch.bfloat16) for _, k in layer_shapes}
    xh = torch.randn(m, head[1], generator=gen, device="cuda")
    calls = [(xs[k], w) for ws in weights
             for (_, k), w in zip(layer_shapes, ws)] + [(xh, head_w)]
    rounds = 5 if tag == "decode" else 3
    for pre, fn in variants.items():
        out[f"{pre}{tag}_97_ms"] = len(calls) * c.time_ms(
            [lambda x=x, w=w: fn(x, *w) for x, w in calls], rounds)
        for (n, k), w in zip(layer_shapes + [head], weights[0] + [head_w]):
            x = xh if (n, k) == head else xs[k]
            key = f"{pre}{tag}_{m}x{n}x{k}"
            out[f"{key}_ms"] = c.time_ms(lambda: fn(x, *w), rounds)
            out[f"{key}_call_ms"] = c.call_ms(lambda: fn(x, *w))
    del xs, xh, calls
    torch.cuda.empty_cache()
del weights, head_w
torch.cuda.empty_cache()

model = c.build_model("cuda").init_params(torch.Generator().manual_seed(0))
qmodel = c.build_model("cuda", weight_quant="int8")
qmodel.load_state_dict(model.state_dict())
del model
InferenceEngine(qmodel, max_slots=c.SLOTS)   # quantizes the weights in place
torch.cuda.empty_cache()
cfg = qmodel.cfg
rng = np.random.RandomState(2)
prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 512))).to("cuda")
tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, c.SLOTS)).to("cuda")
positions = torch.full((c.SLOTS,), 512, dtype=torch.int32, device="cuda")
pool = torch.zeros((c.PAGED_POOL, cfg.num_layers, 2, c.PAGED_BS, c.HEADS,
                    c.HEAD_DIM), dtype=cfg.dtype, device="cuda")
tables = c.paged_step_tables()
with torch.no_grad():
    out["int8_prefill_512_host_ms"] = 1e3 * c._host_time(
        lambda: qmodel.prefill(prompt))
    out["int8_paged_decode_step_host_ms"] = 1e3 * c._host_time(
        lambda: qmodel.decode_step_paged(tokens, pool, tables, positions))
print("PROBE " + json.dumps(out), flush=True)
