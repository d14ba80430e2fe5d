"""One checkout's fused-FFN forward (#11: device time per call and a hash
of its y and z1 at GPT-350M's, BERT-large's, prefill and decode shapes
and in f32; a hash of the machine code of each of its GEMM kernels) and
its phase 5f (GPT-350M training with ``fused_ffn=True``: median step,
peak memory, FFN launches), for comparing two checkouts on one card in
one call:

    for t in parent . . parent; do python3 tools/ffn_compare_torch.py $t; done

Each run prints one ``PROBE {json}`` line; ``TREE`` is the root of a
checkout (its own kernels are built there).
"""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch.ops.fused_ffn import ffn_fwd  # noqa: E402


def forward_sass():
    """sha256 of each #11 kernel's SASS (``cuobjdump -sass`` of the built
    library) by (kernel family, tile, epilogue), instruction text only:
    addresses, encodings and the names of called subroutines (which carry
    the kernel's mangled name) are left out, so two checkouts that name
    one kernel differently compare by its code."""
    from apex_tpu_torch import _kernels
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_kernels.library_path())],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = chunk.partition("\n")
        epi = re.search(r"3ffn(4Bias|8BiasGelu)E", name)
        fam = re.search(r"gemm_(?:nt_)?(tma|fma|mma)_kernel", name)
        if not (epi and fam):
            continue
        tile = re.search(r"(?:tma_kernelILi|3CfgILi16ELi)(\d+)E", name)
        key = f"{fam.group(1)} {tile and tile.group(1)} {epi.group(1)}"
        code = [re.sub(r"`\([^)]*\)", "`()", m.group(1).strip())
                for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)]
        out[key] = hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]
    return out


c.phase_build()
out = {"tree": tree, "sass": forward_sass()}
gen = torch.Generator().manual_seed(0)
bf, f32 = torch.bfloat16, torch.float32
for tag, m, xdt, wdt in (("gpt", 8192, bf, f32), ("bert", 8192, bf, bf),
                         ("prefill", 512, bf, f32), ("decode", 8, bf, f32),
                         ("gpt f32", 8192, f32, f32)):
    x, w1, b1, w2, b2, dy = c._ffn_inputs(gen, m, 1024, 4096, 1024, xdt, wdt)
    y, z1 = ffn_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in (y, z1):
        digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    reps = 3 if xdt == f32 else 20
    ms = c.time_ms([lambda: ffn_fwd(x, w1, b1, w2, b2)] * reps,
                   3 if xdt == f32 else 5)
    out[tag] = dict(ms=ms, sha=digest.hexdigest()[:16])
    del x, w1, b1, w2, b2, dy, y, z1
    torch.cuda.empty_cache()
model, opt, tokens, targets, train = c.phase_train(True, "[5f]")
out["5f"] = dict(median_step_s=train["median_step_s"],
                 peak_memory_bytes=train["peak_memory_bytes"],
                 launches={k: v for k, v in train["launches"].items()
                           if k.startswith("ffn")})
print("PROBE " + json.dumps(out), flush=True)
