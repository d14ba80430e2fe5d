#!/usr/bin/env python3
"""Time variants of the LM head's persistent GEMM kernel
(``csrc/gemm.cuh`` ``gemm_tma_rows_kernel``: #8's forward product with its
row partials, and the backward's dS launch) against the committed one, on
the card in one call:

    python3 tools/lm_head_variants_torch.py

Each variant is a copy of ``apex_tpu_torch/`` and ``chip_smoke.py`` under
``build/lm_head_variants/<name>/`` with a text patch of ``gemm.cuh``, built
there, and runs in a process of its own:

- ``base``: the committed kernel (row partials: a ring of 4 stages, one
  stage's products in flight while the stage before is handed back; dS: a
  ring of 3 beside its output tile, each stage's products waited for);
- ``wait0``: row partials wait for each stage's products too;
- ``ring3``: row partials on a ring of 3 stages;
- ``ds_inflight``: the dS launch also keeps one stage's products in
  flight.

The runs go base, the variants, then the variants and base again in
reverse order; each prints one ``PROBE {json}`` line at GPT-350M's and
BERT-large's bf16 heads (8192 tokens): the forward's time per call
(CUDA-graph replay) and its product's profiled ms and TFLOP/s, the dS
launches' profiled ms, the whole backward's time per call, and checksums
of loss and dX (the variants sum in the same order: equal bits).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "lm_head_variants"

# the committed text of csrc/gemm.cuh each variant replaces
_IN_LOOP = """      if constexpr (kPartials) {
        // this stage's products run on while the one before is handed back"""
_AFTER_LOOP = """    if constexpr (kPartials) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");"""
_LAST_ARRIVE = """      if (nk > 0 && tid == 0) mbar_arrive(&empty[(it - 1) % kStages]);"""
_STAGES = "constexpr int kRowsStages = HasRowPartials<Epi>::value ? 4 : 3;"

VARIANTS = {
    "base": (),
    "wait0": ((_IN_LOOP, _IN_LOOP.replace("(kPartials)", "(false)")),
              (_LAST_ARRIVE, "")),
    "ring3": ((_STAGES, "constexpr int kRowsStages = 3;"),),
    "ds_inflight": ((_IN_LOOP, _IN_LOOP.replace("(kPartials)", "(true)")),
                    (_AFTER_LOOP, _AFTER_LOOP.replace("(kPartials)",
                                                      "(true)"))),
}


def make_tree(name, patches):
    tree = OUT / name
    shutil.rmtree(tree, ignore_errors=True)
    tree.mkdir(parents=True)
    shutil.copytree(ROOT / "apex_tpu_torch", tree / "apex_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tree)
    gemm = tree / "apex_tpu_torch" / "csrc" / "gemm.cuh"
    text = gemm.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the patch anchor is not in gemm.cuh "
                             f"once: {old[:60]!r}")
        text = text.replace(old, new)
    gemm.write_text(text)
    return tree


def probe(tree):
    """One variant's numbers (run in the variant's own process)."""
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    import torch

    import chip_smoke as c
    from apex_tpu_torch.ops.lm_head import (bwd_chunk_plan, lm_head_bwd,
                                            lm_head_fwd)
    c.log = lambda msg: None
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    out = {"variant": tree.name}
    for tag, v, masked in (("gpt", 50304, False), ("bert", 30528, True)):
        x, w, t, g = c._lm_head_inputs(gen, 8192, 1024, v, bf, bf, masked)
        loss, lse = lm_head_fwd(x, w, t)
        dx, _ = lm_head_bwd(x, w, t, lse, g)
        fwd = c._log_fwd_launches(tag, x, w, t)
        rows = c._log_bwd_launches(tag, x, w, t, lse, g,
                                   bwd_chunk_plan(8192, v, 2))
        out[tag] = dict(
            fwd_ms=c.time_ms([lambda: lm_head_fwd(x, w, t)] * 20, 5),
            product_ms=fwd["ms"], product_tflops=fwd["tflops"],
            ds_ms=sum(r["ms"] for r in rows if r["part"] == "dS"),
            bwd_ms=c.time_ms([lambda: lm_head_bwd(x, w, t, lse, g)] * 20, 5),
            loss_sum=float(loss.double().sum()),
            dx_sum=float(dx.double().sum()))
        del x, w, t, g, loss, lse, dx
        torch.cuda.empty_cache()
    print("PROBE " + json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3:          # a variant's own process
        tree = pathlib.Path(sys.argv[2])
        if sys.argv[1] == "--build":
            sys.path.insert(0, str(tree))
            from apex_tpu_torch import _kernels
            _kernels.build()
        else:
            probe(tree)
        return
    trees = {name: make_tree(name, patches)
             for name, patches in VARIANTS.items()}
    me = str(pathlib.Path(__file__).resolve())
    builds = [subprocess.Popen([sys.executable, me, "--build", str(tree)])
              for tree in trees.values()]
    if any(b.wait() for b in builds):
        raise SystemExit("a variant failed to build")
    order = list(trees) + list(reversed(trees))
    for name in order:
        subprocess.run([sys.executable, me, "--probe", str(trees[name])],
                       check=True)


if __name__ == "__main__":
    main()
