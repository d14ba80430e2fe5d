"""Variants of the LayerNorm backward's row-per-warp body (#2,
``apex_tpu_torch/csrc/layer_norm_bwd.cu``) timed in turns on one card:

    python3 tools/lnbwd_variants_torch.py

Each variant is a text-patched copy of the source (the resident blocks an
SM, ``kLnBwdBlocksPerSm``, which also caps the registers through
``__launch_bounds__``; the cross-block sum's groups,
``kLnReduceGroups``), built alone with ``nvcc``
into ``build/lnbwd_variants/`` (all variants at once) and called through
ctypes with the wrapper's C signature.  At 8192 x 1024 bf16 (LN from x)
and in f32 (BERT's MLM LayerNorm) each is held against the plain version
at phase 2's tolerances, then timed by CUDA-graph replay
(``chip_smoke.time_ms``) with one input pair replayed and with six pairs
taken in turn (read from device memory), the variants alternated over
three rounds, and its two launches (the rows, the cross-block sum) timed
apart by ``torch.profiler`` over 20 calls from device memory; the
registers and spills ``ptxas`` reports for its hidden-1024 instantiations
(LN from x) are printed beside.  One ``VARIANTS {json}``
line ends the output.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch import _kernels  # noqa: E402
from apex_tpu_torch.ops import layer_norm as tln  # noqa: E402

SRC = _kernels.CSRC / "layer_norm_bwd.cu"
OUT = ROOT / "build" / "lnbwd_variants"
# name: (constants of the source patched, resident blocks of 8 warps an SM)
VARIANTS = {
    "as_committed": ({}, 2),
    "1_block_an_sm": ({"kLnBwdBlocksPerSm": "1"}, 1),
    "3_blocks_an_sm": ({"kLnBwdBlocksPerSm": "3"}, 3),
    "reduce_8_groups": ({"kLnReduceGroups": "8"}, 2)}


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, (patches, blocks) in VARIANTS.items():
        src = OUT / f"{name}.cu"
        patched = re.sub(r"kLnBwdBlocksPerSm = \d+;",
                         f"kLnBwdBlocksPerSm = {blocks};", text)
        for const, value in patches.items():
            patched, n = re.subn(rf"{const} = \w+;", f"{const} = {value};",
                                 patched)
            assert n == 1, const
        src.write_text(patched)
        procs[name] = subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-I", str(_kernels.CSRC), "-shared", "-o",
             str(OUT / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    regs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}{out}")
        rows = c._ptxas_by_kernel(err + out, ("layer_norm_bwd_warp_kernel",))
        regs[name] = {key: [r for n, r in rows if f"<{key}, false>" in n][0]
                      for key in ("__nv_bfloat16, 4", "float, 8")}
    return regs


def main():
    regs = build()
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.apex_layer_norm_bwd.argtypes = \
            _kernels._SIGNATURES["apex_layer_norm_bwd"]
        lib.apex_layer_norm_bwd.restype = ctypes.c_int
        libs[name] = lib
    rows, hidden, dev = c.TRAIN_ROWS, c.HIDDEN, "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    w = 1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
    b = 0.1 * torch.randn(hidden, generator=gen, device=dev)
    sms = _kernels.sm_count(0)

    def call(name, dtype, t):
        parts = min(-(-rows // tln.LN_BWD_WARPS), sms * VARIANTS[name][1])
        dx = torch.empty_like(t[0])
        part = torch.empty((2, parts, hidden), device=dev)
        sums = torch.empty((2, hidden), device=dev)
        rc = libs[name].apex_layer_norm_bwd(
            t[0].data_ptr(), t[1].data_ptr(), w.data_ptr(), None,
            t[2].data_ptr(), t[3].data_ptr(), dx.data_ptr(),
            part.data_ptr(), sums.data_ptr(), rows, hidden, parts, 0, 0,
            _kernels.DTYPE_CODES[dtype],
            tln.layer_norm_bwd_path(hidden, dtype, True), _kernels.stream())
        _kernels.check(rc, name)
        return dx, sums[0], sums[1]

    from torch.profiler import ProfilerActivity, profile
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        sets = []
        for _ in range(6):
            x = torch.randn(rows, hidden, generator=gen, device=dev).to(dtype)
            dy = torch.randn(rows, hidden, generator=gen, device=dev).to(
                dtype)
            _, mean, rstd = tln.layer_norm_fwd(x, w, b, 1e-5, False)
            sets.append((dy, x, mean, rstd))
        ref = tln.layer_norm_bwd_reference(*sets[0][:2], w, b,
                                           *sets[0][2:], False, False)
        res = {}
        for name in VARIANTS:
            got = call(name, dtype, sets[0])
            torch.cuda.synchronize()
            c._ln_bwd_check(f"variant {name} {dtype}", got, ref, dtype,
                            False)
            res[name] = dict(registers=regs[name], ms=[], ms_l2_cold=[])
        for _ in range(3):
            for name in VARIANTS:
                res[name]["ms"].append(c.time_ms(
                    lambda: call(name, dtype, sets[0])))
                res[name]["ms_l2_cold"].append(c.time_ms(
                    [lambda t=t: call(name, dtype, t) for t in sets] * 4))
        for name in VARIANTS:
            fns = [lambda t=t: call(name, dtype, t) for t in sets] * 4
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for fn in fns[:20]:
                    fn()
                torch.cuda.synchronize()
            split = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    key = "reduce" if "reduce" in e.name else "rows"
                    split[key] = split.get(key, 0.0) \
                        + e.device_time_total / 20e3
            res[name]["profiled_ms_per_call"] = split
        for name, r in res.items():
            c.log(f"  {name} {dtype}: {r['registers']}; ms {r['ms']}, from "
                  f"device memory {r['ms_l2_cold']}; per launch (profiler) "
                  f"{r['profiled_ms_per_call']}")
        out[str(dtype)[6:]] = res
        del sets
    print("VARIANTS " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
