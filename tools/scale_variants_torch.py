"""Variants of the multi-tensor scale (#15,
``apex_tpu_torch/csrc/multi_tensor_scale.cu``) timed in turns on one card:

    python3 tools/scale_variants_torch.py

Each variant is a text-patched copy of the source: the elements a block
owns (``kScaleChunk``), the threads a block (``kScaleThreads``) and the
8-element steps in flight per thread (``kScaleUnroll``), built alone with
``nvcc`` into ``build/scale_variants/`` (all variants at once) and called
through ctypes with the wrapper's C signature.  On BERT-large's O2
gradients (299 tensors, bf16 with f32 LayerNorms, into the same dtypes),
GPT-350M's 291 f32 masters into bf16 and BERT-large's sizes f16 into f32
each is first held bitwise against the committed kernel (outputs and
flag), then timed by CUDA-graph replay (``chip_smoke.time_ms``; every list
is far above the 50 MB L2), the variants alternated over three rounds;
the registers and spills ``ptxas`` reports for the kernel (its nine
bodies inlined) are printed beside.  One ``VARIANTS {json}`` line ends
the output.
"""
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from apex_tpu_torch import _kernels  # noqa: E402
from apex_tpu_torch.ops import multi_tensor as K  # noqa: E402

SRC = _kernels.CSRC / "multi_tensor_scale.cu"
OUT = ROOT / "build" / "scale_variants"
# name: (kScaleChunk, kScaleThreads, kScaleUnroll)
VARIANTS = {f"chunk{ch}_t{th}_u{u}": (ch, th, u)
            for ch in (8192, 16384, 65536) for th in (256, 512)
            for u in (1, 2, 4)}


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, values in VARIANTS.items():
        patched = text
        for const, value in zip(("kScaleChunk", "kScaleThreads",
                                 "kScaleUnroll"), values):
            patched, n = re.subn(rf"{const} = \d+;", f"{const} = {value};",
                                 patched)
            assert n == 1, const
        src = OUT / f"{name}.cu"
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
        rows = c._ptxas_by_kernel(err + out, ("multi_tensor_scale_kernel",))
        regs[name] = [r for _, r in rows]
    return regs


def main():
    c.phase_build()
    regs = build()
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.apex_multi_tensor_scale.argtypes = \
            _kernels._SIGNATURES["apex_multi_tensor_scale"]
        lib.apex_multi_tensor_scale.restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, std):
        return torch.randn(shape, generator=gen, device="cuda") * std

    bert = c.bert_param_specs()
    cases = {
        "bert_large_O2_unscale": (
            lambda: [rand(s, 1e-3).to(dt) for s, dt in bert], None,
            2.0 ** -10),
        "gpt350m_master_copy": (
            lambda: [rand(s, 0.02) for s in c.gpt350m_shapes()],
            torch.bfloat16, 1.0),
        "bert_large_f16_to_f32": (
            lambda: [rand(s, 1.0).half() for s, _ in bert], torch.float32,
            2.0 ** -10)}
    out = {}
    for case, (make, odt, sv) in cases.items():
        xs = make()
        outs = [torch.empty_like(x, dtype=odt or x.dtype) for x in xs]
        s = torch.full((), sv, device="cuda")
        flag = torch.zeros((), device="cuda")
        arrays = [K._addresses(xs), K._addresses(outs), K._numels(xs),
                  K._codes(xs, "v"), K._codes(outs, "v")]
        ptrs = [K._ptr(a) for a in arrays]
        launches = ctypes.c_int(0)

        def call(name):
            flag.zero_()
            rc = libs[name].apex_multi_tensor_scale(
                len(xs), *ptrs, s.data_ptr(), flag.data_ptr(),
                ctypes.byref(launches), _kernels.stream())
            _kernels.check(rc, name)

        ref_flag = K.multi_tensor_scale_(xs, outs, s)
        ref = [o.clone() for o in outs]
        res = {}
        for name in VARIANTS:
            call(name)
            torch.cuda.synchronize()
            if not (all(torch.equal(a.view(-1).view(torch.uint8),
                                    b.view(-1).view(torch.uint8))
                        for a, b in zip(outs, ref))
                    and float(flag) == float(ref_flag)):
                raise AssertionError(f"variant {name} differs from the "
                                     f"committed kernel on {case}")
            res[name] = dict(registers=regs[name], launches=launches.value,
                             ms=[])
        del ref
        for _ in range(3):
            for name in VARIANTS:
                res[name]["ms"].append(c.time_ms(
                    [lambda name=name: call(name)] * 5))
        for name, r in res.items():
            r["median_ms"] = statistics.median(r["ms"])
            c.log(f"  {case} {name}: {r['registers']}; launches "
                  f"{r['launches']}; ms {r['ms']}")
        best = min(res, key=lambda n: res[n]["median_ms"])
        c.log(f"  {case}: fastest {best} {res[best]['median_ms']:.5f} ms")
        out[case] = res
        del xs, outs
        torch.cuda.empty_cache()
    print("VARIANTS " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
