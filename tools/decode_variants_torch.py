#!/usr/bin/env python3
"""Time variants of the split-K decode kernels (#6, #7) against the
committed ones, in one process on the card.

    python3 tools/decode_variants_torch.py [--rounds 2]

Each variant is the committed ``csrc/decode.cuh``, ``flash_decode.cu`` and
``flash_decode_paged.cu`` with a text patch applied, copied under
``build/decode_variants/<name>/`` with its own namespace (libraries loaded
side by side otherwise launch each other's same-named kernels), built with
``nvcc -shared`` and called through ctypes as the wrappers call the
package's library:

- ``base``: the committed kernels (split pass, then the combine launch);
- ``chunk64`` / ``chunk256``: chunks (and blocks) of 64 / 256 keys;
- ``pdl``: the combine launched with programmatic dependent launch (it
  starts while the split pass runs and waits on ``griddepcontrol.wait``);
- ``ticket``: one launch: each chunk takes a ticket after writing its
  partial and the row's last chunk combines (a zeroed int per (slot,
  head), reset by that last block);
- ``staged``: the combine by 128 threads, the chunks' (m, l) staged in
  shared memory so their loads are issued together.

Every variant is checked first (a row of length 0, the chunk edges, a
repeat bitwise, bitwise ``base`` where it keeps the chunk size), then #6
and #7 are timed at ``chip_smoke.py``'s serving shape (CUDA-graph replay
over the 24 layers' views) in turns, and each variant's kernels are
profiled eagerly (device microseconds per launch).
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from apex_tpu_torch import _kernels  # noqa: E402
from apex_tpu_torch.ops import flash_attention as fa  # noqa: E402

FILES = ("common.cuh", "decode.cuh", "flash_decode.cu", "flash_decode_paged.cu")
CUS = ("flash_decode.cu", "flash_decode_paged.cu")


def _sub(s, old, new, count=1):
    if old not in s:
        raise ValueError(f"patch anchor not found: {old[:60]!r}")
    return s.replace(old, new, count)


def chunk(n):
    def patch(f):
        f["decode.cuh"] = _sub(_sub(f["decode.cuh"], "kDecodeThreads = 128;",
                                    f"kDecodeThreads = {n};"),
                               "kDecodeSplit = 128;", f"kDecodeSplit = {n};")
        return f
    return patch


def _combine_launch(s):
    m = re.search(r"  (flash_decode(?:_paged)?_combine_kernel<T, D>)\s*<<<(.*?)>>>\((.*?)\);\n",
                  s, re.S)
    if m is None:
        raise ValueError("combine launch not found")
    return m


def pdl(f):
    for cu in CUS:
        s = _sub(f[cu], "  const int c0 = blockIdx.y * kDecodeSplit;",
                 '  asm volatile("griddepcontrol.launch_dependents;");\n'
                 "  const int c0 = blockIdx.y * kDecodeSplit;")
        s = re.sub(r"(DecodeWork work\) \{\n)",
                   lambda m: m.group(1) + '  asm volatile("griddepcontrol.wait;" ::: "memory");\n',
                   s, count=1)
        m = _combine_launch(s)
        kern, cfg, args = m.group(1), m.group(2), m.group(3)
        grid, block, _, stream = [x.strip() for x in cfg.split(",")]
        s = (s[:m.start()] + f"  {{\n    cudaLaunchConfig_t cfg = {{}};\n"
             f"    cfg.gridDim = dim3({grid});\n    cfg.blockDim = dim3({block});\n"
             f"    cfg.stream = {stream};\n    cudaLaunchAttribute at[1];\n"
             "    at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
             "    at[0].val.programmaticStreamSerializationAllowed = 1;\n"
             "    cfg.attrs = at;\n    cfg.numAttrs = 1;\n"
             f"    cudaLaunchKernelEx(&cfg, {kern}, {args});\n  }}\n" + s[m.end():])
        f[cu] = s
    return f


_TICKET_HELPERS = """
// the row's last chunk to finish combines (the ticket variant)
template <typename T, int D>
__device__ __forceinline__ void decode_finish(const DecodeWork& work, int* tickets, int bh,
                                              int n_live, T* o) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + bh, 1) == n_live - 1;
    if (last) tickets[bh] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < D)
    decode_combine<T, D>(work.acc_at(bh, 0), work.ml_at(bh, 0), o, n_live, threadIdx.x);
}

template <typename T, int D>
__device__ __forceinline__ void decode_empty(int len, T* o) {
  if (len == 0 && blockIdx.y == 0)
    for (int d = threadIdx.x; d < D; d += kDecodeThreads) o[d] = from_f32<T>(0.f);
}

}  // namespace apex_tpu_torch
"""


def ticket(f):
    d = f["decode.cuh"]
    d = d.replace("ml[2 * c]", "__ldcg(ml + 2 * c)").replace(
        "ml[2 * c + 1]", "__ldcg(ml + 2 * c + 1)").replace(
        "acc[c * D + d]", "__ldcg(acc + c * D + d)")
    i = d.rindex("}  // namespace apex_tpu_torch")
    f["decode.cuh"] = d[:i] + _TICKET_HELPERS.lstrip("\n")
    for cu, tail in (("flash_decode.cu", "min(kDecodeSplit, len - c0), addr, scale);"),
                     ("flash_decode_paged.cu", "n, addr, scale);")):
        s = f[cu]
        s = re.sub(r"(_split_kernel\(const T\* __restrict__ q, const T\* __restrict__ k,\n"
                   r"\s*const T\* __restrict__ v,)",
                   lambda m: m.group(1) + " T* __restrict__ o, int* __restrict__ tickets,", s,
                   count=1)
        s = _sub(s, "  if (c0 >= len) return;",
                 "  T* orow = o + bi * st.o_b + hi * st.o_h;\n"
                 "  if (c0 >= len) return decode_empty<T, D>(len, orow);")
        s = _sub(s, tail, tail + "\n  decode_finish<T, D>(work, tickets, bh, decode_splits(len), orow);")
        m = _combine_launch(s)
        s = s[:m.start()] + s[m.end():]
        s = re.sub(r"(_split_kernel<T, D><<<grid, kDecodeThreads, 0, stream>>>\(\n\s*"
                   r"static_cast<const T\*>\(q\), static_cast<const T\*>\(k\), "
                   r"static_cast<const T\*>\(v\),)",
                   lambda m: m.group(1) + " static_cast<T*>(o), static_cast<int*>(tickets),",
                   s, count=1)
        # the tickets pointer goes through the entry point and the launchers
        s = _sub(s, "void* workspace,", "void* workspace, void* tickets,")
        fns = r"(?:launch_flash_decode|launch_paged|dispatch_flash_decode|dispatch_paged)"
        s = re.sub(r"(static (?:void|int) " + fns + r"\()", r"\1void* tickets, ", s)
        s = re.sub(r"(" + fns + r"(?:<[^>]*>)?\()(?!void\* tickets)", r"\1tickets, ", s)
        f[cu] = s
    return f


_STAGED = """template <typename T, int D>
__device__ __forceinline__ void decode_combine(const float* __restrict__ acc,
                                               const float* __restrict__ ml, T* __restrict__ o,
                                               int n_live, int) {
  __shared__ float cw[kDecodeThreads];
  __shared__ float cl[kDecodeThreads];
  __shared__ float w_max[kDecodeWarps];
  const int tid = threadIdx.x;
  float mv = kMask;
  for (int c = tid; c < n_live; c += kDecodeThreads) mv = fmaxf(mv, ml[2 * c]);
  mv = warp_max(mv);
  if ((tid & 31) == 0) w_max[tid >> 5] = mv;
  __syncthreads();
  float m_all = w_max[0];
  for (int w = 1; w < kDecodeWarps; ++w) m_all = fmaxf(m_all, w_max[w]);
  float l_all = 0.f, od = 0.f;
  for (int c0 = 0; c0 < n_live; c0 += kDecodeThreads) {
    const int nt = min(kDecodeThreads, n_live - c0);
    if (tid < nt) {
      cw[tid] = expf(ml[2 * (c0 + tid)] - m_all);
      cl[tid] = ml[2 * (c0 + tid) + 1];
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll 8
      for (int c = 0; c < nt; ++c) {
        l_all += cl[c] * cw[c];
        od += acc[static_cast<int64_t>(c0 + c) * D + tid] * cw[c];
      }
    }
    __syncthreads();
  }
  if (tid < D) o[tid] = from_f32<T>(od / (l_all == 0.f ? 1.f : l_all));
}

"""


def staged(f):
    d = f["decode.cuh"]
    a = d.index("template <typename T, int D>\n__device__ __forceinline__ void decode_combine")
    b = d.index("// Workspace layout")
    f["decode.cuh"] = d[:a] + _STAGED + d[b:]
    for cu in CUS:
        s = _sub(f[cu], "__global__ void __launch_bounds__(D)",
                 "__global__ void __launch_bounds__(kDecodeThreads)")
        m = _combine_launch(s)
        s = s[:m.start()] + m.group(0).replace(", D, 0, stream>>>", ", kDecodeThreads, 0, stream>>>") \
            + s[m.end():]
        f[cu] = s
    return f


# name: (patch, keys per chunk, takes tickets)
VARIANTS = {"base": (lambda f: f, 128, False), "chunk64": (chunk(64), 64, False),
            "chunk256": (chunk(256), 256, False), "pdl": (pdl, 128, False),
            "ticket": (ticket, 128, True), "staged": (staged, 128, False)}


def build(name):
    patch, _, tickets = VARIANTS[name]
    d = ROOT / "build" / "decode_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    files = patch({n: (_kernels.CSRC / n).read_text() for n in FILES})
    for n, s in files.items():
        (d / n).write_text(s.replace("apex_tpu_torch", f"decode_variant_{name}"))
    nvcc = _kernels._nvcc()
    procs = [subprocess.Popen([nvcc, *_kernels.NVCC_FLAGS, "-c", str(d / cu), "-o",
                               str(d / (cu + ".o"))], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for cu in CUS]
    errs = [p.communicate()[1] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(errs))
    so = d / f"lib{name}.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *[str(d / (cu + ".o")) for cu in CUS]],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, n_ptr in (("apex_flash_decode", 6), ("apex_flash_decode_paged", 7)):
        sig = list(_kernels._SIGNATURES[fn])
        if tickets:
            sig = sig[:n_ptr] + [ctypes.c_void_p] + sig[n_ptr:]
        getattr(lib, fn).argtypes = sig
        getattr(lib, fn).restype = ctypes.c_int
    return lib


class Variant:
    def __init__(self, name):
        self.name = name
        self.lib = build(name)
        self.split = VARIANTS[name][1]
        self.tickets = (torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
                        if VARIANTS[name][2] else None)

    def _work(self, b, h, d, positions):
        n = -(-positions // self.split)
        extra = [] if self.tickets is None else [self.tickets.data_ptr()]
        return n, torch.empty(b * h * n * (d + 2), dtype=torch.float32, device="cuda"), extra

    def ring(self, q, k, v, lens, scale):
        b, h, d = q.shape
        S = k.shape[1]
        n, work, extra = self._work(b, h, d, S)
        o = torch.empty_like(q)
        rc = self.lib.apex_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lens.data_ptr(),
            work.data_ptr(), *extra, b, h, S, d, n, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2), o.stride(0),
            o.stride(1), scale, _kernels.dtype_code(q, "decode"), _kernels.stream())
        _kernels.check(rc, f"{self.name} ring")
        return o

    def paged(self, q, k, v, tables, lens, scale):
        b, h, d = q.shape
        nb, bs = k.shape[:2]
        mb = tables.shape[1]
        n, work, extra = self._work(b, h, d, mb * bs)
        o = torch.empty_like(q)
        rc = self.lib.apex_flash_decode_paged(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), tables.data_ptr(),
            lens.data_ptr(), work.data_ptr(), *extra, b, h, d, nb, bs, mb, n, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
            v.stride(2), o.stride(0), o.stride(1), scale, _kernels.dtype_code(q, "decode"),
            _kernels.stream())
        _kernels.check(rc, f"{self.name} paged")
        return o


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_variants_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    gen = torch.Generator().manual_seed(0)
    scale = c.HEAD_DIM ** -0.5
    layers = c.GPT350M["num_layers"]
    cache = torch.randn(c.SLOTS, layers, 2, c.MAX_SEQ, c.HEADS, c.HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16)
    lens_np = np.array([1, 97, 512, 1024, 300, 640, 37, 800], np.int32)
    lens = torch.from_numpy(lens_np).to("cuda")
    q = torch.randn(c.SLOTS, c.HEADS, c.HEAD_DIM, generator=gen).to("cuda", torch.bfloat16)
    views = [(cache[:, li, 0], cache[:, li, 1]) for li in range(layers)]
    pool = torch.randn(c.PAGED_POOL, layers, 2, c.PAGED_BS, c.HEADS, c.HEAD_DIM,
                       generator=gen).to("cuda", torch.bfloat16)
    tables = torch.from_numpy(c.paged_tables(lens_np, np.random.RandomState(7))).to("cuda")
    pviews = [(pool[:, li, 0], pool[:, li, 1]) for li in range(layers)]
    edge = torch.tensor([0, 1, 127, 128, 129, 1024, 1124, 300], dtype=torch.int32,
                        device="cuda")
    eref = fa.flash_attention_decode_reference(q, *views[5], edge, scale)
    pref = fa.flash_attention_decode_paged_reference(q, *pviews[2], tables, lens, scale)
    variants, base = {}, None
    for name in VARIANTS:
        try:
            v = Variant(name)
        except (RuntimeError, ValueError, subprocess.CalledProcessError) as e:
            print(f"{name}: not built: {e}")
            continue
        o1 = v.ring(q, *views[5], edge, scale)
        o2 = v.ring(q, *views[5], edge, scale)
        p1 = v.paged(q, *pviews[2], tables, lens, scale)
        torch.cuda.synchronize()
        base = o1 if name == "base" else base
        ok = (torch.allclose(o1.float(), eref.float(), atol=c.BF16_ATOL, rtol=c.BF16_RTOL)
              and torch.allclose(p1.float(), pref.float(), atol=c.BF16_ATOL, rtol=c.BF16_RTOL)
              and torch.equal(o1, o2) and not o1[0].any())
        print(f"{name}: check {'ok' if ok else 'FAILED'}: max |d| {c.max_err(o1, eref):.3e} "
              f"(paged {c.max_err(p1, pref):.3e}), repeat bitwise {torch.equal(o1, o2)}, "
              f"bitwise base {torch.equal(o1, base)}")
        if ok:
            variants[name] = v
    from torch.profiler import ProfilerActivity, profile
    for name, v in variants.items():
        for kk, vv in views:
            v.ring(q, kk, vv, lens, scale)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for kk, vv in views:
                v.ring(q, kk, vv, lens, scale)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "decode" in e.key:
                kern = e.key.split("::")[-1].split("<")[0]
                print(f"{name}: {kern} {e.device_time_total / e.count:.2f} us a launch "
                      f"({e.count} launches)")
    for rnd in range(args.rounds):
        order = list(variants) if rnd % 2 == 0 else list(reversed(variants))
        for name in order:
            v = variants[name]
            t6 = c.time_ms([lambda k=k, w=w: v.ring(q, k, w, lens, scale) for k, w in views])
            t7 = c.time_ms([lambda k=k, w=w: v.paged(q, k, w, tables, lens, scale)
                            for k, w in pviews])
            print(f"round {rnd} {name}: #6 {t6:.5f} ms, #7 {t7:.5f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
