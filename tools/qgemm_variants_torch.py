#!/usr/bin/env python3
"""Time variants of the int8 dequant-GEMM's TMA kernel (#14) against the
committed one, in one process on the card.

    python3 tools/qgemm_variants_torch.py [--rounds 2]

Each variant is the committed ``csrc/quant_gemm.cu`` (with the headers it
includes) with a text patch applied, copied under
``build/qgemm_variants/<name>/`` with its own namespace (libraries loaded
side by side otherwise launch each other's same-named kernels), built with
``nvcc -shared`` and called through ctypes with the plan the package's
wrapper makes:

- ``base``: the committed kernel (A fed to wgmma from registers, each
  thread dequantizing its fragment's int8 pairs);
- ``smem``: the consumers dequantize their 64 rows of each stage into a
  128-byte-swizzled bf16 tile in shared memory (two tiles alternating),
  fence the generic-proxy writes, meet at a named barrier and run wgmma
  with A from shared memory;
- ``no_dequant`` (timing only, wrong values): the fragments take the raw
  int8 words, no conversion;
- ``x_once`` / ``w_once`` (timing only, wrong values): the x boxes (or the
  int8 box) are loaded at the first stage only: the time without that
  operand's traffic from L2;
- ``ks1``: the committed kernel with every k split turned off;
- ``wide``: the committed kernel on tiles of the least BN that holds the
  tokens, where the plan would halve it;
- ``split16``: k-split clusters of up to 16 blocks (non-portable);
- ``p3_serial``: f32 x making the next stage's fragments only after this
  stage's products have completed; ``p3_bn64``: f32 x on tiles of at
  most 64 tokens;
- ``tma_decode``: a decode step's bf16 qkv / proj / fc1 on the TMA kernel
  too (the plan gives them the register-fed ``qgemm_bf16_rows16``).

Every variant that computes y is checked first (against the plain version
within ``chip_smoke.QGEMM_TOL``, bitwise on a repeat); then each is timed
at ``chip_smoke.py``'s GPT-350M decode (8 rows) and prefill (512 rows)
shapes, one shape alone and the 97 calls of a step (CUDA-graph replay), in
turns.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from apex_tpu_torch import _kernels  # noqa: E402
from apex_tpu_torch.ops import quant_gemm as tq  # noqa: E402

FILES = ("common.cuh", "mma.cuh", "gemm.cuh", "quant_gemm.cu")
CU = "quant_gemm.cu"


def _sub(s, old, new, count=1):
    if old not in s:
        raise ValueError(f"patch anchor not found: {old[:60]!r}")
    return s.replace(old, new, count)


def _between(s, start, end, new):
    a = s.index(start)
    b = s.index(end, a)
    return s[:a] + new + s[b:]


def no_dequant(f):
    f[CU] = _sub(f[CU], "  if constexpr (P == 1) {\n    return bf16x2(q0 * s, q1 * s);",
                 "  if (s != 12345.f) return w;\n  if constexpr (P == 1) {\n"
                 "    return bf16x2(q0 * s, q1 * s);")
    return f


def x_once(f):
    s = _sub(f[CU], "        gemm::mbar_expect_tx(&full[s], C::kStage);",
             "        gemm::mbar_expect_tx(&full[s], i == 0 ? C::kStage : C::kW8);")
    f[CU] = _sub(s, "        for (int p = 0; p < P; ++p) {\n",
                 "        for (int p = 0; p < (i == 0 ? P : 0); ++p) {\n")
    return f


def w_once(f):
    s = _sub(f[CU], "        gemm::mbar_expect_tx(&full[s], C::kStage);",
             "        gemm::mbar_expect_tx(&full[s], i == 0 ? C::kStage : C::kStage - C::kW8);")
    f[CU] = _sub(s, "        tma_box(st, &tw, kc, w0, &full[s]);",
                 "        if (i == 0) tma_box(st, &tw, kc, w0, &full[s]);")
    return f


def _ss_wgmma():
    """wgmma with A and B from shared memory, N = 8 ... 64 (128: gemm.cuh's)."""
    out = ["template <int N>\n__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], "
           "uint64_t da, uint64_t db);\n"]
    for n in (8, 16, 32, 64):
        r = n // 2
        regs = ", ".join(f"%{i}" for i in range(r))
        outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
        out.append(
            f"template <>\n__device__ __forceinline__ void wgmma_ss<{n}>(float (&d)[{r}], "
            f"uint64_t da, uint64_t db) {{\n  asm volatile(\"{{\\n.reg .pred p;\\n"
            f"setp.ne.b32 p, %{r + 2}, 0;\\nwgmma.mma_async.sync.aligned.m64n{n}k16.f32."
            f"bf16.bf16 {{{regs}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n\"\n"
            f"      : {outs}\n      : \"l\"(da), \"l\"(db), \"r\"(1));\n}}\n")
    out.append("template <>\n__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], "
               "uint64_t da, uint64_t db) {\n  gemm::wgmma_n128<false, false>(d, da, db);\n}\n")
    return "\n".join(out)


_SMEM_CONSUMER = r'''  const int c = wg - 1, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = c * 64 + (tid >> 5) * 16 + g;
  unsigned char* sa = ring + C::kRegion;  // two bf16 A tiles of 128 x 64
  // this thread's conversion share: rows crow, crow + 32 of its 64, 16 k
  // from 16 seg; int8 chunk j of row r sits at j ^ (r / 2 % 4)
  const int crow = tid >> 2, seg = tid & 3;
  float srow[2] = {1.f, 1.f};
  if constexpr (P == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w0 + c * 64 + crow + 32 * h;
      srow[h] = r < n ? scale[r] : 0.f;
    }
  }
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const int s = i % C::kStages;
    gemm::mbar_wait(&full[s], (i / C::kStages) & 1);
    const unsigned char* st = ring + s * C::kStage;
    unsigned char* a = sa + (i & 1) * 16384 + c * 8192;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = crow + 32 * h, r = c * 64 + rl;
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + r * kQBK + ((seg ^ ((r >> 1) & 3)) << 4));
      const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                             v.w ^ 0x80808080u};
      uint32_t o[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[2 * q] = dequant2<P>(w[q], 0x7540u, 0x7541u, srow[h]);
        o[2 * q + 1] = dequant2<P>(w[q], 0x7542u, 0x7543u, srow[h]);
      }
      *reinterpret_cast<uint4*>(a + rl * 128 + (((2 * seg) ^ (rl & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(a + rl * 128 + (((2 * seg + 1) ^ (rl & 7)) << 4)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t a_addr = smem_u32(a), x_addr = smem_u32(st + C::kW8);
#pragma unroll
    for (int j = 0; j < kQBK / 16; ++j) {
#pragma unroll
      for (int p = P - 1; p >= 0; --p) {
        const uint64_t da = gemm::desc_sw128(a_addr + 32 * j);
        const uint64_t db = gemm::desc_sw128(x_addr + p * C::kX + 32 * j);
        if constexpr (P == 3) {
          wgmma_ss<BN>(part, da, db);
        } else {
          wgmma_ss<BN>(acc, da, db);
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if constexpr (P == 3) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        acc[j] += part[j];
        part[j] = 0.f;
      }
      if (tid == 0) gemm::mbar_arrive(&empty[s]);
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (i > 0 && tid == 0) gemm::mbar_arrive(&empty[(i - 1) % C::kStages]);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

'''


def smem(f):
    s = f[CU]
    s = _sub(s, "template <int N>\n__device__ __forceinline__ void wgmma_rs(",
             _ss_wgmma() + "\ntemplate <int N>\n__device__ __forceinline__ void wgmma_rs(")
    s = _sub(s, "  static constexpr int kFit = 200 * 1024 / kStage;",
             "  static constexpr int kFit = (200 * 1024 - 32768) / kStage;")
    s = _sub(s, "  static constexpr int kSmem = kRegion + 2 * kStages * 8 + 1024;",
             "  static constexpr int kSmem = kRegion + 32768 + 2 * kStages * 8 + 1024;")
    s = _sub(s, "  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kRegion);",
             "  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kRegion + 32768);")
    s = _between(s, "  // This consumer's 64 weight rows of the tile;",
                 "  // the partial yᵀ tile into the drained ring", _SMEM_CONSUMER)
    f[CU] = s
    return f


def p3_serial(f):
    """f32 x: the next stage's fragments made only after this stage's
    three products have completed (as one fragment buffer would)."""
    s = f[CU]
    load = ("    if (i + 1 < steps) {\n"
            "      gemm::mbar_wait(&full[(i + 1) % C::kStages], ((i + 1) / C::kStages) & 1);\n"
            "      load_a(af[B ^ 1], i + 1);\n    }\n")
    a = s.index(load)
    b = s.index("  };\n", a)
    f[CU] = s[:a] + s[a + len(load):b] + load + s[b:]
    return f


def split16(f):
    """k-split clusters of up to 16 blocks (non-portable)."""
    s = _sub(f[CU], "constexpr int kQMaxSplit = 8;", "constexpr int kQMaxSplit = 16;")
    attr = ("cudaFuncSetAttribute(qgemm_tma_kernel<BN, P>, "
            "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n  QLaunch q(")
    s = _sub(s, "  if (rc != 0) return rc;\n  QLaunch q(",
             "  if (rc != 0) return rc;\n  " + attr)
    f[CU] = _sub(s, "C::kSmem, attr_set) != 0) return 0;\n  QLaunch q(",
                 "C::kSmem, attr_set) != 0) return 0;\n  " + attr)
    return f


def _plan(x, w8, lib, narrow=True, max_split=tq.QGEMM_MAX_SPLIT, f32_bn=128,
          rows16_max_k=tq.QGEMM_ROWS16_MAX_K):
    """The wrapper's plan for (x, w8) with the variant's cluster slots
    (``lib``), k-split cap, f32 tile cap, register-fed decode cap and
    (``narrow`` False) no halved tiles."""
    (m, k), n = x.shape, w8.shape[0]
    if x.dtype == torch.bfloat16 and m <= 16 and k <= rows16_max_k:
        return tq.QgemmPlan("qgemm_bf16_rows16")
    parts = 3 if x.dtype == torch.float32 else 1
    cap = f32_bn if parts == 3 else 128
    bn = next((b for b in tq.QGEMM_TMA_BN if b >= min(m, cap)), cap)
    sms = tq._sm_count(x.device.index or 0)

    def slots(bn_, parts_, ks_):
        if ks_ > 8:  # the variant's own clusters
            return lib.apex_quant_gemm_slots(bn_, parts_, ks_)
        return tq._cluster_slots(x.device.index or 0, bn_, parts_, ks_)

    saved = tq.QGEMM_MAX_SPLIT
    tq.QGEMM_MAX_SPLIT = max_split
    try:
        ks = tq._split(m, n, k, bn, parts, sms, slots)
        if (narrow and bn >= 2 * tq.QGEMM_NARROW_MIN_BN
                and 2 * tq._blocks(m, n, bn, ks) <= sms):
            ks2 = tq._split(m, n, k, bn // 2, parts, sms, slots)
            if tq._blocks(m, n, bn // 2, ks2) > tq._blocks(m, n, bn, ks):
                bn, ks = bn // 2, ks2
    finally:
        tq.QGEMM_MAX_SPLIT = saved
    return tq.QgemmPlan("qgemm_tma", bn, ks, parts)


# name: (patch, computes y, plan keywords)
VARIANTS = {"base": (lambda f: f, True, {}), "smem": (smem, True, {}),
            "ks1": (lambda f: f, True, dict(max_split=1)),
            "wide": (lambda f: f, True, dict(narrow=False)),
            "split16": (split16, True, dict(max_split=16)),
            "p3_serial": (p3_serial, True, {}),
            "p3_bn64": (lambda f: f, True, dict(f32_bn=64)),
            "tma_decode": (lambda f: f, True, dict(rows16_max_k=0)),
            "no_dequant": (no_dequant, False, {}),
            "x_once": (x_once, False, {}), "w_once": (w_once, False, {})}


def build_all(names):
    """Each variant's library, all nvcc processes started together."""
    nvcc, jobs = _kernels._nvcc(), {}
    for name in names:
        d = ROOT / "build" / "qgemm_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        try:
            files = VARIANTS[name][0]({n: (_kernels.CSRC / n).read_text() for n in FILES})
        except ValueError as e:
            print(f"{name}: not built: {e}", flush=True)
            continue
        for n, s in files.items():
            (d / n).write_text(s.replace("apex_tpu_torch", f"qgemm_variant_{name}"))
        so = d / f"lib{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(d / CU)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            print(f"{name}: not built: {err}{out}", flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        for fn in ("apex_quant_gemm", "apex_quant_gemm_slots"):
            getattr(lib, fn).argtypes = _kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


class Variant:
    def __init__(self, name, lib):
        self.name, self.lib = name, lib
        self.plan_kw = VARIANTS[name][2]
        self.plans = {}

    def __call__(self, x, w8, scale):
        m, k = x.shape
        n = w8.shape[0]
        key = (m, n, k, x.dtype)
        if key not in self.plans:
            self.plans[key] = _plan(x, w8, self.lib, **self.plan_kw)
        plan = self.plans[key]
        y = torch.empty((m, n), dtype=torch.float32, device="cuda")
        parts = (torch.empty((3, m, k), dtype=torch.bfloat16, device="cuda")
                 if plan.parts == 3 else None)
        rc = self.lib.apex_quant_gemm(
            x.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(),
            None if parts is None else parts.data_ptr(), m, n, k, x.stride(0),
            tq.QGEMM_KERNELS[plan.kernel], plan.bn, plan.ks,
            _kernels.dtype_code(x, "quant_gemm"), _kernels.stream())
        _kernels.check(rc, self.name)
        return y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qgemm_variants_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    c.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def weight(n, k):
        return (torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                              dtype=torch.int8),
                torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4)

    layer_shapes, head = c.gpt350m_gemm_shapes()
    weights = [[weight(n, k) for n, k in layer_shapes] for _ in range(c.GPT350M["num_layers"])]
    head_w = weight(*head)
    cases = {}
    for tag, m in (("decode", c.SLOTS), ("prefill", 512)):
        xs = {k: torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
              for _, k in layer_shapes}
        xh = torch.randn(m, head[1], generator=gen, device="cuda")
        cases[tag] = [(xh if (n, k) == head else xs[k], w)
                      for (n, k), w in zip(layer_shapes + [head], weights[0] + [head_w])]
        cases[f"{tag}_97"] = [(xs[k], w) for ws in weights
                              for (_, k), w in zip(layer_shapes, ws)] + [(xh, head_w)]
    variants = {}
    for name, lib in build_all(VARIANTS).items():
        v = Variant(name, lib)
        if VARIANTS[name][1]:
            for x, w in cases["decode"] + cases["prefill"]:
                got, again = v(x, *w), v(x, *w)
                ref = tq.quant_gemm_reference(x, *w)
                torch.cuda.synchronize()
                tol = c.QGEMM_TOL[x.dtype]
                c.check_close(f"{name} {x.shape[0]}x{w[0].shape[0]}x{x.shape[1]}", got, ref,
                              tol, tol)
                if not torch.equal(got, again):
                    raise AssertionError(f"{name}: a repeat differs")
        variants[name] = v
    for rnd in range(args.rounds):
        order = list(variants) if rnd % 2 == 0 else list(reversed(variants))
        for name in order:
            v = variants[name]
            row = {}
            for tag in ("decode", "prefill"):
                for x, w in cases[tag]:
                    key = f"{tag}_{x.shape[0]}x{w[0].shape[0]}x{x.shape[1]}"
                    row[key] = round(1e3 * c.time_ms(lambda x=x, w=w: v(x, *w), 5), 3)
                calls = cases[f"{tag}_97"]
                row[f"{tag}_97"] = round(1e3 * len(calls) * c.time_ms(
                    [lambda x=x, w=w: v(x, *w) for x, w in calls], 3), 2)
            print(f"round {rnd} {name} (us): {json.dumps(row)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
