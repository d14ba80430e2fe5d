"""Time the tile configurations of apex_tpu_torch's tiled GEMM
(``apex_tpu_torch/csrc/gemm.cuh``, the FFN's mainloop) on the FFN
forward's two NT products at the paths' shapes, against cuBLAS
(``torch.matmul``) and two designs the port's bf16 path replaced; then on
the FFN backward's four products at 8192 rows (MN-major operands on TMA
128 x 256 and 128 x 128 tiles) against cuBLAS.

    python3 tools/sweep_gemm_torch.py [--out results.json]

Run from the repository root on a machine with an NVIDIA H100 and nvcc: it
builds ``tools/sweep_gemm_torch.cu`` into ``build/`` and prints, per
product shape and configuration, the device time per call (CUDA-graph
replay, ``chip_smoke.time_ms``), TFLOP/s, and the largest error against an
f32 product relative to its largest entry.  Decode shapes are also timed
over 24 weight sets, so that W comes from device memory as on the path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CONFIGS = {0: "port (gemm_nt's choice)", 1: "TMA + wgmma 128x256",
           2: "TMA + wgmma 128x128", 3: "mma.sync 16x16 (narrow)",
           4: "mma.sync 16x8 (narrow)", 5: "mma.sync 128x128, cp.async",
           6: "wgmma 128x256, cp.async"}
# (m, n, k): x W1^T and h W2^T at GPT-350M / BERT-large training (8192
# rows), prefill (512), decode (8) and GPT-2 XL widths (1000 rows)
SHAPES = [(8192, 4096, 1024), (8192, 1024, 4096), (512, 4096, 1024),
          (512, 1024, 4096), (8, 4096, 1024), (8, 1024, 4096),
          (1000, 6400, 1600), (1000, 1600, 6400)]
# the backward at GPT-350M / BERT-large training: tokens, hidden, ffn
BWD_M, BWD_H, BWD_F = 8192, 1024, 4096
TILES = {1: "TMA + wgmma 128x256", 2: "TMA + wgmma 128x128"}


def build():
    from apex_tpu_torch import _kernels
    out = ROOT / "build" / "sweep_gemm_torch.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
                        "-Xptxas", "-v", "-o", str(out),
                        str(ROOT / "tools" / "sweep_gemm_torch.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed:\n{r.stderr}")
    for name, regs in chip_smoke._ptxas_by_kernel(r.stderr, ("gemm_",)):
        print(f"  {name.split('(')[0]}: {regs}", flush=True)
    lib = ctypes.CDLL(str(out))
    lib.sweep_gemm.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.sweep_gemm_mn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(rc, name):
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _err(c, ref):
    return float((c.float() - ref).abs().max() / ref.abs().max())


def sweep_backward(lib, gen, rows):
    """The backward's four products alone, each against cuBLAS on the
    same operands."""
    m, h, f = BWD_M, BWD_H, BWD_F

    def rand(*shape, std=1.0):
        return (std * torch.randn(*shape, device="cuda", generator=gen)
                ).bfloat16()
    x, dy, dz, hh = rand(m, h), rand(m, h), rand(m, f), rand(m, f)
    w1, w2 = rand(f, h, std=0.02), rand(h, f, std=0.02)
    # name, A, B, C = A B as (m, n, k), A MN-major, cuBLAS's call
    products = [("dh = dy W2", dy, w2, (m, f, h), 0, lambda: dy @ w2),
                ("dX = dz W1", dz, w1, (m, h, f), 0, lambda: dz @ w1),
                ("dW1 = dz^T x", dz, x, (f, h, m), 1, lambda: dz.t() @ x),
                ("dW2 = dy^T h", dy, hh, (h, f, m), 1, lambda: dy.t() @ hh)]
    for name, a, b, (pm, pn, pk), a_mn, cublas in products:
        ref = (a.float().t() if a_mn else a.float()) @ b.float()
        flops = 2 * pm * pn * pk
        t_lib = chip_smoke.time_ms(cublas)
        rows.append(dict(product=name, config="cuBLAS", ms=t_lib))
        print(f"{name} ({pm} x {pn} x {pk}): cuBLAS {t_lib:.5f} ms "
              f"({flops / t_lib / 1e9:.1f} TFLOP/s)", flush=True)
        for cfg, tile in TILES.items():
            c = torch.empty(pm, pn, device="cuda", dtype=torch.bfloat16)

            def run(cfg=cfg, c=c, a=a, b=b, pm=pm, pn=pn, pk=pk, a_mn=a_mn):
                _check(lib.sweep_gemm_mn(cfg, a_mn, a.data_ptr(),
                                         b.data_ptr(), c.data_ptr(), pm, pn,
                                         pk, _stream()), tile)
            run()
            torch.cuda.synchronize()
            err = _err(c, ref)
            ms = chip_smoke.time_ms(run)
            rows.append(dict(product=name, config=tile, ms=ms, err=err))
            print(f"  {tile}: {ms:.5f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                  f"max err / max |ref| {err:.2e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for m, n, k in SHAPES:
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        bs = [(0.05 * torch.randn(n, k, device="cuda", generator=gen))
              .bfloat16() for _ in range(24 if m <= 64 else 1)]
        ref = a.float() @ bs[0].float().t()
        flops = 2 * m * n * k

        def timed(call):
            return chip_smoke.time_ms([lambda b=b: call(b) for b in bs]
                                      * (20 // len(bs) or 1))
        t_lib = timed(lambda b: torch.matmul(a, b.t()))
        rows.append(dict(m=m, n=n, k=k, config="cuBLAS", ms=t_lib))
        print(f"m={m} n={n} k={k}: cuBLAS {t_lib:.5f} ms "
              f"({flops / t_lib / 1e9:.1f} TFLOP/s)", flush=True)
        for cfg, name in CONFIGS.items():
            c = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)

            def run(b, cfg=cfg, c=c):
                rc = lib.sweep_gemm(cfg, a.data_ptr(), b.data_ptr(),
                                    c.data_ptr(), m, n, k,
                                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            run(bs[0])
            torch.cuda.synchronize()
            err = float((c.float() - ref).abs().max() / ref.abs().max())
            ms = timed(run)
            rows.append(dict(m=m, n=n, k=k, config=name, ms=ms, err=err))
            print(f"  {name}: {ms:.5f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                  f"max err / max |ref| {err:.2e}", flush=True)
    sweep_backward(lib, gen, rows)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=card, rows=rows),
                                             indent=1))


if __name__ == "__main__":
    main()
