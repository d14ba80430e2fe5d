#!/usr/bin/env python3
"""Drive apex_tpu_torch's serving path on one NVIDIA H100 and hold every
kernel of the path against its plain PyTorch version.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits non-zero; nothing is caught):

1. build the CUDA kernels from ``apex_tpu_torch/csrc`` (nvcc, sm_90a);
2. for each kernel, at the shapes the serving path gives it: the kernel
   against its plain version on the same card inputs (max abs error and
   tolerance), the kernel's time, the plain version's time, one PyTorch
   library call computing the same function (a yardstick the port never
   calls) and the least time the card could take (bytes / 3.35 TB/s or
   operations / peak, whichever is larger);
3. GPT-350M (vocab 50304, hidden 1024, 24 layers, 16 heads, ffn 4096,
   max_seq 1024, bf16 activations, f32 params, random weights from seed 0)
   served by ``InferenceEngine`` (8 slots, bf16 cache): 10 greedy requests,
   prompts of 37..512 tokens, 32 new tokens each.  Every kernel's launch
   count is read around this run alone and checked against the count the
   path implies;
4. one request's prefill and 4 decode steps on the card against a CPU copy
   of the same model (the plain versions): logits within a bf16 tolerance,
   same greedy tokens.

The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12       # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12         # f32 outside the tensor cores

GPT350M = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
               num_attention_heads=16, ffn_hidden_size=4096,
               max_seq_len=1024)
SLOTS = 8
HEADS, HEAD_DIM, HIDDEN, MAX_SEQ = 16, 64, 1024, 1024
BF16_ATOL = BF16_RTOL = 2e-2   # one bf16 ulp at |y| <= 4 is 2**-6 = 0.0156
# Whole path, card vs CPU, both bf16: the two runs round and reduce in other
# orders, so the final hidden state drifts by ~1-2% over 24 residual layers
# (bf16 keeps 8 significant bits): a logit error of ~0.01 on a logit std of
# ~0.64, whose maximum over the 5 x 50304 logits compared is ~5 sigma.
LOGITS_ATOL = 0.1              # max |logit diff|
LOGITS_MEAN_ATOL = 0.02        # mean |logit diff|


def log(msg):
    print(msg, flush=True)


def time_ms(fns, rounds=5):
    """Device time per call: the calls in ``fns`` (one callable, or a list
    cycled through, e.g. one per cache layer so that inputs come from
    device memory and not from L2 as on the real path) captured in one
    CUDA graph and replayed ``rounds`` times; median of the mean per call.
    Host launch overhead is excluded (see ``call_ms``)."""
    fns = fns if isinstance(fns, list) else [fns] * 20
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up outside the capture
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / len(fns))
    del graph
    return statistics.median(samples)


def call_ms(fn, iters=50):
    """Time per eager call, back to back, by CUDA events: what a caller
    pays, host overhead included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, flops, peak):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(out, ref):
    return float((out.float() - ref.float()).abs().max())


def check_close(name, out, ref, atol, rtol):
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
    log(f"  {name}: max_abs_err={err:.3e} (tolerance |d| <= {atol} + "
        f"{rtol}*|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# -- phase 1 -----------------------------------------------------------------

def phase_build():
    from apex_tpu_torch import _kernels
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    log(f"[1] built {path.name} in {time.perf_counter() - t0:.1f} s")
    report = path.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log("    " + line.strip())


# -- phase 2 -----------------------------------------------------------------

def kernel_layer_norm(gen):
    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd,
                                               layer_norm_fwd_reference)
    dev = "cuda"
    w = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
    b = (0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
    w16, b16 = w.bfloat16(), b.bfloat16()
    rows_main = {}
    for rows in (SLOTS, 512):
        x = torch.randn(rows, HIDDEN, generator=gen).to(dev, torch.bfloat16)
        err = 0.0
        for rms in (False, True):
            bias = None if rms else b
            y, mean, rstd = layer_norm_fwd(x, w, bias, 1e-5, rms)
            ry, rmean, rrstd = layer_norm_fwd_reference(x, w, bias, 1e-5, rms)
            torch.cuda.synchronize()
            tag = f"layer_norm_fwd rows={rows} {'rms' if rms else 'ln'}"
            err = max(err, check_close(tag + " y", y, ry, BF16_ATOL,
                                       BF16_RTOL))
            check_close(tag + " mean", mean, rmean, 1e-5, 1e-5)
            check_close(tag + " rstd", rstd, rrstd, 1e-5, 1e-4)
        ms = time_ms(lambda: layer_norm_fwd(x, w, b, 1e-5, False))
        host = call_ms(lambda: layer_norm_fwd(x, w, b, 1e-5, False))
        plain = time_ms(lambda: layer_norm_fwd_reference(x, w, b, 1e-5,
                                                         False))
        lib = time_ms(lambda: F.layer_norm(x, (HIDDEN,), w16, b16, 1e-5))
        n_bytes = 2 * rows * HIDDEN * 2 + 2 * HIDDEN * 4 + 2 * rows * 4
        bms, by = bound_ms(n_bytes, 8 * rows * HIDDEN, PEAK_F32_FLOPS)
        log(f"  layer_norm_fwd rows={rows}: {ms:.4f} ms (eager call "
            f"{host:.4f} ms), plain {plain:.4f} ms, F.layer_norm {lib:.4f} "
            f"ms, bound {bms:.5f} ms ({by})")
        rows_main[rows] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               library_ms=lib, bound_ms=bms, bound_by=by,
                               call_ms=host)
    return rows_main


def _flash_bound(s, causal):
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * HEAD_DIM * pairs * HEADS
    n_bytes = 4 * HEADS * s * HEAD_DIM * 2 + HEADS * s * 4
    return bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)


def kernel_flash(gen):
    from apex_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                    flash_fwd)
    scale = HEAD_DIM ** -0.5
    by_len = {}
    for s in (8, 136, 512):
        # the prefill layout: heads interleaved in one (1, s, h, 3*hd)
        # projection, q/k/v are strided (b, h, s, d) views of it
        qkv = torch.randn(1, s, HEADS, 3 * HEAD_DIM, generator=gen).to(
            "cuda", torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in qkv.split(HEAD_DIM, dim=-1))
        o, _ = flash_fwd(q, k, v, True, scale)
        ref = flash_attention_reference(q, k, v, True, scale)
        torch.cuda.synchronize()
        err = check_close(f"flash_fwd causal s={s}", o, ref, BF16_ATOL,
                          BF16_RTOL)
        if s == 136:
            lens = torch.tensor([100], dtype=torch.int32, device="cuda")
            o2, _ = flash_fwd(q, k, v, False, scale, lens)
            ref2 = flash_attention_reference(q, k, v, False, scale, lens)
            check_close("flash_fwd kv_seqlens=100 s=136", o2, ref2,
                        BF16_ATOL, BF16_RTOL)
        ms = time_ms(lambda: flash_fwd(q, k, v, True, scale))
        host = call_ms(lambda: flash_fwd(q, k, v, True, scale))
        plain = time_ms(lambda: flash_attention_reference(q, k, v, True,
                                                          scale))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale))
        bms, by = _flash_bound(s, True)
        log(f"  flash_fwd s={s}: {ms:.4f} ms (eager call {host:.4f} ms), "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms "
            f"({by})")
        by_len[s] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bms, bound_by=by,
                         call_ms=host)
    return by_len


def kernel_decode(gen):
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_decode, flash_attention_decode_reference)
    scale = HEAD_DIM ** -0.5
    layers = GPT350M["num_layers"]
    cache = torch.randn(SLOTS, layers, 2, MAX_SEQ, HEADS, HEAD_DIM,
                        generator=gen, dtype=torch.float32).to(
        "cuda", torch.bfloat16)
    # ragged lengths: one token, mid-block, half, full cache, ...
    lens = torch.tensor([1, 97, 512, 1024, 300, 640, 37, 800],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(SLOTS, HEADS, HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16)
    k, v = cache[:, 3, 0], cache[:, 3, 1]        # strided views of the ring
    assert not k.is_contiguous()
    o = flash_attention_decode(q, k, v, lens, scale)
    ref = flash_attention_decode_reference(q, k, v, lens, scale)
    torch.cuda.synchronize()
    err = check_close("flash_attention_decode ragged lens, strided cache",
                      o, ref, BF16_ATOL, BF16_RTOL)
    views = [(cache[:, li, 0], cache[:, li, 1]) for li in range(layers)]
    ms = time_ms([lambda k=k, v=v: flash_attention_decode(q, k, v, lens,
                                                          scale)
                  for k, v in views])
    host = call_ms(lambda: flash_attention_decode(q, k, v, lens, scale))
    plain = time_ms([lambda k=k, v=v: flash_attention_decode_reference(
        q, k, v, lens, scale) for k, v in views])
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    lib = time_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        scale=scale) for k, v in views])
    total = int(lens.sum())
    n_bytes = 2 * total * HEADS * HEAD_DIM * 2 + 2 * q.numel() * 2 \
        + lens.numel() * 4
    bms, by = bound_ms(n_bytes, 4 * HEAD_DIM * HEADS * total,
                       PEAK_BF16_FLOPS)
    log(f"  flash_attention_decode: {ms:.4f} ms (eager call {host:.4f} ms), "
        f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms ({by})")
    del cache, views
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, call_ms=host)


# -- phase 3 -----------------------------------------------------------------

def build_model(device):
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    cfg = GPTConfig(**GPT350M, dtype=torch.bfloat16)
    return GPTModel(cfg, device=device)


def phase_serve(model, rng):
    from apex_tpu_torch.inference import InferenceEngine, Request
    from apex_tpu_torch.ops.flash_attention import (flash_attention_decode,
                                                    flash_fwd)
    from apex_tpu_torch.ops.layer_norm import layer_norm_fwd
    counters = (layer_norm_fwd, flash_fwd, flash_attention_decode)
    cfg = model.cfg
    engine = InferenceEngine(model, max_slots=SLOTS, device="cuda")
    lens = rng.randint(37, 513, size=10)
    lens[:2] = (37, 512)
    for i, n in enumerate(lens):
        engine.submit(Request(request_id=i, max_new_tokens=32,
                              prompt=rng.randint(0, cfg.vocab_size,
                                                 int(n)).tolist()))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}

    reasons = {r.request_id: r.finish_reason for r in responses}
    log(f"[3] served {len(responses)} requests in {wall:.3f} s: reasons "
        f"{sorted(set(reasons.values()))}")
    errors = [r for r in responses if r.finish_reason == "error"]
    if errors:
        raise AssertionError(f"requests failed inside the engine: "
                             f"{[(r.request_id, r.error) for r in errors]}")
    if len(responses) != len(lens) or any(
            r.finish_reason not in ("eos", "length") for r in responses):
        raise AssertionError(f"unexpected responses: {reasons}")
    for r in responses:
        if len(r.tokens) != 32 or not all(0 <= t < cfg.vocab_size
                                          for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens "
                                 f"{r.tokens}")
    prefills, steps = len(lens), len(engine.metrics.occupancy)
    layers = cfg.num_layers
    expected = {"layer_norm_fwd": (2 * layers + 1) * (prefills + steps),
                "flash_fwd": layers * prefills,
                "flash_attention_decode": layers * steps}
    log(f"    launches {launches} (expected {expected}: {prefills} "
        f"prefills, {steps} decode steps)")
    if launches != expected:
        raise AssertionError("kernel launch counts do not match the path")
    summary = engine.metrics.summary()
    log("    metrics " + json.dumps(summary, sort_keys=True))

    # latency of the two device programs at the bench_gpt_decode shapes
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 512))).to(
        "cuda")
    prefill_s = _host_time(lambda: model.prefill(prompt))
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, SLOTS)).to(
        "cuda")
    positions = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    step_s = _host_time(lambda: model.decode_step(tokens, engine.cache.data,
                                                  positions))
    log(f"    prefill(512 tokens) {prefill_s * 1e3:.3f} ms, decode_step("
        f"{SLOTS} slots at position 512) {step_s * 1e3:.3f} ms, "
        f"{SLOTS / step_s:.1f} decode tokens/s")
    return dict(launches=launches, steps=steps, prefills=prefills,
                wall_s=wall, served_tokens_per_s=summary["tokens_per_s"],
                prefill_512_ms=prefill_s * 1e3, decode_step_ms=step_s * 1e3,
                decode_tokens_per_s=SLOTS / step_s, summary=summary)


def _host_time(fn, iters=5, rounds=3):
    """Median over rounds of host time per call, ending in a sync."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / iters)
    return statistics.median(out)


# -- phase 4 -----------------------------------------------------------------

def _prefill_and_decode(model, prompt, steps, forced=None):
    """Prefill ``prompt`` into a one-slot cache, then ``steps`` decode
    steps.  Feeds ``forced`` tokens when given (else its own greedy
    picks); returns the stacked last-position logits on the CPU."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    cache = torch.zeros((1, cfg.num_layers, 2, cfg.max_seq_len, HEADS,
                         HEAD_DIM), dtype=cfg.dtype, device=dev)
    logits, kv = model.prefill(prompt.to(dev))
    n = prompt.shape[1]
    cache[0, :, :, :n] = kv[:, :, 0].to(cache.dtype)
    rows = [logits[0, n - 1]]
    for i in range(steps):
        tok = forced[i] if forced is not None else int(rows[-1].argmax())
        lg, cache = model.decode_step(
            torch.tensor([tok], device=dev), cache,
            torch.tensor([n + i], dtype=torch.int32, device=dev))
        rows.append(lg[0])
    return torch.stack(rows).float().cpu()


def phase_parity(model, rng):
    cpu_model = build_model("cpu")
    cpu_model.load_state_dict(model.state_dict())
    prompt = torch.from_numpy(rng.randint(0, model.cfg.vocab_size, (1, 64)))
    card = _prefill_and_decode(model, prompt, 4)
    tokens = card.argmax(-1).tolist()
    cpu = _prefill_and_decode(cpu_model, prompt, 4, forced=tokens)
    diff = (card - cpu).abs()
    err, mean_err = float(diff.max()), float(diff.mean())
    if not bool(torch.isfinite(card).all()):
        raise AssertionError("non-finite logits on the card")
    top2 = cpu.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    log(f"[4] card vs CPU, prefill(64) + 4 decode steps: max |logit diff| "
        f"{err:.3e} (tolerance {LOGITS_ATOL}), mean {mean_err:.3e} "
        f"(tolerance {LOGITS_MEAN_ATOL}); logit std "
        f"{float(cpu.std()):.3f}, smallest top-2 margin {margin:.3e}); "
        f"greedy card {tokens} cpu {cpu.argmax(-1).tolist()}")
    if err > LOGITS_ATOL or mean_err > LOGITS_MEAN_ATOL:
        raise AssertionError("card and CPU logits disagree")
    if cpu.argmax(-1).tolist() != tokens:
        raise AssertionError("card and CPU greedy tokens disagree")
    return dict(max_logit_diff=err, mean_logit_diff=mean_err,
                tolerance=LOGITS_ATOL, mean_tolerance=LOGITS_MEAN_ATOL,
                tokens=tokens, min_top2_margin=margin)


# -- optional: where the time goes ------------------------------------------

def _kernel_class(name):
    if "layer_norm_fwd_kernel" in name:
        return "layer_norm_fwd"
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_decode_kernel" in name:
        return "flash_attention_decode"
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, indexing)"


def phase_profile(model, rng, path):
    """torch.profiler over one prefill(512) and one 8-slot decode step:
    device time by kernel class, and the device's idle share of the
    profiled wall time.  Written to ``path`` and summarized on stdout."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 512))).to(
        "cuda")
    cache = torch.zeros((SLOTS, cfg.num_layers, 2, cfg.max_seq_len, HEADS,
                         HEAD_DIM), dtype=cfg.dtype, device="cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, SLOTS)).to(
        "cuda")
    positions = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    programs = {"prefill_512": lambda: model.prefill(prompt),
                "decode_step_8_slots": lambda: model.decode_step(
                    tokens, cache, positions)}
    lines, out = [], {}
    for name, fn in programs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_class, by_name, n_kernels = {}, {}, 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = e.device_time_total / 1e3
            n_kernels += 1
            cls = _kernel_class(e.name)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
        busy = sum(by_class.values())
        out[name] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                         idle_share=1 - busy / wall_ms, kernels=n_kernels,
                         by_class=by_class)
        log(f"[p] {name}: wall {wall_ms:.3f} ms under the profiler, device "
            f"busy {busy:.3f} ms ({n_kernels} kernels), idle share "
            f"{1 - busy / wall_ms:.3f}; " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in sorted(
                    by_class.items(), key=lambda kv: -kv[1])))
        lines.append(f"== {name} wall {wall_ms:.3f} ms busy {busy:.3f} ms")
        lines += [f"{v:10.4f} ms  {k[:150]}" for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:25]]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out


# -- main --------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write all results to this JSON file")
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one prefill and one decode step and "
                         "write the kernel breakdown to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import apex_tpu_torch  # noqa: F401  (fails outside a checkout)

    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} on {kind}")
    phase_build()

    gen = torch.Generator().manual_seed(0)
    log("[2] kernels against their plain versions on the card")
    ln = kernel_layer_norm(gen)
    fl = kernel_flash(gen)
    dec = kernel_decode(gen)

    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    serve = phase_serve(model, rng)
    parity = phase_parity(model, rng)
    profiled = phase_profile(model, rng, args.profile) if args.profile \
        else None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sources = {"layer_norm_fwd": ("apex_tpu_torch/csrc/layer_norm_fwd.cu",
                                  "apex_tpu/ops/layer_norm.py:91", ln[SLOTS]),
               "flash_fwd": ("apex_tpu_torch/csrc/flash_fwd.cu",
                             "apex_tpu/ops/flash_attention.py:139", fl[512]),
               "flash_attention_decode": (
                   "apex_tpu_torch/csrc/flash_decode.cu",
                   "apex_tpu/ops/flash_attention.py:586", dec)}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=serve["launches"][name],
                    **{k: nums[k] for k in keys})
               for name, (src, rep, nums) in sources.items()]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, layer_norm=ln,
                           flash=fl, decode=dec, serve=serve, parity=parity,
                           profile=profiled, kernels=kernels), f, indent=1, sort_keys=True)
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
