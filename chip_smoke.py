#!/usr/bin/env python3
"""Drive apex_tpu_torch's serving and training paths (GPT serving, GPT
training, BERT training under amp O2, each also with the fused FFN,
ResNet-50 ImageNet training under amp O1 and O2) on one NVIDIA H100 and
hold every kernel of the paths against its plain PyTorch version.

    python3 chip_smoke.py [--out results.json] [--profile breakdown.txt]

Phases (any failure exits non-zero; nothing is caught):

1. build the CUDA kernels from ``apex_tpu_torch/csrc`` (nvcc, sm_90a);
2. for each kernel, at the shapes the paths give it: the kernel against its
   plain version on the same card inputs (max abs error and tolerance), the
   kernel's time, the plain version's time, one PyTorch library call
   computing the same function (a yardstick the port never calls) and the
   least time the card could take (bytes / 3.35 TB/s or operations / peak,
   whichever is larger); the fused LM head (#8-#10) at GPT-350M's and
   BERT-large's head shapes in bf16 and GPT-350M's in f32, a peaked-softmax
   bf16 case off the token and vocab grids, and three small off-grid cases
   (f32, bf16, a mixed pair), its yardstick the two calls matmul +
   F.cross_entropy; the fused FFN (#11-#13) at GPT-350M's and BERT-large's
   micro-batch (bf16 x with f32 W, bf16/bf16), the serving shapes (512
   and 8 rows), GPT-2 XL's widths off the grids (1000 x 1600 -> 6400 ->
   1600), GPT-350M's shape in f32 and small cases, every output held
   entry by entry (``ffn_bounds``), its yardstick the unfused
   F.linear + gelu + F.linear chain; the multi-tensor axpby, SGD, Adagrad
   and NovoGrad (#16, #19, #22, #23) at GPT-350M's f32 list (291 tensors,
   as Adam), on a mixed list of 40 bf16 / f16 / f32 tensors with f32
   masters and model copies, and SGD at ResNet-50's O1 and O2 lists (161
   tensors), their yardsticks ``SGD(fused=True)`` and
   ``Adagrad(foreach=True)``;
3. GPT-350M (vocab 50304, hidden 1024, 24 layers, 16 heads, ffn 4096,
   max_seq 1024, bf16 activations, f32 params, random weights from seed 0)
   served by ``InferenceEngine`` (8 slots, bf16 cache): 10 greedy requests,
   prompts of 37..512 tokens, 32 new tokens each.  Every kernel's launch
   count is read around this run alone and checked against the count the
   path implies, and no plain version may be called; (3f) the same model
   with ``fused_ffn=True`` (its FFN is #11 in every prefill and decode
   step) serves the same requests under the same checks;
4. one request's prefill and 4 decode steps on the card against a CPU copy
   of the same model (the plain versions): logits within a bf16 tolerance,
   same greedy tokens; (4f) the same with ``fused_ffn=True``;
5. GPT-350M training (the fused LM head, micro-batch 8 x accumulation 2 x
   seq 1024 = 16,384 tokens per step, ``FusedAdam(lr=1e-4)`` AdamW: the
   configuration of bench.py's GPT leg) for 4 steps on one fixed batch
   from seed 0, through ``forward_backward_no_pipelining`` over ``GPTModel``'s loss and backward
   and ``FusedAdam.step``: losses finite and falling, step time, tokens/s,
   peak memory, exact launch counts per kernel, and no call of a plain
   version; (5f) the same with ``fused_ffn=True`` (#11-#13 in every layer),
   its step time, tokens/s and peak memory beside phase 5's;
6. a small GPT (4 layers, hidden 256, vocab 50304, seq 256, attention
   dropout 0.1) trained 2 steps on the card and on a CPU copy, with the
   fused LM head, again with the f32-logits head (``fused_lm_head=False``)
   and again with ``fused_ffn=True``: loss, every gradient and the
   parameters within stated tolerances;
7. BERT-large (vocab 30528, hidden 1024, 24 layers, 16 heads, ffn 4096,
   seq 512, the fused LM head) under ``amp.initialize(...,
   opt_level="O2")`` with ``FusedLAMB(lr=1e-3)``: micro-batch 16 x
   accumulation 2 x seq 512, 15% MLM labels from seed 0 (bench.py's
   recipe), 4 steps through ``forward_backward_no_pipelining`` over
   ``BertModel.loss`` and ``FusedLAMB.step``: losses, step time, tokens/s,
   peak memory, exact launch counts per kernel, no plain version called;
   (7f) the same with ``fused_ffn=True``; then (7b)
   ``LossScaler.unscale`` and ``clip_grad_norm_`` on phase 7's last step's
   gradients against their plain versions, their launches counted alone;
8. a small BERT (4 layers, hidden 256, seq 128, vocab 30528, the fused LM
   head) under O2 + FusedLAMB trained 2 steps on the card and on a CPU
   copy, and again with ``fused_ffn=True``: loss, every gradient, the
   masters, m and v within stated bounds; then (8b) a
   dynamic-loss-scale step with an inf in one gradient, skipped on the
   device;
9. ResNet-50 ImageNet through the ported example's ``main()``
   (``apex_tpu_torch/examples/imagenet/main_amp.py`` at its defaults:
   batch 256 x 224^2, 1000 classes, FusedSGD lr 0.1, momentum 0.9, wd
   1e-4, synthetic data from seed 0; a warm-up step, then 4) under amp O1:
   losses, step time, img/s, peak memory, the exact #19 launches and no
   plain version called; (9b) the same under O2 (f32 batch norm, FusedSGD
   with f32 masters); (9c) one step each with FusedAdagrad (#22) and
   FusedNovoGrad (#17 per-tensor sums, #23) on 9b's model; (9d) the
   example's hand-written SGD (#17 overflow check, #16 update);
10. resnet26 (width 16, 64 x 64, batch 8, 10 classes) trained 2 steps
   under O1 on the card and on a CPU copy (and in f32 on the CPU, the
   yardstick) with each of the three optimizers: losses, the first
   step's gradients, the parameters' moves and the running statistics
   within stated bounds; FusedSGD's card run again with the process-wide
   matmul flags as torch set them before the GPT phases.

The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
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
# bench.py's GPT train step (bench_gpt_train_step)
MICRO, ACCUM, SEQ, LR, TRAIN_STEPS = 8, 2, 1024, 1e-4, 4
TRAIN_ROWS = MICRO * SEQ       # rows of every LayerNorm on that path
BF16_ATOL = BF16_RTOL = 2e-2   # one bf16 ulp at |y| <= 4 is 2**-6 = 0.0156
# Whole path, card vs CPU, both bf16: the two runs round and reduce in other
# orders, so the final hidden state drifts by ~1-2% over 24 residual layers
# (bf16 keeps 8 significant bits): a logit error of ~0.01 on a logit std of
# ~0.64, whose maximum over the 5 x 50304 logits compared is ~5 sigma.
LOGITS_ATOL = 0.1              # max |logit diff|
LOGITS_MEAN_ATOL = 0.02        # mean |logit diff|
# Training, card vs CPU, bf16 activations: each gradient within 5e-2 of its
# largest entry (bf16 rounding places and sum orders differ; the same bound
# holds the port against JAX on the CPU); the loss within 2e-3 relative.
# Adam moves an entry by about lr per step whatever its gradient's size, so
# an entry whose gradient is at noise level (the key bias, which softmax
# ignores) may move the other way on one side.  At step 2 |m^ / sqrt(v^)|
# is at most 1.0014 lr (Cauchy-Schwarz over the two gradients), so after 2
# steps entries may differ by 4.003 lr: checked at 4.5 lr; 99% of entries
# agree to lr / 2.
TRAIN_GRAD_TOL = 5e-2
TRAIN_LOSS_RTOL = 2e-3
# bench.py's BERT-large + amp O2 + FusedLAMB step (_make_bert_lamb_step)
BERT_LARGE = dict(vocab_size=30528, hidden_size=1024, num_layers=24,
                  num_attention_heads=16, ffn_hidden_size=4096,
                  max_seq_len=512, type_vocab_size=2)
BERT_MICRO, BERT_ACCUM, BERT_SEQ, BERT_LR, BERT_STEPS = 16, 2, 512, 1e-3, 4
BERT_ROWS = BERT_MICRO * BERT_SEQ
LAMB_BETAS, LAMB_WD = (0.9, 0.999), 0.01
# Training, card vs CPU under LAMB: each leaf's whole move over the steps
# agrees, ||p_card - p_cpu|| <= MOVE_RTOL ||p_cpu - p0||.  The entry-wise
# bound of phase 8 admits a master that never moved (share 1) or moved at
# half the learning rate (0.5); the CPU tests against JAX see at most 0.2.
MOVE_RTOL = 0.35


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


def numbers(err, ms, plain, lib, bound, host):
    bms, by = bound
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, call_ms=host)


def log_numbers(name, n, lib_name):
    lib = ("" if n["library_ms"] is None
           else f" {n['library_ms']:.4f} ms")
    log(f"  {name}: {n['ms']:.4f} ms (eager call {n['call_ms']:.4f} ms), "
        f"plain {n['plain_ms']:.4f} ms, {lib_name}{lib}, "
        f"bound {n['bound_ms']:.5f} ms ({n['bound_by']})")


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
    for rows in (SLOTS, 512, TRAIN_ROWS):
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
        n_bytes = 2 * rows * HIDDEN * 2 + 2 * HIDDEN * 4 + 2 * rows * 4
        n = numbers(
            err, time_ms(lambda: layer_norm_fwd(x, w, b, 1e-5, False)),
            time_ms(lambda: layer_norm_fwd_reference(x, w, b, 1e-5, False)),
            time_ms(lambda: F.layer_norm(x, (HIDDEN,), w16, b16, 1e-5)),
            bound_ms(n_bytes, 8 * rows * HIDDEN, PEAK_F32_FLOPS),
            call_ms(lambda: layer_norm_fwd(x, w, b, 1e-5, False)))
        log_numbers(f"layer_norm_fwd rows={rows}", n, "F.layer_norm")
        rows_main[rows] = n
    # BERT's MLM LayerNorm takes the f32 output of its transform (f32 in,
    # f32 out): the same math without the bf16 rounding of y, so the
    # kernel and its plain version differ only in their f32 sum orders
    x = torch.randn(TRAIN_ROWS, HIDDEN, generator=gen).to(dev)
    y, mean, rstd = layer_norm_fwd(x, w, b, 1e-5, False)
    ry, rmean, rrstd = layer_norm_fwd_reference(x, w, b, 1e-5, False)
    torch.cuda.synchronize()
    tag = f"layer_norm_fwd rows={TRAIN_ROWS} f32 ln"
    if y.dtype != torch.float32:
        raise AssertionError(f"{tag}: y is {y.dtype}, not f32")
    check_close(tag + " y", y, ry, 1e-5, 1e-5)
    check_close(tag + " mean", mean, rmean, 1e-5, 1e-5)
    check_close(tag + " rstd", rstd, rrstd, 1e-5, 1e-4)
    return rows_main


def kernel_layer_norm_bwd(gen):
    """#2 at the training shape (8192 x 1024 bf16, LN from x), the same
    shape in f32 (BERT's MLM LayerNorm), plus small from_y / RMS / f32
    cases."""
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd,
                                               layer_norm_bwd_reference,
                                               layer_norm_fwd)
    dev = "cuda"
    out = {}
    cases = [(TRAIN_ROWS, torch.bfloat16, False, False),
             (TRAIN_ROWS, torch.float32, False, False),
             (512, torch.bfloat16, False, True), (512, torch.bfloat16, True,
                                                  False),
             (512, torch.bfloat16, True, True), (300, torch.float32, False,
                                                 True)]
    for rows, dt, rms, from_y in cases:
        w = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
        b = None if rms else (0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
        x = torch.randn(rows, HIDDEN, generator=gen).to(dev, dt)
        dy = torch.randn(rows, HIDDEN, generator=gen).to(dev, dt)
        y, mean, rstd = layer_norm_fwd(x, w, b, 1e-5, rms)
        res = y if from_y else x
        dx, dw, db = layer_norm_bwd(dy, res, w, b, mean, rstd, rms, from_y)
        rdx, rdw, rdb = layer_norm_bwd_reference(dy, res, w, b, mean, rstd,
                                                 rms, from_y)
        torch.cuda.synchronize()
        tag = (f"layer_norm_bwd rows={rows} {str(dt)[6:]} "
               f"{'rms' if rms else 'ln'}{' from_y' if from_y else ''}")
        tol = BF16_ATOL if dt == torch.bfloat16 else 1e-4
        err = check_close(tag + " dx", dx, rdx, tol, tol)
        # f32 sums over `rows` products in another order
        check_close(tag + " dgamma", dw, rdw, 1e-3, 1e-4)
        if not rms:
            check_close(tag + " dbeta", db, rdb, 1e-3, 1e-4)
        if (rows, dt, rms, from_y) != (TRAIN_ROWS, torch.bfloat16, False,
                                       False):
            continue
        x_, w16, b16 = x, w.bfloat16(), b.bfloat16()
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x_, [HIDDEN], w16,
                                                           b16, 1e-5)
        n_bytes = 3 * rows * HIDDEN * 2 + 2 * HIDDEN * 4 + 2 * rows * 4 \
            + 2 * HIDDEN * 4
        n = numbers(
            err,
            time_ms(lambda: layer_norm_bwd(dy, x, w, b, mean, rstd, False,
                                           False)),
            time_ms(lambda: layer_norm_bwd_reference(dy, x, w, b, mean, rstd,
                                                     False, False)),
            time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x_, [HIDDEN], lmean, lrstd, w16, b16, [True, True, True])),
            bound_ms(n_bytes, 12 * rows * HIDDEN, PEAK_F32_FLOPS),
            call_ms(lambda: layer_norm_bwd(dy, x, w, b, mean, rstd, False,
                                           False)))
        log_numbers(f"layer_norm_bwd rows={rows}", n,
                    "aten native_layer_norm_backward")
        out = n
    return out


def _flash_bound(batch, s, causal, n_products, n_io, lens=None):
    """Bytes: n_io (b, h, s, d) bf16 tensors read or written once, plus the
    f32 row statistics; operations: n_products products of head_dim per
    (query, key) pair the masks leave."""
    if lens is not None:
        pairs = int(sum(min(int(n), s) for n in lens)) * s
    elif causal:
        pairs = batch * s * (s + 1) // 2
    else:
        pairs = batch * s * s
    flops = 2 * n_products * HEAD_DIM * pairs * HEADS
    n_bytes = n_io * batch * HEADS * s * HEAD_DIM * 2 + batch * HEADS * s * 4
    return bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)


def _qkv_views(gen, batch, s):
    """q, k, v as the model gives them: strided (b, h, s, d) views of one
    (b, s, h, 3*hd) projection."""
    qkv = torch.randn(batch, s, HEADS, 3 * HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16)
    return [t.transpose(1, 2) for t in qkv.split(HEAD_DIM, dim=-1)]


def kernel_flash(gen):
    from apex_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                    flash_fwd,
                                                    flash_fwd_reference)
    scale = HEAD_DIM ** -0.5
    by_len = {}                  # JSON keys: "s=<len>", "train_dropout_<rate>"
    for s in (8, 136, 512):
        q, k, v = _qkv_views(gen, 1, s)
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
        n = numbers(
            err, time_ms(lambda: flash_fwd(q, k, v, True, scale)),
            time_ms(lambda: flash_attention_reference(q, k, v, True, scale)),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)),
            _flash_bound(1, s, True, 2, 4),
            call_ms(lambda: flash_fwd(q, k, v, True, scale)))
        log_numbers(f"flash_fwd s={s}", n, "sdpa")
        by_len[f"s={s}"] = n
    # the training shape, without and with dropout (the hash mask is
    # compared through the plain version, which draws it densely)
    q, k, v = _qkv_views(gen, MICRO, SEQ)
    for rate in (0.0, 0.1):
        seed = 1234 if rate else None
        o, lse = flash_fwd(q, k, v, True, scale, None, rate, seed)
        ro, rlse = flash_fwd_reference(q, k, v, True, scale, None, rate, seed)
        torch.cuda.synchronize()
        tag = f"flash_fwd causal ({MICRO},{HEADS},{SEQ},{HEAD_DIM}) " \
              f"dropout={rate}"
        err = check_close(tag, o, ro, BF16_ATOL, BF16_RTOL)
        check_close(tag + " lse", lse, rlse, 1e-4, 1e-5)
        n = numbers(
            err, time_ms(lambda: flash_fwd(q, k, v, True, scale, None, rate,
                                           seed)),
            time_ms(lambda: flash_fwd_reference(q, k, v, True, scale, None,
                                                rate, seed)),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)),
            _flash_bound(MICRO, SEQ, True, 2, 4),
            call_ms(lambda: flash_fwd(q, k, v, True, scale, None, rate,
                                      seed)))
        log_numbers(f"flash_fwd train dropout={rate}", n,
                    "sdpa (no dropout)")
        by_len[f"train_dropout_{rate}"] = n
    # the BERT training shape: bidirectional (no mask)
    q, k, v = _qkv_views(gen, BERT_MICRO, BERT_SEQ)
    o, lse = flash_fwd(q, k, v, False, scale)
    ro, rlse = flash_fwd_reference(q, k, v, False, scale)
    torch.cuda.synchronize()
    tag = f"flash_fwd non-causal ({BERT_MICRO},{HEADS},{BERT_SEQ},{HEAD_DIM})"
    err = check_close(tag, o, ro, BF16_ATOL, BF16_RTOL)
    check_close(tag + " lse", lse, rlse, 1e-4, 1e-5)
    n = numbers(
        err, time_ms(lambda: flash_fwd(q, k, v, False, scale)),
        time_ms(lambda: flash_fwd_reference(q, k, v, False, scale)),
        time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=scale)),
        _flash_bound(BERT_MICRO, BERT_SEQ, False, 2, 4),
        call_ms(lambda: flash_fwd(q, k, v, False, scale)))
    log_numbers("flash_fwd bert non-causal", n, "sdpa")
    by_len["bert_noncausal"] = n
    return by_len


def _flash_bwd_library_ms(q, k, v, do, causal, scale):
    """SDPA computes dq, dk and dv in one backward: its time is the graph
    of forward + backward less the forward alone."""
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                              scale=scale)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (ql, kl, vl), do)

    return time_ms(sdpa_fwd_bwd) - time_ms(sdpa_fwd)


def kernel_flash_bwd(gen):
    """#4 / #5 at (8, 16, 1024, 64) bf16: causal with and without dropout,
    and kv_seqlens (non-causal); then at BERT's (16, 16, 512, 64),
    non-causal."""
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dkv_reference, flash_attention_dq,
        flash_attention_dq_reference, flash_fwd)
    scale = HEAD_DIM ** -0.5
    q, k, v = _qkv_views(gen, MICRO, SEQ)
    # dO as autograd hands it back: a (b, h, s, d) view of (b, s, h*d)
    do = torch.randn(MICRO, SEQ, HEADS, HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16).transpose(1, 2)
    lens = torch.tensor([1024, 700, 333, 1, 1024, 512, 64, 999],
                        dtype=torch.int32, device="cuda")
    out = {}
    for tag, causal, rate, seed, kl in (
            ("causal", True, 0.0, None, None),
            ("causal dropout=0.1", True, 0.1, 99, None),
            ("kv_seqlens", False, 0.0, None, lens)):
        o, lse = flash_fwd(q, k, v, causal, scale, kl, rate, seed)
        delta = (do.float() * o.float()).sum(-1).reshape(MICRO * HEADS, SEQ)
        args = (q, k, v, do, lse, delta, causal, scale, kl, rate, seed)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        rdq = flash_attention_dq_reference(*args)
        rdk, rdv = flash_attention_dkv_reference(*args)
        torch.cuda.synchronize()
        name = f"({MICRO},{HEADS},{SEQ},{HEAD_DIM}) {tag}"
        err_q = check_close(f"flash_attention_dq {name}", dq, rdq,
                            BF16_ATOL, BF16_RTOL)
        err_k = check_close(f"flash_attention_dkv {name} dk", dk, rdk,
                            BF16_ATOL, BF16_RTOL)
        err_v = check_close(f"flash_attention_dkv {name} dv", dv, rdv,
                            BF16_ATOL, BF16_RTOL)
        if tag != "causal":
            continue
        lib_bwd = _flash_bwd_library_ms(q, k, v, do, True, scale)
        out["dq"] = numbers(
            err_q, time_ms(lambda: flash_attention_dq(*args)),
            time_ms(lambda: flash_attention_dq_reference(*args)), lib_bwd,
            _flash_bound(MICRO, SEQ, True, 3, 5),
            call_ms(lambda: flash_attention_dq(*args)))
        out["dkv"] = numbers(
            max(err_k, err_v), time_ms(lambda: flash_attention_dkv(*args)),
            time_ms(lambda: flash_attention_dkv_reference(*args)), lib_bwd,
            _flash_bound(MICRO, SEQ, True, 4, 6),
            call_ms(lambda: flash_attention_dkv(*args)))
        log_numbers("flash_attention_dq causal", out["dq"],
                    "sdpa backward (dq+dk+dv)")
        log_numbers("flash_attention_dkv causal", out["dkv"],
                    "sdpa backward (dq+dk+dv)")
    # BERT: (16, 16, 512, 64), no mask
    q, k, v = _qkv_views(gen, BERT_MICRO, BERT_SEQ)
    do = torch.randn(BERT_MICRO, BERT_SEQ, HEADS, HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16).transpose(1, 2)
    o, lse = flash_fwd(q, k, v, False, scale)
    delta = (do.float() * o.float()).sum(-1).reshape(BERT_MICRO * HEADS,
                                                     BERT_SEQ)
    args = (q, k, v, do, lse, delta, False, scale)
    dq = flash_attention_dq(*args)
    dk, dv = flash_attention_dkv(*args)
    rdq = flash_attention_dq_reference(*args)
    rdk, rdv = flash_attention_dkv_reference(*args)
    torch.cuda.synchronize()
    name = f"({BERT_MICRO},{HEADS},{BERT_SEQ},{HEAD_DIM}) non-causal"
    err_q = check_close(f"flash_attention_dq {name}", dq, rdq, BF16_ATOL,
                        BF16_RTOL)
    err_k = check_close(f"flash_attention_dkv {name} dk", dk, rdk, BF16_ATOL,
                        BF16_RTOL)
    err_v = check_close(f"flash_attention_dkv {name} dv", dv, rdv, BF16_ATOL,
                        BF16_RTOL)
    lib_bwd = _flash_bwd_library_ms(q, k, v, do, False, scale)
    out["dq_bert"] = numbers(
        err_q, time_ms(lambda: flash_attention_dq(*args)),
        time_ms(lambda: flash_attention_dq_reference(*args)), lib_bwd,
        _flash_bound(BERT_MICRO, BERT_SEQ, False, 3, 5),
        call_ms(lambda: flash_attention_dq(*args)))
    out["dkv_bert"] = numbers(
        max(err_k, err_v), time_ms(lambda: flash_attention_dkv(*args)),
        time_ms(lambda: flash_attention_dkv_reference(*args)), lib_bwd,
        _flash_bound(BERT_MICRO, BERT_SEQ, False, 4, 6),
        call_ms(lambda: flash_attention_dkv(*args)))
    log_numbers("flash_attention_dq bert non-causal", out["dq_bert"],
                "sdpa backward (dq+dk+dv)")
    log_numbers("flash_attention_dkv bert non-causal", out["dkv_bert"],
                "sdpa backward (dq+dk+dv)")
    return out


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
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    total = int(lens.sum())
    n_bytes = 2 * total * HEADS * HEAD_DIM * 2 + 2 * q.numel() * 2 \
        + lens.numel() * 4
    n = numbers(
        err,
        time_ms([lambda k=k, v=v: flash_attention_decode(q, k, v, lens,
                                                         scale)
                 for k, v in views]),
        time_ms([lambda k=k, v=v: flash_attention_decode_reference(
            q, k, v, lens, scale) for k, v in views]),
        time_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale) for k, v in views]),
        bound_ms(n_bytes, 4 * HEAD_DIM * HEADS * total, PEAK_BF16_FLOPS),
        call_ms(lambda: flash_attention_decode(q, k, v, lens, scale)))
    log_numbers("flash_attention_decode", n, "sdpa + mask")
    del cache, views
    return n

def _lm_head_inputs(gen, n, h, v, x_dtype, w_dtype, masked=False,
                    w_std=0.02):
    """x as a LayerNorm output, W as the N(0, 0.02) tied embedding (or
    N(0, w_std): at 0.1 and H 1024 the scores have a std of 3.2 and the
    softmax is peaked, so p carries most of the gradient), random targets;
    g = 1 per token (so the gradients are O(1e-2) and their check means
    something), 0 at 85% of the rows when ``masked`` (BERT's unmasked
    positions carry a zero cotangent)."""
    x = torch.randn(n, h, generator=gen).to("cuda", x_dtype)
    w = (w_std * torch.randn(v, h, generator=gen)).to("cuda", w_dtype)
    t = torch.randint(0, v, (n,), generator=gen).to("cuda")
    g = torch.ones(n)
    if masked:
        g = (torch.rand(n, generator=gen) < 0.15).float()
    return x, w, t, g.to("cuda")


def _lm_head_library(x, w, t, g):
    """The two-call yardstick (never called by the port): a matmul to
    logits in the operands' dtype, then F.cross_entropy(reduction='none')
    in f32; forward alone, and forward + autograd backward."""
    xl, wl = (a.detach().clone().requires_grad_() for a in (x, w))

    def fwd():
        return F.cross_entropy((xl @ wl.t()).float(), t, reduction="none")

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (xl, wl), g)

    return fwd, fwd_bwd


# The dX and dW kernels against their plain versions, entry by entry:
#   |d| <= ulp |ref| + ulp (|dS near a midpoint| @ |B|) + SUM (|dS| @ |B|)
# where B is the other operand of the product (W for dX, X for dW).
# - Both round the f32 result once: one unit in the last place, 2**-7 |ref|
#   in bf16 (2**-23 in f32).
# - The bf16 kernels round dS to bf16 from their own f32 scores.  A dS entry
#   within 1e-4 (relative, in p) of a bf16 rounding midpoint may round to
#   the neighbouring value on one side, moving the result by one ulp of
#   that dS times B; the scores of the two sides differ by ~1e-5, so 1e-4
#   is a wide margin.  f32 and mixed pairs do not round dS.
# - Both sum the same terms in f32 in other orders (the tensor cores'
#   accumulation truncates): the sums differ by ~sqrt(K) 2**-23 of the
#   terms' magnitude sum (2.7e-5 at K = 50304); allowed 2.5e-4 of it.
# A wrong softmax term (p dropped or halved, or the lse of another row)
# moves entries by ~4e-4 |x| in dX, many times this bound at the GPT-350M
# and BERT-large shapes and in the peaked case.
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
       torch.float32: 2.0 ** -23}
MIDPOINT = 1e-4
SUM_ORDER = 2.5e-4


def _lm_head_grad_bounds(x, w, t, lse, g, rounds_ds):
    """Per entry of dX and of dW, the bound above less its ulp |ref| term:
    (dx_slack, dw_slack), f32, computed on the card from the plain
    version's f32 scores."""
    s = x.float() @ w.float().t()
    p = torch.exp(s - lse[:, None])
    del s
    hit = (torch.arange(w.shape[0], device=x.device)[None, :]
           == t[:, None]).float()
    gcol = g[:, None].float()
    ds = ((p - hit) * gcol).abs()
    sx = SUM_ORDER * (ds @ w.float().abs())
    sw = SUM_ORDER * (ds.t() @ x.float().abs())
    if rounds_ds:
        hi = ((p * (1 + MIDPOINT) - hit) * gcol).bfloat16()
        lo = ((p * (1 - MIDPOINT) - hit) * gcol).bfloat16()
        del p, hit
        ulp = ULP[torch.bfloat16]
        near = torch.where(hi != lo, ds, 0.0)
        del hi, lo, ds
        sx += ulp * (near @ w.float().abs())
        sw += ulp * (near.t() @ x.float().abs())
    return sx, sw


def check_entrywise(name, got, ref, slack, rows=None):
    """One output against its plain version entry by entry: |d| <= ulp
    |ref| + slack (the LM head's rule above, the FFN's below); ``rows`` (a
    bool mask) also reports those rows on their own.  Returns the max abs
    error."""
    if got.dtype != ref.dtype:
        raise AssertionError(f"{name}: dtype {got.dtype}, want {ref.dtype}")
    ulp = ULP[ref.dtype]
    ref32 = ref.float()
    d = (got.float() - ref32).abs()
    lim = ulp * ref32.abs() + slack
    ratio = torch.where(d > 0, d / lim, 0.0)   # d > 0 = lim: inf
    parts = [("", ratio, d, ref32)]
    if rows is not None:
        parts.append((f", the {int(rows.sum())} rows with no target",
                      ratio[rows], d[rows], ref32[rows]))
    for tag, r, dd, rr in parts:
        worst = float(r.max())
        share = float(dd.max() / rr.abs().max().clamp_min(1e-30))
        log(f"  {name}{tag}: max_abs_err={float(dd.max()):.3e} (max |d| / "
            f"max |ref| {share:.3e}; |d| <= {ulp:.3g} |ref| + slack, largest "
            f"share of it {worst:.3f}) {'ok' if worst <= 1 else 'FAIL'}")
        if not worst <= 1:
            raise AssertionError(f"{name}{tag} disagrees with its plain "
                                 f"version")
    return float(d.max())


def _no_target_rows(v, t, g):
    """dW's rows that no token with g != 0 targets: they hold only the
    softmax term sum_i g_i p_iv x_i."""
    free = torch.ones(v, dtype=torch.bool, device=t.device)
    free[t[(g != 0) & (t >= 0)]] = False
    return free


def kernel_lm_head(gen):
    """#8, #9 and #10 against their plain versions: bf16 at GPT-350M's head
    (8192 x 1024 x 50304) and BERT-large's (8192 x 1024 x 30528, 85% of
    rows with g = 0), both timed; f32 at GPT-350M's head, timed (the f32
    instantiation an f32 model runs); bf16 with a peaked softmax off the
    token and vocab grids (1000 x 1024 x 30522); small off-grid cases
    (200 x 96 x 1000: bf16, f32, bf16 x with f32 W).  The off-grid cases
    carry a target of -1.  loss and lse within f32 tolerances, dX and dW
    entry by entry (``_check_lm_head_grad``), dW's rows with no target also
    reported on their own."""
    from apex_tpu_torch.ops.lm_head import (
        lm_head_dw, lm_head_dw_reference, lm_head_dx, lm_head_dx_reference,
        lm_head_fwd, lm_head_fwd_reference)
    out = {}
    bf, f32 = torch.bfloat16, torch.float32
    vg, vb = GPT350M["vocab_size"], BERT_LARGE["vocab_size"]
    # tag, n, h, v, x dtype, w dtype, masked, w std, timed
    cases = [("gpt", TRAIN_ROWS, HIDDEN, vg, bf, bf, False, 0.02, True),
             ("bert", BERT_ROWS, HIDDEN, vb, bf, bf, True, 0.02, True),
             ("gpt f32", TRAIN_ROWS, HIDDEN, vg, f32, f32, False, 0.02, True),
             ("peaked", 1000, HIDDEN, 30522, bf, bf, False, 0.1, False),
             ("small bf16", 200, 96, 1000, bf, bf, True, 0.02, False),
             ("small f32", 200, 96, 1000, f32, f32, True, 0.02, False),
             ("small bf16 x f32 w", 200, 96, 1000, bf, f32, True, 0.02,
              False)]
    for tag, n, h, v, xdt, wdt, masked, w_std, timed in cases:
        x, w, t, g = _lm_head_inputs(gen, n, h, v, xdt, wdt, masked, w_std)
        off_grid = not timed
        if off_grid:
            t[3] = -1                        # matches no column: loss = lse
        before = lm_head_fwd.launches
        loss, lse = lm_head_fwd(x, w, t)
        if lm_head_fwd.launches - before != 2:
            raise AssertionError("lm_head_fwd: expected 2 launches per call")
        rloss, rlse = lm_head_fwd_reference(x, w, t)
        dx = lm_head_dx(x, w, t, lse, g)
        dw = lm_head_dw(x, w, t, lse, g)
        rdx = lm_head_dx_reference(x, w, t, lse, g)
        rdw = lm_head_dw_reference(x, w, t, lse, g)
        torch.cuda.synchronize()
        name = f"lm_head {tag} ({n}x{h}x{v})"
        # f32 scores summed in another order over H, then a logsumexp over
        # V in another order
        err_f = max(check_close(f"{name} loss", loss, rloss, 1e-4, 1e-5),
                    check_close(f"{name} lse", lse, rlse, 1e-4, 1e-5))
        # the kernels round dS to bf16 for a bf16 pair only
        slx, slw = _lm_head_grad_bounds(x, w, t, lse, g, xdt == wdt == bf)
        errs = dict(dx=check_entrywise(f"{name} dx", dx, rdx, slx),
                    dw=check_entrywise(f"{name} dw", dw, rdw, slw,
                                           _no_target_rows(v, t, g)))
        del slx, slw
        if off_grid:
            if float(loss[3]) != float(lse[3]):
                raise AssertionError(f"{name}: target -1 must give loss "
                                     f"= lse")
            continue
        ops = 2 * n * v * h
        isz = x.element_size()
        io = n * h * isz + v * h * w.element_size() + n * 8
        peak = PEAK_BF16_FLOPS if xdt == bf else PEAK_F32_FLOPS
        f32_case = xdt == f32            # slow: fewer calls per sample
        reps, rounds = (3, 3) if f32_case else (20, 5)
        lib_fwd, lib_bwd = _lm_head_library(x, w, t, g)
        t_fwd = time_ms([lib_fwd] * reps, rounds)
        lib_grad = time_ms([lib_bwd] * reps, rounds) - t_fwd
        plain = dict(fwd=lambda: lm_head_fwd_reference(x, w, t),
                     dx=lambda: lm_head_dx_reference(x, w, t, lse, g),
                     dw=lambda: lm_head_dw_reference(x, w, t, lse, g))
        kern = dict(fwd=lambda: lm_head_fwd(x, w, t),
                    dx=lambda: lm_head_dx(x, w, t, lse, g),
                    dw=lambda: lm_head_dw(x, w, t, lse, g))
        io_part = dict(fwd=io + n * 8, dx=io + n * 8 + n * h * isz,
                       dw=io + n * 8 + v * h * w.element_size())
        for part, work in (("fwd", ops), ("dx", 2 * ops), ("dw", 2 * ops)):
            key = f"{part}_{tag.replace(' ', '_')}"
            out[key] = numbers(
                err_f if part == "fwd" else errs[part],
                time_ms([kern[part]] * reps, rounds),
                time_ms([plain[part]] * 3, rounds=3),
                t_fwd if part == "fwd" else lib_grad,
                bound_ms(io_part[part], work, peak),
                call_ms(kern[part], iters=5 if f32_case else 50))
            log_numbers(f"lm_head_{part} {tag}", out[key],
                        "matmul + F.cross_entropy (two calls; "
                        + ("forward)" if part == "fwd"
                           else "backward, dX and dW together)"))
        del x, w, t, g, rloss, rlse, rdx, rdw, lib_fwd, lib_bwd, plain, kern
        torch.cuda.empty_cache()
    return out


# The fused FFN's outputs against their plain versions, entry by entry:
#   |d| <= ulp |ref| + SUM_ORDER (|A| @ |B|) + R
# for an output that is the product A B (A = h for y, dz for dX and dW1,
# gelu(z1) for dW2: the terms' magnitude sum gives the summation-order
# slack, as for the LM head).  R covers the one intermediate each kernel
# makes from f32 sums of its own and rounds to the activation dtype: the
# forward's h = gelu(x W1^T + b1) and the backward's dz = (dy W2) gelu'(z1).
# An entry within MIDPOINT (relative) of a rounding midpoint may round to
# the neighbouring value on one side, moving the output by one ulp of that
# entry times the other operand: R = (ulp |near entries|) @ |B|.  In f32
# nothing is rounded and the intermediate's own sum-order difference
# (within MIDPOINT of it) carries through: R = MIDPOINT |A| @ |B|.  Both
# sides read the same z1, so gelu(z1) and gelu'(z1) differ only in the f32
# tanh's last bits (within MIDPOINT).  z1 = x W1^T + b1 takes the SUM_ORDER
# term alone; db1 (f32 sums of the unrounded dz) takes (SUM_ORDER +
# MIDPOINT) of the sum of |dz|.  Wrong GELU' terms, dW2 taken from z
# instead of gelu(z) and a dropped b1 fail this rule by large factors
# (tests/test_torch_fused_ffn.py, on an emulation of the kernels).

def ffn_bounds(x, w1, b1, w2, dy, z1):
    """Per entry of each output, the slack of the rule above:
    ``{"z1", "y", "dx", "dw1", "db1", "dw2"}``, f32, from the plain
    version's own f32 intermediates on the inputs' device."""
    from apex_tpu_torch.ops.fused_ffn import _gelu, _gelu_grad
    dt = x.dtype
    xf, dyf = x.float(), dy.float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    ax, adj, aw1, aw2 = xf.abs(), dyf.abs(), w1f.abs(), w2f.abs()

    def carry(v):
        if dt == torch.float32:
            return MIDPOINT * v.abs()
        hi, lo = (v * (1 + MIDPOINT)).to(dt), (v * (1 - MIDPOINT)).to(dt)
        return torch.where(hi != lo, ULP[dt] * v.abs(), 0.0)

    out = dict(z1=SUM_ORDER * (ax @ aw1.t()))
    h = _gelu(xf @ w1f.t() + b1.float())
    out["y"] = (SUM_ORDER * h.abs() + carry(h)) @ aw2.t()
    del h
    z = z1.float()
    dz = (dyf @ w2f) * _gelu_grad(z)
    a = SUM_ORDER * dz.abs() + carry(dz)
    out["dx"] = a @ aw1
    out["dw1"] = a.t() @ ax
    out["db1"] = (SUM_ORDER + MIDPOINT) * dz.abs().sum(0)
    del a, dz
    h1 = _gelu(z)
    out["dw2"] = adj.t() @ (SUM_ORDER * h1.abs() + carry(h1))
    return out


def _ffn_inputs(gen, m, k, f, n, x_dtype, w_dtype):
    """x as a LayerNorm output, W1 and W2 N(0, 0.02) as the models draw
    them, b1 and b2 N(0, 0.1) (the models start them at 0: a random bias
    is what a check can see), dy N(0, 1)."""
    x = torch.randn(m, k, generator=gen).to("cuda", x_dtype)
    w1 = (0.02 * torch.randn(f, k, generator=gen)).to("cuda", w_dtype)
    b1 = (0.1 * torch.randn(f, generator=gen)).to("cuda", w_dtype)
    w2 = (0.02 * torch.randn(n, f, generator=gen)).to("cuda", w_dtype)
    b2 = (0.1 * torch.randn(n, generator=gen)).to("cuda", w_dtype)
    dy = torch.randn(m, n, generator=gen).to("cuda", x_dtype)
    return x, w1, b1, w2, b2, dy


def _ffn_library(x, w1, b1, w2, b2, dy):
    """The unfused cuBLAS chain (the yardstick; the port never calls it):
    F.linear, F.gelu(approximate="tanh"), F.linear on operands cast to the
    activation dtype beforehand; forward alone, and forward + autograd
    backward (dX, dW1, db1, dW2, db2 together)."""
    leaves = [a.detach().to(x.dtype).clone().requires_grad_()
              for a in (x, w1, b1, w2, b2) if a is not None]

    def fwd():
        h = F.gelu(F.linear(leaves[0], leaves[1], leaves[2]),
                   approximate="tanh")
        return F.linear(h, *leaves[3:])

    def fwd_bwd():
        return torch.autograd.grad(fwd(), leaves, dy)

    return fwd, fwd_bwd


def kernel_fused_ffn(gen):
    """#11, #12 and #13 against their plain versions, entry by entry
    (``ffn_bounds``), and timed: bf16 x with f32 W at GPT-350M's
    micro-batch (8192 x 1024 -> 4096 -> 1024), bf16/bf16 at BERT-large's
    (the same shape, O2), at the serving shapes (prefill 512 rows; decode 8
    rows, timed over 24 weight sets so that W comes from device memory as
    on the path), GPT-2 XL's widths off the grids (1000 x 1600 -> 6400 ->
    1600, bf16), GPT-350M's shape in f32 (the FMA instantiation); small
    off-grid cases (200 x 96 -> 320 -> 80: f32, bf16, bf16 x f32 W, f16)
    and one off the 16-byte loads (77 x 100 -> 200 -> 36, bf16, no b2).
    The backward kernels read the forward kernel's z1 on both sides."""
    from apex_tpu_torch.ops.fused_ffn import (
        ffn_dw, ffn_dw_reference, ffn_dx, ffn_dx_reference, ffn_fwd,
        ffn_fwd_reference)
    out = {}
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    k, f, n = HIDDEN, GPT350M["ffn_hidden_size"], HIDDEN
    # tag, m, k, f, n, x dtype, w dtype, timed
    cases = [("gpt", TRAIN_ROWS, k, f, n, bf, f32, True),
             ("bert", BERT_ROWS, k, f, n, bf, bf, True),
             ("prefill", 512, k, f, n, bf, f32, True),
             ("decode", SLOTS, k, f, n, bf, f32, True),
             ("gpt2-xl", 1000, 1600, 6400, 1600, bf, bf, True),
             ("gpt f32", TRAIN_ROWS, k, f, n, f32, f32, True),
             ("small f32", 200, 96, 320, 80, f32, f32, False),
             ("small bf16", 200, 96, 320, 80, bf, bf, False),
             ("small bf16 x f32 w", 200, 96, 320, 80, bf, f32, False),
             ("small f16", 200, 96, 320, 80, f16, f16, False),
             ("unaligned bf16", 77, 100, 200, 36, bf, bf, False)]
    for tag, m, k, f, n, xdt, wdt, timed in cases:
        x, w1, b1, w2, b2, dy = _ffn_inputs(gen, m, k, f, n, xdt, wdt)
        if tag.startswith("unaligned"):
            b2 = None
        before = ffn_fwd.launches
        y, z1 = ffn_fwd(x, w1, b1, w2, b2)
        if ffn_fwd.launches - before != 2:
            raise AssertionError("ffn_fwd: expected 2 launches per call")
        ry, rz1 = ffn_fwd_reference(x, w1, b1, w2, b2)
        dx = ffn_dx(dy, z1, w1, w2)
        dw1, db1, dw2 = ffn_dw(x, dy, z1, w1, w2)
        rdx = ffn_dx_reference(dy, z1, w1, w2)
        rdw1, rdb1, rdw2 = ffn_dw_reference(x, dy, z1, w1, w2)
        torch.cuda.synchronize()
        name = f"fused_ffn {tag} ({m}x{k}->{f}->{n})"
        slack = ffn_bounds(x, w1, b1, w2, dy, z1)
        errs = {part: check_entrywise(f"{name} {part}", got, ref,
                                      slack[part])
                for part, got, ref in (("z1", z1, rz1), ("y", y, ry),
                                       ("dx", dx, rdx), ("dw1", dw1, rdw1),
                                       ("db1", db1, rdb1),
                                       ("dw2", dw2, rdw2))}
        del slack, ry, rz1, rdx, rdw1, rdb1, rdw2, dx, dw1, db1, dw2
        if not timed:
            continue
        isz, wsz = x.element_size(), w1.element_size()
        w_bytes = (f * k + n * f) * wsz
        io = dict(fwd=m * k * isz + w_bytes + (f + n) * wsz
                  + (m * n + m * f) * isz,
                  dx=(m * n + m * f + m * k) * isz + w_bytes,
                  dw=(m * k + m * n + m * f) * isz + n * f * wsz + w_bytes
                  + f * 4)
        work = dict(fwd=2 * m * f * (k + n), dx=2 * m * f * (n + k),
                    dw=2 * m * f * (2 * n + k))
        peak = PEAK_BF16_FLOPS if xdt == bf else PEAK_F32_FLOPS
        f32_case = xdt == f32
        reps, rounds = (3, 3) if f32_case else (20, 5)
        sets = [(w1, b1, w2, b2)]
        if tag == "decode":              # one weight set per layer
            sets += [tuple((0.02 * torch.randn(a.shape, device="cuda")).to(
                wdt) for a in (w1, b1, w2, b2)) for _ in range(23)]
            reps = len(sets)

        def cycle(fn):
            return [lambda s=s: fn(*s) for s in sets] * (reps // len(sets))
        lib = [_ffn_library(x, *s, dy) for s in sets]
        t_fwd = time_ms([lf for lf, _ in lib] * (reps // len(sets)), rounds)
        t_bwd = time_ms([lb for _, lb in lib] * (reps // len(sets)),
                        rounds) - t_fwd
        kern = dict(
            fwd=cycle(lambda a, b, c, d: ffn_fwd(x, a, b, c, d)),
            dx=cycle(lambda a, b, c, d: ffn_dx(dy, z1, a, c)),
            dw=cycle(lambda a, b, c, d: ffn_dw(x, dy, z1, a, c)))
        plain = dict(
            fwd=cycle(lambda a, b, c, d: ffn_fwd_reference(x, a, b, c, d)),
            dx=cycle(lambda a, b, c, d: ffn_dx_reference(dy, z1, a, c)),
            dw=cycle(lambda a, b, c, d: ffn_dw_reference(x, dy, z1, a, c)))
        err = dict(fwd=max(errs["y"], errs["z1"]), dx=errs["dx"],
                   dw=max(errs["dw1"], errs["db1"], errs["dw2"]))
        for part in ("fwd", "dx", "dw"):
            key = f"{part}_{tag.replace(' ', '_')}"
            out[key] = numbers(
                err[part], time_ms(kern[part], rounds),
                time_ms(plain[part][:3], rounds=3),
                t_fwd if part == "fwd" else t_bwd,
                bound_ms(io[part], work[part], peak),
                call_ms(kern[part][0], iters=5 if f32_case else 50))
            log_numbers(f"ffn_{part} {tag}", out[key],
                        "unfused F.linear + gelu + F.linear chain ("
                        + ("forward)" if part == "fwd" else
                           "backward: dX, dW1, db1, dW2, db2 together)"))
        del x, w1, b1, w2, b2, dy, y, z1, sets, lib, kern, plain
        torch.cuda.empty_cache()
    return out


def table_launches(numels, max_tensors=36, max_blocks=320, chunk=65536):
    """Launches of a multi-tensor kernel (csrc/multi_tensor.cuh) over
    tensors of these sizes: a table launches when its 320 blocks or 36
    tensors are full, carrying a tensor whose chunks are not all
    issued."""
    launches = nt = nb = 0
    for n in numels:
        if n <= 0:
            continue
        nt += 1
        chunks = -(-n // chunk)
        for c in range(chunks):
            nb += 1
            done = c == chunks - 1
            if nb == max_blocks or (nt == max_tensors and done):
                launches += 1
                nb = 0
                nt = 0 if done else 1
    return launches + (nb > 0)


def sumsq_launches(numels, per_tensor=False):
    """Launches of multi_tensor_sumsq: the table's first pass, then the
    fixed-order sums of its partials (csrc/multi_tensor_l2norm.cu), one
    launch per 480 tensors with per-tensor sums, else one."""
    return table_launches(numels) + (-(-len(numels) // 480) if per_tensor
                                     else 1)


def kernel_adam(gen_cuda):
    """#18 over the GPT-350M parameter list (291 f32 tensors), noop 0 and
    1, against its plain version on copies of the same tensors."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.ops.multi_tensor import (multi_tensor_adam,
                                                 multi_tensor_adam_reference)
    shapes = [p.shape for p in GPTModel(GPTConfig(**GPT350M),
                                        device="meta").parameters()]
    numels = [int(np.prod(s)) for s in shapes]

    def rand(shape, std, positive=False):
        t = torch.randn(shape, generator=gen_cuda, device="cuda") * std
        return t.abs() if positive else t

    # mixed dtypes (bf16 / f16 / f32 params and grads) over 40 tensors, so
    # the 36-tensor table limit and chunk carry-over are crossed too: the
    # params round once from the same f32 value, so one ulp of their dtype
    mixed = [(n, pdt, gdt) for n, pdt, gdt in zip(
        [70000, 65536, 1, 3, 200000, 129] * 7, [torch.bfloat16, torch.float16,
                                                 torch.float32] * 14,
        [torch.bfloat16, torch.float16, torch.bfloat16, torch.float32] * 10)]
    mg = [rand(n, 1e-3).to(gdt) for n, _, gdt in mixed]
    mp = [rand(n, 0.02).to(pdt) for n, pdt, _ in mixed]
    step1 = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.01, 0.1, 0.001, 0.5],
                         dtype=torch.float32, device="cuda")
    outs = []
    for fn in (multi_tensor_adam, multi_tensor_adam_reference):
        p = [t.clone() for t in mp]
        m = [torch.zeros(t.shape, device="cuda") for t in mp]
        v = [torch.zeros(t.shape, device="cuda") for t in mp]
        fn(mg, p, m, v, step1)
        outs.append((p, m, v))
    torch.cuda.synchronize()
    # relative ulp, and the absolute spacing of f16 subnormals
    ulp = {torch.bfloat16: (2 ** -7, 1e-9),
           torch.float16: (2 ** -10, 2 ** -24),
           torch.float32: (1e-6, 1e-9)}
    for (kp, km, kv), (rp, rm, rv), (_, pdt, _) in zip(
            zip(*outs[0]), zip(*outs[1]), mixed):
        rtol, atol = ulp[pdt]
        if not (torch.allclose(kp.float(), rp.float(), rtol=rtol, atol=atol)
                and torch.allclose(km, rm, rtol=1e-6, atol=1e-12)
                and torch.allclose(kv, rv, rtol=1e-6, atol=1e-15)):
            raise AssertionError(f"multi_tensor_adam disagrees with its plain "
                                 f"version on a {pdt} parameter")
    err_p = max(max_err(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    log(f"  multi_tensor_adam {len(mixed)} mixed bf16/f16/f32 tensors: "
        f"max_abs_err p {err_p:.3e} (tolerance one ulp of the param dtype) "
        f"ok")
    del mg, mp, outs

    gs = [rand(s, 1e-3) for s in shapes]
    ps = [rand(s, 0.02) for s in shapes]
    ms = [rand(s, 1e-4) for s in shapes]
    vs = [rand(s, 1e-6, positive=True) for s in shapes]
    # step 3 of AdamW(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, wd=0.01)
    scal = torch.tensor([LR, 0.9, 0.999, 1e-8, 0.01, 1 - 0.9 ** 3,
                         1 - 0.999 ** 3, 1.0], dtype=torch.float32,
                        device="cuda")
    err = 0.0
    for noop_v in (0, 1):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        kp, km, kv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
        rp, rm, rv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
        before = multi_tensor_adam.launches
        multi_tensor_adam(gs, kp, km, kv, scal, noop)
        n_launch = multi_tensor_adam.launches - before
        multi_tensor_adam_reference(gs, rp, rm, rv, scal, noop)
        torch.cuda.synchronize()
        if n_launch != table_launches(numels):
            raise AssertionError(f"multi_tensor_adam made {n_launch} "
                                 f"launches, the table rule says "
                                 f"{table_launches(numels)}")
        for name, a, b in (("p", kp, rp), ("m", km, rm), ("v", kv, rv)):
            # f32 on both sides; FMA contraction on the card moves the
            # last bits: 1e-6 relative
            err = max(err, _check_lists(f"multi_tensor_adam noop={noop_v} "
                                        f"{name}", a, b, 1e-6, 1e-9))
        if noop_v and not all(torch.equal(x, y) for x, y in zip(kp, ps)):
            raise AssertionError("multi_tensor_adam noop=1 changed params")
        del kp, km, kv, rp, rm, rv
    noop = torch.tensor(0, dtype=torch.int32, device="cuda")
    lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(lib_ps, gs):
        p.grad = g
    lib_opt = torch.optim.AdamW(lib_ps, lr=LR, weight_decay=0.01, fused=True)
    n_el = sum(numels)
    n = numbers(
        err, time_ms([lambda: multi_tensor_adam(gs, ps, ms, vs, scal, noop)]
                     * 5),
        time_ms([lambda: multi_tensor_adam_reference(gs, ps, ms, vs, scal,
                                                     noop)] * 2, rounds=3),
        call_ms(lib_opt.step, iters=10),
        bound_ms(7 * 4 * n_el, 15 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: multi_tensor_adam(gs, ps, ms, vs, scal, noop),
                iters=10))
    log_numbers(f"multi_tensor_adam {len(shapes)} tensors, {n_el} elements, "
                f"{table_launches(numels)} launches", n,
                "AdamW(fused=True).step (eager)")
    n["tensors"], n["elements"] = len(shapes), n_el
    n["launches_per_step"] = table_launches(numels)
    return n


def bert_param_specs():
    """(shape, dtype) of BERT-large's 299 parameters under amp O2: bf16,
    the LayerNorms f32."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.bert import BertConfig, BertModel
    model = BertModel(BertConfig(**BERT_LARGE), device="meta")
    amp.initialize(model, None, opt_level="O2")
    return [(tuple(p.shape), p.dtype) for p in model.parameters()]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _check_lists(name, got, ref, rtol, atol, scale_rtol=0.0):
    """Every pair within |d| <= atol + rtol*|ref| + scale_rtol*max|ref|
    (the largest entry of that tensor); returns the max error."""
    pairs = [(a, b) for a, b in zip(got, ref) if a is not None]
    err = max(max_err(a, b) for a, b in pairs)
    ok = all(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol + (
        scale_rtol * float(b.float().abs().max()) if scale_rtol else 0.0))
        for a, b in pairs)
    scale = f" + {scale_rtol}*max|ref|" if scale_rtol else ""
    log(f"  {name}: max_abs_err={err:.3e} (tolerance |d| <= {atol} + "
        f"{rtol}*|ref|{scale}) {'ok' if ok else 'FAIL'}")
    if not ok:
        i, (a, b) = max(enumerate(pairs), key=lambda ip: max_err(*ip[1]))
        j = int((a.float() - b.float()).abs().argmax())
        log(f"    worst: tensor {i} {tuple(b.shape)} element {j}: got "
            f"{float(a.flatten()[j])!r}, plain {float(b.flatten()[j])!r}")
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def _check_found_inf(name, kernel_fn, plain_fn, tensors):
    """The found-inf flag of kernel and plain version, clean and with one
    inf in the middle of the list."""
    t = tensors[len(tensors) // 2].view(-1)
    saved = t[7].clone()
    flags = []
    for bad in (False, True):
        if bad:
            t[7] = float("inf")
        flags.append((float(kernel_fn()), float(plain_fn())))
    t[7] = saved
    log(f"  {name} found_inf clean / with an inf: kernel "
        f"{[f[0] for f in flags]}, plain {[f[1] for f in flags]}")
    if flags != [(0.0, 0.0), (1.0, 1.0)]:
        raise AssertionError(f"{name}: wrong found-inf flag")


def kernel_multi_tensor_lamb(gen_cuda):
    """#17, #15, #20 and #21 over BERT-large's O2 tensor list (299
    tensors: bf16 gradients for bf16 parameters, f32 for the LayerNorms;
    f32 masters and moments), each against its plain version."""
    from apex_tpu_torch.ops import multi_tensor as K
    specs = bert_param_specs()
    numels = [int(np.prod(s)) for s, _ in specs]
    n_el, launches = sum(numels), table_launches(numels)

    def rand(shape, std, positive=False):
        t = torch.randn(shape, generator=gen_cuda, device="cuda") * std
        return t.abs() if positive else t

    grads = [rand(s, 1e-3).to(dt) for s, dt in specs]
    # f32 masters hold bf16 values at the start, as amp O2 makes them
    masters = [rand(s, 0.02).to(dt).float() for s, dt in specs]
    copies = [None if dt == torch.float32 else torch.empty(s, dtype=dt,
                                                           device="cuda")
              for s, dt in specs]
    out = {}

    # #17: sums of squares, global and per tensor
    total, per, _ = K.multi_tensor_sumsq(grads, per_tensor=True)
    rtotal, rper, _ = K.multi_tensor_sumsq_reference(grads, per_tensor=True)
    torch.cuda.synchronize()
    # f32 sums of 335M squares in other orders (chunk partials, then a
    # fixed tree): 1e-5 relative
    err = check_close("multi_tensor_sumsq total", total, rtotal, 0, 1e-5)
    check_close("multi_tensor_sumsq per tensor", per, rper, 0, 1e-5)
    _check_found_inf("multi_tensor_sumsq",
                     lambda: K.multi_tensor_sumsq(grads)[2],
                     lambda: K.multi_tensor_sumsq_reference(grads)[2],
                     grads)
    before = K.multi_tensor_sumsq.launches
    K.multi_tensor_sumsq(grads)
    if K.multi_tensor_sumsq.launches - before != sumsq_launches(numels):
        raise AssertionError("multi_tensor_sumsq launch count")
    g_bytes = _nbytes(grads)
    out["sumsq"] = numbers(
        err, time_ms([lambda: K.multi_tensor_sumsq(grads)] * 5),
        time_ms([lambda: K.multi_tensor_sumsq_reference(grads)] * 2,
                rounds=3),
        time_ms([lambda: torch._foreach_norm(grads)] * 5),
        bound_ms(g_bytes, 2 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_sumsq(grads), iters=10))
    log_numbers(f"multi_tensor_sumsq {len(specs)} tensors, {n_el} "
                f"elements, {sumsq_launches(numels)} launches", out["sumsq"],
                "torch._foreach_norm")

    # #15: out = x * s into the gradients' dtypes (the unscale)
    scale = torch.full((), 2.0 ** -10, device="cuda")
    kout = [torch.empty_like(g) for g in grads]
    rout = [torch.empty_like(g) for g in grads]
    K.multi_tensor_scale_(grads, kout, scale)
    K.multi_tensor_scale_reference(grads, rout, scale)
    torch.cuda.synchronize()
    # the same f32 product rounded once: one ulp of bf16 at most
    err = _check_lists("multi_tensor_scale_ bf16/f32 outputs", kout, rout,
                       2.0 ** -8, 0.0)
    _check_found_inf("multi_tensor_scale_",
                     lambda: K.multi_tensor_scale_(grads, kout, scale),
                     lambda: K.multi_tensor_scale_reference(grads, rout,
                                                            scale), grads)
    out["scale"] = numbers(
        err, time_ms([lambda: K.multi_tensor_scale_(grads, kout, scale)] * 5),
        time_ms([lambda: K.multi_tensor_scale_reference(grads, rout, scale)]
                * 2, rounds=3),
        time_ms([lambda: torch._foreach_mul(grads, scale)] * 5),
        bound_ms(2 * g_bytes, n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_scale_(grads, kout, scale), iters=10))
    log_numbers(f"multi_tensor_scale_ {len(specs)} tensors", out["scale"],
                "torch._foreach_mul")
    del kout, rout

    # #20: stage 1 at step 3, clip 0.5, noop 0 and 1
    b1, b2 = LAMB_BETAS
    scal = torch.tensor([b1, b2, 1e-6, LAMB_WD, 1 - b1 ** 3, 1 - b2 ** 3,
                         1.0, 0.5, 1 - b1], dtype=torch.float32,
                        device="cuda")
    ms = [rand(s, 1e-4) for s, _ in specs]
    vs = [rand(s, 1e-8, positive=True) for s, _ in specs]
    err = 0.0
    for noop_v in (1, 0):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        km, kv, rm, rv = ([t.clone() for t in ts] for ts in (ms, vs, ms, vs))
        ku = [torch.empty_like(t) for t in masters]
        ru = [torch.empty_like(t) for t in masters]
        before = K.multi_tensor_lamb_stage1.launches
        kusq, kpsq = K.multi_tensor_lamb_stage1(grads, masters, km, kv, ku,
                                                scal, noop)
        n_launch = K.multi_tensor_lamb_stage1.launches - before
        rusq, rpsq = K.multi_tensor_lamb_stage1_reference(
            grads, masters, rm, rv, ru, scal, noop)
        torch.cuda.synchronize()
        if n_launch != launches:
            raise AssertionError(f"multi_tensor_lamb_stage1 made {n_launch} "
                                 f"launches, the table rule says {launches}")
        tag = f"multi_tensor_lamb_stage1 noop={noop_v}"
        # f32 on both sides; FMA contraction on the card rounds
        # b1*m + b3*g once where the plain version rounds twice, which
        # moves an entry where the two terms cancel by an ulp of the terms
        # (not of the result), and u divides it by sqrt(v): 1e-6 of each
        # tensor's largest entry; the chunk partials sum 64K terms in
        # another order (1e-5 relative)
        for name, a, b in (("u", ku, ru), ("m", km, rm), ("v", kv, rv)):
            err = max(err, _check_lists(f"{tag} {name}", a, b, 1e-6, 0.0,
                                        scale_rtol=1e-6))
        check_close(f"{tag} chunk sums of u^2", kusq, rusq, 1e-30, 1e-5)
        check_close(f"{tag} chunk sums of p^2", kpsq, rpsq, 1e-30, 1e-5)
        if noop_v and not (all(torch.equal(a, b) for a, b in zip(km, ms))
                           and all(torch.equal(a, b) for a, b in zip(kv, vs))
                           and not any(bool(u.any()) for u in ku)):
            raise AssertionError("multi_tensor_lamb_stage1 noop=1 changed "
                                 "the moments or wrote a nonzero u")
        del rm, rv, ru
    s1_bytes = _nbytes(grads) + 6 * 4 * n_el
    out["stage1"] = numbers(
        err, time_ms([lambda: K.multi_tensor_lamb_stage1(
            grads, masters, km, kv, ku, scal, noop)] * 5),
        time_ms([lambda: K.multi_tensor_lamb_stage1_reference(
            grads, masters, km, kv, ku, scal, noop)], rounds=3),
        None, bound_ms(s1_bytes, 20 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_lamb_stage1(
            grads, masters, km, kv, ku, scal, noop), iters=10))
    log_numbers(f"multi_tensor_lamb_stage1 {len(specs)} tensors",
                out["stage1"], "no library call")
    del km, kv

    # #21: stage 2 on stage 1's u and partials, masters and bf16 copies
    lr = torch.full((), BERT_LR, device="cuda")
    err = 0.0
    for noop_v in (1, 0):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        kp, rp = [t.clone() for t in masters], [t.clone() for t in masters]
        kc = [None if c is None else torch.zeros_like(c) for c in copies]
        rc = [None if c is None else torch.zeros_like(c) for c in copies]
        before = K.multi_tensor_lamb_stage2.launches
        K.multi_tensor_lamb_stage2(ku, kp, kc, kusq, kpsq, lr, noop)
        n_launch = K.multi_tensor_lamb_stage2.launches - before
        K.multi_tensor_lamb_stage2_reference(ku, rp, rc, kusq, kpsq, lr,
                                             noop)
        torch.cuda.synchronize()
        if n_launch != launches:
            raise AssertionError(f"multi_tensor_lamb_stage2 made {n_launch} "
                                 f"launches, the table rule says {launches}")
        tag = f"multi_tensor_lamb_stage2 noop={noop_v}"
        err = max(err, _check_lists(f"{tag} masters", kp, rp, 1e-6, 0.0,
                                    scale_rtol=1e-6))
        # the model copy is the new master rounded to nearest even, on both
        # sides (under noop: unchanged)
        for side, ps, cs in (("kernel", kp, kc), ("plain", rp, rc)):
            want = [None if c is None else (torch.zeros_like(c) if noop_v
                                            else p.to(c.dtype))
                    for p, c in zip(ps, cs)]
            _check_lists(f"{tag} {side} bf16 copies vs its masters", cs, want,
                         0.0, 0.0)
        if noop_v and not all(torch.equal(a, b) for a, b in zip(kp, masters)):
            raise AssertionError("multi_tensor_lamb_stage2 noop=1 changed "
                                 "the parameters")
        del rp, rc
    s2_bytes = 3 * 4 * n_el + _nbytes(kc)
    out["stage2"] = numbers(
        err, time_ms([lambda: K.multi_tensor_lamb_stage2(
            ku, kp, kc, kusq, kpsq, lr, noop)] * 5),
        time_ms([lambda: K.multi_tensor_lamb_stage2_reference(
            ku, kp, kc, kusq, kpsq, lr, noop)] * 2, rounds=3),
        None, bound_ms(s2_bytes, 3 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_lamb_stage2(
            ku, kp, kc, kusq, kpsq, lr, noop), iters=10))
    log_numbers(f"multi_tensor_lamb_stage2 {len(specs)} tensors",
                out["stage2"], "no library call")
    for n in out.values():
        n["tensors"], n["elements"], n["launches_per_call"] = (
            len(specs), n_el, launches)
    out["sumsq"]["launches_per_call"] = sumsq_launches(numels)
    return out


def gpt350m_shapes():
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    return [p.shape for p in GPTModel(GPTConfig(**GPT350M),
                                      device="meta").parameters()]


def resnet50_specs(opt_level):
    """(shape, dtype) of ResNet-50's 161 parameters under ``amp.initialize``
    at ``opt_level``: f32 at O1, bf16 with f32 batch norms at O2."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import resnet50
    model = resnet50(device="meta", dtype=torch.bfloat16
                     if opt_level == "O2" else torch.float32)
    amp.initialize(model, None, opt_level=opt_level)
    return [(tuple(p.shape), p.dtype) for p in model.parameters()]


def _opt_kernel_check(tag, kernel, plain, run, params, state, copies,
                      numels):
    """``run(f, params, state, copies, noop)`` with ``f`` the kernel's
    wrapper against the same with its plain version, on clones of the same
    tensors, noop 1 then 0: exact table launches; f32
    params and state within 1e-6 relative plus 1e-6 of each tensor's
    largest entry (FMA contraction on the card rounds a product-sum once
    where the plain version rounds twice); each side's model copies equal
    its params rounded to nearest even (unchanged under noop); under noop
    nothing moves.  Returns the largest error."""
    err = 0.0
    for noop_v in (1, 0):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        sides = []
        for f in (kernel, plain):
            kp = [t.clone() for t in params]
            ks = [t.clone() for t in state]
            kc = [None if c is None else torch.zeros_like(c) for c in copies]
            before = kernel.launches
            run(f, kp, ks, kc, noop)
            sides.append((kp, ks, kc, kernel.launches - before))
        torch.cuda.synchronize()
        (kp, ks, kc, n_launch), (rp, rs, rc, n_plain) = sides
        if n_launch != table_launches(numels) or n_plain:
            raise AssertionError(f"{tag} made {n_launch} launches (plain "
                                 f"{n_plain}), the table rule says "
                                 f"{table_launches(numels)}")
        t = f"{tag} noop={noop_v}"
        err = max(err, _check_lists(f"{t} params", kp, rp, 1e-6, 0.0,
                                    scale_rtol=1e-6))
        _check_lists(f"{t} state", ks, rs, 1e-6, 0.0, scale_rtol=1e-6)
        for side, ps, cs in (("kernel", kp, kc), ("plain", rp, rc)):
            want = [None if c is None else (torch.zeros_like(c) if noop_v
                                            else p.to(c.dtype))
                    for p, c in zip(ps, cs)]
            if any(c is not None for c in cs):
                _check_lists(f"{t} {side} copies vs its params", cs, want,
                             0.0, 0.0)
        if noop_v and not (all(torch.equal(a, b) for a, b in zip(kp, params))
                           and all(torch.equal(a, b)
                                   for a, b in zip(ks, state))):
            raise AssertionError(f"{tag} noop=1 changed the parameters or "
                                 f"the state")
        del sides, kp, ks, kc, rp, rs, rc
    return err


def _mixed_opt_lists(rand):
    """40 tensors crossing the 36-tensor table limit and the chunk
    carry-over: bf16 / f16 grads of f32 masters with bf16 / f16 model
    copies, and f32 parameters without one."""
    sizes = [70000, 65536, 1, 3, 200000, 129] * 7
    out = []
    for i, n in enumerate(sizes[:40]):
        cdt = (torch.bfloat16, torch.float16, None)[i % 3]
        gdt = cdt or torch.float32
        master = rand(n, 0.02)
        if cdt is not None:
            master = master.to(cdt).float()
        out.append((rand(n, 1e-2).to(gdt), master,
                    None if cdt is None else master.to(cdt)))
    return out


def kernel_optimizers(gen_cuda):
    """#16, #19, #22 and #23 against their plain versions over GPT-350M's
    f32 parameter list (291 tensors, as #18), a mixed-dtype list with
    master weights and model copies, and over ResNet-50's lists as its
    paths run them: #19 at O1 (f32) and O2 (bf16 with f32 masters and
    copies, f32 batch norm), #16 in place at O1 (the hand-written SGD), #22
    and #23 at O2 (phase 9c)."""
    from apex_tpu_torch.ops import multi_tensor as K
    shapes = gpt350m_shapes()
    numels = [int(np.prod(s)) for s in shapes]
    n_el = sum(numels)

    def rand(shape, std, positive=False):
        t = torch.randn(shape, generator=gen_cuda, device="cuda") * std
        return t.abs() + 1e-3 if positive else t

    out = {}
    noop0 = torch.tensor(0, dtype=torch.int32, device="cuda")
    sgd_scal = torch.tensor([0.1, 1e-4, 0.9, 0.0, 0.5], device="cuda")
    ada_scal = torch.tensor([1e-2, 1e-10, 1e-4, 0.5], device="cuda")
    # NovoGrad at step 3: lr with the bias corrections folded in
    nv_scal = torch.tensor([1e-3 * (1 - 0.98 ** 3) ** 0.5 / (1 - 0.95 ** 3),
                            0.95, 1e-3, 1e-8, 0.5, 0.05], device="cuda")
    runs = {
        "sgd": (K.multi_tensor_sgd, K.multi_tensor_sgd_reference,
                lambda g, p, s, c, n, f: f(g, p, s, c, sgd_scal, n),
                dict(std=1e-3, positive=False)),
        "sgd_nesterov_wd_after": (
            K.multi_tensor_sgd, K.multi_tensor_sgd_reference,
            lambda g, p, s, c, n, f: f(g, p, s, c, sgd_scal, n,
                                       nesterov=True, wd_after_momentum=True),
            dict(std=1e-3, positive=False)),
        "adagrad": (K.multi_tensor_adagrad, K.multi_tensor_adagrad_reference,
                    lambda g, p, s, c, n, f: f(g, p, s, c, ada_scal, n),
                    dict(std=1e-4, positive=True)),
        "adagrad_w_mode": (
            K.multi_tensor_adagrad, K.multi_tensor_adagrad_reference,
            lambda g, p, s, c, n, f: f(g, p, s, c, ada_scal, n, True),
            dict(std=1e-4, positive=True)),
    }

    # the mixed list: masters and copies, every optimizer kernel
    mixed = _mixed_opt_lists(rand)
    mg, mp, mc = (list(x) for x in zip(*mixed))
    m_numels = [t.numel() for t in mp]
    for name, (kern, plain, call, st) in runs.items():
        ms = [rand(t.numel(), st["std"], st["positive"]) for t in mp]
        _opt_kernel_check(
            f"{kern.__name__} ({name}) {len(mp)} mixed tensors", kern, plain,
            lambda f, p, s, c, n, _c=call: _c(mg, p, s, c, n, f),
            mp, ms, mc, m_numels)
    v_mixed = rand(len(mp), 1e-4, positive=True)
    ms = [rand(t.numel(), 1e-4) for t in mp]
    _opt_kernel_check(
        f"multi_tensor_novograd {len(mp)} mixed tensors",
        K.multi_tensor_novograd, K.multi_tensor_novograd_reference,
        lambda f, p, s, c, n: f(mg, p, s, c, v_mixed, nv_scal, n, True),
        mp, ms, mc, m_numels)
    del mixed, mg, mp, mc, ms

    # #16 axpby over the GPT list (f32), then a bf16 output
    xs = [rand(s, 1e-2) for s in shapes]
    ys = [rand(s, 1e-2) for s in shapes]
    kout = [torch.empty_like(x) for x in xs]
    rout = [torch.empty_like(x) for x in xs]
    before = K.multi_tensor_axpby_.launches
    K.multi_tensor_axpby_(xs, ys, kout, 0.9, -0.3)
    n_launch = K.multi_tensor_axpby_.launches - before
    K.multi_tensor_axpby_reference(xs, ys, rout, 0.9, -0.3)
    torch.cuda.synchronize()
    if n_launch != table_launches(numels):
        raise AssertionError("multi_tensor_axpby_ launch count")
    # a x + b y: FMA contraction rounds once where the plain version
    # rounds twice; where the two terms cancel that is an ulp of the terms
    err = _check_lists("multi_tensor_axpby_ f32", kout, rout, 1e-6, 0.0,
                       scale_rtol=1e-6)
    kb = [torch.empty_like(x, dtype=torch.bfloat16) for x in xs[:40]]
    rb = [torch.empty_like(x, dtype=torch.bfloat16) for x in xs[:40]]
    K.multi_tensor_axpby_(xs[:40], ys[:40], kb, 0.9, -0.3)
    K.multi_tensor_axpby_reference(xs[:40], ys[:40], rb, 0.9, -0.3)
    # the two f32 values may differ in their last bits (above), and a value
    # near a bf16 rounding midpoint then rounds to the neighbour: one bf16
    # ulp, up to 2**-7 of the result
    _check_lists("multi_tensor_axpby_ f32 -> bf16 outputs (one bf16 ulp)",
                 kb, rb, 2.0 ** -7, 0.0, scale_rtol=1e-6)
    del kb, rb
    _check_found_inf("multi_tensor_axpby_",
                     lambda: K.multi_tensor_axpby_(xs, ys, kout, 0.9, -0.3),
                     lambda: K.multi_tensor_axpby_reference(xs, ys, rout,
                                                            0.9, -0.3), xs)
    out["axpby"] = numbers(
        err, time_ms([lambda: K.multi_tensor_axpby_(xs, ys, kout, 0.9, -0.3)]
                     * 5),
        time_ms([lambda: K.multi_tensor_axpby_reference(xs, ys, rout, 0.9,
                                                        -0.3)] * 2, rounds=3),
        None, bound_ms(3 * 4 * n_el, 3 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_axpby_(xs, ys, kout, 0.9, -0.3),
                iters=10))
    log_numbers(f"multi_tensor_axpby_ {len(shapes)} tensors, {n_el} "
                f"elements, {table_launches(numels)} launches", out["axpby"],
                "no single library call for a x + b y")
    del xs, ys, kout, rout
    torch.cuda.empty_cache()

    # #19, #22, #23 over the GPT list (f32 g, p and state)
    gs = [rand(s, 1e-3) for s in shapes]
    ps = [rand(s, 0.02) for s in shapes]
    none = [None] * len(shapes)
    for name, (kern, plain, call, st) in runs.items():
        ss = [rand(s, st["std"], st["positive"]) for s in shapes]
        err = _opt_kernel_check(
            f"{kern.__name__} ({name}) {len(shapes)} tensors", kern, plain,
            lambda f, p, s, c, n, _c=call: _c(gs, p, s, c, n, f),
            ps, ss, none, numels)
        if name in ("sgd", "adagrad"):
            lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
            for p, g in zip(lib_ps, gs):
                p.grad = g
            lib = (torch.optim.SGD(lib_ps, lr=0.1, momentum=0.9,
                                   weight_decay=1e-4, fused=True)
                   if name == "sgd" else
                   torch.optim.Adagrad(lib_ps, lr=1e-2, weight_decay=1e-4,
                                       foreach=True))
            lib.step()
            out[name] = numbers(
                err, time_ms([lambda: call(gs, ps, ss, none, noop0, kern)]
                             * 5),
                time_ms([lambda: call(gs, ps, ss, none, noop0, plain)] * 2,
                        rounds=3),
                call_ms(lib.step, iters=10),
                bound_ms(5 * 4 * n_el, 10 * n_el, PEAK_F32_FLOPS),
                call_ms(lambda: call(gs, ps, ss, none, noop0, kern),
                        iters=10))
            lib_name = ("SGD(fused=True).step (eager)" if name == "sgd"
                        else "Adagrad(foreach=True).step (eager)")
            log_numbers(f"{kern.__name__} {len(shapes)} tensors, {n_el} "
                        f"elements, {table_launches(numels)} launches",
                        out[name], lib_name)
            del lib, lib_ps
        del ss
        torch.cuda.empty_cache()
    v = rand(len(shapes), 1e-6, positive=True)
    ms = [rand(s, 1e-4) for s in shapes]
    for reg in (False, True):
        err = _opt_kernel_check(
            f"multi_tensor_novograd (reg_inside_moment={reg}) "
            f"{len(shapes)} tensors", K.multi_tensor_novograd,
            K.multi_tensor_novograd_reference,
            lambda f, p, s, c, n, _r=reg: f(gs, p, s, c, v, nv_scal, n, _r),
            ps, ms, none, numels)
    out["novograd"] = numbers(
        err, time_ms([lambda: K.multi_tensor_novograd(gs, ps, ms, none, v,
                                                      nv_scal, noop0)] * 5),
        time_ms([lambda: K.multi_tensor_novograd_reference(
            gs, ps, ms, none, v, nv_scal, noop0)] * 2, rounds=3),
        None, bound_ms(5 * 4 * n_el + 4 * len(shapes), 10 * n_el,
                       PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_novograd(gs, ps, ms, none, v, nv_scal,
                                                noop0), iters=10))
    log_numbers(f"multi_tensor_novograd {len(shapes)} tensors, {n_el} "
                f"elements, {table_launches(numels)} launches",
                out["novograd"], "no single library call")
    del gs, ps, ms
    torch.cuda.empty_cache()
    for n in (out["axpby"], out["sgd"], out["adagrad"], out["novograd"]):
        n["tensors"], n["elements"] = len(shapes), n_el
        n["launches_per_call"] = table_launches(numels)

    # #19 over ResNet-50's lists, as phase 9 steps them
    for level in ("O1", "O2"):
        specs = resnet50_specs(level)
        r_numels = [int(np.prod(s)) for s, _ in specs]
        gs = [rand(s, 1e-3).to(dt) for s, dt in specs]
        masters = [rand(s, 0.05).to(dt).float() for s, dt in specs]
        copies = [None if dt == torch.float32 else m.to(dt)
                  for m, (_, dt) in zip(masters, specs)]
        bufs = [rand(s, 1e-3) for s, _ in specs]
        err = _opt_kernel_check(
            f"multi_tensor_sgd ResNet-50 {level} {len(specs)} tensors",
            K.multi_tensor_sgd, K.multi_tensor_sgd_reference,
            lambda f, p, s, c, n: f(gs, p, s, c, sgd_scal, n),
            masters, bufs, copies, r_numels)
        r_el = sum(r_numels)
        lib_ps = [torch.nn.Parameter(m.clone()) for m in masters]
        for p, g in zip(lib_ps, gs):
            p.grad = g.float()
        lib = torch.optim.SGD(lib_ps, lr=0.1, momentum=0.9,
                              weight_decay=1e-4, fused=True)
        lib.step()
        key = f"sgd_resnet50_{level}"
        out[key] = numbers(
            err, time_ms([lambda: K.multi_tensor_sgd(
                gs, masters, bufs, copies, sgd_scal, noop0)] * 5),
            time_ms([lambda: K.multi_tensor_sgd_reference(
                gs, masters, bufs, copies, sgd_scal, noop0)] * 2, rounds=3),
            call_ms(lib.step, iters=10),
            bound_ms(_nbytes(gs) + 4 * 4 * r_el + _nbytes(copies),
                     10 * r_el, PEAK_F32_FLOPS),
            call_ms(lambda: K.multi_tensor_sgd(gs, masters, bufs, copies,
                                               sgd_scal, noop0), iters=10))
        log_numbers(f"multi_tensor_sgd ResNet-50 {level} {len(specs)} "
                    f"tensors, {r_el} elements, {table_launches(r_numels)} "
                    f"launches", out[key],
                    "SGD(fused=True).step on f32 copies (eager)")
        out[key].update(tensors=len(specs), elements=r_el,
                        launches_per_call=table_launches(r_numels))
        if level == "O1":
            # the hand-written SGD's update: #16 in place on the
            # parameters (outs = xs), a and b as f32 device scalars
            _axpby_in_place_check(
                f"multi_tensor_axpby_ ResNet-50 O1 {len(specs)} tensors, "
                f"in place", masters, bufs,
                torch.tensor(1.0 - 0.1 * 1e-4, device="cuda"),
                torch.tensor(-0.1, device="cuda"), r_numels)
        else:
            # phase 9c's steps: #22 and #23 on the O2 list, bf16 grads of
            # f32 masters with bf16 model copies, f32 batch norm
            for name in ("adagrad", "adagrad_w_mode"):
                kern, plain, call, st = runs[name]
                ss = [rand(s, st["std"], st["positive"]) for s, _ in specs]
                _opt_kernel_check(
                    f"{kern.__name__} ({name}) ResNet-50 O2 {len(specs)} "
                    f"tensors", kern, plain,
                    lambda f, p, s, c, n, _c=call: _c(gs, p, s, c, n, f),
                    masters, ss, copies, r_numels)
                del ss
            v = rand(len(specs), 1e-6, positive=True)
            ms = [rand(s, 1e-4) for s, _ in specs]
            for reg in (False, True):
                _opt_kernel_check(
                    f"multi_tensor_novograd (reg_inside_moment={reg}) "
                    f"ResNet-50 O2 {len(specs)} tensors",
                    K.multi_tensor_novograd,
                    K.multi_tensor_novograd_reference,
                    lambda f, p, s, c, n, _r=reg: f(gs, p, s, c, v, nv_scal,
                                                    n, _r),
                    masters, ms, copies, r_numels)
            del v, ms
        del gs, masters, copies, bufs, lib, lib_ps
        torch.cuda.empty_cache()
    return out


def _axpby_in_place_check(tag, xs, ys, a, b, numels):
    """#16 writing over its x (``outs=xs``) against its plain version, each
    on its own clones of ``xs``: exact table launches, the same found-inf
    flag, values as #16's f32 check in phase 2."""
    from apex_tpu_torch.ops import multi_tensor as K
    kx, rx = [x.clone() for x in xs], [x.clone() for x in xs]
    before = K.multi_tensor_axpby_.launches
    kf = K.multi_tensor_axpby_(kx, ys, kx, a, b)
    n_launch = K.multi_tensor_axpby_.launches - before
    rf = K.multi_tensor_axpby_reference(rx, ys, rx, a, b)
    torch.cuda.synchronize()
    if n_launch != table_launches(numels) or float(kf) != float(rf):
        raise AssertionError(f"{tag}: {n_launch} launches (the table rule "
                             f"says {table_launches(numels)}), found-inf "
                             f"{float(kf)} vs plain {float(rf)}")
    err = _check_lists(tag, kx, rx, 1e-6, 0.0, scale_rtol=1e-6)
    del kx, rx
    return err


# -- phase 3 -----------------------------------------------------------------

def build_model(device, **overrides):
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    cfg = GPTConfig(**dict(GPT350M, dtype=torch.bfloat16, **overrides))
    return GPTModel(cfg, device=device)


def phase_serve(model, rng, tag="[3]"):
    """Phase 3's 10 requests through ``InferenceEngine`` (``tag`` [3f]: the
    same with ``fused_ffn=True``, whose FFN runs #11 in every prefill and
    decode step): finish reasons, exact launches, no plain version
    called, then prefill(512) and decode-step times."""
    from apex_tpu_torch.inference import InferenceEngine, Request
    from apex_tpu_torch.ops.flash_attention import (flash_attention_decode,
                                                    flash_fwd)
    from apex_tpu_torch.ops.fused_ffn import ffn_fwd
    from apex_tpu_torch.ops.layer_norm import layer_norm_fwd
    counters = (layer_norm_fwd, flash_fwd, flash_attention_decode, ffn_fwd)
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
    with counting_plain_versions() as plain_calls:
        responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}

    reasons = {r.request_id: r.finish_reason for r in responses}
    ffn = "fused FFN" if cfg.fused_ffn else "unfused FFN"
    log(f"{tag} served {len(responses)} requests ({ffn}) in {wall:.3f} s: "
        f"reasons {sorted(set(reasons.values()))}")
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
                "flash_attention_decode": layers * steps,
                # the row kernel and its combine per layer and program
                "ffn_fwd": 2 * layers * (prefills + steps) * cfg.fused_ffn}
    log(f"    launches {launches} (expected {expected}: {prefills} "
        f"prefills, {steps} decode steps); plain-version calls "
        f"{dict(plain_calls)}")
    if launches != expected:
        raise AssertionError("kernel launch counts do not match the path")
    if sum(plain_calls.values()):
        raise AssertionError(f"the serving path called plain versions: "
                             f"{dict(plain_calls)}")
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


def phase_parity(model, rng, tag="[4]"):
    cpu_model = build_model("cpu", fused_ffn=model.cfg.fused_ffn)
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
    log(f"{tag} card vs CPU, prefill(64) + 4 decode steps: max |logit diff| "
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


# -- phase 5 -----------------------------------------------------------------

def _train_counters():
    from apex_tpu_torch.ops.flash_attention import (flash_attention_dkv,
                                                    flash_attention_dq,
                                                    flash_fwd)
    from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from apex_tpu_torch.ops.fused_ffn import ffn_dw, ffn_dx, ffn_fwd
    from apex_tpu_torch.ops.lm_head import lm_head_dw, lm_head_dx, lm_head_fwd
    from apex_tpu_torch.ops.multi_tensor import multi_tensor_adam
    return (layer_norm_fwd, layer_norm_bwd, flash_fwd, flash_attention_dq,
            flash_attention_dkv, multi_tensor_adam, lm_head_fwd, lm_head_dx,
            lm_head_dw, ffn_fwd, ffn_dx, ffn_dw)


_PLAIN_VERSIONS = {
    "apex_tpu_torch.ops.layer_norm": ("layer_norm_fwd_reference",
                                      "layer_norm_bwd_reference"),
    "apex_tpu_torch.ops.flash_attention": (
        "flash_fwd_reference", "flash_attention_reference",
        "flash_attention_dq_reference", "flash_attention_dkv_reference",
        "flash_attention_decode_reference"),
    "apex_tpu_torch.ops.multi_tensor": (
        "multi_tensor_adam_reference", "multi_tensor_scale_reference",
        "multi_tensor_sumsq_reference", "multi_tensor_lamb_stage1_reference",
        "multi_tensor_lamb_stage2_reference",
        "multi_tensor_axpby_reference", "multi_tensor_sgd_reference",
        "multi_tensor_adagrad_reference",
        "multi_tensor_novograd_reference"),
    "apex_tpu_torch.ops.lm_head": ("lm_head_fwd_reference",
                                   "lm_head_dx_reference",
                                   "lm_head_dw_reference"),
    "apex_tpu_torch.ops.fused_ffn": ("ffn_fwd_reference", "ffn_dx_reference",
                                     "ffn_dw_reference",
                                     "fused_ffn_reference"),
}


@contextlib.contextmanager
def counting_plain_versions():
    """Count every call of a kernel's plain version while the block runs
    (the wrappers look their plain versions up by module attribute)."""
    calls = collections.Counter()
    saved = []
    for mod_name, names in _PLAIN_VERSIONS.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            fn = getattr(mod, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                calls[_name] += 1
                return _fn(*args, **kwargs)
            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_step(model, opt, tokens, targets, dropout_seed=None):
    """One step of the slice: the schedule over the model's loss and
    backward (M micro-batches), then FusedAdam.  Returns the mean loss."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    opt.zero_grad()
    loss = forward_backward_no_pipelining(
        lambda m, x: m.backbone(m.embed(x), dropout_seed),
        lambda x, t: model.head_loss(x, t).mean(), model, tokens, targets)
    opt.step()
    return loss


def ffn_launches(steps, micro, layers, fused):
    """#11-#13 launches of ``steps`` training steps: per micro-batch and
    layer, the forward and dX (two launches each) and dW (one)."""
    n = steps * micro * layers * fused
    return {"ffn_fwd": 2 * n, "ffn_dx": 2 * n, "ffn_dw": n}


def phase_train(fused_ffn=False, tag="[5]"):
    """Phase 5 (``tag`` [5f]: with ``fused_ffn=True``)."""
    from apex_tpu_torch.optimizers import FusedAdam
    model = build_model("cuda", fused_ffn=fused_ffn).init_params(
        torch.Generator().manual_seed(0))
    opt = FusedAdam(model.parameters(), lr=LR)
    numels = [p.numel() for p in model.parameters()]
    rng = np.random.RandomState(0)
    shape = (ACCUM, MICRO, SEQ)
    tokens = torch.from_numpy(rng.randint(0, GPT350M["vocab_size"],
                                          shape)).to("cuda")
    targets = torch.from_numpy(rng.randint(0, GPT350M["vocab_size"],
                                           shape)).to("cuda")
    counters = _train_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with counting_plain_versions() as plain_calls:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = train_step(model, opt, tokens, targets)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    per_mb = 2 * GPT350M["num_layers"] + 1
    n_steps, layers = TRAIN_STEPS, GPT350M["num_layers"]
    expected = {"layer_norm_fwd": n_steps * ACCUM * per_mb,
                "layer_norm_bwd": n_steps * ACCUM * per_mb,
                "flash_fwd": n_steps * ACCUM * layers,
                "flash_attention_dq": n_steps * ACCUM * layers,
                "flash_attention_dkv": n_steps * ACCUM * layers,
                "multi_tensor_adam": n_steps * table_launches(numels),
                # the forward's split pass and its combine, then dX, dW
                "lm_head_fwd": n_steps * ACCUM * 2,
                "lm_head_dx": n_steps * ACCUM,
                "lm_head_dw": n_steps * ACCUM,
                **ffn_launches(n_steps, ACCUM, layers, fused_ffn)}
    step_s = statistics.median(times[1:])
    tokens_per_step = ACCUM * MICRO * SEQ
    ffn = "fused FFN" if fused_ffn else "unfused FFN"
    log(f"{tag} trained GPT-350M {n_steps} steps ({ACCUM} x {MICRO} x {SEQ} "
        f"tokens, fused LM head, {ffn}, FusedAdam lr={LR}): losses "
        f"{[round(x, 5) for x in losses]} (ln vocab = "
        f"{np.log(GPT350M['vocab_size']):.3f}); step times (s) "
        f"{[round(t, 4) for t in times]}, median of steps 2-{n_steps} "
        f"{step_s:.4f} s, {tokens_per_step / step_s:.1f} tokens/s; peak "
        f"memory {peak / 2 ** 30:.2f} GiB")
    log(f"    launches {launches} (expected {expected}); per step "
        f"{ {k: v // n_steps for k, v in launches.items()} }; plain-version "
        f"calls {dict(plain_calls)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if launches != expected:
        raise AssertionError("training launch counts do not match the path")
    if sum(plain_calls.values()):
        raise AssertionError(f"the training path called plain versions: "
                             f"{dict(plain_calls)}")
    return model, opt, tokens, targets, dict(
        losses=losses, step_times_s=times, median_step_s=step_s,
        tokens_per_s=tokens_per_step / step_s, peak_memory_bytes=peak,
        launches=launches, launches_per_step={
            k: v // n_steps for k, v in launches.items()},
        adam_tensors=len(numels), adam_elements=sum(numels))


# -- phase 6 -----------------------------------------------------------------

PARITY_TRAIN = dict(vocab_size=50304, hidden_size=256, num_layers=4,
                    num_attention_heads=4, ffn_hidden_size=1024,
                    max_seq_len=256, attention_dropout=0.1,
                    dtype=torch.bfloat16)


def phase_train_parity(fused_lm_head=True, fused_ffn=False):
    """2 training steps of a small GPT with attention dropout on the card
    and on a CPU copy (the plain versions): loss, grads, params."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(**PARITY_TRAIN, fused_lm_head=fused_lm_head,
                    fused_ffn=fused_ffn)
    card = GPTModel(cfg, device="cuda").init_params(
        torch.Generator().manual_seed(1))
    cpu = GPTModel(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.RandomState(2)
    shape = (2, 2, PARITY_TRAIN["max_seq_len"])
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
    targets = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = next(model.parameters()).device
        opt = FusedAdam(model.parameters(), lr=LR)
        losses, grads = [], None
        for step in range(2):
            losses.append(float(train_step(model, opt, tokens.to(dev),
                                           targets.to(dev), dropout_seed=3)))
            if step == 0:
                grads = {n: p.grad.float().cpu()
                         for n, p in model.named_parameters()}
        runs[name] = (losses, grads, {n: p.detach().float().cpu()
                                      for n, p in model.named_parameters()})
    (cl, cg, cp), (rl, rg, rp) = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, rl))
    grad_err = max(float((cg[n] - rg[n]).abs().max() / rg[n].abs().max())
                   for n in rg)
    worst = max(rg, key=lambda n: float((cg[n] - rg[n]).abs().max()
                                        / rg[n].abs().max()))
    diffs = torch.sort(torch.cat([(cp[n] - rp[n]).abs().flatten()
                                  for n in rp])).values
    p_max = float(diffs[-1])
    p_q99 = float(diffs[int(0.99 * (diffs.numel() - 1))])
    head = "fused LM head" if fused_lm_head else "f32-logits head"
    head += ", fused FFN" if fused_ffn else ""
    log(f"[6] training card vs CPU (4 layers, hidden 256, dropout 0.1, "
        f"{head}, 2 steps): losses card {cl} cpu {rl}, max relative loss diff "
        f"{loss_err:.3e} (tolerance {TRAIN_LOSS_RTOL}); step-1 grads max "
        f"|diff| / max|grad| {grad_err:.3e} at {worst} (tolerance "
        f"{TRAIN_GRAD_TOL}); params after 2 steps max |diff| {p_max:.3e} "
        f"(tolerance {4.5 * LR}), 99th percentile {p_q99:.3e} (tolerance "
        f"{LR / 2})")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL
            and p_max <= 4.5 * LR and p_q99 <= LR / 2):
        raise AssertionError("card and CPU training disagree")
    return dict(losses_card=cl, losses_cpu=rl, loss_rel_err=loss_err,
                grad_rel_err=grad_err, worst_grad=worst, param_max_diff=p_max,
                param_q99_diff=p_q99)


# -- phase 7 -----------------------------------------------------------------

def _bert_counters():
    from apex_tpu_torch.ops.flash_attention import (flash_attention_dkv,
                                                    flash_attention_dq,
                                                    flash_fwd)
    from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from apex_tpu_torch.ops.lm_head import lm_head_dw, lm_head_dx, lm_head_fwd
    from apex_tpu_torch.ops.multi_tensor import (multi_tensor_sumsq,
                                                 multi_tensor_lamb_stage1,
                                                 multi_tensor_lamb_stage2)
    from apex_tpu_torch.ops.fused_ffn import ffn_dw, ffn_dx, ffn_fwd
    return (layer_norm_fwd, layer_norm_bwd, flash_fwd, flash_attention_dq,
            flash_attention_dkv, multi_tensor_sumsq, multi_tensor_lamb_stage1,
            multi_tensor_lamb_stage2, lm_head_fwd, lm_head_dx, lm_head_dw,
            ffn_fwd, ffn_dx, ffn_dw)


def build_bert(device, cfg_overrides, lr, seed, loss_scale=None):
    """BERT under amp O2 with FusedLAMB, through ``amp.initialize``:
    bf16 parameters, f32 LayerNorms, f32 masters."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.bert import BertConfig, BertModel
    from apex_tpu_torch.optimizers import FusedLAMB
    cfg = BertConfig(**cfg_overrides, dtype=torch.bfloat16)
    model = BertModel(cfg, device=device).init_params(
        torch.Generator().manual_seed(seed))
    opt = FusedLAMB(model.parameters(), lr=lr, betas=LAMB_BETAS,
                    weight_decay=LAMB_WD)
    state = amp.initialize(model, opt, opt_level="O2", loss_scale=loss_scale)
    return model, opt, state


def mlm_batch(vocab, shape, seed):
    """Tokens and MLM labels as bench.py draws them: 15% masked positions
    carry a random id, -1 elsewhere."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, shape)
    labels = np.where(rng.rand(*shape) < 0.15,
                      rng.randint(0, vocab, shape), -1)
    return torch.from_numpy(tokens), torch.from_numpy(labels)


def bert_step(model, opt, tokens, labels, scaler=None):
    """One step of the slice: the schedule over ``BertModel.loss`` and its
    backward (M micro-batches), then ``FusedLAMB.step`` (or, with a
    scaler, the scaled loss and ``amp.unscale_step``).  Returns the mean
    loss."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    opt.zero_grad()
    if scaler is None:
        loss_fn = lambda x, t: model.loss(x, t)              # noqa: E731
    else:
        loss_fn = lambda x, t: amp.scale_loss(model.loss(x, t),  # noqa
                                              scaler)
    loss = forward_backward_no_pipelining(lambda m, x: x, loss_fn, model,
                                          tokens, labels)
    if scaler is None:
        opt.step()
        return loss
    amp.unscale_step(opt, scaler)
    return loss / scaler.loss_scale


def phase_bert_train(fused_ffn=False, tag="[7]"):
    """4 steps of BERT-large O2 + FusedLAMB (``tag`` [7f]: with
    ``fused_ffn=True``); losses, times, memory, exact launch counts, and no
    plain version called."""
    model, opt, _ = build_bert("cuda", dict(BERT_LARGE, fused_ffn=fused_ffn),
                               BERT_LR, 0)
    numels = [p.numel() for p in model.parameters()]
    shape = (BERT_ACCUM, BERT_MICRO, BERT_SEQ)
    tokens, labels = (t.to("cuda") for t in mlm_batch(
        BERT_LARGE["vocab_size"], shape, 0))
    counters = _bert_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with counting_plain_versions() as plain_calls:
        for _ in range(BERT_STEPS):
            t0 = time.perf_counter()
            loss = bert_step(model, opt, tokens, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    n, layers = BERT_STEPS, BERT_LARGE["num_layers"]
    per_mb = 2 * layers + 2           # embedding LN, 2 per layer, MLM LN
    table = table_launches(numels)
    expected = {"layer_norm_fwd": n * BERT_ACCUM * per_mb,
                "layer_norm_bwd": n * BERT_ACCUM * per_mb,
                "flash_fwd": n * BERT_ACCUM * layers,
                "flash_attention_dq": n * BERT_ACCUM * layers,
                "flash_attention_dkv": n * BERT_ACCUM * layers,
                "multi_tensor_sumsq": n * sumsq_launches(numels),
                "multi_tensor_lamb_stage1": n * table,
                "multi_tensor_lamb_stage2": n * table,
                "lm_head_fwd": n * BERT_ACCUM * 2,
                "lm_head_dx": n * BERT_ACCUM,
                "lm_head_dw": n * BERT_ACCUM,
                **ffn_launches(n, BERT_ACCUM, layers, fused_ffn)}
    step_s = statistics.median(times[1:])
    tokens_per_step = BERT_ACCUM * BERT_MICRO * BERT_SEQ
    ffn = "fused FFN" if fused_ffn else "unfused FFN"
    log(f"{tag} trained BERT-large O2 + FusedLAMB {n} steps ({BERT_ACCUM} x "
        f"{BERT_MICRO} x {BERT_SEQ} tokens, fused LM head, {ffn}, "
        f"lr={BERT_LR}, "
        f"{len(numels)} "
        f"parameters, {sum(numels)} elements): losses "
        f"{[round(x, 5) for x in losses]} (ln vocab = "
        f"{np.log(BERT_LARGE['vocab_size']):.3f}); step times (s) "
        f"{[round(t, 4) for t in times]}, median of steps 2-{n} "
        f"{step_s:.4f} s, {tokens_per_step / step_s:.1f} tokens/s; peak "
        f"memory {peak / 2 ** 30:.2f} GiB")
    log(f"    launches {launches} (expected {expected}); per step "
        f"{ {k: v // n for k, v in launches.items()} }; plain-version "
        f"calls {dict(plain_calls)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not (abs(losses[0] - np.log(BERT_LARGE["vocab_size"])) < 1.0
            and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not start near ln(vocab) and "
                             f"fall: {losses}")
    if launches != expected:
        raise AssertionError("BERT launch counts do not match the path")
    if sum(plain_calls.values()):
        raise AssertionError(f"the BERT path called plain versions: "
                             f"{dict(plain_calls)}")
    return model, opt, tokens, labels, dict(
        losses=losses, step_times_s=times, median_step_s=step_s,
        tokens_per_s=tokens_per_step / step_s, peak_memory_bytes=peak,
        launches=launches, launches_per_step={
            k: v // n for k, v in launches.items()},
        lamb_tensors=len(numels), lamb_elements=sum(numels))


def phase_unscale_clip(model):
    """#15 and #17 on the last BERT step's real gradients, through
    ``LossScaler.unscale`` and ``clip_grad_norm_`` (counted alone), each
    against the plain versions on the same gradients."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
    from apex_tpu_torch.ops import multi_tensor as K
    params = [p for p in model.parameters() if p.grad is not None]
    grads = [p.grad for p in params]
    scaler = amp.LossScaler(init_scale=1024.0, device="cuda")
    ref_unscaled = [torch.empty_like(g) for g in grads]
    ref_clipped = [g.clone() for g in grads]
    K.multi_tensor_scale_reference(grads, ref_unscaled,
                                   1.0 / scaler.loss_scale)
    total, _, _ = K.multi_tensor_sumsq_reference(grads)
    ref_norm = torch.sqrt(total)
    max_norm = 0.5 * float(ref_norm)       # so that the clip rescales
    coef = torch.clamp(max_norm / (ref_norm + 1e-6), max=1.0)
    K.multi_tensor_scale_reference(grads, ref_clipped, coef)
    counters = (K.multi_tensor_scale_, K.multi_tensor_sumsq)
    for c in counters:
        c.launches = 0
    unscaled, found_inf = scaler.unscale(grads)
    norm = clip_grad_norm_(params, max_norm)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    numels = [g.numel() for g in grads]
    expected = {"multi_tensor_scale_": 2 * table_launches(numels),
                "multi_tensor_sumsq": sumsq_launches(numels)}
    log(f"[7b] LossScaler.unscale and clip_grad_norm_(max_norm={max_norm:.4g})"
        f" on the last step's {len(grads)} gradients: launches {launches} "
        f"(expected {expected}); found_inf {float(found_inf)}; norm "
        f"{float(norm):.6g}, plain {float(ref_norm):.6g}")
    err_u = _check_lists("unscale vs plain", unscaled, ref_unscaled,
                         2.0 ** -8, 0.0)
    check_close("clip_grad_norm_ total norm vs plain", norm, ref_norm, 0,
                1e-5)
    err_c = _check_lists("clipped gradients vs plain", grads, ref_clipped,
                         2.0 ** -7, 0.0)
    if launches != expected or float(found_inf) != 0.0:
        raise AssertionError("the unscale / clip path did not run as "
                             "expected")
    return dict(launches=launches, max_norm=max_norm, norm=float(norm),
                unscale_err=err_u, clip_err=err_c)


# -- phase 8 -----------------------------------------------------------------

PARITY_BERT = dict(vocab_size=30528, hidden_size=256, num_layers=4,
                   num_attention_heads=4, ffn_hidden_size=1024,
                   max_seq_len=128)


def _cs_bound(t, b1=LAMB_BETAS[0], b2=LAMB_BETAS[1]):
    """max |m^ / sqrt(v^)| over gradient histories of length t
    (Cauchy-Schwarz): 1 at step 1, 1.0014 at step 2."""
    k = np.arange(1, t + 1)
    a = (1 - b1) * b1 ** (t - k) / (1 - b1 ** t)
    b = (1 - b2) * b2 ** (t - k) / (1 - b2 ** t)
    return float(np.sqrt(np.sum(a * a / b)))


def phase_bert_parity(fused_ffn=False):
    """2 steps of a small BERT under O2 + FusedLAMB on the card and on a
    CPU copy (the plain versions): losses, every gradient of both steps,
    then the masters, m and v.

    Tolerances: the loss 2e-3 relative and each gradient within 5e-2 of
    its largest entry (bf16 rounding places and sum orders differ; the
    bound of the CPU tests against JAX).  The optimizer's state follows
    from its update rule: m' = b1 m + (1 - b1) c g and v' = b2 v + (1 - b2)
    (c g)^2, with c the clip factor (within 1% on the two sides), bound
    |dm|, |dv| by the measured gradient differences E_t of each leaf; a
    master moves by lr r_t u with |u| <= C_t + wd |p| (C_t the
    Cauchy-Schwarz bound of |m^ / sqrt(v^)|) and r_t the leaf's trust
    ratio (the CPU run's, 5% allowed for the card's), and an entry whose
    gradient is noise may move the other way on one side: 2.1 lr r_t
    (C_t + wd |p|) per step.  That bound admits a master that never moved,
    so each leaf's move from its start p0 is held as a whole too (within
    MOVE_RTOL of the CPU run's move).
    """
    cfg = dict(PARITY_BERT, fused_ffn=fused_ffn)
    card, copt, _ = build_bert("cuda", cfg, BERT_LR, 1)
    cpu, popt, _ = build_bert("cpu", cfg, BERT_LR, 1)
    cpu.load_state_dict(card.state_dict())
    # the masters start as the parameters in f32
    p0 = {n: p.detach().float().cpu().clone()
          for n, p in card.named_parameters()}
    shape = (2, 2, PARITY_BERT["max_seq_len"])
    tokens, labels = mlm_batch(PARITY_BERT["vocab_size"], shape, 2)
    runs = {}
    for name, model, opt in (("card", card, copt), ("cpu", cpu, popt)):
        dev = next(model.parameters()).device
        losses, grads, ratios, clips = [], [], [], []
        for _ in range(2):
            before = {n: t.detach().cpu().clone() for n, t in zip(
                (n for n, _ in model.named_parameters()),
                opt.master_params())}
            losses.append(float(bert_step(model, opt, tokens.to(dev),
                                          labels.to(dev))))
            g = {n: (torch.zeros(p.shape) if p.grad is None
                     else p.grad.float().cpu())
                 for n, p in model.named_parameters()}
            grads.append(g)
            gnorm = float(torch.sqrt(sum(torch.sum(x * x)
                                         for x in g.values())))
            clips.append(min(1.0, 1.0 / gnorm))
            ratios.append({})
            for n, p in model.named_parameters():
                u = opt._updates[p].cpu()
                pn, un = float(before[n].norm()), float(u.norm())
                ratios[-1][n] = pn / un if pn > 0 and un > 0 else 1.0
        # m, v and the updated f32 value (the master, or the f32 param)
        state = {n: {"exp_avg": opt.state[p]["exp_avg"].cpu(),
                     "exp_avg_sq": opt.state[p]["exp_avg_sq"].cpu(),
                     "value": value.detach().cpu().clone()}
                 for (n, p), value in zip(model.named_parameters(),
                                          opt.master_params())}
        runs[name] = (losses, grads, state, ratios, clips)
    (cl, cg, cs, _, cc), (rl, rg, rs, rr, rc) = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, rl))
    grad_err, worst, diffs = 0.0, None, []
    for t in range(2):
        diffs.append({})
        for n in rg[t]:
            d = float((cg[t][n] - rg[t][n]).abs().max())
            diffs[t][n] = d
            rel = d / max(float(rg[t][n].abs().max()), 1e-30)
            if worst is None or rel > grad_err:
                grad_err, worst = rel, (t + 1, n)
    b1, b2 = LAMB_BETAS
    state_ok, state_worst, move_worst = True, {}, (0.0, None)
    for n in rs:
        g_max = [float(rg[t][n].abs().max()) for t in range(2)]
        e = [diffs[t][n] for t in range(2)]
        dm = [(1 - b1) * rc[t] * (e[t] + 1e-2 * g_max[t]) for t in range(2)]
        dv = [1.02 * (1 - b2) * rc[t] ** 2 * (2 * g_max[t] + e[t])
              * (e[t] + 1e-2 * g_max[t]) for t in range(2)]
        tol = {"exp_avg": b1 * dm[0] + dm[1] + 1e-9,
               "exp_avg_sq": b2 * dv[0] + dv[1] + 1e-12}
        for key in rs[n]:
            d = (cs[n][key] - rs[n][key]).abs()
            if key == "value":
                bound = sum(2.1 * BERT_LR * rr[t][n]
                            * (_cs_bound(t + 1)
                               + LAMB_WD * rs[n]["value"].abs())
                            for t in range(2)) + 1e-7
                ok = bool((d <= bound).all())
                share = float((d / bound).max())
                moved = float((rs[n]["value"] - p0[n]).norm())
                off = float(d.norm())
                ok &= off <= MOVE_RTOL * moved + 1e-9
                move_share = off / moved if moved > 0 else (
                    0.0 if off == 0 else float("inf"))
                if move_share >= move_worst[0]:
                    move_worst = (move_share, n)
            else:
                ok = float(d.max()) <= tol[key]
                share = float(d.max()) / tol[key]
            state_worst[key] = max(state_worst.get(key, 0.0), share)
            state_ok &= ok
    ffn = ", fused FFN" if fused_ffn else ""
    log(f"[8] BERT O2 + FusedLAMB card vs CPU (4 layers, hidden 256, seq "
        f"128{ffn}, 2 steps): losses card {cl} cpu {rl}, max relative loss "
        f"diff "
        f"{loss_err:.3e} (tolerance {TRAIN_LOSS_RTOL}); grads max |diff| / "
        f"max|grad| {grad_err:.3e} at step {worst[0]} {worst[1]} (tolerance "
        f"{TRAIN_GRAD_TOL}); f32 values (masters), m, v: largest share of "
        f"their update-rule bounds {state_worst}; largest ||card - cpu|| / "
        f"||cpu - p0|| of a leaf {move_worst[0]:.4f} ({move_worst[1]}, "
        f"tolerance {MOVE_RTOL})")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL
            and state_ok):
        raise AssertionError("card and CPU BERT training disagree")
    return dict(losses_card=cl, losses_cpu=rl, loss_rel_err=loss_err,
                grad_rel_err=grad_err, worst_grad=list(worst),
                state_bound_shares=state_worst, move_share=move_worst[0],
                move_worst_leaf=move_worst[1])


def phase_dynamic_skip():
    """A dynamic-loss-scale step with an inf injected into one gradient is
    skipped on the device: masters, m, v, the step count and the
    parameters unchanged bit for bit, and the scale halves."""
    from apex_tpu_torch import amp
    model, opt, state = build_bert("cuda", PARITY_BERT, BERT_LR, 3,
                                   loss_scale="dynamic")
    scaler = state.scaler
    tokens, labels = (t.to("cuda") for t in mlm_batch(
        PARITY_BERT["vocab_size"], (2, 2, PARITY_BERT["max_seq_len"]), 4))
    loss = float(bert_step(model, opt, tokens, labels, scaler))
    snap = {n: ({k: v.clone() for k, v in opt.state[p].items()},
                p.detach().clone()) for n, p in model.named_parameters()}
    step0, scale0 = int(opt.param_groups[0]["step"]), float(
        scaler.loss_scale)
    opt.zero_grad()
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    forward_backward_no_pipelining(
        lambda m, x: x,
        lambda x, t: amp.scale_loss(model.loss(x, t), scaler), model,
        tokens, labels)
    model.layers[1].fc1.weight.grad[3, 5] = float("inf")
    found_inf = amp.unscale_step(opt, scaler)
    torch.cuda.synchronize()
    same = all(torch.equal(p, snap[n][1]) and all(
        torch.equal(opt.state[p][k], v) for k, v in snap[n][0].items())
        for n, p in model.named_parameters())
    step1, scale1 = int(opt.param_groups[0]["step"]), float(
        scaler.loss_scale)
    log(f"[8b] dynamic loss scale: clean step (loss {loss:.5f}) then an inf "
        f"in layers.1.fc1.weight's gradient: found_inf "
        f"{float(found_inf)}, step count {step0} -> {step1}, scale {scale0} "
        f"-> {scale1}, masters/m/v/parameters unchanged bit for bit: {same}")
    if not (float(found_inf) == 1.0 and same and step1 == step0 == 1
            and scale1 == scale0 / 2):
        raise AssertionError("the overflow step was not skipped on the "
                             "device")
    return dict(found_inf=float(found_inf), step_before=step0,
                step_after=step1, scale_before=scale0, scale_after=scale1,
                unchanged=same)


# -- phase 9 -----------------------------------------------------------------

# examples/imagenet/main_amp.py at its defaults: ResNet-50, batch 256 at
# 224 x 224, 1000 classes, FusedSGD(lr 0.1, momentum 0.9, wd 1e-4),
# synthetic data from seed 0; a warm-up step, then 4 steps
RESNET_ARGV = ["--arch", "resnet50", "--batch-size", "256", "--image-size",
               "224", "--num-classes", "1000", "--steps", "4",
               "--print-freq", "4", "--seed", "0", "--lr", "0.1",
               "--momentum", "0.9", "--weight-decay", "1e-4"]
RESNET_STEPS = 1 + 4


def _all_counters():
    from apex_tpu_torch.ops import multi_tensor as K
    return tuple(dict.fromkeys(_train_counters() + _bert_counters() + (
        K.multi_tensor_scale_, K.multi_tensor_axpby_, K.multi_tensor_sgd,
        K.multi_tensor_adagrad, K.multi_tensor_novograd)))


def _launches_of(counters):
    return {c.__name__: c.launches for c in counters if c.launches}


def phase_resnet(opt_level, tag):
    """The ported ImageNet example's ``main()`` at ``opt_level``: losses,
    step times, img/s and peak memory; every kernel counter read around
    the run (only #19, exactly its table launches per step) and no plain
    version called.  Returns the trainer and the numbers."""
    from apex_tpu_torch.examples.imagenet import main_amp
    numels = [int(np.prod(s)) for s, _ in resnet50_specs(opt_level)]
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    with counting_plain_versions() as plain_calls:
        res = main_amp.main(RESNET_ARGV + ["--opt-level", opt_level])
    torch.cuda.synchronize()
    launches = _launches_of(counters)
    trainer = res.pop("trainer")
    batch = res.pop("batch")
    per_step = table_launches(numels)
    expected = {"multi_tensor_sgd": RESNET_STEPS * per_step}
    step_s = statistics.median(res["step_times_s"])
    peak = res["peak_memory_bytes"]
    log(f"{tag} ResNet-50 ImageNet {opt_level} (examples/imagenet/main_amp,"
        f" batch 256 x 224^2, FusedSGD lr 0.1): warm-up loss "
        f"{res['warmup_loss']:.5f}, losses "
        f"{[round(x, 5) for x in res['losses']]}; step times (s) "
        f"{[round(t, 4) for t in res['step_times_s']]}, median "
        f"{step_s:.4f} s, {256 / step_s:.1f} img/s (main's "
        f"{res['images_per_s']:.1f}); peak memory {peak / 2 ** 30:.2f} GiB")
    log(f"    launches {launches} (expected {expected}: {per_step} per "
        f"step over {len(numels)} tensors); plain-version calls "
        f"{dict(plain_calls)}")
    if not np.all(np.isfinite(res["losses"] + [res["warmup_loss"]])):
        raise AssertionError(f"non-finite ResNet-50 loss: {res['losses']}")
    if launches != expected:
        raise AssertionError("ResNet-50 launch counts do not match the path")
    if sum(plain_calls.values()):
        raise AssertionError(f"the ResNet-50 path called plain versions: "
                             f"{dict(plain_calls)}")
    model, opt = trainer.model, trainer.optimizer
    if opt_level == "O2":
        f32 = {n for n, p in model.named_parameters()
               if p.dtype == torch.float32}
        if not (f32 and all("bn_" in n for n in f32)
                and all(("master" in opt.state[p])
                        == (p.dtype == torch.bfloat16)
                        for p in model.parameters())):
            raise AssertionError("O2: batch norm not f32 or masters missing")
        log(f"    O2: {len(f32)} batch-norm parameters f32, "
            f"{len(numels) - len(f32)} bf16 with f32 masters")
    res.update(median_step_s=step_s, launches=launches,
               launches_per_step={k: v // RESNET_STEPS
                                  for k, v in launches.items()},
               sgd_tensors=len(numels), sgd_elements=sum(numels))
    return trainer, batch, res


def phase_resnet_optimizers(trainer, batch, tag="[9c]"):
    """One step each with FusedAdagrad and FusedNovoGrad in place of
    FusedSGD on phase 9b's model (bf16 with f32 batch norm, masters): exact
    launches of #22, and of #17 (per-tensor sums) and #23."""
    from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad
    model = trainer.model
    numels = [p.numel() for p in model.parameters()]
    table = table_launches(numels)
    out = {}
    for cls, kw, expected in (
            (FusedAdagrad, dict(lr=1e-3, weight_decay=1e-4),
             {"multi_tensor_adagrad": table}),
            (FusedNovoGrad, dict(lr=1e-3, weight_decay=1e-4),
             {"multi_tensor_sumsq": sumsq_launches(numels, per_tensor=True),
              "multi_tensor_novograd": table})):
        trainer.optimizer = cls(model.parameters(), master_weights=True,
                                **kw)
        counters = _all_counters()
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        with counting_plain_versions() as plain_calls:
            t0 = time.perf_counter()
            loss = float(trainer.step(*batch))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = _launches_of(counters)
        log(f"{tag} {cls.__name__} step on ResNet-50 O2: loss {loss:.5f}, "
            f"{dt:.4f} s; launches {launches} (expected {expected}); "
            f"plain-version calls {dict(plain_calls)}")
        if not np.isfinite(loss) or launches != expected or sum(
                plain_calls.values()):
            raise AssertionError(f"{cls.__name__} on ResNet-50: launches, "
                                 f"plain calls or loss")
        out[cls.__name__] = dict(loss=loss, step_s=dt, launches=launches)
    return out


def phase_resnet_baseline(tag="[9d]"):
    """The example's hand-written SGD (``--no-fused-sgd``) at O1, a warm-up
    step and one step: its overflow check is #17 and its parameter update
    #16, exact launches of both; no plain version called."""
    from apex_tpu_torch.examples.imagenet import main_amp
    numels = [int(np.prod(s)) for s, _ in resnet50_specs("O1")]
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    with counting_plain_versions() as plain_calls:
        res = main_amp.main(RESNET_ARGV + ["--opt-level", "O1", "--steps",
                                           "1", "--no-fused-sgd"])
    torch.cuda.synchronize()
    res.pop("trainer")
    res.pop("batch")
    launches = _launches_of(counters)
    expected = {"multi_tensor_sumsq": 2 * sumsq_launches(numels),
                "multi_tensor_axpby_": 2 * table_launches(numels)}
    log(f"{tag} ResNet-50 O1, hand-written SGD: losses "
        f"{[res['warmup_loss']] + res['losses']}, step "
        f"{res['step_times_s'][0]:.4f} s; launches {launches} (expected "
        f"{expected}); plain-version calls {dict(plain_calls)}")
    if (launches != expected or sum(plain_calls.values())
            or not np.all(np.isfinite(res["losses"]))):
        raise AssertionError("the hand-written SGD path: launches, plain "
                             "calls or losses")
    res["launches"] = launches
    return res


# -- phase 10 ----------------------------------------------------------------

PARITY_RESNET = dict(width=16, num_classes=10)
PARITY_IMAGES, PARITY_BATCH = 64, 8


def _matmul_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)


def _set_matmul_flags(flags):
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = \
        flags


def _resnet_two_steps(device, opt_level, cls, kw, x, y):
    """``resnet26`` (width 16) from seed 0 under ``opt_level``, 2 steps of
    ``cls`` on one batch: the losses, the first step's gradients (same
    parameters on every side), the parameters' moves and the BN running
    statistics after the steps, on the CPU."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import resnet26
    model = resnet26(device=device, **PARITY_RESNET).init_params(
        torch.Generator().manual_seed(0))
    p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    opt = cls(model.parameters(), **kw)
    amp.initialize(model, opt, opt_level=opt_level)
    xd, yd = x.to(device), y.to(device)
    losses, grads = [], None
    for step in range(2):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(xd, yd)
        loss.backward()
        if step == 0:
            grads = {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters()}
        opt.step()
        losses.append(float(loss.detach()))
    moves = {n: p.detach().float().cpu() - p0[n]
             for n, p in model.named_parameters()}
    stats = {n: b.detach().float().cpu() for n, b in model.named_buffers()
             if "running" in n}
    return dict(losses=losses, grads=grads, moves=moves, stats=stats)


# Card vs CPU under O1: both round the same values to bf16 (the
# convolutions' inputs) but sum the products in other orders, and a bf16
# rounding that flips is amplified by the batch norms (8 images, a 2 x 2
# map at stage 4): a gradient whose terms cancel (the BN parameters') moves
# by up to ~70% between bf16 and f32 on the CPU.  So the yardstick is the
# CPU's own O1-to-f32 distance d: each tensor (gradient, parameter move,
# running statistic) of the card within 3 d + a share of the f32 tensor's
# norm (1e-2; 1e-3 for the running statistics), the whole first-step
# gradient within d + 1e-2 of its norm, and each loss within 3 d + 2e-3 of
# it.  The card's bf16 convolutions land further from the CPU's than the
# CPU's from f32: on an H100 (700 W) a 2 d bound was 0.79-0.92 used by
# the losses and 0.72 by the moves, so the factor is 3.
PARITY_SHARE = {"grads": 1e-2, "moves": 1e-2, "stats": 1e-3}


def _parity_check(tag, card, cpu, f32):
    norm = np.linalg.norm
    worst = {}
    for key, share in PARITY_SHARE.items():
        ratio = 0.0
        for n in cpu[key]:
            a, b, c = (r[key][n].numpy().astype(np.float64)
                       for r in (card, cpu, f32))
            bound = 3 * norm(b - c) + share * norm(c)
            ratio = max(ratio, norm(a - b) / max(bound, 1e-30))
        worst[key] = float(ratio)
    cat = {k: np.concatenate([r["grads"][n].numpy().ravel()
                              for n in sorted(cpu["grads"])])
           for k, r in (("card", card), ("cpu", cpu), ("f32", f32))}
    worst["grads_global"] = float(norm(cat["card"] - cat["cpu"]) / (
        norm(cat["cpu"] - cat["f32"]) + 1e-2 * norm(cat["f32"])))
    worst["losses"] = max(abs(a - b) / (3 * abs(b - c) + 2e-3 * abs(c))
                          for a, b, c in zip(card["losses"], cpu["losses"],
                                             f32["losses"]))
    log(f"{tag} losses card {[round(v, 5) for v in card['losses']]} cpu "
        f"{[round(v, 5) for v in cpu['losses']]} cpu f32 "
        f"{[round(v, 5) for v in f32['losses']]}; worst share of the bound "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    if max(worst.values()) > 1.0:
        raise AssertionError(f"{tag}: the card and the CPU disagree beyond "
                             f"the bound")
    return worst


def phase_resnet_parity(flags_at_start):
    """resnet26 (width 16, 64 x 64, batch 8, 10 classes) trained 2 steps
    under O1 on the card and on a CPU copy (and in f32 on the CPU, the
    yardstick), with each of FusedSGD, FusedAdagrad and FusedNovoGrad;
    then FusedSGD's card run again with the matmul flags as torch set them
    before any GPTModel turned them (TF32, bf16 reduced-precision
    reduction) process-wide."""
    from apex_tpu_torch.optimizers import (FusedAdagrad, FusedNovoGrad,
                                           FusedSGD)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(PARITY_BATCH, PARITY_IMAGES,
                                   PARITY_IMAGES, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, PARITY_BATCH))
    out = {}
    for cls, kw in ((FusedSGD, dict(lr=0.1, momentum=0.9,
                                    weight_decay=1e-4)),
                    (FusedAdagrad, dict(lr=1e-2, weight_decay=1e-4)),
                    (FusedNovoGrad, dict(lr=1e-2, weight_decay=1e-3))):
        card = _resnet_two_steps("cuda", "O1", cls, kw, x, y)
        cpu = _resnet_two_steps("cpu", "O1", cls, kw, x, y)
        f32 = _resnet_two_steps("cpu", "O0", cls, kw, x, y)
        out[cls.__name__] = _parity_check(f"[10] {cls.__name__} card vs "
                                          f"CPU, O1", card, cpu, f32)
        if cls is FusedSGD:
            now = _matmul_flags()
            _set_matmul_flags(flags_at_start)
            try:
                default = _resnet_two_steps("cuda", "O1", cls, kw, x, y)
            finally:
                _set_matmul_flags(now)
            diff = max(float((default[k][n] - card[k][n]).abs().max())
                       for k in ("grads", "moves", "stats")
                       for n in card[k])
            log(f"[10] matmul flags (tf32, cudnn tf32, bf16 reduced "
                f"reduction) as the GPT phases left them {now} against "
                f"torch's at start {flags_at_start}: losses "
                f"{card['losses']} vs {default['losses']}, largest "
                f"difference of a gradient, move or running statistic "
                f"{diff:.3e}")
            out["flags"] = dict(now=now, at_start=flags_at_start,
                                max_diff=diff,
                                losses=[card["losses"], default["losses"]])
    return out


# -- optional: where the time goes ------------------------------------------

_KERNEL_CLASSES = (("layer_norm_bwd", "layer_norm_bwd"),
                   ("layer_norm_fwd_kernel", "layer_norm_fwd"),
                   ("flash_fwd_kernel", "flash_fwd"),
                   ("flash_bwd_dq_kernel", "flash_attention_dq"),
                   ("flash_bwd_dkv_kernel", "flash_attention_dkv"),
                   ("flash_decode_kernel", "flash_attention_decode"),
                   ("multi_tensor_adam_kernel", "multi_tensor_adam"),
                   ("multi_tensor_scale_kernel", "multi_tensor_scale_"),
                   ("multi_tensor_l2norm_kernel", "multi_tensor_sumsq"),
                   ("multi_tensor_sum_partials", "multi_tensor_sumsq"),
                   ("lamb_stage1_kernel", "multi_tensor_lamb_stage1"),
                   ("lamb_stage2_kernel", "multi_tensor_lamb_stage2"),
                   ("multi_tensor_axpby_kernel", "multi_tensor_axpby_"),
                   ("multi_tensor_sgd_kernel", "multi_tensor_sgd"),
                   ("multi_tensor_adagrad_kernel", "multi_tensor_adagrad"),
                   ("multi_tensor_novograd_kernel", "multi_tensor_novograd"),
                   ("lm_head_fwd", "lm_head_fwd"),
                   ("lm_head_dx", "lm_head_dx"),
                   ("lm_head_dw", "lm_head_dw"),
                   ("ffn_rows_kernel<__nv_bfloat16, false>", "ffn_fwd"),
                   ("ffn_rows_kernel<float, false>", "ffn_fwd"),
                   ("ffn_rows_kernel<__nv_bfloat16, true>", "ffn_dx"),
                   ("ffn_rows_kernel<float, true>", "ffn_dx"),
                   ("ffn_combine_kernel", "ffn_fwd / ffn_dx combine"),
                   ("ffn_dw_kernel", "ffn_dw"))


def _kernel_class(name):
    for key, cls in _KERNEL_CLASSES:
        if key in name:
            return cls
    low = name.lower()
    if "batch_norm" in low or "batchnorm" in low:
        return "batch norm"
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv")):
        return "convolution (cuDNN)"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, indexing)"


def _profile_programs(programs, lines):
    from torch.profiler import ProfilerActivity, profile
    out = {}
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
            # device kernels only: a user annotation (Optimizer.step's
            # range) spans kernels already counted
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
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
    return out


def phase_profile_serving(model, rng, lines, suffix=""):
    """torch.profiler over one prefill(512) and one 8-slot decode step:
    device time by kernel class, and the device's idle share of the
    profiled wall time (``suffix`` tags the programs' names)."""
    cfg = model.cfg
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 512))).to(
        "cuda")
    cache = torch.zeros((SLOTS, cfg.num_layers, 2, cfg.max_seq_len, HEADS,
                         HEAD_DIM), dtype=cfg.dtype, device="cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, SLOTS)).to(
        "cuda")
    positions = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    return _profile_programs(
        {"prefill_512" + suffix: lambda: model.prefill(prompt),
         "decode_step_8_slots" + suffix: lambda: model.decode_step(
             tokens, cache, positions)}, lines)


def phase_profile_train(model, opt, tokens, targets, lines,
                        name="train_step"):
    """torch.profiler over one whole training step (2 micro-batches of
    loss + backward, then FusedAdam)."""
    return _profile_programs(
        {name: lambda: train_step(model, opt, tokens, targets)}, lines)


def phase_profile_bert(model, opt, tokens, labels, lines,
                       name="bert_train_step"):
    """torch.profiler over one whole BERT-large step (2 micro-batches of
    loss + backward, then FusedLAMB)."""
    return _profile_programs(
        {name: lambda: bert_step(model, opt, tokens, labels)}, lines)


def log_fused_change(tag, base, fused):
    """Step time, tokens/s and peak memory of a fused_ffn=True training run
    beside the same path's unfused run (this process, this card)."""
    log(f"{tag} fused_ffn=True against False: median step "
        f"{fused['median_step_s']:.4f} s vs {base['median_step_s']:.4f} s "
        f"({fused['median_step_s'] / base['median_step_s']:.3f}x), "
        f"{fused['tokens_per_s']:.1f} vs {base['tokens_per_s']:.1f} "
        f"tokens/s, peak memory {fused['peak_memory_bytes'] / 2 ** 30:.2f} "
        f"vs {base['peak_memory_bytes'] / 2 ** 30:.2f} GiB")


# -- main --------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write all results to this JSON file")
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one prefill, one decode step and one "
                         "step of each training path, each with and without "
                         "the fused FFN, and one ResNet-50 step at O1 and "
                         "O2, and write the kernel breakdown to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import apex_tpu_torch  # noqa: F401  (fails outside a checkout)

    flags_at_start = _matmul_flags()
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} on {kind}")
    phase_build()

    gen = torch.Generator().manual_seed(0)
    log("[2] kernels against their plain versions on the card")
    ln = kernel_layer_norm(gen)
    ln_bwd = kernel_layer_norm_bwd(gen)
    fl = kernel_flash(gen)
    fl_bwd = kernel_flash_bwd(gen)
    dec = kernel_decode(gen)
    adam = kernel_adam(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.empty_cache()
    mt = kernel_multi_tensor_lamb(torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.empty_cache()
    lmh = kernel_lm_head(gen)
    torch.cuda.empty_cache()
    ffn = kernel_fused_ffn(gen)
    torch.cuda.empty_cache()
    opts = kernel_optimizers(torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.empty_cache()

    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    serve = phase_serve(model, rng)
    parity = phase_parity(model, rng)
    profile_lines, profiled = [], {}
    if args.profile:
        profiled.update(phase_profile_serving(model, rng, profile_lines))
    # the same weights with fused_ffn=True: the same requests (seed 0)
    fmodel = build_model("cuda", fused_ffn=True)
    fmodel.load_state_dict(model.state_dict())
    del model
    serve_f = phase_serve(fmodel, np.random.RandomState(0), tag="[3f]")
    parity_f = phase_parity(fmodel, rng, tag="[4f]")
    if args.profile:
        profiled.update(phase_profile_serving(fmodel, rng, profile_lines,
                                              "_ffn"))
    del fmodel
    torch.cuda.empty_cache()

    tmodel, topt, ttokens, ttargets, train = phase_train()
    if args.profile:
        profiled.update(phase_profile_train(tmodel, topt, ttokens, ttargets,
                                            profile_lines))
    del tmodel, topt
    torch.cuda.empty_cache()
    tmodel, topt, ttokens, ttargets, train_f = phase_train(True, "[5f]")
    if args.profile:
        profiled.update(phase_profile_train(tmodel, topt, ttokens, ttargets,
                                            profile_lines, "train_step_ffn"))
    log_fused_change("[5f] GPT-350M", train, train_f)
    del tmodel, topt
    torch.cuda.empty_cache()
    train_parity = phase_train_parity()
    train_parity_f32_head = phase_train_parity(fused_lm_head=False)
    train_parity_ffn = phase_train_parity(fused_ffn=True)
    torch.cuda.empty_cache()

    bmodel, bopt, btokens, blabels, bert = phase_bert_train()
    clip = phase_unscale_clip(bmodel)
    if args.profile:
        profiled.update(phase_profile_bert(bmodel, bopt, btokens, blabels,
                                           profile_lines))
    del bmodel, bopt
    torch.cuda.empty_cache()
    bmodel, bopt, btokens, blabels, bert_f = phase_bert_train(True, "[7f]")
    if args.profile:
        profiled.update(phase_profile_bert(bmodel, bopt, btokens, blabels,
                                           profile_lines,
                                           "bert_train_step_ffn"))
    log_fused_change("[7f] BERT-large O2", bert, bert_f)
    del bmodel, bopt
    torch.cuda.empty_cache()
    bert_parity = phase_bert_parity()
    bert_parity_ffn = phase_bert_parity(fused_ffn=True)
    skip = phase_dynamic_skip()
    torch.cuda.empty_cache()

    resnet = {}
    for level, tag in (("O1", "[9]"), ("O2", "[9b]")):
        trainer, batch, resnet[level] = phase_resnet(level, tag)
        if args.profile:
            profiled.update(_profile_programs(
                {f"resnet50_{level}_step": lambda: trainer.step(*batch)},
                profile_lines))
        if level == "O1":
            del trainer, batch
            torch.cuda.empty_cache()
    resnet_opts = phase_resnet_optimizers(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    resnet_baseline = phase_resnet_baseline()
    torch.cuda.empty_cache()
    resnet_parity = phase_resnet_parity(flags_at_start)
    if args.profile:
        with open(args.profile, "w") as f:
            f.write("\n".join(profile_lines) + "\n")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    both = collections.Counter(serve["launches"])
    for run in (serve_f, train, train_f, bert, bert_f, clip, resnet["O1"],
                resnet["O2"], resnet_baseline, *resnet_opts.values()):
        both.update(run["launches"])
    sources = {
        "layer_norm_fwd": ("apex_tpu_torch/csrc/layer_norm_fwd.cu",
                           "apex_tpu/ops/layer_norm.py:91", ln[TRAIN_ROWS]),
        "layer_norm_bwd": ("apex_tpu_torch/csrc/layer_norm_bwd.cu",
                           "apex_tpu/ops/layer_norm.py:102", ln_bwd),
        "flash_fwd": ("apex_tpu_torch/csrc/flash_fwd.cu",
                      "apex_tpu/ops/flash_attention.py:139",
                      fl["train_dropout_0.0"]),
        "flash_attention_dq": ("apex_tpu_torch/csrc/flash_bwd_dq.cu",
                               "apex_tpu/ops/flash_attention.py:238",
                               fl_bwd["dq"]),
        "flash_attention_dkv": ("apex_tpu_torch/csrc/flash_bwd_dkv.cu",
                                "apex_tpu/ops/flash_attention.py:282",
                                fl_bwd["dkv"]),
        "flash_attention_decode": ("apex_tpu_torch/csrc/flash_decode.cu",
                                   "apex_tpu/ops/flash_attention.py:586",
                                   dec),
        "multi_tensor_adam": ("apex_tpu_torch/csrc/multi_tensor_adam.cu",
                              "apex_tpu/ops/multi_tensor.py:214", adam),
        "multi_tensor_scale_": ("apex_tpu_torch/csrc/multi_tensor_scale.cu",
                                "apex_tpu/ops/multi_tensor.py:99",
                                mt["scale"]),
        "multi_tensor_sumsq": ("apex_tpu_torch/csrc/multi_tensor_l2norm.cu",
                               "apex_tpu/ops/multi_tensor.py:161",
                               mt["sumsq"]),
        "multi_tensor_lamb_stage1": ("apex_tpu_torch/csrc/multi_tensor_lamb.cu",
                                     "apex_tpu/ops/multi_tensor.py:352",
                                     mt["stage1"]),
        "multi_tensor_lamb_stage2": ("apex_tpu_torch/csrc/multi_tensor_lamb.cu",
                                     "apex_tpu/ops/multi_tensor.py:404",
                                     mt["stage2"]),
        "lm_head_fwd": ("apex_tpu_torch/csrc/lm_head_fwd.cu",
                        "apex_tpu/ops/lm_head.py:70", lmh["fwd_gpt"]),
        "lm_head_dx": ("apex_tpu_torch/csrc/lm_head_bwd.cu",
                       "apex_tpu/ops/lm_head.py:129", lmh["dx_gpt"]),
        "lm_head_dw": ("apex_tpu_torch/csrc/lm_head_bwd.cu",
                       "apex_tpu/ops/lm_head.py:157", lmh["dw_gpt"]),
        "ffn_fwd": ("apex_tpu_torch/csrc/ffn_fwd.cu",
                    "apex_tpu/ops/fused_ffn.py:110", ffn["fwd_gpt"]),
        "ffn_dx": ("apex_tpu_torch/csrc/ffn_bwd.cu",
                   "apex_tpu/ops/fused_ffn.py:137", ffn["dx_gpt"]),
        "ffn_dw": ("apex_tpu_torch/csrc/ffn_bwd.cu",
                   "apex_tpu/ops/fused_ffn.py:162", ffn["dw_gpt"]),
        "multi_tensor_axpby_": ("apex_tpu_torch/csrc/multi_tensor_axpby.cu",
                                "apex_tpu/ops/multi_tensor.py:131",
                                opts["axpby"]),
        "multi_tensor_sgd": ("apex_tpu_torch/csrc/multi_tensor_sgd.cu",
                             "apex_tpu/ops/multi_tensor.py:281", opts["sgd"]),
        "multi_tensor_adagrad": ("apex_tpu_torch/csrc/multi_tensor_adagrad.cu",
                                 "apex_tpu/ops/multi_tensor.py:446",
                                 opts["adagrad"]),
        "multi_tensor_novograd": (
            "apex_tpu_torch/csrc/multi_tensor_novograd.cu",
            "apex_tpu/ops/multi_tensor.py:499", opts["novograd"])}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=both[name], **{k: nums[k] for k in keys})
               for name, (src, rep, nums) in sources.items()]
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError("a kernel of the paths was never launched")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, layer_norm=ln,
                           layer_norm_bwd=ln_bwd, flash=fl, flash_bwd=fl_bwd,
                           decode=dec, adam=adam, multi_tensor=mt,
                           lm_head=lmh, fused_ffn=ffn, optimizers=opts,
                           serve=serve,
                           parity=parity, serve_ffn=serve_f,
                           parity_ffn=parity_f, train=train,
                           train_ffn=train_f, train_parity=train_parity,
                           train_parity_f32_head=train_parity_f32_head,
                           train_parity_ffn=train_parity_ffn, bert=bert,
                           bert_ffn=bert_f, unscale_clip=clip,
                           bert_parity=bert_parity,
                           bert_parity_ffn=bert_parity_ffn,
                           dynamic_skip=skip, resnet50=resnet,
                           resnet50_optimizers=resnet_opts,
                           resnet50_hand_written_sgd=resnet_baseline,
                           resnet_parity=resnet_parity,
                           profile=profiled or None, kernels=kernels), f,
                      indent=1, sort_keys=True)
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
