#!/usr/bin/env python
"""Conformer RNN-T training recipe — port of ``examples/conformer/train_rnnt.py``
(the "Conformer RNN-T: apex.contrib.transducer + fused multihead
attention" workload).

Every block is a port surface:

* encoder   — a stem (4 frames stacked, a linear and ReLU: T -> T/4), then
              per layer a half feed-forward (``FusedLayerNorm``, SiLU), self
              attention by ``contrib.multihead_attn.SelfMultiheadAttn``
              (``include_norm_add=True``: #1 / #2 and the flash kernels #3,
              #4, #5 on the card), a conv module (LayerNorm, pointwise to 2H,
              GLU, depthwise kernel-5 ``F.conv1d(groups=H)``, SiLU,
              pointwise) and a second half feed-forward;
* predictor — ``RNN.LSTM`` over the blank-prepended targets;
* joint     — ``contrib.transducer.TransducerJoint(relu=True)``, a linear
              to V + 1 and ``log_softmax``;
* loss      — ``contrib.transducer.TransducerLoss`` (the lattice);
* optimizer — ``FusedNovoGrad`` (#17's per-tensor sums, #23).

The JAX example's flags and defaults plus ``--device`` (default the
card).  The encoder, joint and output matrices keep the JAX ``x @ W``
orientation (``(in, out)`` parameters); weights are drawn from
``--seed`` with the JAX example's scales, and
:func:`apex_tpu_torch.convert.conformer_params_from_jax` carries a JAX
parameter tree.  Synthetic log-mel features and token targets from
``np.random.RandomState(--seed)``, drawn as the JAX example draws them; a
warm-up step, then ``--steps`` timed ones.

Run:  python -m apex_tpu_torch.examples.conformer.train_rnnt --steps 20 \\
          [--device cpu]

``main(argv)`` returns what it prints (losses, step times, utterances/s),
the peak device memory of the timed steps above what was allocated when
``main`` began (the weights, the optimizer's state and the activations,
whatever the caller holds) and the trainer it ran.
"""

from __future__ import annotations

import argparse
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
from apex_tpu_torch.contrib.transducer import TransducerJoint, TransducerLoss
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.optimizers import FusedNovoGrad
from apex_tpu_torch.RNN import LSTM
from apex_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="apex_tpu_torch conformer RNN-T")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--audio-len", type=int, default=200,
                   help="input frames (subsampled 4x by the stem)")
    p.add_argument("--target-len", type=int, default=20)
    p.add_argument("--n-mels", type=int, default=80)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--pred-hidden", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--print-freq", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def _param(device, *shape):
    return nn.Parameter(torch.zeros(shape, device=device))


class FeedForward(nn.Module):
    """``x + 0.5 * silu(ln(x) @ w1) @ w2``."""

    def __init__(self, h, device):
        super().__init__()
        self.w1, self.w2 = _param(device, h, 4 * h), _param(device, 4 * h, h)
        self.ln = FusedLayerNorm(h, device=device)

    def forward(self, x):
        return x + 0.5 * (F.silu(self.ln(x) @ self.w1) @ self.w2)


class ConvModule(nn.Module):
    """``x + silu(depthwise5(glu(ln(x) @ pw1))) @ pw2``."""

    def __init__(self, h, device):
        super().__init__()
        self.pw1 = _param(device, h, 2 * h)
        self.dw = _param(device, 5, h)          # (K, H): the JAX WIO kernel
        self.pw2 = _param(device, h, h)
        self.ln = FusedLayerNorm(h, device=device)

    def forward(self, x):
        a, b = (self.ln(x) @ self.pw1).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)                             # GLU
        # one depthwise conv over time, "SAME" padding: (B, H, T) layout
        h = F.conv1d(h.transpose(1, 2), self.dw.t()[:, None, :],
                     padding=self.dw.shape[0] // 2, groups=h.shape[-1])
        return x + F.silu(h.transpose(1, 2)) @ self.pw2


class ConformerLayer(nn.Module):
    def __init__(self, h, heads, device):
        super().__init__()
        self.ff1 = FeedForward(h, device)
        self.attn = SelfMultiheadAttn(h, heads, include_norm_add=True,
                                      device=device)
        self.conv = ConvModule(h, device)
        self.ff2 = FeedForward(h, device)

    def forward(self, x):
        x = self.ff1(x)
        # (seq, batch, hidden) with the fused residual + LN
        x = self.attn(x.transpose(0, 1), is_training=False).transpose(0, 1)
        return self.ff2(self.conv(x))


class ConformerRNNT(nn.Module):
    """The JAX example's model; parameter names are its tree's paths."""

    def __init__(self, args, device=None):
        super().__init__()
        dev = resolve_device(device)
        # an f32 recipe: full-precision f32 products and convolutions, as
        # the JAX example's f32 dots, not TF32's ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h, v = args.hidden, args.vocab
        self.stem1 = _param(dev, 4 * args.n_mels, h)
        self.stem_b1 = _param(dev, h)
        self.layers = nn.ModuleList(ConformerLayer(h, args.heads, dev)
                                    for _ in range(args.layers))
        self.pred_embed = _param(dev, v, h)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            self.predictor = LSTM(h, args.pred_hidden, device=dev)
        self.enc_proj = _param(dev, h, h)
        self.pred_proj = _param(dev, args.pred_hidden, h)
        self.out_proj = _param(dev, h, v + 1)
        self.out_b = _param(dev, v + 1)
        self.joint = TransducerJoint(relu=True)
        self.loss_mod = TransducerLoss()

    def init_params(self, generator=None):
        """The JAX example's scales: ``n_in ** -0.5 * N(0, 1)`` matrices,
        ``0.1 * N(0, 1)`` depthwise kernels, zero biases, LayerNorms at 1
        and 0, the attention's and the LSTM's own inits; returns the
        module."""
        def winit(p, scale=None):
            s = p.shape[0] ** -0.5 if scale is None else scale
            p.copy_(s * torch.randn(p.shape, generator=generator))
        with torch.no_grad():
            for p in (self.stem1, self.pred_embed, self.enc_proj,
                      self.pred_proj, self.out_proj):
                winit(p)
            self.stem_b1.zero_()
            self.out_b.zero_()
            for layer in self.layers:
                for ff in (layer.ff1, layer.ff2):
                    winit(ff.w1)
                    winit(ff.w2)
                winit(layer.conv.pw1)
                winit(layer.conv.dw, 0.1)
                winit(layer.conv.pw2)
                layer.attn.init_params(generator)
            self.predictor.init_params(generator)
        return self

    def encoder(self, feats):
        b, t, m = feats.shape
        t4 = t // 4
        x = feats[:, :t4 * 4].reshape(b, t4, 4 * m)
        x = torch.relu(x @ self.stem1 + self.stem_b1)
        for layer in self.layers:
            x = layer(x)
        return x                                       # (B, T/4, H)

    def loss(self, feats, labels, f_len, y_len):
        enc = self.encoder(feats)                      # (B, T', H)
        # the predictor reads the blank-prepended targets, time-major
        tokens = F.pad(labels, (1, 0))                 # (B, U+1)
        pred, _ = self.predictor(self.pred_embed[tokens].transpose(0, 1))
        f = enc @ self.enc_proj
        g = pred.transpose(0, 1) @ self.pred_proj
        h = self.joint(f, g)                           # (B, T', U+1, H)
        logp = torch.log_softmax(h @ self.out_proj + self.out_b, dim=-1)
        return self.loss_mod(logp, labels, f_len, y_len, blank_idx=0).mean()


class Trainer:
    """One step: the loss, its backward, ``FusedNovoGrad.step``."""

    def __init__(self, model, optimizer):
        self.model, self.optimizer = model, optimizer

    def step(self, feats, labels, f_len, y_len):
        self.optimizer.zero_grad()
        loss = self.model.loss(feats, labels, f_len, y_len)
        loss.backward()
        self.optimizer.step()
        return loss.detach()


def batches(args, device):
    """``make_batch()`` drawing from ``RandomState(--seed)`` as the JAX
    example does: features, labels, frame and label lengths."""
    rng = np.random.RandomState(args.seed)
    t4 = args.audio_len // 4

    def make_batch():
        feats = rng.randn(args.batch_size, args.audio_len,
                          args.n_mels).astype(np.float32)
        labels = rng.randint(1, args.vocab, (args.batch_size,
                                             args.target_len))
        f_len = rng.randint(t4 // 2, t4 + 1, (args.batch_size,))
        y_len = rng.randint(args.target_len // 2, args.target_len + 1,
                            (args.batch_size,))
        return tuple(torch.from_numpy(np.asarray(a)).to(device)
                     for a in (feats, labels, f_len, y_len))
    return make_batch


def build(args, device):
    """The model (weights from ``--seed``) and its trainer."""
    model = ConformerRNNT(args, device).init_params(
        torch.Generator().manual_seed(args.seed))
    return Trainer(model, FusedNovoGrad(model.parameters(), lr=args.lr))


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    # the recipe's memory is what it allocates above what its caller holds
    base = (torch.cuda.memory_allocated(device) if device.type == "cuda"
            else None)
    trainer = build(args, device)
    make_batch = batches(args, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    warm = trainer.step(*make_batch())                 # warm-up step
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, times = [], []
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        batch = make_batch()
        ts = time.perf_counter()
        loss = trainer.step(*batch)
        sync()
        times.append(time.perf_counter() - ts)
        losses.append(float(loss))
        if step % args.print_freq == 0 or step == args.steps:
            print(f"step {step:4d}  rnnt_loss {losses[-1]:9.4f}  "
                  f"{step * args.batch_size / (time.perf_counter() - t0):6.1f}"
                  " utt/s", flush=True)
    dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) - base
            if device.type == "cuda" else None)
    print(f"DONE layers={args.layers} hidden={args.hidden} "
          f"throughput={args.steps * args.batch_size / dt:.1f} utt/s",
          flush=True)
    return dict(layers=args.layers, hidden=args.hidden,
                warmup_loss=float(warm), losses=losses, step_times_s=times,
                utterances_per_s=args.steps * args.batch_size / dt,
                peak_memory_bytes=peak, device=str(device), trainer=trainer,
                batch=batch)


if __name__ == "__main__":
    main()
