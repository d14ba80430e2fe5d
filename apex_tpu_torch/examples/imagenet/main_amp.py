#!/usr/bin/env python
"""ImageNet training CLI — port of ``examples/imagenet/main_amp.py``
(apex's flagship example: ResNet + amp O0-O3 + optional FusedSGD + a data
prefetcher that stages the next batch while the current step runs).

* model      — :mod:`apex_tpu_torch.models.resnet` (NHWC input, bottleneck
               ResNet, batch norm with running stats in buffers)
* amp        — ``amp.initialize(model, optimizer, opt_level=O0|O1|O2|O3)``
               (O1 wraps ``forward`` in the per-op autocast, O2 casts the
               model to bf16 with f32 batch norm and f32 masters) +
               ``scale_loss`` / ``unscale_step``
* FusedSGD   — ``--fused-sgd`` (default; multi-tensor SGD kernel #19) or
               the hand-written momentum SGD of the reference
               (``--no-fused-sgd``; its parameter update is one
               multi-tensor axpby, kernel #16, and its overflow check the
               L2-norm pass, #17)
* prefetcher — a thread makes the next batch and stages it onto the device
               on a side stream, normalising it there (apex's
               ``data_prefetcher``)

Data is synthetic, made from ``--seed``: uint8 images of ImageNet's shape
and labels, normalised on the device with ImageNet's mean and std (apex's
prefetcher does this to its decoded uint8 batches).  One device, no data
parallelism (``devices=1``).

Run:  python -m apex_tpu_torch.examples.imagenet.main_amp --arch resnet50 \\
          --batch-size 256 --opt-level O1 --steps 100 [--device cpu]

``main(argv)`` returns what it prints (losses, step times, img/s, peak
device memory) and the trainer it ran.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

import numpy as np
import torch

MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="apex_tpu_torch imagenet + amp")
    p.add_argument("--arch", default="resnet50",
                   choices=["resnet50", "resnet18"])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--loss-scale", default=None,
                   help='None, a float, or "dynamic"')
    p.add_argument("--sync-bn", action="store_true",
                   help="apex convert_syncbn_model (one device: the local "
                        "statistics are the batch's)")
    p.add_argument("--no-fused-sgd", dest="fused_sgd", action="store_false")
    p.add_argument("--synthetic", action="store_true", default=True)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


class Prefetcher:
    """Host-side double buffering: a thread makes the next host batch and
    stages it onto the device (on a side CUDA stream, ending in an event
    the consumer waits on) while the device runs the current step."""

    def __init__(self, make_batch, put, depth=2):
        self.q = queue.Queue(maxsize=depth)
        self.make_batch, self.put = make_batch, put
        self.stop = threading.Event()
        self.error = None
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            while not self.stop.is_set():
                batch = self.put(*self.make_batch())
                while not self.stop.is_set():
                    try:
                        self.q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:          # surface in next(), don't hang
            self.error = e
            self.stop.set()

    def next(self):
        while True:
            try:
                x, y, ready = self.q.get(timeout=0.5)
            except queue.Empty:
                if self.error is not None:
                    raise RuntimeError("prefetcher worker died") \
                        from self.error
                continue
            if ready is not None:            # the staging copy's event
                stream = torch.cuda.current_stream(x.device)
                stream.wait_event(ready)
                x.record_stream(stream)
                y.record_stream(stream)
            return x, y

    def close(self):
        self.stop.set()
        while not self.q.empty():
            self.q.get_nowait()
        self.thread.join(timeout=2)


class Trainer:
    """The model, its optimizer (``None``: the hand-written SGD) and amp
    state, and one training step on a device batch."""

    def __init__(self, args, device):
        from apex_tpu_torch import amp
        from apex_tpu_torch.models.resnet import resnet18, resnet50
        from apex_tpu_torch.optimizers import FusedSGD
        from apex_tpu_torch.parallel import convert_syncbn_model

        self.args, self.device = args, device
        half = torch.bfloat16
        compute = half if args.opt_level in ("O2", "O3") else torch.float32
        make = resnet50 if args.arch == "resnet50" else resnet18
        model = make(device=device, num_classes=args.num_classes,
                     dtype=compute).init_params(
            torch.Generator().manual_seed(args.seed))
        if args.sync_bn:
            model = convert_syncbn_model(model)
        opt = (FusedSGD(model.parameters(), lr=args.lr,
                        momentum=args.momentum,
                        weight_decay=args.weight_decay,
                        master_weights=args.opt_level == "O2")
               if args.fused_sgd else None)
        loss_scale = args.loss_scale
        if isinstance(loss_scale, str):
            if loss_scale in ("None", "none"):
                loss_scale = None
            elif loss_scale != "dynamic":
                loss_scale = float(loss_scale)
        self.amp = amp.initialize(model, opt, opt_level=args.opt_level,
                                  loss_scale=loss_scale, device=device)
        self.model, self.optimizer = model, opt
        self.scaler = self.amp.scaler
        # the hand-written baseline keeps f32 momentum whatever the
        # parameter dtype (the update runs in f32)
        self.momentum = (None if opt is not None else
                         [torch.zeros_like(p, dtype=torch.float32)
                          for p in model.parameters()])

    def step(self, x, y):
        """One step: loss (f32, unscaled) of the batch, backward of the
        scaled loss, then FusedSGD through ``amp.unscale_step`` or the
        hand-written SGD (skipped on overflow, on the device)."""
        from apex_tpu_torch import amp
        from apex_tpu_torch.multi_tensor_apply import multi_tensor_axpby
        model, scaler = self.model, self.scaler
        for p in model.parameters():
            p.grad = None
        loss = model.loss(x, y)
        amp.scale_loss(loss, scaler).backward()
        if self.optimizer is not None:
            amp.unscale_step(self.optimizer, scaler)
            return loss.detach()
        args = self.args
        with torch.no_grad():
            params = list(model.parameters())
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            inv = 1.0 / scaler.loss_scale
            finf = amp.LossScaler.found_inf(grads)
            keep = 1.0 - finf             # 0 on overflow: skip the update
            for g, m in zip(grads, self.momentum):
                m.copy_(torch.where(finf > 0, m,
                                    args.momentum * m + g.float() * inv))
            # p - keep lr (m + wd p) = (1 - keep lr wd) p + (-keep lr) m,
            # in f32, one multi-tensor axpby (kernel #16) into p's dtype
            multi_tensor_axpby(1.0 - keep * (args.lr * args.weight_decay),
                               params, -keep * args.lr, self.momentum,
                               out=params)
            scaler.update(finf)
        return loss.detach()


def make_data(args, device):
    """The batch maker and the device stager of the prefetcher: uint8 NHWC
    images and int64 labels from ``--seed`` on the host; on the device
    (on a side stream where it is a card) the images as f32, normalised
    with ImageNet's mean and std."""
    rng = np.random.default_rng(args.seed)
    shape = (args.batch_size, args.image_size, args.image_size, 3)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def make_batch():
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
        y = torch.from_numpy(rng.integers(0, args.num_classes,
                                          args.batch_size))
        return (x.pin_memory(), y.pin_memory()) if cuda else (x, y)

    def put(x, y):
        if not cuda:
            return (x.float() - mean) / std, y, None
        with torch.cuda.stream(side):
            xd = x.to(device, non_blocking=True).float().sub_(mean).div_(std)
            yd = y.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return xd, yd, ready

    return make_batch, put


def main(argv=None):
    args = parse_args(argv)
    from apex_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    trainer = Trainer(args, device)
    make_batch, put = make_data(args, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    pre = Prefetcher(make_batch, put)
    losses, times = [], []
    try:
        x, y = pre.next()                    # warm-up step
        warm = trainer.step(x, y)
        sync()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        seen = 0
        for step in range(1, args.steps + 1):
            ts = time.perf_counter()
            x, y = pre.next()
            loss = trainer.step(x, y)
            sync()
            times.append(time.perf_counter() - ts)
            losses.append(float(loss))
            seen += args.batch_size
            if step % args.print_freq == 0 or step == args.steps:
                dt = time.perf_counter() - t0
                print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                      f"{seen / dt:9.1f} img/s  "
                      f"scale {float(trainer.scaler.loss_scale):.0f}",
                      flush=True)
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
        print(f"DONE arch={args.arch} opt_level={args.opt_level} devices=1 "
              f"throughput={seen / dt:.1f} img/s", flush=True)
    finally:
        pre.close()
    return dict(arch=args.arch, opt_level=args.opt_level,
                batch_size=args.batch_size, image_size=args.image_size,
                warmup_loss=float(warm), losses=losses, step_times_s=times,
                images_per_s=seen / dt, peak_memory_bytes=peak,
                device=str(device), devices=1, trainer=trainer, batch=(x, y))


if __name__ == "__main__":
    main()
