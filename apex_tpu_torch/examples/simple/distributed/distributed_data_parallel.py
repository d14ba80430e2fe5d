#!/usr/bin/env python
"""Minimal DDP example — port of
``examples/simple/distributed/distributed_data_parallel.py`` (apex's
``init_process_group``, a toy model wrapped in DDP, random data).

Each rank runs the model on its rows of the global batch
(``DistributedDataParallel.scatter``); the wrapper's hooks average the
gradients over the ranks during the backward, then a plain SGD step.
Under ``torchrun`` (``WORLD_SIZE`` in the environment) the ranks use NCCL
on the card or gloo with ``--device cpu``; one process runs alone:

    torchrun --nproc-per-node 2 -m \\
        apex_tpu_torch.examples.simple.distributed.distributed_data_parallel
    python -m apex_tpu_torch.examples.simple.distributed.\\
        distributed_data_parallel --device cpu

``main(argv)`` returns the printed losses and the world size.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    owned = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if owned:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    gen = torch.Generator().manual_seed(0)
    model = nn.Sequential(nn.Linear(16, 32), nn.Tanh(), nn.Linear(32, 4))
    with torch.no_grad():
        for prm in model.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.1)
    ddp = DistributedDataParallel(model.to(device))
    world = ddp.world_size
    rng = np.random.RandomState(0)
    losses = []
    for step in range(args.steps):
        x = torch.from_numpy(rng.randn(8 * world, 16).astype(np.float32))
        y = torch.from_numpy(rng.randn(8 * world, 4).astype(np.float32))
        xs, ys = (t.to(device) for t in ddp.scatter((x, y)))
        for prm in ddp.parameters():
            prm.grad = None
        loss = torch.mean((ddp(xs) - ys) ** 2)
        loss.backward()                       # the DDP hooks reduce here
        with torch.no_grad():
            for prm in ddp.parameters():
                prm.sub_(0.05 * prm.grad)
        losses.append(float(loss.detach()))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {losses[-1]:.5f}")
    print(f"DONE devices={world}")
    if owned:
        dist.destroy_process_group()
    return dict(losses=losses, devices=world)


if __name__ == "__main__":
    main()
