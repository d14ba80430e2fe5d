#!/usr/bin/env python
"""Switch-GPT training with expert parallelism — port of
``examples/moe/train_switch_gpt.py`` (MoE is not in apex; the recipe
drives :mod:`apex_tpu_torch.transformer.expert_parallel` through the GPT
model).

The experts are sharded over the ``expert`` process group, which doubles
as the data group: each rank trains on its own rows of the global batch
(the Switch / GShard deployment).  Dense parameters stay replicated and
their gradients take the mean over the group; the expert stacks'
gradients are each rank's own (:func:`~apex_tpu_torch.transformer.
expert_parallel.reduce_moe_grads`).  One process is the plain serial form
(every expert on the card).  Under ``torchrun`` (``WORLD_SIZE`` in the
environment) every rank joins the group; ``--n-experts`` must be divisible
by the ranks.

The JAX example's flags and recipe (bf16 activations, f32 parameters,
``FusedAdam``, new random tokens from ``--seed`` each step, a warm-up step
before the timed ones; the FFN width and the aux-loss weight are
``GPTConfig``'s defaults), plus micro-batch accumulation (``--accum``: the
step is ``forward_backward_no_pipelining`` over that many micro-batches of
``--batch-per-device`` rows) and ``--device``.

    python -m apex_tpu_torch.examples.moe.train_switch_gpt --n-experts 8 \\
        --top-k 1 --steps 20

``main(argv)`` returns what it prints: losses, the aux losses, step times,
tokens/s and peak memory.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="apex_tpu_torch Switch-GPT")
    p.add_argument("--n-experts", type=int, default=8)
    p.add_argument("--top-k", type=int, default=1,
                   help="1 = Switch, 2 = GShard")
    p.add_argument("--capacity-factor", type=float, default=1.25)
    p.add_argument("--batch-per-device", type=int, default=4)
    p.add_argument("--accum", type=int, default=1,
                   help="micro-batches of --batch-per-device rows a step")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=32768)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--print-freq", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def init_expert_group(device, n_experts):
    """The ``expert`` group over every rank of ``torch.distributed``
    (joined here under torchrun), or one process.  Returns ``(device, ep,
    rank, owned)``."""
    import os
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state as ps
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        return device, 1, 0, False
    owned = not dist.is_initialized()
    if device.type == "cuda":
        index = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", torch.cuda.current_device()
                              if index is None else int(index))
        torch.cuda.set_device(device)
    if owned:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    ep = dist.get_world_size()
    if n_experts % ep:
        raise SystemExit(
            f"--n-experts must be divisible by the rank count ({ep})")
    ps.initialize_model_parallel(expert_parallel_size_=ep)
    return device, ep, ps.get_expert_parallel_rank(), owned


def build(args, device, ep):
    """The model (this rank's experts, weights from ``--seed``) and its
    FusedAdam."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_attention_heads=args.heads,
        max_seq_len=args.seq_len, dtype=torch.bfloat16,
        n_experts=args.n_experts, moe_top_k=args.top_k,
        moe_capacity_factor=args.capacity_factor,
        expert_axis="expert" if ep > 1 else None, expert_parallel_size=ep)
    model = GPTModel(cfg, device=device).init_params(
        torch.Generator().manual_seed(args.seed))
    return model, FusedAdam(model.parameters(), lr=args.lr)


def main(argv=None):
    args = parse_args(argv)
    from apex_tpu_torch.transformer.expert_parallel import reduce_moe_grads
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    from apex_tpu_torch.utils.device import resolve_device
    device, ep, rank, owned = init_expert_group(resolve_device(args.device),
                                                args.n_experts)
    model, opt = build(args, device, ep)
    rng = np.random.RandomState(args.seed)
    rows = ep * args.batch_per_device * args.accum

    def make_batch():
        # the global batch from the seed; this rank's rows of it
        tokens, targets = (torch.from_numpy(rng.randint(
            0, args.vocab, (rows, args.seq_len))) for _ in range(2))
        mine = slice(rank * rows // ep, (rank + 1) * rows // ep)
        return tuple(t[mine].reshape(args.accum, args.batch_per_device,
                                     args.seq_len).to(device)
                     for t in (tokens, targets))

    def step(tokens, targets):
        opt.zero_grad()
        aux = []

        def loss_fn(x, t):
            loss = model.loss(x, t)
            aux.append(model.moe_aux.detach())
            return loss
        loss = forward_backward_no_pipelining(lambda m, x: x, loss_fn,
                                              model, tokens, targets)
        if ep > 1:
            import torch.distributed as dist
            from apex_tpu_torch.transformer import parallel_state as ps
            reduce_moe_grads(model, "expert")
            dist.all_reduce(loss, group=ps.get_expert_parallel_group())
            loss = loss / ep
        opt.step()
        return loss, torch.stack(aux).mean()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, auxes, times = [], [], []
    try:
        warm, warm_aux = step(*make_batch())          # warm-up step
        sync()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        tokens_per_step = rows * args.seq_len
        for i in range(1, args.steps + 1):
            batch = make_batch()
            ts = time.perf_counter()
            loss, aux = step(*batch)
            sync()
            times.append(time.perf_counter() - ts)
            losses.append(float(loss))
            auxes.append(float(aux))
            if rank == 0 and (i % args.print_freq == 0 or i == args.steps):
                tok_s = i * tokens_per_step / (time.perf_counter() - t0)
                print(f"step {i:4d}  loss {losses[-1]:8.4f}  aux "
                      f"{auxes[-1]:.4f}  {tok_s:10.0f} tok/s", flush=True)
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else None)
        if rank == 0:
            print(f"DONE experts={args.n_experts} top_k={args.top_k} "
                  f"devices={ep} throughput="
                  f"{args.steps * tokens_per_step / dt:.0f} tok/s",
                  flush=True)
    finally:
        if owned:
            import torch.distributed as dist
            from apex_tpu_torch.transformer import parallel_state as ps
            ps.destroy_model_parallel()
            dist.destroy_process_group()
    return dict(n_experts=args.n_experts, top_k=args.top_k, devices=ep,
                rank=rank, warmup_loss=float(warm),
                warmup_aux=float(warm_aux), losses=losses, aux_losses=auxes,
                step_times_s=times,
                tokens_per_s=args.steps * rows * args.seq_len / dt,
                peak_memory_bytes=peak, device=str(device), model=model,
                optimizer=opt)


if __name__ == "__main__":
    main()
