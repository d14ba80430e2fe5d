"""Why phase 16p of ``chip_smoke.py`` holds its small MoE model card
against CPU in f32, with the experts' ``w1`` gradient in norm: one
training step's gradients of the small Switch / GShard GPT
(``chip_smoke.PARITY_MOE``) on the card and on a CPU copy, with every
gate call's routing and every expert ReLU's input recorded on both sides.

    python3 tools/moe_parity_torch.py [--dtype float32|bfloat16]

Per ``top_k`` it prints the token-choices routed to another expert on
the card than on the CPU, the ReLU inputs that changed sign (and the
largest of them), and the worst gradients, entry by entry (of the
tensor's largest entry) and in norm.  On the card, kernels built first.
"""
import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.transformer import expert_parallel as ep
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    c.phase_build()
    seen = collections.defaultdict(list)
    top_k_by_index, relu = ep.top_k_by_index, torch.relu

    def routes(probs, k):
        out = top_k_by_index(probs, k)
        seen["route", probs.device.type].append(out[1].cpu())
        return out

    def kink(z):
        seen["relu", z.device.type].append(z.detach().float().cpu())
        return relu(z)
    ep.top_k_by_index, torch.relu = routes, kink
    try:
        for top_k in (1, 2):
            seen.clear()
            cfg = GPTConfig(**dict(c.PARITY_MOE,
                                   dtype=getattr(torch, args.dtype)),
                            moe_top_k=top_k)
            card = GPTModel(cfg, device="cuda").init_params(
                torch.Generator().manual_seed(1))
            cpu = GPTModel(cfg, device="cpu")
            cpu.load_state_dict(card.state_dict())
            rng = np.random.RandomState(2)
            shape = (2, 2, cfg.max_seq_len)
            tokens, targets = (torch.from_numpy(rng.randint(
                0, cfg.vocab_size, shape)) for _ in range(2))
            grads = {}
            for name, model in (("card", card), ("cpu", cpu)):
                dev = next(model.parameters()).device
                forward_backward_no_pipelining(
                    lambda m, x: x,
                    lambda x, t, m=model: m.loss(x, t, dropout_seed=3),
                    model, tokens.to(dev), targets.to(dev))
                grads[name] = {n: p.grad.float().cpu()
                               for n, p in model.named_parameters()}
            moved = sum(int((a != b).any(-1).sum()) for a, b in zip(
                seen["route", "cuda"], seen["route", "cpu"]))
            flips = [((a > 0) != (b > 0), b) for a, b in zip(
                seen["relu", "cuda"], seen["relu", "cpu"])]
            n_flips = sum(int(f.sum()) for f, _ in flips)
            largest = max((float(b[f].abs().max()) for f, b in flips
                           if f.any()), default=0.0)
            g, r = grads["card"], grads["cpu"]
            entry = {n: float((g[n] - r[n]).abs().max() / r[n].abs().max())
                     for n in r}
            norm = {n: float((g[n] - r[n]).norm() / r[n].norm()) for n in r}
            worst = sorted(entry, key=entry.get, reverse=True)[:3]
            c.log(f"{args.dtype} top-{top_k}: {moved} token-choices routed "
                  f"elsewhere over {len(seen['route', 'cpu'])} gate calls; "
                  f"{n_flips} ReLU inputs changed sign (largest |z| "
                  f"{largest:.3e}); worst gradients entry by entry / in norm "
                  + ", ".join(f"{n} {entry[n]:.3e} / {norm[n]:.3e}"
                              for n in worst))
    finally:
        ep.top_k_by_index, torch.relu = top_k_by_index, relu
    return 0


if __name__ == "__main__":
    sys.exit(main())
