"""#20 (LAMB stage 1) of two checkouts, element by element, on one card:

    python3 tools/lamb_bitwise_torch.py dump TREE_A a.pt
    python3 tools/lamb_bitwise_torch.py dump TREE_B b.pt
    python3 tools/lamb_bitwise_torch.py diff a.pt b.pt [samples.json]

``dump`` runs ``TREE``'s kernel once per case on BERT-large's O2 tensors
of at most 4,194,304 elements among its first 40 (one encoder layer and
the embedding's LayerNorm: bf16 gradients with f32 masters, and f32
LayerNorm tensors; ``chip_smoke.bert_param_specs``; inputs from seed 2,
the same in every tree) and saves the inputs and the new u, m and v.  The
cases cover AdamW and classic Adam (L2 folded into the gradient), clip
and a grad scale that make every rounding count (0.37, 0.5), grad
averaging off (beta3 = 1) and noop.  ``diff`` prints, per case, how many
entries of u, m and v differ in their bits, and writes up to 500
differing entries of each (inputs, both outputs) to ``samples.json`` for
an emulation of candidate roundings.
"""
import json
import os
import sys

B1, B2, STEP = 0.9, 0.999, 3
# name: (grad_scale, clip, beta3, adam_w_mode, noop)
CASES = {"adamw": (0.37, 0.5, 1 - B1, True, 0),
         "adam_l2": (0.37, 0.5, 1 - B1, False, 0),
         "adamw_no_grad_averaging": (0.37, 1.0, 1.0, True, 0),
         "adamw_noop": (0.37, 0.5, 1 - B1, True, 1)}


def dump(tree, path):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as c
    from apex_tpu_torch.ops import multi_tensor as K

    specs = [(s, dt) for s, dt in c.bert_param_specs()[:40]
             if torch.Size(s).numel() <= 4194304]

    def cat(tensors):
        return torch.cat([t.flatten().float() for t in tensors]).cpu()

    out = {}
    for case, (gscale, clip, beta3, w_mode, noop_v) in CASES.items():
        gen = torch.Generator(device="cuda").manual_seed(2)

        def rand(shape, std):
            return torch.randn(shape, generator=gen, device="cuda") * std
        gs = [rand(s, 1e-3).to(dt) for s, dt in specs]
        ps = [rand(s, 0.02).to(dt).float() for s, dt in specs]
        ms = [rand(s, 1e-4) for s, _ in specs]
        vs = [rand(s, 1e-8).abs() for s, _ in specs]
        us = [torch.empty_like(p) for p in ps]
        inputs = (cat(gs), cat(ps), cat(ms), cat(vs))
        scal = [B1, B2, 1e-6, 0.01, 1 - B1 ** STEP, 1 - B2 ** STEP, gscale,
                clip, beta3]
        K.multi_tensor_lamb_stage1(
            gs, ps, ms, vs, us, torch.tensor(scal, device="cuda"),
            torch.tensor(noop_v, dtype=torch.int32, device="cuda"), w_mode)
        out[case] = dict(outputs=(cat(us), cat(ms), cat(vs)), inputs=inputs,
                         scal=scal, adam_w_mode=w_mode)
    torch.save(out, path)


def diff(path_a, path_b, samples_path=None):
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    samples = {}
    for key in a:
        row = []
        g, p, m, v = a[key]["inputs"]
        for name, x, y in zip(("u", "m", "v"), a[key]["outputs"],
                              b[key]["outputs"]):
            differ = x.view(torch.int32) != y.view(torch.int32)
            row.append(f"{name} {int(differ.sum())} of {x.numel()}")
            if differ.any():
                idx = differ.nonzero().flatten()[:500]
                samples[f"{key}/{name}"] = dict(
                    scal=a[key]["scal"], adam_w_mode=a[key]["adam_w_mode"],
                    g=g[idx].tolist(), p=p[idx].tolist(), m=m[idx].tolist(),
                    v=v[idx].tolist(), a=x[idx].tolist(), b=y[idx].tolist())
        print("DIFF", key, ", ".join(row), flush=True)
    if samples_path:
        with open(samples_path, "w") as f:
            json.dump(samples, f)


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(os.path.abspath(sys.argv[2]), os.path.abspath(sys.argv[3]))
    else:
        diff(*sys.argv[2:])
