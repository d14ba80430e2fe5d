"""#19 (multi-tensor SGD) of two checkouts, element by element, on one card:

    python3 tools/sgd_bitwise_torch.py dump TREE_A a.pt
    python3 tools/sgd_bitwise_torch.py dump TREE_B b.pt
    python3 tools/sgd_bitwise_torch.py diff a.pt b.pt [samples.json]

``dump`` runs ``TREE``'s kernel once per case on ResNet-50's O1 and O2
parameter lists (``chip_smoke.resnet50_specs``; inputs from seed 2, the
same in every tree) and saves the inputs and the new parameters, momentum
buffers and model copies.  The cases cover the flags (nesterov, first_run,
wd_after_momentum, momentum_zero) and a grad scale and dampening that
make every rounding count (0.37, 0.1; a scale of 0.5 is exact).  ``diff``
prints, per case, how many entries of each output differ in their bits,
and writes up to 500 differing entries of each (inputs, both outputs) to
``samples.json`` for an emulation of candidate roundings.
"""
import json
import os
import sys

CASES = {
    "default_gs0.5": ([0.1, 1e-4, 0.9, 0.0, 0.5], {}),
    "default_gs0.37_damp0.1": ([0.1, 3e-4, 0.9, 0.1, 0.37], {}),
    "nesterov": ([0.1, 3e-4, 0.9, 0.0, 0.37], dict(nesterov=True)),
    "wd_after": ([0.1, 3e-4, 0.9, 0.1, 0.37],
                 dict(wd_after_momentum=True)),
    "nesterov_wd_after": ([0.1, 3e-4, 0.9, 0.0, 0.37],
                          dict(nesterov=True, wd_after_momentum=True)),
    "first_run": ([0.1, 3e-4, 0.9, 0.1, 0.37], dict(first_run=True)),
    "momentum_zero": ([0.1, 3e-4, 0.0, 0.0, 0.37],
                      dict(momentum_zero=True)),
    "momentum_zero_wd_after": ([0.1, 3e-4, 0.0, 0.0, 0.37],
                               dict(momentum_zero=True,
                                    wd_after_momentum=True))}


def dump(tree, path):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as c
    from apex_tpu_torch.ops import multi_tensor as K

    def cat(tensors):
        flat = [t.flatten().float() for t in tensors if t is not None]
        return torch.cat(flat or [torch.zeros(0, device="cuda")]).cpu()

    out = {}
    for level in ("O1", "O2"):
        specs = c.resnet50_specs(level)
        for case, (scal, flags) in CASES.items():
            gen = torch.Generator(device="cuda").manual_seed(2)

            def rand(shape, std):
                return torch.randn(shape, generator=gen, device="cuda") * std
            gs = [rand(s, 1e-3).to(dt) for s, dt in specs]
            ps = [rand(s, 0.05).to(dt).float() for s, dt in specs]
            cs = [None if dt == torch.float32 else p.to(dt)
                  for p, (_, dt) in zip(ps, specs)]
            bs = [rand(s, 1e-3) for s, _ in specs]
            inputs = (cat(gs), cat(ps), cat(bs))
            K.multi_tensor_sgd(gs, ps, bs, cs,
                               torch.tensor(scal, device="cuda"),
                               torch.tensor(0, dtype=torch.int32,
                                            device="cuda"), **flags)
            out[f"{level}_{case}"] = dict(outputs=(cat(ps), cat(bs), cat(cs)),
                                          inputs=inputs, scal=scal,
                                          flags=flags)
    torch.save(out, path)


def diff(path_a, path_b, samples_path=None):
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    samples = {}
    for key in a:
        row = []
        g, p, buf = a[key]["inputs"]
        for name, x, y in zip(("p", "buf", "copy"), a[key]["outputs"],
                              b[key]["outputs"]):
            differ = x.view(torch.int32) != y.view(torch.int32)
            row.append(f"{name} {int(differ.sum())}")
            if name != "copy" and differ.any():
                idx = differ.nonzero().flatten()[:500]
                samples[f"{key}/{name}"] = dict(
                    scal=a[key]["scal"], flags=a[key]["flags"],
                    g=g[idx].tolist(), p=p[idx].tolist(),
                    buf=buf[idx].tolist(), a=x[idx].tolist(),
                    b=y[idx].tolist())
        print("DIFF", key, ", ".join(row), flush=True)
    if samples_path:
        with open(samples_path, "w") as f:
            json.dump(samples, f)


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(os.path.abspath(sys.argv[2]), os.path.abspath(sys.argv[3]))
    else:
        diff(*sys.argv[2:])
