"""#15 (multi-tensor scale) of two checkouts, element by element, on one
card:

    python3 tools/scale_bitwise_torch.py dump TREE_A a.pt
    python3 tools/scale_bitwise_torch.py dump TREE_B b.pt
    python3 tools/scale_bitwise_torch.py diff a.pt b.pt

``dump`` runs ``TREE``'s kernel once per case over BERT-large's first
tensors (``chip_smoke.bert_param_specs``: the position and token-type
embeddings, the embedding LayerNorm and the first encoder layer, 16
tensors and 13.1M elements; the word embedding is left out) and saves the
outputs and the found-inf flag.  The cases are the nine (in, out) dtype
pairs of f32, bf16 and f16, by 0.37 (every rounding counts) and by 2**-10;
the inputs, from seed 2 (the same in every tree), spread over 2**-40 ..
2**40 so that outputs round, overflow their dtype and fall to subnormals
and zero, with inf, -inf and NaN placed in each tensor (the flag is 1 in
every case).  ``diff`` prints, per case, how many entries of the outputs
differ in their bits and whether the flags agree.
"""
import os
import sys

DTYPES = ("float32", "bfloat16", "float16")
SCALES = (0.37, 2.0 ** -10)


def dump(tree, path):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as c
    from apex_tpu_torch.ops import multi_tensor as K

    specs = [s for s, _ in c.bert_param_specs()[:17]]
    del specs[2]                      # the word embedding
    out = {}
    for idt in DTYPES:
        for odt in DTYPES:
            for sv in SCALES:
                gen = torch.Generator(device="cuda").manual_seed(2)
                xs = []
                for shape in specs:
                    x = torch.randn(shape, generator=gen, device="cuda")
                    x = x * torch.exp2(80 * torch.rand(
                        shape, generator=gen, device="cuda") - 40)
                    flat = x.view(-1)
                    for i, v in zip((0, 5, 2 * flat.numel() // 3),
                                    ("inf", "-inf", "nan")):
                        flat[min(i, flat.numel() - 1)] = float(v)
                    xs.append(x.to(getattr(torch, idt)))
                outs = [torch.empty_like(x, dtype=getattr(torch, odt))
                        for x in xs]
                flag = K.multi_tensor_scale_(
                    xs, outs, torch.full((), sv, device="cuda"))
                out[f"{idt}->{odt} x{sv}"] = dict(
                    outputs=torch.cat([o.view(-1).view(torch.uint8)
                                       for o in outs]).cpu(),
                    itemsize=outs[0].element_size(), flag=float(flag))
    torch.save(out, path)


def diff(path_a, path_b):
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    for key in a:
        size = a[key]["itemsize"]
        as_int = {4: torch.int32, 2: torch.int16}[size]
        x = a[key]["outputs"].view(as_int)
        y = b[key]["outputs"].view(as_int)
        print(f"DIFF {key}: {int((x != y).sum())} of {x.numel()} entries "
              f"differ; flags {a[key]['flag']} / {b[key]['flag']}",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(os.path.abspath(sys.argv[2]), os.path.abspath(sys.argv[3]))
    else:
        diff(*sys.argv[2:])
