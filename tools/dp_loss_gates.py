"""The readings behind the loss gates of ``chip_smoke.py``'s phase 14: at
one rank, the largest relative gap between a data-parallel run's losses
and its single-process recipe's (phases 7, 5 and 9), beside the gap that a
planted fault opens, so that each gate can sit between the two:

    python3 tools/dp_loss_gates.py [--device cuda|cpu] [--out results.json]

On the card (the default) the recipes run at phase 14's full width with
the kernels built from this checkout; ``--device cpu`` runs them at a
small size (2 layers, narrow widths, ResNet-18 at 64 x 64 and lr 0.01,
where lr 0.1 diverges) on the plain versions.  Every run is a process group of one through a ``file://`` store
under ``build/dp_loss_gates/``, as phase 14 is on one card:

* ``bert``: BERT O2 + FusedLAMB, per parameter (phase 7), against
  DistributedFusedLAMB on the packed buckets (14a);
* ``gpt``: GPT + FusedAdam (phase 5) against DistributedFusedAdam (14b);
* ``resnet``: the ImageNet example at O1 in one process (phase 9), and
  ``chip_smoke.resnet_group_path_reference`` (one process, ``--sync-bn``
  on the group path, no DDP: 14c's reference; twice, for the spread of
  two equal runs), against ``--sync-bn`` under DDP (14c).

Faults, what one rank can show (its collectives are copies, so a wrong
average or cross-rank sum changes nothing there; the gloo tests hold
those against the JAX package at 2 and 4 ranks):

* ``zero_skip`` (bert, gpt): the ZeRO step leaves its smallest bucket
  unupdated;
* ``ddp_drop`` (resnet): DDP loses its smallest bucket's reduced gradient
  (zeros in its place).

The last line is one JSON object: per recipe, the losses of each run and
each run's largest relative gap to the single-process losses (ResNet: the
warm-up loss, before any update, separately).
"""
import argparse
import contextlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

SMALL_BERT = dict(vocab_size=512, hidden_size=64, num_layers=2,
                  num_attention_heads=4, ffn_hidden_size=256,
                  max_seq_len=64, type_vocab_size=2)
SMALL_GPT = dict(vocab_size=512, hidden_size=64, num_layers=2,
                 num_attention_heads=4, ffn_hidden_size=256, max_seq_len=64)
SMALL_RESNET_ARGV = ["--device", "cpu", "--arch", "resnet18",
                     "--batch-size", "8", "--image-size", "64",
                     "--num-classes", "10", "--steps", "4", "--print-freq",
                     "4", "--seed", "0", "--lr", "0.01", "--momentum", "0.9",
                     "--weight-decay", "1e-4"]


def _gap(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _skip_smallest(cls):
    """``cls`` whose step leaves the bucket of fewest rows unupdated."""
    class Skip(cls):
        def _update_bucket(self, info, *args, **kw):
            smallest = min(self._layout().buckets, key=lambda b: b.meta.nrows)
            if info.key != smallest.key:
                super()._update_bucket(info, *args, **kw)
    return Skip


@contextlib.contextmanager
def _ddp_drops_smallest():
    """DDP loses its smallest bucket's reduced gradient (zeros)."""
    from apex_tpu_torch.parallel import DistributedDataParallel as DDP
    orig = DDP._reduce_bucket

    def drop(self, bucket):
        if bucket is min(self._buckets, key=lambda b: b.meta.nrows):
            for p in bucket.params:
                p.grad = torch.zeros_like(p)
            bucket.done = True
            return
        orig(self, bucket)
    DDP._reduce_bucket = drop
    try:
        yield
    finally:
        DDP._reduce_bucket = orig


def bert_runs(device, full):
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.bert import BertConfig, BertModel
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.parallel import DistributedFusedLAMB
    cfg = c.BERT_LARGE if full else SMALL_BERT
    shape = ((c.BERT_ACCUM, c.BERT_MICRO, c.BERT_SEQ) if full
             else (2, 4, 32))
    tokens, labels = (t.to(device) for t in c.mlm_batch(
        cfg["vocab_size"], shape, 0))
    out = {}
    for name, cls in (("single", FusedLAMB), ("zero", DistributedFusedLAMB),
                      ("zero_skip", _skip_smallest(DistributedFusedLAMB))):
        model = BertModel(BertConfig(**cfg, dtype=torch.bfloat16),
                          device=device).init_params(
            torch.Generator().manual_seed(0))
        opt = cls(model.parameters(), lr=c.BERT_LR, betas=c.LAMB_BETAS,
                  weight_decay=c.LAMB_WD)
        amp.initialize(model, opt, opt_level="O2")
        out[name] = [float(c.bert_step(model, opt, tokens, labels))
                     for _ in range(c.BERT_STEPS)]
        out["skipped"] = _smallest(b.params for b in opt._layout().buckets)
        del model, opt
        _empty(device)
    return out


def gpt_runs(device, full):
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedFusedAdam
    cfg = c.GPT350M if full else SMALL_GPT
    shape = (c.ACCUM, c.MICRO, c.SEQ) if full else (2, 4, 32)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg["vocab_size"], shape))
    targets = torch.from_numpy(rng.randint(0, cfg["vocab_size"], shape))
    tokens, targets = tokens.to(device), targets.to(device)
    out = {}
    for name, cls, kw in (
            ("single", FusedAdam, {}),
            ("zero", DistributedFusedAdam, dict(message_size=10_000_000)),
            ("zero_skip", _skip_smallest(DistributedFusedAdam),
             dict(message_size=10_000_000))):
        model = GPTModel(GPTConfig(**dict(cfg, dtype=torch.bfloat16)),
                         device=device).init_params(
            torch.Generator().manual_seed(0))
        opt = cls(model.parameters(), lr=c.LR, **kw)
        out[name] = [float(c.train_step(model, opt, tokens, targets))
                     for _ in range(c.TRAIN_STEPS)]
        out["skipped"] = _smallest(b.params for b in opt._layout().buckets)
        del model, opt
        _empty(device)
    return out


def resnet_runs(device, full, group=None):
    """Without ``group``: phase 9's run.  With it: 14c's reference twice
    (the spread of two equal runs), then the example under DDP."""
    from apex_tpu_torch.examples.imagenet import main_amp
    argv = (c.RESNET_ARGV if full else SMALL_RESNET_ARGV) + [
        "--opt-level", "O1"]
    if group is None:
        res = main_amp.main(argv)
        return {"single": [res["warmup_loss"]] + res["losses"]}
    argv = argv + ["--sync-bn"]
    out = {}
    for name in ("reference", "reference_again"):
        out[name] = c.resnet_group_path_reference(argv, group)
        _empty(device)
    for name, ctx in (("sync_bn", contextlib.nullcontext()),
                      ("ddp_drop", _ddp_drops_smallest())):
        with ctx:
            res = main_amp.main(argv)
        out[name] = [res["warmup_loss"]] + res["losses"]
        out["dropped"] = _smallest(b.params for b in res["trainer"].ddp._buckets)
        del res
        _empty(device)
    return out


def _smallest(buckets):
    """Parameters and elements of the bucket of fewest elements."""
    params = min(buckets, key=lambda ps: sum(p.numel() for p in ps))
    return dict(params=len(params), elements=sum(p.numel() for p in params))


def _empty(device):
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", help="also write the results to this file")
    args = ap.parse_args()
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state as ps
    device, full = args.device, args.device == "cuda"
    if full:
        if not torch.cuda.is_available():
            print("needs an NVIDIA GPU (or --device cpu)", file=sys.stderr)
            return 2
        c.phase_build()
    else:
        torch.manual_seed(0)
    res = {"resnet": resnet_runs(device, full)}
    store = pathlib.Path("build") / "dp_loss_gates"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    dist.init_process_group("nccl" if full else "gloo",
                            init_method=f"file://{store.resolve()}/store",
                            rank=0, world_size=1)
    ps.initialize_model_parallel()
    try:
        res["bert"] = bert_runs(device, full)
        res["gpt"] = gpt_runs(device, full)
        res["resnet"].update(resnet_runs(device, full,
                                         ps.get_data_parallel_group()))
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()
    gaps = {}
    for key, runs in res.items():
        for name, losses in runs.items():
            if name in ("single", "reference", "skipped", "dropped"):
                continue
            for ref in ("single", "reference"):
                if ref not in runs or name == ref:
                    continue
                want = runs[ref]
                tag = f"{key}_{name}" + ("" if ref == "single" else
                                         "_vs_reference")
                if key == "resnet":
                    gaps[f"{tag}_first"] = _gap(losses[:1], want[:1])
                gaps[tag] = _gap(losses, want)
    for k, v in gaps.items():
        print(f"{k}: largest relative loss gap {v!r}")
    out = dict(device=device, full=full, losses=res, gaps=gaps)
    if full:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(out["nvidia_smi"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
