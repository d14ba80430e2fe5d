"""Elastic ZeRO training of GPT-350M across cards: the multi-card half of
``chip_smoke.py``'s phase 17, with the kernels built from this checkout:

    python3 tools/elastic_torch.py [--world N] [--paths P,...]
        [--out results.json]

``--world`` (2 or 4; default every card) NCCL ranks, one a card, train
GPT-350M
(phase 5's recipe, ``FusedAdam(lr=1e-4)`` as ``DistributedFusedAdam`` under
``ZeROGuardAdapter``, checkpoints under ``build/elastic/``) with
``ElasticTrainer`` along each path, against the uninterrupted run at the
path's starting dp.  In the first three each rank takes phase 5's whole
batch (replicated over the data axis), so the path is bit for bit; in
``sharded`` each rank takes its own rows:

* ``shrink``: dp W -> W/2 -> W (injected ``topology_change`` at steps 1
  and 3; the ZeRO buckets gathered to the logical tensors and re-split);
* ``halves`` (4 ranks): dp 2 -> 1 -> 2 on the first two ranks while the
  others idle;
* ``hard``: a shrink at step 1, a hard ``Preemption`` at step 2 on every
  rank, and a fresh dp-W trainer that restores the dp-W/2 checkpoint and
  grows back;
* ``sharded``: dp W -> W/2 -> W as ``shrink``, each rank on its share of
  a global batch of W times phase 5's micro-batches (at dp W/2 a rank
  accumulates twice as many), so the gradients the ranks exchange differ
  and a lost or wrong exchange shows; not bit for bit (a rank's mean over
  more micro-batches rounds otherwise).

Each path's gap is the largest over its final parameters, Adam moments and
step of ``max |x - ref| / max |ref|``, held to ``ELASTIC_GAP`` at that card
count (a count without readings raises).  At two ranks a sum of two
identical gradients is exact, so the replicated paths are bit for bit;
NCCL's sum of four copies may round in principle, but the readings at four
cards were bit for bit too, so their gates are 0.

    python3 tools/elastic_torch.py --gates [--world N]

The readings behind the gates: every path's gap, correct and with its
planted fault, so that each gate sits between its two readings:
``lost_v`` on the replicated paths (the re-shard drops Adam's second
moment: it zeroes the new plan's ``v`` after ``_zero_reshard``) and
``lost_rs`` on ``sharded`` (the ZeRO reduce-scatter drops the other
ranks' gradients, returning this rank's rows times the world, which is
exact on replicated data and so invisible to the other paths).  The last lines are the cards' names and
power limits and one ``{json}`` line.
"""
import argparse
import contextlib
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

ALL_PATHS = ("shrink", "halves", "hard", "sharded")
STEPS = 4
# the planted faults and the paths each is read on
FAULTS = {"lost_v": ("shrink", "halves", "hard"), "lost_rs": ("sharded",)}
# gap gates by card count, each between the correct and the planted-fault
# reading of `--gates` at that count (NVIDIA H100 80GB HBM3, 700 W): the
# replicated paths read 0.0 correct (bit for bit, four ranks too: NCCL's
# sums of four identical gradients were exact) and 3.6e4 (shrink, halves) /
# 2.0e3 (hard) with lost_v, at 2 and at 4 cards; sharded read 0.110 / 0.023
# correct and 1.90 / 2.10 with lost_rs at 2 / 4 cards; a count or path
# without readings raises
ELASTIC_GAP = {2: {"shrink": 0.0, "hard": 0.0, "sharded": 0.5},
               4: {"shrink": 0.0, "halves": 0.0, "hard": 0.0,
                   "sharded": 0.2}}


def gap_limits(world, paths):
    missing = [p for p in paths if p not in ELASTIC_GAP.get(world, {})]
    if missing:
        raise ValueError(
            f"no elastic gap readings for {missing} at {world} ranks: take "
            f"them with python3 tools/elastic_torch.py --gates --world "
            f"{world}")
    return ELASTIC_GAP[world]


def _lost_reduce_scatter(x, *args, process_group=None, **kwargs):
    from apex_tpu_torch.transformer import parallel_state as ps
    world = ps.group_size(process_group)
    rows = x.shape[0] // world
    lo = ps.group_rank(process_group) * rows
    return x[lo:lo + rows] * world


@contextlib.contextmanager
def _plant(fault):
    """``lost_v``: every ZeRO re-shard leaves the new plan's second
    moments at zero.  ``lost_rs``: the ZeRO reduce-scatter keeps this
    rank's gradient rows alone."""
    from apex_tpu_torch.resilience import elastic
    from apex_tpu_torch.utils import compressed_allreduce as CA
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "lost_rs":
        original = CA.reduce_scatter
        CA.reduce_scatter = _lost_reduce_scatter
        try:
            yield
        finally:
            CA.reduce_scatter = original
        return
    original = elastic._zero_reshard

    def planted(*args, **kwargs):
        live = original(*args, **kwargs)
        if live is not None:
            for slots in live["buckets"].values():
                slots["v"].data.zero_()
        return live
    elastic._zero_reshard = planted
    try:
        yield
    finally:
        elastic._zero_reshard = original


def _factory(init):
    from apex_tpu_torch.parallel import DistributedFusedAdam
    from apex_tpu_torch.resilience import (ElasticComponents,
                                           GuardedTrainStep,
                                           ZeROGuardAdapter)

    def factory(plan, ckpt, inj):
        model = c.build_model(plan.device)
        model.load_state_dict(init)
        zopt = DistributedFusedAdam(model.parameters(), lr=c.LR,
                                    process_group=plan.groups["data"])
        guard = GuardedTrainStep(
            grad_fn=c._gpt_grad_fn, optimizer=ZeROGuardAdapter(zopt, plan),
            warmup_steps=c.GUARD_WARMUP, checkpoint=ckpt,
            fault_injector=inj, group=plan.group, plan=plan)
        return ElasticComponents(guard, model, guard.init_state())
    return factory


def _trainer(init, directory, dp, **kw):
    from apex_tpu_torch.resilience import (ElasticPlan, ElasticTrainer,
                                           TopologySpec)
    return ElasticTrainer(
        _factory(init), ElasticPlan.build(TopologySpec(dp=dp, zero_shard=dp),
                                          device="cuda"),
        directory=directory, keep=c.RESILIENCE_KEEP,
        save_every=c.RESILIENCE_SAVE_EVERY, **kw)


def _state(tr):
    if tr.model is None:
        return None
    return c._clone_all(c._train_state(tr.model,
                                       tr._comp.reshard_optimizer()))


def _gap(got, want):
    """This rank's largest relative gap; 0.0 outside the plan."""
    if got is None:
        return 0.0
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.double(), b.double()
        scale = max(float(b.abs().max()), 1e-30) if b.numel() else 1.0
        worst = max(worst, float((a - b).abs().max()) / scale
                    if b.numel() else 0.0)
    return worst


def _rank(rank, world, out_dir, paths, fault):
    import torch.distributed as dist
    from apex_tpu_torch.resilience import Fault, FaultInjector, Preemption
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"file://{pathlib.Path(out_dir).resolve()}/store",
        rank=rank, world_size=world)
    model = c.build_model("cuda").init_params(
        torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = c._phase17_batch()
    batch_fn = lambda step, plan: batch                 # noqa: E731
    rows = _sharded_batch(world)

    def sharded_fn(step, plan):
        n = rows[0].shape[0] // plan.spec.dp
        return tuple(t[rank * n:(rank + 1) * n] for t in rows)

    out, refs = {}, {}
    root = pathlib.Path(out_dir)

    def ref(dp, fn=batch_fn, tag=""):
        if (dp, tag) not in refs:
            tr = _trainer(init, str(root / f"ref{tag}{dp}"), dp)
            tr.train(fn, STEPS)
            refs[dp, tag] = _state(tr)
            del tr
            torch.cuda.empty_cache()
        return refs[dp, tag]

    def switches():
        return FaultInjector([Fault(1, "topology_change"),
                              Fault(3, "topology_change")])

    for path in paths:
        # the reference runs unplanted
        want = (ref(2) if path == "halves" else
                ref(world, sharded_fn, "sharded") if path == "sharded" else
                ref(world))
        fn = sharded_fn if path == "sharded" else batch_fn
        t0 = time.perf_counter()
        with _plant(fault):
            if path == "hard":
                tr = _trainer(init, str(root / path), world,
                              fault_injector=FaultInjector([
                                  Fault(1, "topology_change"),
                                  Fault(2, "preempt_at_step")]))
                try:
                    tr.train(fn, STEPS)
                    raise AssertionError("hard: no Preemption")
                except Preemption:
                    pass
                del tr
                tr = _trainer(init, str(root / path), world)
            else:
                tr = _trainer(init, str(root / path),
                              2 if path == "halves" else world,
                              fault_injector=switches())
            summary = tr.train(fn, STEPS)
        local = _gap(_state(tr), want)
        worst = torch.tensor([local], dtype=torch.float64, device="cuda")
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        out[path] = dict(summary=summary, gap=float(worst),
                         seconds=time.perf_counter() - t0,
                         spec=tr.plan.spec.to_dict(),
                         peak_memory_bytes=torch.cuda.max_memory_allocated())
        del tr
        torch.cuda.empty_cache()
    with open(root / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _sharded_batch(world):
    """The sharded path's global batch: ``world`` times phase 5's
    micro-batches (seed 1); a plan of ``d`` ranks gives each its
    ``world / d`` share of them, in rank order."""
    rng = np.random.RandomState(1)
    shape = (world * c.ACCUM, c.MICRO, c.SEQ)
    return tuple(torch.from_numpy(rng.randint(
        0, c.GPT350M["vocab_size"], shape)).to("cuda") for _ in range(2))


def run_ranks(world, out_dir, paths, fault=None):
    import torch.multiprocessing as mp
    out_dir = pathlib.Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        mp.start_processes(_rank, args=(world, str(out_dir), tuple(paths),
                                        fault),
                           nprocs=world, start_method="spawn", join=True)
        ranks = []
        for r in range(world):
            with open(out_dir / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        return ranks
    finally:
        # the checkpoints are GBs: keep only the results
        for sub in out_dir.iterdir():
            if sub.is_dir():
                shutil.rmtree(sub, ignore_errors=True)


def paths_for(names, world):
    for name in names:
        if name not in ALL_PATHS:
            raise SystemExit(f"unknown path {name!r}; paths: {ALL_PATHS}")
        if name == "halves" and world < 4:
            raise SystemExit("halves needs 4 ranks (dp 2 -> 1 -> 2 on two)")
    return list(names)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this file")
    ap.add_argument("--gates", action="store_true",
                    help="take the gate readings instead")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card)")
    ap.add_argument("--paths", default=None,
                    help=f"comma-separated subset of {ALL_PATHS}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    world = args.world or torch.cuda.device_count()
    if world not in (2, 4) or world > torch.cuda.device_count():
        raise SystemExit(f"--world {world}: the paths need 2 or 4 ranks, "
                         "one a card")
    paths = paths_for(args.paths.split(",") if args.paths else
                      [p for p in ALL_PATHS if p != "halves" or world == 4],
                      world)
    if not args.gates:
        limits = gap_limits(world, paths)
    c.phase_build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    readings = {}
    for fault in ((None,) + tuple(FAULTS) if args.gates else (None,)):
        name = fault or "correct"
        run = [p for p in paths if fault is None or p in FAULTS[fault]]
        if not run:
            continue
        t0 = time.perf_counter()
        ranks = run_ranks(world, os.path.join("build", "elastic", name),
                          run, fault)
        readings[name] = dict(
            gaps={p: ranks[0][p]["gap"] for p in run},
            summaries={p: ranks[0][p]["summary"] for p in run},
            seconds={p: ranks[0][p]["seconds"] for p in run},
            peak_memory_bytes=[{p: r[p]["peak_memory_bytes"]
                                for p in run} for r in ranks],
            wall_s=time.perf_counter() - t0)
        c.log(f"{name} at {world} ranks: gaps {readings[name]['gaps']} "
              f"({readings[name]['wall_s']:.1f} s)")
    if not args.gates:
        gaps = readings["correct"]["gaps"]
        bad = {p: g for p, g in gaps.items() if not g <= limits[p]}
        if bad:
            raise AssertionError(f"elastic gaps over their gates {limits}: "
                                 f"{bad}")
    res = dict(world=world, readings=readings)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, nvidia_smi=smi), f, indent=1, default=str)
    print(smi)
    print(json.dumps(res, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
