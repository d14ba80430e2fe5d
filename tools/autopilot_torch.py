"""The trainer half of the reference's autopilot day on the cards:
``ParallelismAutopilot`` driving a ZeRO ``ElasticTrainer`` of GPT-350M
through a link drift and a poisoned re-adoption, with the kernels built
from this checkout:

    python3 tools/autopilot_torch.py [--world N] [--out results.json]
        [--steps 40] [--drift-step 6] [--recover-step 22]

``--world`` (2 or 4; default every card) NCCL ranks, one a card, train
GPT-350M (phase 5's recipe and batch, replicated over the data axis;
``FusedAdam(lr=1e-4)`` as ``DistributedFusedAdam`` under
``ZeROGuardAdapter``; checkpoints under ``build/autopilot/``) with
``ElasticTrainer`` at dp W.  The autopilot carries the reference day's
knobs (``tools/day_in_life.py`` ``autopilot_args``): a simulated
dcn-class psum profile of alpha 2 ms, threshold 0.3, two confirming
windows, 8 measurements a refit, a 0.5 s cooldown on a virtual clock that
moves 0.1 s a step, 2 gate steps, tolerance 1.2, and the minimum dp W/2.
Its beta is 1 ps/B where the day's is 1 ns/B: the day prices the 144-byte
gradient of its small model, and GPT-350M's 1.415 GB at 1 ns/B would make
the all-reduce 1.4 s (22 s drifted), so dp 1 would win at every link speed
and two cards would never re-adopt; at 1 ps/B the all-reduce stays
latency-bound (14 ms at dp 4), as in the day.  The injector schedules a
16x ``cost_drift`` at ``--drift-step`` (a confirmed drift; the re-rank
commits dp W -> W/2), and at ``--recover-step`` the links recover (1/16)
together with a 4x ``plan_regression`` (the re-adoption of dp W measures
slower than its baseline and rolls back to W/2).

The step times the autopilot reads are the reference day's ``_drift_dt``
(serial time / dp + the drifted alpha-beta price of the gradient
all-reduce), not the cards' wall times: no link on the machine can be
slowed on purpose, and the drift is what the loop must react to.  What is
real: the refits and the detection, the re-rank, every replan (the drain
checkpoint under the old plan, the new plan's model and ZeRO optimizer,
the gather-to-logical -> re-split re-shard of the optimizer state, the
checkpoint under the new plan) and the GPT-350M steps between them.

Gates: the adoption outcomes are [commit, rollback] (the rollback for a
measured regression, not a failed replan), the final plan is dp
W/2, ``audit() == []``, the counters match the applied faults, every rank
took the same decisions, and after the rollback the live state is bit for
bit the checkpoint the rollback stamped (restored into a template).  The
commit's and the rollback's wall seconds (the ticks that replanned, and
the trainer's drain and re-shard seconds) are logged.  The last lines are
the cards' names and power limits and one ``{json}`` line.
"""
import argparse
import json
import os
import pathlib
import pickle
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

DAY = dict(link_alpha=2e-3, link_beta=1e-12, serial_s=0.12,
           drift_scale=16.0, regression_scale=4.0, drift_threshold=0.3,
           confirm_windows=2, min_measurements=8, adopt_cooldown_s=0.5,
           gate_steps=2, gate_tolerance=1.2, tick_s=0.1)


def drift_dt(step, dp, grad_bytes, drift_step, recover_step, day=DAY):
    """The reference day's synthetic step time (``_drift_dt``): perfectly
    dp-scalable serial compute + the alpha-beta price of the gradient
    all-reduce at the link coefficients drifted ``day["drift_scale"]``
    times from ``drift_step`` until ``recover_step``."""
    from apex_tpu_torch.observability.costmodel import CostFit
    scale = 1.0
    if step >= drift_step:
        scale *= day["drift_scale"]
    if step >= recover_step:
        scale /= day["drift_scale"]
    fit = CostFit(day["link_alpha"] * scale, day["link_beta"] * scale)
    comm = fit.predict("psum", grad_bytes, dp) if dp > 1 else 0.0
    return day["serial_s"] / dp + comm


def _leaves(tree):
    from apex_tpu_torch.resilience.checkpoint import ShardedLeaf, tree_flatten
    return [x.data if isinstance(x, ShardedLeaf) else x
            for x in tree_flatten(tree)[0]]


def _rank(rank, world, out_dir, args):
    import torch.distributed as dist
    from apex_tpu_torch.observability import MetricsRegistry
    from apex_tpu_torch.observability.costmodel import (
        fit_cost_model, simulate_link_measurements)
    from apex_tpu_torch.resilience import (ElasticPlan, ElasticTrainer,
                                           Fault, FaultInjector,
                                           ParallelismAutopilot,
                                           TopologySpec)
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"file://{pathlib.Path(out_dir).resolve()}/store",
        rank=rank, world_size=world)
    model = c.build_model("cuda").init_params(
        torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    del model
    batch = c._phase17_batch()
    inj = FaultInjector([
        Fault(args.drift_step, "cost_drift", magnitude=DAY["drift_scale"]),
        Fault(args.recover_step, "cost_drift",
              magnitude=1.0 / DAY["drift_scale"]),
        Fault(args.recover_step, "plan_regression",
              magnitude=DAY["regression_scale"])])
    tr = ElasticTrainer(
        c.zero_factory(init),
        ElasticPlan.build(TopologySpec(dp=world, zero_shard=world),
                          device="cuda"),
        directory=str(pathlib.Path(out_dir) / "run"), fault_injector=inj,
        keep=c.RESILIENCE_KEEP, save_every=10 ** 6)
    profile = fit_cost_model(simulate_link_measurements(
        DAY["link_alpha"], DAY["link_beta"], link_class="dcn",
        ops=("psum",)), meta={"source": "autopilot day"})
    reg = MetricsRegistry()
    clockv = [0.0]
    ap = ParallelismAutopilot(
        tr, profile, min_dp=max(1, world // 2), link_class="dcn",
        drift_threshold=DAY["drift_threshold"],
        confirm_windows=DAY["confirm_windows"],
        min_measurements=DAY["min_measurements"],
        cooldown_s=DAY["adopt_cooldown_s"], gate_steps=DAY["gate_steps"],
        gate_tolerance=DAY["gate_tolerance"], injector=inj, registry=reg,
        clock=lambda: clockv[0])
    batch_fn = lambda step, plan: batch                 # noqa: E731
    steps, replan_ticks, after = [], [], None
    t_run = time.perf_counter()
    while tr.current_step < args.steps:
        step = tr.current_step
        t0 = time.perf_counter()
        tr.step_once(batch_fn)
        step_s = time.perf_counter() - t0
        dp = tr.plan.spec.dp
        ap.record_step(drift_dt(step, dp, grad_bytes, args.drift_step,
                                args.recover_step))
        for _ in range(2):
            n = tr.stats["replans"]
            t0 = time.perf_counter()
            ap.tick()
            if tr.stats["replans"] > n:
                replan_ticks.append(dict(
                    step=step, seconds=time.perf_counter() - t0,
                    dp=tr.plan.spec.dp,
                    drain_s=tr.stats["last_checkpoint_s"],
                    reshard_s=tr.stats["last_reshard_s"]))
        steps.append(dict(step=step, dp=dp, wall_s=step_s))
        if ap.stats["rollbacks"] and after is None:
            latest = tr.checkpoint.latest_step()
            after = dict(step=latest, spec=tr.plan.spec.to_dict(),
                         stamp=tr.checkpoint.topology_of(latest),
                         bitwise=None)
            if tr.model is not None:
                template = tr.guard._template(tr.model, tr.guard_state,
                                              step=latest)
                live = [t.detach().clone() for t in _leaves(template)]
                got, _ = tr.checkpoint.restore(template, step=latest)
                after["bitwise"] = c._equal_all(live, _leaves(got))
        clockv[0] += DAY["tick_s"]
    counts = reg.get("autopilot_adoptions_total")
    out = dict(
        log=[{k: e.get(k) for k in ("tick", "outcome", "old", "new",
                                     "drift", "fault", "baseline_s",
                                     "gate_s", "reason")}
             for e in ap.adoption_log],
        stats={k: v for k, v in ap.stats.items()
               if k not in ("last_refit_s",)},
        audit=ap.audit(), faults=list(inj.log), steps=steps,
        replan_ticks=replan_ticks, after=after,
        final=tr.plan.spec.to_dict(), queued=ap.queued,
        counters=dict(commit=counts.value(outcome="commit"),
                      rollback=counts.value(outcome="rollback")),
        seconds=time.perf_counter() - t_run,
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def run_ranks(world, out_dir, args):
    import torch.multiprocessing as mp
    out_dir = pathlib.Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        mp.start_processes(_rank, args=(world, str(out_dir), args),
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


def check(ranks, world):
    """The gates over every rank's results; returns the failures."""
    r0, bad = ranks[0], []
    half = {"dp": world // 2, "zero_shard": world // 2}
    if [e["outcome"] for e in r0["log"]] != ["commit", "rollback"] \
            or not r0["log"][1]["reason"].startswith("measured regression"):
        bad.append("outcomes "
                   f"{[(e['outcome'], e['reason']) for e in r0['log']]}")
    if {k: r0["final"][k] for k in half} != half:
        bad.append(f"final plan {r0['final']}")
    if r0["audit"] != [] or r0["queued"]:
        bad.append(f"audit {r0['audit']}, queued {r0['queued']}")
    drifts = sum(1 for _, k in r0["faults"] if k == "cost_drift")
    regressions = sum(1 for _, k in r0["faults"] if k == "plan_regression")
    cnt = r0["counters"]
    if not (cnt["commit"] + cnt["rollback"] == drifts
            and cnt["rollback"] == regressions == 1):
        bad.append(f"counters {cnt} against faults {r0['faults']}")
    for r, rank in enumerate(ranks):
        if (rank["log"], rank["final"]) != (r0["log"], r0["final"]):
            bad.append(f"rank {r} decided otherwise")
        a = rank["after"]
        if a is None or a["stamp"] != a["spec"]:
            bad.append(f"rank {r}: rollback stamp {a}")
        elif r < world // 2 and a["bitwise"] is not True:
            bad.append(f"rank {r}: live state is not the stamped checkpoint")
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this file")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--drift-step", type=int, default=6)
    ap.add_argument("--recover-step", type=int, default=22)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs NVIDIA GPUs", file=sys.stderr)
        return 2
    world = args.world or torch.cuda.device_count()
    if world not in (2, 4) or world > torch.cuda.device_count():
        raise SystemExit(f"--world {world}: the day needs 2 or 4 ranks, "
                         "one a card")
    c.phase_build()
    smi = c._smi()
    t0 = time.perf_counter()
    ranks = run_ranks(world, os.path.join("build", "autopilot", f"w{world}"),
                      args)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for e in r0["log"]:
        c.log(f"tick {e['tick']}: {e['old']} -> {e['new']} "
              f"{e['outcome']} (drift {e['drift']}, baseline "
              f"{e.get('baseline_s')}, gate {e.get('gate_s')}; {e['reason']})")
    for t in r0["replan_ticks"]:
        c.log(f"replan at step {t['step']} to dp {t['dp']}: {t['seconds']!r} "
              f"s wall (drain {t['drain_s']!r} s, re-shard "
              f"{t['reshard_s']!r} s) [{smi}]")
    c.log(f"{world} ranks, {len(r0['steps'])} steps: step wall s "
          f"{[round(s['wall_s'], 4) for s in r0['steps']]}; audit "
          f"{r0['audit']}; after the rollback {r0['after']}; {wall:.1f} s")
    bad = check(ranks, world)
    res = dict(world=world, ranks=ranks, wall_s=wall, failures=bad)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, nvidia_smi=smi), f, indent=1, default=str)
    print(smi)
    print(json.dumps(dict(world=world, log=r0["log"],
                          replan_ticks=r0["replan_ticks"],
                          stats=r0["stats"], final=r0["final"],
                          audit=r0["audit"], after=r0["after"],
                          wall_s=wall, failures=bad), default=str))
    if bad:
        raise AssertionError(f"autopilot day gates failed: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
