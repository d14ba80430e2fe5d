"""The rank side of ``tests/test_torch_costmodel.py``,
``tests/test_torch_comms.py`` and ``tests/test_torch_autopilot.py``: what
one ``gloo`` rank of ``tests/_torch_dist.py``'s case ``obs`` runs.  It
imports torch, ``apex_tpu_torch`` and ``tools/autopilot_torch.py`` (the
day's step times) only; pytest does not collect it.
Each entry of ``inputs["parts"]`` names a function here and its inputs;
the results come back as plain Python and numpy (per rank)."""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _leaf_np(leaf):
    """A checkpoint tree's leaf (a tensor, or a ZeRO shard's
    ``ShardedLeaf``) as numpy."""
    from apex_tpu_torch.resilience.checkpoint import ShardedLeaf
    return _np(leaf.data if isinstance(leaf, ShardedLeaf) else leaf)


def _rows(stats):
    """A ``collective_stats`` result without its per-op scopes' objects:
    plain dicts and lists."""
    return {k: (dict(v, ops=[dict(o) for o in v["ops"]]) if "ops" in v
                else dict(v)) for k, v in stats.items()}


# -- the probe ----------------------------------------------------------------

def probe(rank, world, c):
    """``probe_collectives`` over the job at small sizes, then the fit."""
    from apex_tpu_torch.observability.costmodel import (fit_cost_model,
                                                        probe_collectives)
    ms = probe_collectives(dtypes=c["dtypes"], sizes=c["sizes"],
                           iters=c["iters"], rounds=c["rounds"])
    model = fit_cost_model(ms, meta={"source": "gloo probe"})
    return {"measurements": [m.to_dict() for m in ms],
            "profile": model.to_json()}


# -- comms -------------------------------------------------------------------

def comms_hand(rank, world, c):
    """The reference's hand-computed cases: a psum of a per-rank f32[4, 16]
    shard, the tiled all-gather of one into f32[8, 16], a reduce-scatter,
    a one-hop send/recv ring and an all-to-all, each under a named range;
    the wire bytes and the table."""
    from apex_tpu_torch.observability import (collective_stats, format_stats,
                                              span, wire_bytes)
    from apex_tpu_torch.utils.profiling import annotate
    out = {}
    x = torch.ones(4, 16)

    def psum():
        with annotate("attn"):
            dist.all_reduce(x.clone())
    out["psum"] = _rows(collective_stats(psum))

    def gather():
        full = torch.empty(8, 16)
        with span("gather"):
            dist.all_gather_into_tensor(full, x)
    out["gather"] = _rows(collective_stats(gather))

    def scatter():
        shard = torch.empty(4 // world, 16)
        dist.reduce_scatter_tensor(shard, x)
    out["scatter"] = _rows(collective_stats(scatter))

    def ring():
        recv = torch.empty(4, 16)
        with annotate("ring"):
            for r in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % world),
                    dist.P2POp(dist.irecv, recv, (rank - 1) % world)]):
                r.wait()
    out["ring"] = _rows(collective_stats(ring))

    def a2a():
        o = torch.empty(4, 16)
        dist.all_to_all_single(o, x)
    out["a2a"] = _rows(collective_stats(a2a))
    st = collective_stats(psum)
    out["wire"] = wire_bytes(st)
    out["table"] = format_stats(st, by_scope=True)
    return out


def _gpt(c, seed=0):
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    model = GPTModel(GPTConfig(**c["cfg"]), device="cpu")
    model.init_params(torch.Generator().manual_seed(seed))
    return model


def _gpt_step(model, opt, tokens, targets):
    opt.zero_grad()
    loss = model.loss(tokens, targets)
    loss.backward()
    opt.step()
    return loss


def comms_zero(rank, world, c):
    """One ZeRO step of a small GPT (``DistributedFusedAdam`` over small
    buckets) under ``collective_stats``, its bucket layout, and one step
    with the overflow flag (``noop_flag``); one DDP step and its bucket
    layout."""
    from apex_tpu_torch.observability import collective_stats
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (DistributedDataParallel,
                                         DistributedFusedAdam)
    from apex_tpu_torch.utils.profiling import annotate
    out = {}
    r = np.random.RandomState(c["seed"] + rank)
    tokens = torch.from_numpy(r.randint(0, c["cfg"]["vocab_size"],
                                        (2, 8)))
    targets = torch.from_numpy(r.randint(0, c["cfg"]["vocab_size"],
                                         (2, 8)))
    model = _gpt(c)
    opt = DistributedFusedAdam(model.parameters(), lr=1e-3,
                               message_size=c["message_size"])

    def zero_step(noop=None):
        with annotate("zero_step"):
            opt.zero_grad()
            model.loss(tokens, targets).backward()
            opt.step(noop_flag=noop)
    out["zero"] = _rows(collective_stats(zero_step))
    out["zero_noop"] = _rows(collective_stats(
        zero_step, torch.zeros((), dtype=torch.int32)))
    out["zero_layout"] = [(int(i.meta.nrows), 128, 4)
                          for i in opt._layout().buckets]
    out["world"] = opt.world_size

    model = _gpt(c)
    ddp = DistributedDataParallel(model, message_size=c["message_size"])
    dopt = FusedAdam(model.parameters(), lr=1e-3)

    def ddp_step():
        with annotate("ddp_step"):
            _gpt_step(model, dopt, tokens, targets)
    out["ddp"] = _rows(collective_stats(ddp_step))
    out["ddp_layout"] = [(int(b.meta.nrows), 128,
                          b.params[0].element_size()) for b in ddp._buckets]
    return out


# -- the autopilot over a real trainer ----------------------------------------

_GRAD_BYTES = 8 * 4 * 4 + 4 * 4   # the Linear model's params: w (8x4) + b


def drift_dt(step, dp, c):
    """The autopilot day's step time (``tools/autopilot_torch.py``
    ``drift_dt``) at this test's link, compute and drift."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    try:
        from autopilot_torch import drift_dt as day_dt
    finally:
        sys.path.pop(0)
    return day_dt(step, dp, _GRAD_BYTES, c["drift_step"], c["recover_step"],
                  day=dict(link_alpha=c["alpha"], link_beta=c["beta"],
                           serial_s=c["serial_s"],
                           drift_scale=c["drift_scale"]))


def autopilot_cycle(rank, world, c):
    """A real ``ElasticTrainer`` (the elastic tests' Linear model, ZeRO) at
    dp ``world`` under ``ParallelismAutopilot`` fed ``drift_dt`` step
    times: the links drift (commit dp world -> world / 2), then recover
    with a ``plan_regression`` (the re-adoption rolls back).  After the
    rollback the live state is held against the checkpoint the rollback
    wrote, restored into a template.  Ranks other than the first feed
    wrong step times, and more of them: a tick applies the first rank's.
    """
    import _torch_elastic_ranks as er
    from apex_tpu_torch.observability import MetricsRegistry
    from apex_tpu_torch.observability.costmodel import (
        fit_cost_model, simulate_link_measurements)
    from apex_tpu_torch.resilience import (Fault, FaultInjector,
                                           ParallelismAutopilot)
    from apex_tpu_torch.resilience.checkpoint import tree_flatten
    inj = FaultInjector([
        Fault(c["drift_step"], "cost_drift", magnitude=c["drift_scale"]),
        Fault(c["recover_step"], "cost_drift",
              magnitude=1.0 / c["drift_scale"]),
        Fault(c["recover_step"], "plan_regression",
              magnitude=c["regression_scale"])])
    tr = er._trainer(c, c["tmp"], "autopilot", zero=True, save_every=1000,
                     fault_injector=inj)
    profile = fit_cost_model(simulate_link_measurements(
        c["alpha"], c["beta"], link_class="dcn", ops=("psum",)),
        meta={"source": "test"})
    reg = MetricsRegistry()
    clockv = [0.0]
    ap = ParallelismAutopilot(
        tr, profile, min_dp=c["min_dp"], link_class="dcn",
        drift_threshold=0.3, confirm_windows=2, min_measurements=8,
        cooldown_s=0.5, gate_steps=2, gate_tolerance=1.2, injector=inj,
        registry=reg, clock=lambda: clockv[0])
    batch = er._batch_fn(c)
    dps, after = [], None
    while tr.current_step < c["steps"]:
        step = tr.current_step
        tr.step_once(batch)
        dt = drift_dt(step, tr.plan.spec.dp, c)
        # only the first rank's feeds count: the others feed wrong times,
        # twice a step, and must still take its decisions
        for _ in range(1 if rank == 0 else 2):
            ap.record_step(dt if rank == 0 else 3.0 * dt)
        before = ap.stats["rollbacks"]
        ap.tick()
        ap.tick()
        dps.append(tr.plan.spec.dp)
        if ap.stats["rollbacks"] > before and after is None:
            latest = tr.checkpoint.latest_step()
            stamp = tr.checkpoint.topology_of(latest)
            live = er._flat(tr)
            restored = None
            if tr.model is not None:
                template = tr.guard._template(tr.model, tr.guard_state,
                                              step=latest)
                got, _ = tr.checkpoint.restore(template, step=latest)
                restored = [_leaf_np(t) for t in tree_flatten(got)[0]]
                live = [_leaf_np(t) for t in tree_flatten(template)[0]]
            after = dict(step=latest, stamp=stamp, live=live,
                         restored=restored, spec=tr.plan.spec.to_dict())
        clockv[0] += 0.1
    counts = reg.get("autopilot_adoptions_total")
    return dict(log=[{k: e[k] for k in ("tick", "outcome", "old", "new",
                                         "manual", "source", "fault",
                                         "reason")}
                     for e in ap.adoption_log],
                stats={k: ap.stats[k] for k in (
                    "refits", "drift_confirmed", "adoptions", "rollbacks",
                    "no_change", "queued", "drift_faults")},
                audit=ap.audit(), dps=dps, after=after,
                final=tr.plan.spec.to_dict(), faults=list(inj.log),
                counters=(counts.value(outcome="commit"),
                          counts.value(outcome="rollback")),
                replans=tr.stats["replans"])


def run(rank, world, inputs):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return {name: globals()[name](rank, world, c)
            for name, c in inputs["parts"].items()}
