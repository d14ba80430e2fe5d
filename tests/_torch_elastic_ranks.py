"""The rank side of ``tests/test_torch_elastic.py`` and
``tests/test_torch_capacity.py``: what one ``gloo`` rank of
``tests/_torch_dist.py``'s case ``elastic`` runs.  It imports torch and
``apex_tpu_torch`` only; pytest does not collect it.  Each entry of
``inputs["parts"]`` names a function here and its numpy inputs; the
results come back as numpy (per rank)."""

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


class Linear(torch.nn.Module):
    """The reference tests' model, ``x @ w + b``; ``b`` is registered
    first so the parameters follow the JAX tree's leaf order (``b``,
    ``w``)."""

    def __init__(self, w, b):
        super().__init__()
        self.b = torch.nn.Parameter(torch.tensor(b))
        self.w = torch.nn.Parameter(torch.tensor(w))


def _batch(step, seed):
    r = np.random.RandomState(seed + step)
    return (torch.tensor(r.randn(8, 8).astype(np.float32)),
            torch.tensor(r.randn(8, 4).astype(np.float32)))


def _grad_fn(group, dp):
    """The mean-square loss on this rank's batch; the gradients averaged
    over the plan's data group (on a replicated batch a sum of ``dp``
    identical gradients, exact at two ranks), or left to the ZeRO
    optimizer's reduce-scatter with ``group`` None."""
    def grad_fn(model, x, y):
        loss = torch.mean(torch.square(x @ model.w + model.b - y))
        loss.backward()
        if group is not None:
            for p in model.parameters():
                dist.all_reduce(p.grad, group=group)
                p.grad.div_(dp)
        return loss
    return grad_fn


def _factory(w, b, zero=False):
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedFusedAdam
    from apex_tpu_torch.resilience import (ElasticComponents,
                                           GuardedTrainStep,
                                           ZeROGuardAdapter)

    def factory(plan, ckpt, inj):
        model = Linear(w, b)
        if zero:
            # the ZeRO reduce-scatter is the gradient reduction
            opt = ZeROGuardAdapter(DistributedFusedAdam(
                model.parameters(), lr=1e-2, block_rows=8,
                process_group=plan.groups["data"]), plan)
            grad_fn = _grad_fn(None, 1)
        else:
            opt = FusedAdam(model.parameters(), lr=1e-2)
            grad_fn = _grad_fn(plan.groups["data"], plan.spec.dp)
        guard = GuardedTrainStep(grad_fn=grad_fn, optimizer=opt,
                                 warmup_steps=1, checkpoint=ckpt,
                                 fault_injector=inj,
                                 group=plan.group, plan=plan)
        return ElasticComponents(guard, model, guard.init_state())
    return factory


def _flat(trainer):
    """Parameters, then the optimizer state's leaves (ZeRO shards gathered
    to the whole buckets), as numpy; None on a rank outside the plan."""
    if trainer.model is None:
        return None
    return [_np(p) for p in trainer.model.parameters()] + _gathered(
        trainer.opt_state, trainer._comp.reshard_optimizer())


def _gathered(opt_state, opt):
    """The optimizer state's leaves, ZeRO shards gathered, as numpy."""
    from apex_tpu_torch.resilience.checkpoint import (ShardedLeaf,
                                                      tree_flatten)
    from apex_tpu_torch.utils import compressed_allreduce as CA
    out = []
    leaves, _ = tree_flatten(opt_state)
    for leaf in leaves:
        data = leaf
        if isinstance(leaf, ShardedLeaf):
            data = CA.all_gather_rows(leaf.data,
                                      process_group=opt.process_group,
                                      axis_name=None)
        out.append(_np(data))
    return out


def _named(trainer):
    """A per-leaf trainer's parameters, Adam moments and step by name (the
    JAX state's ``m`` / ``v``)."""
    out = {n: _np(p) for n, p in trainer.model.named_parameters()}
    group = trainer.opt_state["groups"][0]
    for (n, _), st in zip(trainer.model.named_parameters(), group["state"]):
        out[f"m.{n}"], out[f"v.{n}"] = _np(st["exp_avg"]), _np(
            st["exp_avg_sq"])
    out["step"] = int(group["step"])
    return out


def _trainer(c, tmp, name, *, spec=None, zero=False, **kw):
    from apex_tpu_torch.resilience import (ElasticPlan, ElasticTrainer,
                                           TopologySpec)
    world = dist.get_world_size()
    spec = spec or TopologySpec(dp=world, zero_shard=world if zero else 1)
    return ElasticTrainer(_factory(c["w"], c["b"], zero),
                          ElasticPlan.build(spec, device="cpu"),
                          directory=os.path.join(tmp, name), **kw)


def _batch_fn(c):
    return lambda step, plan: _batch(step, c["seed"])


def trainer_cases(rank, world, c):
    """The reference's ``TestElasticTrainer`` / ``TestSteppableAPI`` cases
    at ``world`` ranks (dp ``world`` <-> ``world // 2``)."""
    from apex_tpu_torch.observability import MetricsRegistry
    from apex_tpu_torch.resilience import (Fault, FaultInjector,
                                           HostSignals, Preemption,
                                           TopologySpec)
    tmp, n, out = c["tmp"], c["n"], {}
    batch = _batch_fn(c)
    for zero in (False, True):
        tag = "zero_" if zero else ""
        ref = _trainer(c, tmp, tag + "ref", zero=zero)
        ref.train(batch, n)
        out[tag + "ref"] = _flat(ref)
        if not zero:
            out["ref_named"] = _named(ref)

        # an injected shrink -> grow
        inj = FaultInjector([Fault(1, "topology_change"),
                             Fault(3, "topology_change")])
        tr = _trainer(c, tmp, tag + "shrink", zero=zero,
                      fault_injector=inj)
        out[tag + "shrink_summary"] = tr.train(batch, n)
        out[tag + "shrink"] = _flat(tr)
        out[tag + "shrink_spec"] = tr.plan.spec.to_dict()
        out[tag + "shrink_stamp"] = tr.checkpoint.topology_of(n)

    # a replan to the same spec: an in-place rebuild
    signals = HostSignals()
    tr = _trainer(c, tmp, "inplace", signals=signals)

    def inplace_batch(step, plan):
        if step == 1 and rank == 0:
            signals.request_replan(TopologySpec(dp=world))
        return batch(step, plan)
    out["inplace_summary"] = tr.train(inplace_batch, n)
    out["inplace"] = _flat(tr)

    # a soft preemption seen by one rank: every rank drains and stops
    signals = HostSignals()
    tr = _trainer(c, tmp, "soft", signals=signals)

    def soft_batch(step, plan):
        if step == 1 and rank == world - 1:
            signals.request_preempt()
        return batch(step, plan)
    out["soft_summary"] = tr.train(soft_batch, n)
    tr2 = _trainer(c, tmp, "soft")
    out["soft_resume_summary"] = tr2.train(batch, n)
    out["soft"] = _flat(tr2)

    # a hard preemption while shrunk; a fresh trainer at the full dp
    inj = FaultInjector([Fault(1, "topology_change"),
                         Fault(2, "preempt_at_step")])
    tr = _trainer(c, tmp, "hard", fault_injector=inj)
    try:
        tr.train(batch, n)
        out["hard_raised"] = False
    except Preemption as e:
        out["hard_raised"] = e.step
    out["hard_stamp"] = tr.checkpoint.topology_of(
        tr.checkpoint.latest_step())
    tr2 = _trainer(c, tmp, "hard")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["hard_resume_summary"] = tr2.train(batch, n)
    out["hard_warnings"] = [str(w.message) for w in caught]
    out["hard_spec"] = tr2.plan.spec.to_dict()
    out["hard"] = _flat(tr2)

    # a failed replan restores the stamp and training continues
    tr = _trainer(c, tmp, "failed")
    tr.step_once(batch)
    try:
        tr.replan_to(TopologySpec(dp=16))
        out["failed_error"] = None
    except ValueError as e:
        out["failed_error"] = str(e)
    out["failed_spec"] = tr.plan.spec.to_dict()
    out["failed_stamp"] = tr.checkpoint.topology_of(tr.current_step)
    while tr.current_step < n:
        tr.step_once(batch)
    out["failed"] = _flat(tr)

    # step_once / replan_to against train
    tr = _trainer(c, tmp, "steppable")
    out["start"] = (tr.start(), tr.start())
    for step in range(n):
        if step == 1:
            tr.replan_to(TopologySpec(dp=world // 2))
        if step == 3:
            tr.replan_to(TopologySpec(dp=world))
        tr.step_once(batch)
    out["steppable"] = _flat(tr)
    out["steppable_stats"] = dict(tr.stats)

    # the registry series
    reg = MetricsRegistry()
    tr = _trainer(c, tmp, "registry", registry=reg,
                  fault_injector=FaultInjector([Fault(1,
                                                      "topology_change")]))
    tr.train(batch, 3)
    out["registry"] = {name: reg.get(name).value() for name in (
        "elastic_replans", "elastic_preempt_signals", "elastic_resume_step")}
    out["registry_reshard_s"] = tr.stats["last_reshard_s"]
    return out


def reshard(rank, world, c):
    """``reshard_optimizer_state`` dp ``world`` -> 1 -> ``world``: ZeRO
    from the JAX state at ``world`` shards (``distributed_state_from_jax``)
    and per-leaf FusedAdam from the JAX per-leaf state.  Returns each
    plan's shards of every bucket slot."""
    from apex_tpu_torch.convert import distributed_state_from_jax
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedFusedAdam
    from apex_tpu_torch.resilience import (ElasticPlan, TopologySpec,
                                           optimizer_state,
                                           reshard_optimizer_state)
    out = {}
    plans = {ws: ElasticPlan.build(TopologySpec(dp=ws, zero_shard=ws),
                                   device="cpu") for ws in (world, 1)}

    def zero_opt(ws):
        plan = plans[ws]
        if not plan.active:
            return None
        return DistributedFusedAdam(Linear(c["w"], c["b"]).parameters(),
                                    lr=1e-2, block_rows=8,
                                    process_group=plan.groups["data"])

    def shards(opt):
        if opt is None:
            return None
        st = optimizer_state(opt)
        return {"step": int(st["step"]),
                "buckets": {k: {s: _np(leaf.data) for s, leaf in v.items()}
                            for k, v in st["buckets"].items()}}

    big = zero_opt(world)
    big.load_state_dict(distributed_state_from_jax(big, c["zero_state"]))
    small = zero_opt(1)
    reshard_optimizer_state(optimizer_state(big), plans[world], plans[1],
                            optimizer=big, new_optimizer=small)
    out["zero_small"] = shards(small)
    back = zero_opt(world)
    reshard_optimizer_state(
        optimizer_state(small) if small is not None else None,
        plans[1], plans[world], optimizer=small, new_optimizer=back)
    out["zero_back"] = shards(back)
    # per-leaf: replicated state moves as is (rank 1 receives it back)
    plain_plans = {ws: ElasticPlan.build(TopologySpec(dp=ws), device="cpu")
                   for ws in (world, 1)}
    opt = FusedAdam(Linear(c["w"], c["b"]).parameters(), lr=1e-2)
    st = optimizer_state(opt)
    for i, p_state in enumerate(st["groups"][0]["state"]):
        for slot, t in p_state.items():
            t.copy_(torch.tensor(c["leaf_state"][slot][i]))
    st["groups"][0]["step"].fill_(c["leaf_step"])
    one = (FusedAdam(Linear(c["w"], c["b"]).parameters(), lr=1e-2)
           if rank == 0 else None)
    reshard_optimizer_state(st, plain_plans[world], plain_plans[1],
                            optimizer=opt, new_optimizer=one)
    again = FusedAdam(Linear(c["w"], c["b"]).parameters(), lr=1e-2)
    got = reshard_optimizer_state(
        optimizer_state(one) if one is not None else None, plain_plans[1],
        plain_plans[world], optimizer=one, new_optimizer=again)
    out["leaf_back"] = {
        "step": int(got["groups"][0]["step"]),
        "state": [{k: _np(v) for k, v in s.items()}
                  for s in got["groups"][0]["state"]]}
    try:
        reshard_optimizer_state(optimizer_state(opt), plain_plans[world],
                                plain_plans[world], optimizer=opt,
                                transform=lambda t, p: t)
        out["transform"] = None
    except NotImplementedError as e:
        out["transform"] = str(e)
    return out


def _rows(step, seed, rank, dp):
    """Rank ``rank``'s rows of the step's global batch of 16 rows (its
    share under a plan of ``dp`` ranks): the ranks train on different
    data, so a lost or wrong gradient exchange shows."""
    r = np.random.RandomState(seed + step)
    x, y = r.randn(16, 8).astype(np.float32), r.randn(16, 4).astype(
        np.float32)
    lo, hi = rank * 16 // dp, (rank + 1) * 16 // dp
    return torch.tensor(x[lo:hi]), torch.tensor(y[lo:hi])


def _lost_reduce_scatter(x, *args, process_group=None, **kwargs):
    """A planted fault: the reduce-scatter that drops the other ranks'
    gradients (this rank's rows times the world, as a sum of identical
    gradients would give)."""
    from apex_tpu_torch.transformer import parallel_state as ps
    world = ps.group_size(process_group)
    rows = x.shape[0] // world
    lo = ps.group_rank(process_group) * rows
    return x[lo:lo + rows] * world


def sharded(rank, world, c):
    """Each rank trains on its own rows of a global batch.  ``guard``: a
    ZeRO ``DistributedFusedAdam`` at dp ``world`` under the guard through
    ``ZeROGuardAdapter`` with a spike and a NaN scheduled (per step the
    discrete fields, the norm and this rank's loss; the final parameters
    and gathered state).  ``ref`` / ``shrink`` / ``lost``: the ZeRO
    ``ElasticTrainer`` uninterrupted, with an injected shrink -> grow, and
    uninterrupted with the reduce-scatter's exchange dropped."""
    from apex_tpu_torch.parallel import DistributedFusedAdam
    from apex_tpu_torch.resilience import (ElasticPlan, Fault,
                                           FaultInjector, GuardedTrainStep,
                                           TopologySpec, ZeROGuardAdapter,
                                           optimizer_state)
    from apex_tpu_torch.utils import compressed_allreduce as CA
    out = {}
    plan = ElasticPlan.build(TopologySpec(dp=world, zero_shard=world),
                             device="cpu")
    model = Linear(c["w"], c["b"])
    opt = ZeROGuardAdapter(DistributedFusedAdam(
        model.parameters(), lr=1e-2, block_rows=8,
        process_group=plan.groups["data"]), plan)
    guard = GuardedTrainStep(
        grad_fn=_grad_fn(None, 1), optimizer=opt, warmup_steps=2,
        max_consecutive=10, group=plan.group, plan=plan,
        fault_injector=FaultInjector([Fault(f[0], f[1], f[2])
                                      for f in c["faults"]]))
    gstate, results = guard.init_state(), []
    for step in range(c["n_guard"]):
        res = guard(model, gstate, *_rows(step, c["seed"], rank, world),
                    step=step)
        gstate = res.guard_state
        results.append(dict(fields=(res.skipped, res.anomaly,
                                    res.next_step),
                            grad_norm=res.grad_norm,
                            loss=res.loss_value))
    out["guard"] = results
    out["guard_params"] = {n: _np(p) for n, p in model.named_parameters()}
    st = optimizer_state(opt)
    out["guard_state"] = {"step": int(st["step"]), "buckets": {
        key: {slot: _np(CA.all_gather_rows(
            leaf.data, process_group=opt.inner.process_group,
            axis_name=None)) for slot, leaf in slots.items()}
        for key, slots in st["buckets"].items()}}

    def batch(step, plan):
        return _rows(step, c["seed"], rank, plan.spec.dp)

    for name, inj in (("ref", None),
                      ("shrink", FaultInjector([Fault(1, "topology_change"),
                                                Fault(3, "topology_change")]))):
        tr = _trainer(c, c["tmp"], "sharded_" + name, zero=True,
                      fault_injector=inj)
        tr.train(batch, c["n"])
        out[name] = _flat(tr)
        out[name + "_spec"] = tr.plan.spec.to_dict()
    keep = CA.reduce_scatter
    CA.reduce_scatter = _lost_reduce_scatter
    try:
        tr = _trainer(c, c["tmp"], "sharded_lost", zero=True)
        tr.train(batch, c["n"])
        out["lost"] = _flat(tr)
    finally:
        CA.reduce_scatter = keep
    return out


def capacity_crash(rank, world, c):
    """A real trainer under ``CapacityController``: an injected mid-shift
    crash rolls the split and the trainer's state back bit for bit, the
    retry commits and training goes on at the smaller dp."""
    from apex_tpu_torch.resilience import (CapacityController, Fault,
                                           FaultInjector)
    import _torch_capacity_fakes as fakes
    trainer = _trainer(c, c["tmp"], "capacity", save_every=1)
    clockv = [0.0]
    fleet = fakes.FakeFleet(clock=lambda: clockv[0])
    ctl = CapacityController(trainer, fleet, fakes.FakeEngine,
                             min_train_dp=1, cooldown_s=0.0,
                             injector=FaultInjector(
                                 [Fault(2, "capacity_change")]),
                             clock=lambda: clockv[0])
    batch = _batch_fn(c)
    for _ in range(2):
        trainer.step_once(batch)
    out = {"pre": _flat(trainer)}
    ctl.request_shift("to_serving")
    ctl.tick()
    out["after_crash"] = dict(stats=dict(ctl.stats), split=ctl.split,
                              dp=trainer.plan.spec.dp,
                              state=_flat(trainer))
    ctl.request_shift("to_serving")
    ctl.tick()
    out["after_retry"] = dict(shifts=ctl.stats["shifts"], split=ctl.split,
                              dp=trainer.plan.spec.dp)
    trainer.step_once(batch)
    out["step"] = trainer.current_step
    out["log"] = [{k: e[k] for k in ("direction", "fault", "outcome")}
                  for e in ctl.shift_log]
    return out


def run(rank, world, inputs):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return {name: globals()[name](rank, world, c)
            for name, c in inputs["parts"].items()}
