"""Elastic, preemption-native training — port of
``apex_tpu/resilience/elastic.py``.

Sharded optimizer state is a pure partition of the same logical tensors, so
a ``dp=4 -> dp=2`` shrink is a deterministic re-partition.  The pieces:

* :class:`TopologySpec` / :class:`ElasticPlan` — the (dp, tp, pp, SP,
  ZeRO-shard) descriptor, and the spec resolved onto **ranks**: the
  ``data`` / ``pipe`` / ``model`` process groups of a ``(dp, pp, tp)`` mesh
  over the first ``n`` ranks of the job
  (:func:`~apex_tpu_torch.transformer.parallel_state.subset_groups`).
  Every rank builds every plan, in the same order, including ranks outside
  it; a rank outside the plan idles until a later plan takes it back.  The
  checkpoint manager stamps the spec into every manifest.
* :func:`reshard_optimizer_state` — re-partitions optimizer state across a
  dp change.  ZeRO buckets gather to the LOGICAL per-leaf tensors (the old
  ``block_rows * world`` padding dropped) and re-split under the new
  padding; per-leaf fused-optimizer state is replicated and moves as is.
  Ranks that join receive the state from the plan's first rank.  f32
  moments and master weights are carried bitwise.  tp/pp layout transforms
  (``transform=``) raise ``NotImplementedError``: they need the port of
  ``pack_for_shard_map`` / ``unpack_from_shard_map`` (``ROADMAP.md`` queue
  A item 15, left over).
* :class:`ZeROGuardAdapter` — a ZeRO optimizer under
  :class:`~apex_tpu_torch.resilience.guard.GuardedTrainStep`.
* :class:`ElasticTrainer` — the training loop around the guard.  On a
  preemption/arrival signal (an injected ``topology_change`` fault or a
  :class:`HostSignals` delivery) it drains in-flight saves, checkpoints
  under the OLD topology, builds the new plan's components, re-shards the
  live state, checkpoints again under the NEW topology and resumes.  A hard
  :class:`~apex_tpu_torch.resilience.faults.Preemption` propagates (on
  every rank); the next trainer reads the manifest's stamped topology,
  restores onto it and re-shards to its own plan.

A signal reaches one process, so at each step boundary the ranks agree on
what they saw (one object all-gather over the job: a preemption anywhere
preempts everywhere, the lowest rank's re-plan target wins) before anyone
acts, and after each step the ranks take the first rank's next step (a
guard rollback moves it back on every rank, idle ones included).

Which transitions are BITWISE: with the global batch replicated over the
data axis, each rank's gradient is the same, and a sum of two identical
values is exact, so dp changes between 1 and 2 ranks resume bit for bit
(the ZeRO reduce-scatter sums ``world`` identical copies and divides them
back out).  A gloo or NCCL sum of three or four copies rounds in an order
the transport picks, so larger worlds are held at gates read from correct
and planted-fault runs (``tools/elastic_torch.py``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import signal as _signal
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from apex_tpu_torch.multi_tensor_apply import bucketing as B
from apex_tpu_torch.resilience.guard import (GuardedTrainStep, _inner,
                                             load_optimizer_state,
                                             optimizer_state)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.device import resolve_device

__all__ = ["ElasticComponents", "ElasticPlan", "ElasticSignal",
           "ElasticTrainer", "HostSignals", "TopologySpec",
           "ZeROGuardAdapter", "reshard_optimizer_state"]

_f32 = torch.float32
_TRANSFORMS = ("tp/pp layout transforms of the elastic re-shard need the "
               "port of pack_for_shard_map / unpack_from_shard_map "
               "(ROADMAP.md queue A item 15, left over); dp and ZeRO "
               "changes need no transform")


def _world_and_rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


# -- topology descriptors -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The logical parallelism layout a train state lives under.

    ``zero_shard`` is the ZeRO optimizer-state shard factor over the
    data axis — 1 (replicated optimizer state, the per-leaf fused
    optimizers) or ``dp`` (the distributed optimizers' reduce-scatter
    sharding).  Anything in between would shard rows unevenly against
    the data axis, so it is rejected.
    """
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sequence_parallel: bool = False
    zero_shard: int = 1

    def __post_init__(self):
        for name in ("dp", "tp", "pp", "zero_shard"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if self.zero_shard not in (1, self.dp):
            raise ValueError(
                f"zero_shard must be 1 or dp ({self.dp}), got "
                f"{self.zero_shard}: ZeRO shards the data axis")
        if self.sequence_parallel and self.tp == 1:
            raise ValueError("sequence_parallel requires tp > 1")

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.pp

    def to_dict(self) -> dict:
        return {"dp": int(self.dp), "tp": int(self.tp), "pp": int(self.pp),
                "sequence_parallel": bool(self.sequence_parallel),
                "zero_shard": int(self.zero_shard)}

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        return cls(dp=int(d.get("dp", 1)), tp=int(d.get("tp", 1)),
                   pp=int(d.get("pp", 1)),
                   sequence_parallel=bool(d.get("sequence_parallel", False)),
                   zero_shard=int(d.get("zero_shard", 1)))

    def describe(self) -> str:
        return (f"dp={self.dp} tp={self.tp} pp={self.pp} "
                f"sp={'on' if self.sequence_parallel else 'off'} "
                f"zero={self.zero_shard}")

    def to_plan(self, **overrides):
        """Lift into the full :class:`~apex_tpu_torch.parallel.plan.
        ParallelPlan` this spec is a projection of; ``overrides`` supply
        the knobs the spec does not carry.  ``spec.to_plan().topology() ==
        spec``."""
        from apex_tpu_torch.parallel.plan import ParallelPlan
        return ParallelPlan.from_topology(self, **overrides)


@dataclasses.dataclass(frozen=True, eq=False)
class ElasticPlan:
    """A :class:`TopologySpec` resolved onto ranks.

    ``ranks`` are the plan's global ranks (the first ``n_devices`` of the
    job), ``layout`` their ``(dp, pp, tp)`` array, ``groups`` this rank's
    ``data`` / ``pipe`` / ``model`` groups, ``group`` the group of all the
    plan's ranks (under :mod:`torch.distributed` an axis of one rank has
    a group of that rank alone; None outside the plan, and everywhere
    without :mod:`torch.distributed`) and ``device`` where the plan's
    tensors live.  ``parallel`` is the full ``ParallelPlan`` when
    the plan was built from one.
    """
    spec: TopologySpec
    ranks: tuple
    layout: Any
    groups: dict
    group: Any
    device: torch.device
    parallel: Any = None

    @classmethod
    def build(cls, spec, ranks=None, device=None) -> "ElasticPlan":
        """``spec`` is a :class:`TopologySpec` or a full ``ParallelPlan``
        (kept on :attr:`parallel`); ``ranks`` default to the whole job;
        ``device`` defaults to ``"cuda"`` (raises without CUDA unless
        ``"cpu"`` is asked for).  Every rank of the job must call it."""
        parallel = None
        if not isinstance(spec, TopologySpec) and hasattr(spec, "topology"):
            parallel = spec
            if getattr(parallel, "n_pods", 1) > 1:
                raise ValueError(
                    f"plan has n_pods={parallel.n_pods}: a cross-pod "
                    "MPMD plan spans multiple meshes and cannot build one "
                    "ElasticPlan; set n_pods=1 for a single-mesh ring "
                    "pipeline")
            spec = spec.topology()
        world, _ = _world_and_rank()
        ranks = list(range(world)) if ranks is None else list(ranks)
        n = spec.n_devices
        if len(ranks) < n:
            raise ValueError(
                f"plan {spec.describe()} needs {n} ranks (devices), have "
                f"{len(ranks)}")
        layout, groups, group = ps.subset_groups(ranks[:n], spec.tp,
                                                 spec.pp)
        return cls(spec=spec, ranks=tuple(ranks[:n]), layout=layout,
                   groups=groups, group=group,
                   device=resolve_device(device), parallel=parallel)

    @property
    def active(self) -> bool:
        """Whether this rank is one of the plan's."""
        return _world_and_rank()[1] in self.ranks

    @property
    def mesh_shape(self) -> dict:
        return {"data": self.spec.dp, "pipe": self.spec.pp,
                "model": self.spec.tp}


# -- optimizer state re-sharding ----------------------------------------------

def _is_zero(optimizer) -> bool:
    return hasattr(_inner(optimizer), "_shards")


def _joiners(old_plan, new_plan) -> bool:
    """Whether some rank of the new plan holds no state of the old one."""
    return bool(set(new_plan.ranks) - set(old_plan.ranks))


def _broadcast(tensors, plan) -> None:
    """Broadcast ``tensors`` in place from the plan's first rank over its
    group (its collectives run on the plan's device's backend)."""
    if plan.group is None:
        return
    import torch.distributed as dist
    for t in tensors:
        dist.broadcast(t, src=plan.ranks[0], group=plan.group)


def _zero_reshard(state, old_plan, new_plan, optimizer, new_optimizer):
    """Gather-to-logical -> re-split for ZeRO (bucketed) state.

    Bucket padding is ``block_rows * world`` rows, so the packed layout
    depends on dp — but the pad rows are identically zero, so dropping
    them via ``unflatten_bucket`` under the OLD meta and re-padding via
    ``flatten_bucket`` under the NEW meta moves only zeros: the logical f32
    values (moments AND master weights) transfer bitwise."""
    from apex_tpu_torch.utils import compressed_allreduce as CA
    old_in, new_in = optimizer is not None, new_optimizer is not None
    old_by_key = ({i.key: i for i in _inner(optimizer)._layout().buckets}
                  if old_in else None)
    new_by_key = ({i.key: i for i in _inner(new_optimizer)._layout().buckets}
                  if new_in else None)
    if old_in and new_in and set(old_by_key) != set(new_by_key):
        raise ValueError(
            f"bucket keys changed across the re-shard: {sorted(old_by_key)} "
            f"vs {sorted(new_by_key)} — elastic re-sharding requires a "
            "layout-stable bucketing (message_size=None, same param "
            "grouping)")
    full = {}                                # key -> {slot: new bucket}
    if old_in:
        old = _inner(optimizer)
        for key, info in old_by_key.items():
            dst = {}
            for slot, leaf in state["buckets"][key].items():
                data = getattr(leaf, "data", leaf)
                gathered = CA.all_gather_rows(
                    data, process_group=old.process_group, axis_name=None)
                meta = info.meta._replace(dtype=_f32)
                leaves = B.unflatten_bucket(gathered, meta)
                if new_in:
                    dst[slot] = B.flatten_bucket(
                        leaves, new_by_key[key].meta._replace(dtype=_f32))
            full[key] = dst
    if not new_in:
        return None
    new = _inner(new_optimizer)
    live = optimizer_state(new)
    step = live["step"]
    if old_in:
        step.copy_(state["step"])
    joining = _joiners(old_plan, new_plan)
    for key, info in new_by_key.items():
        for slot, leaf in live["buckets"][key].items():
            buf = full.get(key, {}).get(slot)
            if buf is None:
                buf = torch.empty((info.meta.nrows, 128), dtype=_f32,
                                  device=leaf.data.device)
            if joining:
                _broadcast([buf], new_plan)
            (lo, hi), _ = leaf.index
            leaf.data.copy_(buf[lo:hi])
    if joining:
        _broadcast([step], new_plan)
    return live


def _per_leaf_reshard(state, old_plan, new_plan, new_optimizer):
    """Per-leaf fused-optimizer state is replicated over the data axis: it
    moves as is into the new optimizer, and ranks that join receive it."""
    if new_optimizer is None:
        return None
    if state is not None:
        load_optimizer_state(new_optimizer, state)
    live = optimizer_state(new_optimizer)
    if _joiners(old_plan, new_plan):
        _broadcast([g["step"] for g in live["groups"]]
                   + [t for g in live["groups"] for st in g["state"]
                      for _, t in sorted(st.items())], new_plan)
    return live


def reshard_optimizer_state(state, old_plan: ElasticPlan,
                            new_plan: ElasticPlan, *, optimizer,
                            new_optimizer=None,
                            transform: Optional[Callable] = None):
    """Re-partition optimizer ``state`` (the tree of
    :func:`~apex_tpu_torch.resilience.guard.optimizer_state`) from
    ``old_plan`` onto ``new_plan``, into ``new_optimizer`` (default
    ``optimizer``: an identity re-partition), in place; returns the new
    optimizer's live state tree.

    Every rank of both plans calls it: a rank outside the old plan passes
    ``state=None`` and ``optimizer=None``, a rank outside the new one
    ``new_optimizer=None`` (and gets None back).  ZeRO state takes the
    gather-to-logical -> re-split path; per-leaf state moves as is.
    ``transform`` (a tp/pp layout change) raises ``NotImplementedError``.
    """
    from apex_tpu_torch.parallel.distributed_optimizer import \
        _DistributedMixin
    if transform is not None:
        raise NotImplementedError(_TRANSFORMS)
    if optimizer is not None and new_optimizer is None \
            and new_plan.active:
        new_optimizer = optimizer
    kinds = {isinstance(_inner(o), _DistributedMixin)
             for o in (optimizer, new_optimizer) if o is not None}
    if len(kinds) > 1:
        raise ValueError(
            "old optimizer is ZeRO-sharded but the new one is not (or the "
            "other way round); build the new plan's optimizer of the same "
            "kind before re-sharding")
    if optimizer is not None and not (isinstance(state, dict) and (
            "buckets" in state or "groups" in state)):
        raise ValueError("expected a fused-optimizer state tree "
                         "(resilience.guard.optimizer_state)")
    if kinds == {True}:
        return _zero_reshard(state, old_plan, new_plan, optimizer,
                             new_optimizer)
    return _per_leaf_reshard(state, old_plan, new_plan, new_optimizer)


# -- ZeRO under the guard -----------------------------------------------------


class ZeROGuardAdapter:
    """A distributed (ZeRO) optimizer under :class:`GuardedTrainStep`.

    The port's ZeRO optimizer reduce-scatters each rank's gradients itself,
    so the adapter is thin: it checks that the optimizer's world size is
    the plan's ``zero_shard`` (and its group the plan's ``data`` group),
    ``init()`` makes the shards and returns their state tree, and
    :meth:`step` runs the optimizer's step, whose skip flag is the largest
    of the ranks' (``global_found_inf``): one rank's anomaly skips the
    step on every rank, never on that rank alone.
    """

    def __init__(self, optimizer, plan):
        spec = getattr(plan, "spec", plan)
        zero = getattr(spec, "zero_shard", None)
        if zero is None:
            zero = spec.topology().zero_shard
        if optimizer.world_size != zero:
            raise ValueError(
                f"optimizer world_size={optimizer.world_size} does not "
                f"match plan.zero_shard={zero}; build the optimizer over "
                "the plan's data group")
        groups = getattr(plan, "groups", None)
        if groups is not None and optimizer.process_group \
                is not groups["data"]:
            raise ValueError("the optimizer's process group is not the "
                             "plan's data group")
        self.inner = optimizer
        self.plan = plan

    @property
    def param_groups(self):
        return self.inner.param_groups

    def init(self):
        return optimizer_state(self.inner)

    def step(self, *, grad_scale=1.0, noop_flag=None):
        return self.inner.step(grad_scale=grad_scale, noop_flag=noop_flag)


# -- host signals -------------------------------------------------------------


class ElasticSignal(collections.namedtuple("ElasticSignal",
                                           ("kind", "spec"))):
    """``kind`` is ``"preempt"`` (drain + checkpoint + stop — the
    SIGTERM-with-grace analogue) or ``"replan"`` (re-shard onto ``spec``
    and keep training — the arrival/defrag analogue)."""

    def __new__(cls, kind: str, spec=None):
        if kind not in ("preempt", "replan"):
            raise ValueError(f"unknown signal kind {kind!r}")
        if kind == "replan" and spec is None:
            raise ValueError("replan signals need a target TopologySpec "
                             "or ParallelPlan")
        return super().__new__(cls, kind, spec)


class HostSignals:
    """Thread/handler-safe mailbox for preemption & arrival signals.

    Programmatic delivery (:meth:`request_preempt` /
    :meth:`request_replan`) covers tests and schedulers with an API;
    :meth:`install` binds a POSIX signal (the real SIGTERM grace window)
    to the same mailbox.  :class:`ElasticTrainer` polls once per step —
    signals land between steps, never mid-step.
    """

    def __init__(self):
        self._pending: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._installed: dict = {}

    def request(self, sig: ElasticSignal) -> None:
        with self._lock:
            self._pending.append(sig)

    def request_preempt(self) -> None:
        self.request(ElasticSignal("preempt"))

    def request_replan(self, spec) -> None:
        """``spec`` is a :class:`TopologySpec` or a full
        ``ParallelPlan``."""
        self.request(ElasticSignal("replan", spec))

    def poll(self) -> Optional[ElasticSignal]:
        with self._lock:
            return self._pending.popleft() if self._pending else None

    def install(self, signum: int = _signal.SIGTERM, *,
                kind: str = "preempt",
                spec: Optional[TopologySpec] = None) -> None:
        """Bind a POSIX signal to this mailbox (main thread only, like any
        ``signal.signal`` use); :meth:`uninstall` restores the previous
        handlers."""
        sig = ElasticSignal(kind, spec)   # validate before binding

        def handler(_signum, _frame):
            self.request(sig)

        self._installed[signum] = _signal.signal(signum, handler)

    def uninstall(self) -> None:
        while self._installed:
            signum, prev = self._installed.popitem()
            _signal.signal(signum, prev)


# -- the elastic training loop ------------------------------------------------


@dataclasses.dataclass
class ElasticComponents:
    """What a plan factory returns: a guard wired to the trainer's
    checkpoint manager, the model it trains and a fresh guard state, all in
    THIS plan's layout.  ``optimizer`` is the instance
    :func:`reshard_optimizer_state` reasons about (default: the guard's,
    the ZeRO optimizer inside a :class:`ZeROGuardAdapter`).  ``transform``
    would map a model from another plan's layout into this one (tp/pp
    changes; not ported: it raises)."""
    guard: GuardedTrainStep
    model: Any
    guard_state: Any
    optimizer: Any = None
    transform: Optional[Callable[[Any, ElasticPlan], Any]] = None

    def reshard_optimizer(self):
        return self.optimizer if self.optimizer is not None \
            else _inner(self.guard.optimizer)


class ElasticTrainer:
    """Signal-driven elastic training around :class:`GuardedTrainStep`.

    ``factory(plan, checkpoint, fault_injector) -> ElasticComponents``
    builds everything a topology needs on the plan's ranks (it is called
    only on ranks of the plan); the trainer owns the plan lifecycle::

        RUNNING --signal--> DRAIN (async saves) --> CHECKPOINT (old
        topology) --> REPLAN (factory on the new plan) --> RESHARD
        (params/optimizer/guard/scaler onto the new ranks) -->
        CHECKPOINT (new topology) --> RUNNING

    Every rank of the job runs the trainer (the plans take its first ``n``
    ranks); a rank outside the current plan takes part in the signal
    agreement and the re-plans and idles otherwise.

    Observability: ``elastic_preempt_signals`` / ``elastic_replans``
    counters, the ``elastic_reshard_seconds`` histogram and the
    ``elastic_resume_step`` gauge on ``registry``; ``elastic/replan`` and
    ``elastic/restore`` spans (plus signal instants) on ``tracer``; a
    ``trainer`` source on ``recorder``.
    """

    def __init__(self, factory, plan: ElasticPlan, *, directory: str,
                 fault_injector=None, signals: Optional[HostSignals] = None,
                 registry=None, tracer=None, recorder=None, keep: int = 3,
                 save_every: int = 1,
                 clock: Callable[[], float] = time.perf_counter):
        from apex_tpu_torch.resilience.checkpoint import CheckpointManager

        self.factory = factory
        self.plan = plan
        self._base_spec = plan.spec
        self.fault_injector = fault_injector
        self.signals = signals
        self.tracer = tracer
        self.recorder = recorder
        self.save_every = max(1, int(save_every))
        self.clock = clock
        self._ranks = list(range(_world_and_rank()[0]))
        self._device = plan.device
        self.checkpoint = CheckpointManager(
            directory, keep=keep, fault_injector=fault_injector,
            topology=plan.spec, parallel_plan=plan.parallel,
            group=plan.group)
        self._comp: Optional[ElasticComponents] = None
        self._gstate = None
        self._started = False
        self._preempt_requested = False
        self._step = 0
        self.stats = {"replans": 0, "preempt_signals": 0,
                      "resume_step": 0, "last_checkpoint_s": 0.0,
                      "last_reshard_s": 0.0}
        self._c_signals = self._c_replans = None
        self._h_reshard = self._g_resume = None
        if registry is not None:
            self._c_signals = registry.counter(
                "elastic_preempt_signals",
                "preemption/arrival signals received")
            self._c_replans = registry.counter(
                "elastic_replans", "topology re-plans executed")
            self._h_reshard = registry.histogram(
                "elastic_reshard_seconds",
                "checkpoint+rebuild+reshard wall time per re-plan")
            self._g_resume = registry.gauge(
                "elastic_resume_step",
                "step training (re)started from after the last "
                "restore/re-plan")

    # -- small observability helpers ----------------------------------------

    def _span(self, name: str, **args):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, device=False, **args)

    def _signal_seen(self, step: int, kind: str) -> None:
        self.stats["preempt_signals"] += 1
        if self._c_signals is not None:
            self._c_signals.inc()
        if self.tracer is not None:
            self.tracer.instant("elastic/signal", step=step, kind=kind)
        if self.recorder is not None:
            self.recorder.record("trainer", "signal", step=step, kind=kind)

    def _resumed_at(self, step: int) -> None:
        self.stats["resume_step"] = int(step)
        if self._g_resume is not None:
            self._g_resume.set(int(step))

    # -- the job's agreement -------------------------------------------------

    def _multi(self) -> bool:
        return len(self._ranks) > 1

    def _agree(self, obj):
        """Every rank's ``obj``, in rank order (one object all-gather)."""
        if not self._multi():
            return [obj]
        import torch.distributed as dist
        out = [None] * len(self._ranks)
        dist.all_gather_object(out, obj)
        return out

    def _sync_step(self, step: int) -> int:
        """The first rank's step (a rollback there moves every rank)."""
        if not self._multi():
            return int(step)
        import torch.distributed as dist
        box = [int(step)]
        dist.broadcast_object_list(box, src=self._ranks[0])
        return int(box[0])

    # -- component lifecycle -------------------------------------------------

    def _build(self, plan: ElasticPlan,
               injector="inherit") -> Optional[ElasticComponents]:
        if not plan.active:
            return None
        inj = self.fault_injector if injector == "inherit" else injector
        comp = self.factory(plan, self.checkpoint, inj)
        if comp.guard.checkpoint is not self.checkpoint:
            raise ValueError(
                "the factory must attach the trainer's CheckpointManager "
                "to the guard (guard.checkpoint is the rollback store)")
        return comp

    def _set_plan_stamp(self, plan: ElasticPlan) -> None:
        self.checkpoint.topology = plan.spec
        self.checkpoint.parallel_plan = plan.parallel
        self.checkpoint.group = plan.group

    def _save(self, step: int) -> None:
        if self._comp is not None:
            self._comp.guard.save(step, self._comp.model, self._gstate)

    def _restore_into(self, comp: ElasticComponents,
                      topology) -> int:
        """Restore the newest checkpoint into ``comp`` (this rank's part);
        returns its step."""
        template = comp.guard._template(comp.model, comp.guard_state)
        restored, _ = self.checkpoint.restore(template, topology=topology)
        comp.guard.load_state(comp.model, restored)
        self._comp, self._gstate = comp, restored["guard"]
        return int(restored["step"])

    @torch.no_grad()
    def _reshard_onto(self, old_plan: ElasticPlan,
                      old_comp: Optional[ElasticComponents],
                      new_plan: ElasticPlan,
                      new_comp: Optional[ElasticComponents]) -> None:
        if new_comp is not None and new_comp.transform is not None:
            raise NotImplementedError(_TRANSFORMS)
        joining = _joiners(old_plan, new_plan)
        old_state = (optimizer_state(old_comp.reshard_optimizer())
                     if old_comp is not None else None)
        new_gstate = None
        if new_comp is not None:
            new_params = dict(new_comp.model.named_parameters())
            gstate = new_comp.guard_state
            if old_comp is not None:
                for name, p in old_comp.model.named_parameters():
                    new_params[name].copy_(p)
                for dst, src in zip(gstate, self._gstate):
                    dst.copy_(src)
                if new_comp.guard.scaler is not None:
                    from apex_tpu_torch.resilience.guard import (
                        load_scaler_state, scaler_state)
                    load_scaler_state(new_comp.guard.scaler,
                                      scaler_state(old_comp.guard.scaler))
            if joining:
                extra = []
                if new_comp.guard.scaler is not None:
                    from apex_tpu_torch.resilience.guard import scaler_state
                    extra = list(scaler_state(new_comp.guard.scaler))
                _broadcast([new_params[k] for k in sorted(new_params)]
                           + list(gstate) + extra, new_plan)
            new_gstate = gstate
        reshard_optimizer_state(
            old_state, old_plan, new_plan,
            optimizer=(old_comp.reshard_optimizer()
                       if old_comp is not None else None),
            new_optimizer=(new_comp.reshard_optimizer()
                           if new_comp is not None else None))
        self._gstate = new_gstate

    # -- restore / replan ----------------------------------------------------

    def _restore_or_init(self, resume: bool) -> int:
        latest = self._agree(self.checkpoint.latest_step())[0]
        if not resume or latest is None:
            comp = self._build(self.plan)
            self._comp = comp
            self._gstate = None if comp is None else comp.guard_state
            self._resumed_at(0)
            return 0
        saved = self.checkpoint.topology_of(latest)
        saved_spec = (TopologySpec.from_dict(saved) if saved
                      else self.plan.spec)
        with self._span("elastic/restore"):
            if saved_spec == self.plan.spec:
                comp = self._build(self.plan)
                step = (self._restore_into(comp, self.plan.spec)
                        if comp is not None else 0)
            else:
                # restore onto the SAVED topology's layout, then re-plan
                # onto ours — the restart half of a shrink/grow cycle
                old_plan = ElasticPlan.build(saved_spec, self._ranks,
                                             self._device)
                self._set_plan_stamp(old_plan)
                old_comp = self._build(old_plan, injector=None)
                step = (self._restore_into(old_comp, self.plan.spec)
                        if old_comp is not None else 0)
                step = self._sync_step(step)
                target = (self.plan.parallel
                          if self.plan.parallel is not None
                          else self.plan.spec)
                self._replan(target, step, from_plan=old_plan,
                             checkpoint_first=False)
        step = self._sync_step(step)
        self._resumed_at(step)
        return step

    def _replan(self, new_spec, step: int, *,
                from_plan: Optional[ElasticPlan] = None,
                checkpoint_first: bool = True) -> None:
        t0 = self.clock()
        old_plan = from_plan if from_plan is not None else self.plan
        old_comp = self._comp
        target = getattr(new_spec, "topology", None)
        described = (new_spec.describe() if target is None
                     else target().describe())
        with self._span("elastic/replan", step=step,
                        old=old_plan.spec.describe(), new=described):
            if checkpoint_first:
                # drain in-flight async writes, then a boundary
                # checkpoint stamped with the OLD topology — the state a
                # hard kill mid-reshard falls back to
                self.checkpoint.wait()
                self._save(step)
            t_ck = self.clock()
            new_plan = ElasticPlan.build(new_spec, self._ranks,
                                         self._device)
            self._set_plan_stamp(new_plan)
            try:
                new_comp = self._build(new_plan)
                self._reshard_onto(old_plan, old_comp, new_plan, new_comp)
            except Exception:
                # a failed build/re-shard must leave the manifest stamped
                # with the topology the live state still has
                self._set_plan_stamp(old_plan)
                raise
            self._comp, self.plan = new_comp, new_plan
            # post-reshard checkpoint in the NEW layout: the guard's
            # K-anomaly rollback must never restore an old-topology layout
            self._save(step)
        dt = self.clock() - t0
        self.stats["replans"] += 1
        self.stats["last_checkpoint_s"] = t_ck - t0
        self.stats["last_reshard_s"] = dt - (t_ck - t0)
        if self._c_replans is not None:
            self._c_replans.inc()
        if self._h_reshard is not None:
            self._h_reshard.observe(dt)
        if self.recorder is not None:
            self.recorder.record("trainer", "replan", step=step,
                                 old=old_plan.spec.describe(),
                                 new=described, reshard_s=dt)
        self._resumed_at(step)

    # -- signal polling ------------------------------------------------------

    def _auto_spec(self, magnitude: float) -> TopologySpec:
        """Target spec for an injected ``topology_change``: magnitude > 0
        names the new dp; 0 toggles shrink-to-half / grow-to-base."""
        cur = self.plan.spec
        if magnitude > 0:
            new_dp = int(magnitude)
        else:
            new_dp = (max(1, cur.dp // 2) if cur.dp == self._base_spec.dp
                      else self._base_spec.dp)
        # a ZeRO plan shrunk to dp 1 has zero_shard 1 too: the base plan
        # says whether the state is sharded when it grows back
        zero = (new_dp if max(cur.zero_shard, self._base_spec.zero_shard)
                > 1 else 1)
        return dataclasses.replace(cur, dp=new_dp, zero_shard=zero)

    def _poll_signals(self, step: int):
        target = None
        inj = self.fault_injector
        if inj is not None:
            fault = inj.check_topology_change(step)
            if fault is not None:
                self._signal_seen(step, "topology_change")
                target = self._auto_spec(fault.magnitude)
        if self.signals is not None:
            sig = self.signals.poll()
            while sig is not None:
                self._signal_seen(step, sig.kind)
                if sig.kind == "preempt":
                    self._preempt_requested = True
                else:
                    target = sig.spec
                sig = self.signals.poll()
        seen = self._agree((self._preempt_requested, target))
        self._preempt_requested = any(p for p, _ in seen)
        return next((t for _, t in seen if t is not None), None)

    # -- the loop ------------------------------------------------------------

    def start(self, resume: bool = True) -> int:
        """Build — or restore, with ``resume`` and a checkpoint present —
        the live components.  Idempotent; returns the current step."""
        if not self._started:
            self._step = self._restore_or_init(resume)
            self._started = True
        return self._step

    @property
    def current_step(self) -> int:
        """The step the next :meth:`step_once` will run."""
        return self._step

    def replan_to(self, new_spec, *, checkpoint_first: bool = True) -> None:
        """Synchronous externally-driven re-plan to ``new_spec`` at the
        current step boundary (every rank calls it) — the capacity
        controller's drain-training primitive.  Failures propagate with
        the checkpoint stamp already restored."""
        self.start()
        self._replan(new_spec, self._step,
                     checkpoint_first=checkpoint_first)

    def step_once(self, batch_fn) -> str:
        """Advance exactly one guarded step (after signal polling).
        Returns ``"ran"``, or ``"preempted"`` when a preempt signal
        checkpointed and stopped the trainer instead."""
        self.start()
        step = self._step
        target = self._poll_signals(step)
        if self._preempt_requested:
            self.checkpoint.wait()
            self._save(step)
            self._preempt_requested = False
            return "preempted"
        if target is not None:
            # a target equal to the current spec is an IN-PLACE rebuild
            # (checkpoint, rebuild, identity re-partition)
            self._replan(target, step)
        inj = self.fault_injector
        if inj is not None:
            inj.check_preempt(step)     # a hard kill ends every rank
        comp = self._comp
        if comp is not None:
            res = comp.guard(comp.model, self._gstate,
                             *batch_fn(step, self.plan), step=step)
            self._gstate = res.guard_state
            step = res.next_step
            if self.recorder is not None:
                self.recorder.record("trainer", "step", step=step,
                                     loss=float(res.loss_value),
                                     rolled_back=bool(res.rolled_back))
                if res.rolled_back:
                    self.recorder.trigger("guard_rollback", step=step,
                                          loss=float(res.loss_value))
            if step % self.save_every == 0 or res.rolled_back:
                self._save(step)
        self._step = self._sync_step(step)
        return "ran"

    def train(self, batch_fn, n_steps: int, *, resume: bool = True) -> dict:
        """Run up to ``n_steps`` guarded steps, reacting to signals.

        ``batch_fn(step, plan) -> batch args`` supplies data for the
        CURRENT plan.  Returns a summary dict; the live state stays
        readable as :attr:`model` / :attr:`opt_state` /
        :attr:`guard_state`.  A hard :class:`Preemption` propagates —
        restart is a fresh trainer with ``resume=True``."""
        self.start(resume)
        status = "completed"
        while self._step < n_steps:
            if self.step_once(batch_fn) == "preempted":
                status = "preempted"
                break
        return {"status": status, "step": self._step,
                "replans": self.stats["replans"],
                "preempt_signals": self.stats["preempt_signals"],
                "rollbacks": (self._comp.guard.counters["rollbacks"]
                              if self._comp else 0)}

    # -- live state ----------------------------------------------------------

    @property
    def model(self):
        return None if self._comp is None else self._comp.model

    @property
    def opt_state(self):
        return (None if self._comp is None
                else optimizer_state(self._comp.reshard_optimizer()))

    @property
    def guard_state(self):
        return self._gstate

    @property
    def guard(self) -> Optional[GuardedTrainStep]:
        return self._comp.guard if self._comp is not None else None
