"""ZeRO-style distributed fused optimizers — port of
``apex_tpu/parallel/distributed_optimizer.py`` (apex
``contrib/optimizers/distributed_fused_adam.py`` / ``_lamb.py``).

The reference dataflow over the packed ``(rows, 128)`` buckets of
:meth:`~apex_tpu_torch.optimizers.base.FusedOptimizer._layout`, each padded
to ``block_rows * world`` rows so rank ``r`` owns rows ``[r L, (r+1) L)``
(``L = nrows / world``), whole blocks, as device ``r`` of the JAX mesh does:

* ``step()`` reads each rank's local ``.grad`` (a missing one is zeros),
  packs each bucket and reduce-scatters it over the data-parallel group
  (``allreduce_dtype``: exact, bf16 or int8 transport through
  :mod:`apex_tpu_torch.utils.compressed_allreduce`; the reduce-scatter IS
  the gradient reduction, so the model needs no DDP reduction), averages
  (``average_grads``); :meth:`~_DistributedMixin.reduce_gradients` does
  this part ahead of the step, for a caller that needs the reduced
  gradient first (the anomaly guard's norm);
* the fused update runs on the local shard only — its segments, each
  tensor's rows in the shard as one view, through the same kernels as the
  per-parameter optimizers (#18 Adam; #17, #20, #21 LAMB, whose global
  norm and per-tensor trust ratios are summed across the shards) — on the
  f32 master shard (``master_weights`` with non-f32 parameters) or the
  parameters' own rows: moments and masters exist only as ``1/world``
  shards, the ZeRO saving;
* the new parameters are all-gathered exactly (compression applies to
  gradients only) and written back into the parameters, rounded to their
  dtype.

The JAX ``state_specs`` / ``make_init`` / ``make_step`` own a ``shard_map``
region and have no counterpart; :meth:`~_DistributedMixin.state_dict`
names this rank's shards instead (``convert.distributed_state_from_jax``
carries a JAX ZeRO state into them).  The reduce-scatter is the gradient
reduction, so the optimizer refuses the parameters of a
:class:`~apex_tpu_torch.parallel.DistributedDataParallel` (whose hooks
would reduce them a second time): build it over the bare model.

The overflow flag of a dynamic loss scaler is taken from each rank's own
gradients, which nothing has reduced before the step; the step takes the
largest flag over the group (:meth:`~_DistributedMixin.global_found_inf`),
so an overflow on one rank skips the step on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.multi_tensor_apply import bucketing as B
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.parallel.distributed import owner_of
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils import compressed_allreduce as CA
from apex_tpu_torch.utils.collectives import all_reduce_

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB"]

_f32 = torch.float32


class _DistributedMixin:
    """Reduce-scatter -> local fused update -> all-gather over the
    data-parallel group."""

    # the packed (rows, 128) buckets ARE the ZeRO sharding unit
    _default_bucketed = True

    @staticmethod
    def _resolve_plan(plan, world_size, allreduce_dtype):
        """Fold a :class:`~apex_tpu_torch.parallel.plan.ParallelPlan` into
        the per-knob arguments (JAX ``_resolve_plan``): silent without a
        plan; a knob that conflicts with the plan is superseded — the plan
        wins and a DeprecationWarning names it."""
        if plan is None:
            return world_size, allreduce_dtype
        import warnings
        kw = plan.optimizer_kwargs()
        if world_size is not None and world_size != 1 \
                and world_size != kw["world_size"]:
            warnings.warn(
                f"world_size={world_size} is superseded by the attached "
                f"ParallelPlan (zero_shard={kw['world_size']}); set "
                "zero_shard on the plan instead", DeprecationWarning,
                stacklevel=4)
        if allreduce_dtype is not None \
                and allreduce_dtype != kw["allreduce_dtype"]:
            warnings.warn(
                f"allreduce_dtype={allreduce_dtype!r} is superseded by "
                f"the attached ParallelPlan "
                f"({kw['allreduce_dtype']!r})", DeprecationWarning,
                stacklevel=4)
        return kw["world_size"], kw["allreduce_dtype"]

    def _dist_init(self, world_size, axis_name, process_group, average_grads,
                   allreduce_dtype, plan=None):
        world_size, allreduce_dtype = self._resolve_plan(
            plan, world_size, allreduce_dtype)
        self.plan = plan
        self.axis_name = axis_name
        self.process_group = ps.resolve_group(axis_name, process_group)
        self.world_size = ps.group_size(self.process_group)
        if world_size is not None and int(world_size) != self.world_size:
            raise ValueError(
                f"world_size={world_size} but the data-parallel group has "
                f"{self.world_size} ranks; the ZeRO shards must match it")
        self.rank = ps.group_rank(self.process_group)
        self.average_grads = bool(average_grads)
        self.allreduce_dtype = CA.check_mode(allreduce_dtype)
        if not self.bucketed:
            raise ValueError(
                "distributed (ZeRO) optimizers require bucketed=True — "
                "the packed (rows, 128) buckets are what reduce-scatter/"
                "all-gather shard")
        self._shards = {}      # bucket key -> {"m", "v"[, "master"]}
        self._segments = {}    # bucket key -> the shard's segments
        self._step_count = None
        self._reduced = None   # bucket key -> reduced shard, for the step
        if any(owner_of(p) is not None
               for g in self.param_groups for p in g["params"]):
            raise ValueError(
                "a ZeRO optimizer's reduce-scatter is the gradient "
                "reduction: build it over the model's parameters, not a "
                "DistributedDataParallel module's, whose hooks would reduce "
                "them a second time")

    def _meta_block_rows(self):
        return self.block_rows * self.world_size

    def _local_rows(self, info):
        return info.meta.nrows // self.world_size

    def _sum_across(self, t):
        return all_reduce_(t, self.process_group)

    def _bucket(self, info):
        """This rank's state shards and segments of bucket ``info``."""
        st = self._shards.get(info.key)
        if st is None:
            rows = self._local_rows(info)
            lo = self.rank * rows
            device = info.params[0].device
            st = self._init_bucket(rows, device)
            if self.master_weights and info.meta.dtype != _f32:
                st["master"] = B.flatten_rows(
                    [p.detach() for p in info.params], info.meta, lo,
                    lo + rows, _f32)
            self._shards[info.key] = st
            self._segments[info.key] = B.shard_segments(info.meta, lo,
                                                        lo + rows)
        return st, self._segments[info.key]

    def global_found_inf(self, found_inf):
        """The group's overflow flag from this rank's (a new tensor): the
        largest over the ranks.  A loss scaler updates with it, so the
        ranks keep one loss scale (``amp.unscale_step`` does this)."""
        return all_reduce_(found_inf.clone(), self.process_group,
                           dist.ReduceOp.MAX)

    def _noop_and_step(self, noop_flag, device):
        step = self._step_count
        if step is None:
            step = torch.zeros((), dtype=torch.int32, device=device)
        if noop_flag is None:
            return None, step + 1
        noop = (noop_flag.to(device=device, dtype=torch.int32).reshape(())
                if isinstance(noop_flag, torch.Tensor) else
                torch.full((), int(noop_flag), dtype=torch.int32,
                           device=device))
        # a flag from one rank's unreduced gradients: every rank skips
        noop = self.global_found_inf(noop)
        return noop, step + (noop == 0).to(torch.int32)

    def _reduce_scatter(self, layout):
        local = {}
        for info in layout.buckets:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in info.params]
            g_full = B.flatten_bucket(grads, info.meta._replace(
                dtype=grads[0].dtype))
            g_loc = CA.reduce_scatter(g_full, mode=self.allreduce_dtype,
                                      process_group=self.process_group,
                                      axis_name=None)
            if self.average_grads:
                g_loc = g_loc / self.world_size
            local[info.key] = g_loc
        return local

    @torch.no_grad()
    def reduce_gradients(self):
        """Reduce-scatter (and average) the gradients now rather than in
        the next :meth:`step`, which then updates with these shards as they
        are.  Returns this rank's shards of the reduced gradient, one per
        bucket: what the step applies, so a norm taken over them (summed
        across the group) is the applied gradient's."""
        self._reduced = self._reduce_scatter(self._layout())
        return list(self._reduced.values())

    @torch.no_grad()
    def step(self, closure=None, *, grad_scale=1.0, noop_flag=None):
        """One ZeRO step over every parameter (``grad_scale`` and
        ``noop_flag`` as in the per-parameter optimizers)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        layout = self._layout()
        if not layout.buckets:
            return loss
        group_ = self.process_group
        device = layout.buckets[0].params[0].device
        noop, step_count = self._noop_and_step(noop_flag, device)
        local = self._reduced or self._reduce_scatter(layout)
        self._reduced = None
        g_views = [v for info in layout.buckets
                   for v in B.segment_views(local[info.key],
                                            self._bucket(info)[1])]
        extras = self._pre_step_bucketed(g_views, grad_scale,
                                         self._sum_across)
        for info in layout.buckets:
            st, segments = self._bucket(info)
            if "master" in st:
                p_loc = st["master"]
            else:
                lo = self.rank * self._local_rows(info)
                p_loc = B.flatten_rows([p.detach() for p in info.params],
                                       info.meta, lo,
                                       lo + self._local_rows(info))
            self._update_bucket(info, self.param_groups[info.group],
                                segments, local[info.key], p_loc, st,
                                step_count, grad_scale, noop, extras,
                                self._sum_across)
            full = CA.all_gather_rows(p_loc, process_group=group_,
                                      axis_name=None)
            for p, t in zip(info.params, B.unflatten_bucket(
                    full, info.meta._replace(dtype=full.dtype))):
                p.copy_(t)
        self._step_count = step_count
        return loss

    def master_params(self):
        """The f32 values the optimizer updates, one per parameter in
        bucket order: the gathered master shards where there are masters,
        else the parameters upcast (a collective where masters exist)."""
        for info in self._layout().buckets:
            st, _ = self._bucket(info)
            if "master" not in st:
                yield from (p.detach().to(_f32) for p in info.params)
                continue
            full = CA.all_gather_rows(st["master"],
                                      process_group=self.process_group,
                                      axis_name=None)
            yield from B.unflatten_bucket(full, info.meta._replace(
                dtype=_f32))

    def state_dict(self):
        """This rank's state: the step, and per bucket key its shards of
        the moments (and master), rows ``[rank L, (rank+1) L)``."""
        for info in self._layout().buckets:
            self._bucket(info)
        return {"step": (None if self._step_count is None
                         else self._step_count.clone()),
                "world_size": self.world_size, "rank": self.rank,
                "buckets": {k: {n: t.clone() for n, t in st.items()}
                            for k, st in self._shards.items()},
                "param_groups": [{k: v for k, v in g.items()
                                  if k != "params"}
                                 for g in self.param_groups]}

    def load_state_dict(self, state_dict):
        if (state_dict["world_size"], state_dict["rank"]) != (
                self.world_size, self.rank):
            raise ValueError(
                f"the state is rank {state_dict['rank']} of "
                f"{state_dict['world_size']}; this optimizer is rank "
                f"{self.rank} of {self.world_size}")
        for group, saved in zip(self.param_groups,
                                state_dict["param_groups"]):
            group.update(saved)
        for info in self._layout().buckets:
            st, _ = self._bucket(info)
            for name, t in state_dict["buckets"][info.key].items():
                st[name] = t.to(device=info.params[0].device, copy=True)
        step = state_dict["step"]
        device = self.param_groups[0]["params"][0].device
        self._step_count = None if step is None else torch.as_tensor(
            step, dtype=torch.int32).to(device).reshape(())


class DistributedFusedAdam(_DistributedMixin, FusedAdam):
    """ZeRO-sharded FusedAdam (apex ``DistributedFusedAdam``):
    ``DistributedFusedAdam(params, lr=..., axis_name="data")`` (or
    ``process_group=``); ``world_size``, when given, must be the group's
    size.  ``allreduce_dtype`` in ``{None/'f32', 'bf16', 'int8'}`` picks
    the gradient reduce-scatter's transport.  ``plan=`` (a
    :class:`~apex_tpu_torch.parallel.plan.ParallelPlan`) sets both from
    its ``zero_shard`` and ``allreduce_dtype``."""

    def __init__(self, params, lr=1e-3, world_size=None, axis_name="data",
                 average_grads=True, allreduce_dtype=None, *,
                 process_group=None, plan=None, **kw):
        super().__init__(params, lr=lr, **kw)
        self._dist_init(world_size, axis_name, process_group, average_grads,
                        allreduce_dtype, plan)


class DistributedFusedLAMB(_DistributedMixin, FusedLAMB):
    """ZeRO-sharded FusedLAMB (apex ``DistributedFusedLAMB``, the MLPerf
    BERT optimizer): the global gradient norm is the sum across the ranks
    of each shard's #17 sums, and each tensor's trust ratio comes from its
    segments' stage-1 sums, summed across the ranks (a tensor may straddle
    shards)."""

    def __init__(self, params, lr=1e-3, world_size=None, axis_name="data",
                 average_grads=True, allreduce_dtype=None, *,
                 process_group=None, plan=None, **kw):
        super().__init__(params, lr=lr, **kw)
        self._dist_init(world_size, axis_name, process_group, average_grads,
                        allreduce_dtype, plan)

