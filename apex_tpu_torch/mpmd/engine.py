"""``MpmdPipeline`` — host-driven cross-pod pipeline training; port of
``apex_tpu/mpmd/engine.py``.

One controller, as in JAX: this process holds one
:class:`~apex_tpu_torch.mpmd.stage.StageProgram` a pipeline stage, each on
its own :class:`torch.device` (``device=`` places every stage on one card,
``devices=`` gives one device a stage), executes jobs in the order a
:mod:`~apex_tpu_torch.mpmd.schedule` produced, and moves stage boundaries
through a :class:`~apex_tpu_torch.mpmd.channel.LocalDcnChannel` — retrying
:class:`~apex_tpu_torch.mpmd.channel.DcnTimeout` drops in place.  The
channel moves plain data: a received activation becomes a new leaf on the
destination device, and the gradient of that input travels back the same
way; autograd never crosses a boundary.

Numerics contract: at ``dp == 1`` one :meth:`loss_and_grads` is bit for
bit the port's ring engine (:func:`~apex_tpu_torch.models.gpt.
pipeline_step`) at the same stage count — the stage programs replay the
ring's per-micro-batch accumulation (ascending ``m``, the loss seeded
``1 / M``), and the channel moves bytes verbatim.  At ``dp > 1`` each stage
runs its data shards in turn, one accumulator a shard, and averages them
in ascending shard order where JAX ``pmean`` s.

Tied embedding across pods: the last stage ships its per-data-shard head
gradient to the first stage, which merges it into the embedding pullback
BEFORE the data mean (the ring's summation order); the total then ships
back so the last stage's embedding replica takes the identical
(elementwise) optimizer update — the two copies stay bit for bit in
lockstep without a reduction spanning pods.

Integration: :meth:`save_checkpoint` writes one
:class:`~apex_tpu_torch.resilience.checkpoint.CheckpointManager` tree a
stage under one stamped ``MPMD_PLAN.json`` (restore validates the
cross-pod plan and :meth:`restore_stage` re-seats a single killed stage);
``trace=True`` gives every stage a
:class:`~apex_tpu_torch.observability.spans.Tracer` lane, threads
per-micro-batch flow events (``dcn_send`` / ``dcn_recv``) through every
hop, and records the per-op anatomy events (``mpmd_op`` compute spans,
``mpmd_xfer`` link spans with their link class, one ``mpmd_schedule``
marker a step) that :mod:`apex_tpu_torch.observability.anatomy`
reconstructs — :meth:`anatomy_events` hands them over, and
``measure_ops=True`` ends each op's span with a
``torch.cuda.synchronize`` of the stage's device, so the spans measure
device time, not dispatch.  A ``dp > 1`` stage's op span covers all of its
shards (they run in turn).  :meth:`collector` returns the
:class:`~apex_tpu_torch.observability.fleetobs.FleetCollector` whose
``continuity()`` must come back unbroken.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, List, Optional

import torch

from apex_tpu_torch.mpmd.channel import Edge, LocalDcnChannel
from apex_tpu_torch.mpmd.schedule import SCHEDULES, edge_link_classes
from apex_tpu_torch.mpmd.stage import StageProgram

__all__ = ["MpmdPipeline", "MPMD_PLAN_FILE"]

MPMD_PLAN_FILE = "MPMD_PLAN.json"
_PLAN_VERSION = 1


class MpmdPipeline:
    """Cross-pod MPMD pipeline over per-stage programs.

    ``model_kw`` are the :class:`~apex_tpu_torch.models.gpt.GPTConfig`
    kwargs of the FULL model (``num_layers`` total); ``state_dict`` its
    serial state dict (``GPTModel(cfg).state_dict()`` names, e.g. from
    :func:`~apex_tpu_torch.convert.gpt_params_from_jax`), or None for the
    fresh modules' values; ``plan`` the cross-pod
    :class:`~apex_tpu_torch.parallel.plan.ParallelPlan` (``pp`` = stage
    count, ``n_pods`` pod blocks, optional per-pod ``stage_plans``).
    ``device`` (default ``"cuda"``; raises without CUDA unless ``"cpu"`` is
    passed) holds every stage; ``devices`` gives stage ``i`` the device
    ``devices[i]`` instead.
    """

    def __init__(self, model_kw: Dict[str, Any], state_dict, plan, *,
                 device=None, devices=None, lr: float = 1e-3, channel=None,
                 fault_injector=None, schedule: str = "1f1b",
                 trace: bool = False, measure_ops: bool = False):
        from apex_tpu_torch.models.gpt import GPTConfig, stage_state_dict
        from apex_tpu_torch.parallel.plan import ParallelPlan

        if plan.pp < 2:
            raise ValueError(
                f"MPMD needs pp >= 2 (got pp={plan.pp}): a one-stage "
                "pipeline has no cross-pod edges — use the single-mesh "
                "engines")
        if plan.n_virtual != 1:
            raise ValueError(
                "MPMD stages are whole programs; the interleaved "
                "schedule (n_virtual > 1) only exists inside the ring "
                "engine's scan")
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; "
                             f"one of {sorted(SCHEDULES)}")
        self.plan = plan
        self.n_stages = int(plan.pp)
        self.M = int(plan.n_microbatches)
        self.dp = int(plan.dp)
        self.schedule_name = schedule
        self.order = SCHEDULES[schedule](self.n_stages, self.M)
        self._edge_class = edge_link_classes(self.n_stages, plan.n_pods)
        self.channel = (channel if channel is not None
                        else LocalDcnChannel(
                            fault_injector=fault_injector))

        kw = dict(model_kw)
        n_layers = int(kw["num_layers"])
        if n_layers % self.n_stages:
            raise ValueError(
                f"num_layers ({n_layers}) must divide into pp "
                f"({self.n_stages}) equal stage chunks")
        for drop in ("tensor_parallel_size", "axis_name",
                     "sequence_parallel", "plan"):
            kw.pop(drop, None)
        if devices is not None:
            devices = list(devices)
            if len(devices) < self.n_stages:
                raise ValueError(
                    f"devices holds {len(devices)} entries but the "
                    f"cross-pod plan has {self.n_stages} stages (one "
                    "device a stage)")
        else:
            devices = [device] * self.n_stages

        per_pod = self.n_stages // plan.n_pods
        self.stages: List[StageProgram] = []
        for i in range(self.n_stages):
            pod = i // per_pod
            if plan.stage_plans is not None:
                sub = plan.stage_plans[pod]
            else:
                sub = ParallelPlan(
                    dp=plan.dp, tp=plan.tp,
                    sequence_parallel=plan.sequence_parallel)
            cfg = GPTConfig(
                tensor_parallel_size=sub.tp,
                axis_name="model" if sub.tp > 1 else None,
                sequence_parallel=sub.sequence_parallel, **kw)
            params = (None if state_dict is None else stage_state_dict(
                state_dict, n_layers, self.n_stages, 1, i))
            self.stages.append(StageProgram(
                cfg, params, stage_index=i, n_stages=self.n_stages,
                n_microbatches=self.M, plan=sub, device=devices[i], lr=lr))

        # measure_ops implies trace: each op's span ends with a sync of
        # its device, so span durations are device times — at the cost of
        # serializing the host (an anatomy / profiling mode)
        self.measure_ops = bool(measure_ops)
        self.tracers = None
        if trace or self.measure_ops:
            from apex_tpu_torch.observability.spans import Tracer
            self.tracers = [Tracer(id_tag=f"stage{i}")
                            for i in range(self.n_stages)]
        self.step_count = 0

    # -- transfers --------------------------------------------------------

    def _link_class(self, src: int, dst: int) -> str:
        if abs(src - dst) == 1:
            return self._edge_class.get(min(src, dst), "ici")
        # the tied-embedding sync between the first and last pod
        return "dcn" if self.plan.n_pods > 1 else "ici"

    def _block(self, value, device):
        """Wait for ``device`` (anatomy mode): span durations then
        measure the work, not just its dispatch."""
        if self.measure_ops and device.type == "cuda":
            torch.cuda.synchronize(device)
        return value

    def _op_span(self, s: int, kind: str, m: int, step: int, **extra):
        """The per-op structured trace span anatomy reconstructs from
        (no-op without tracing)."""
        if self.tracers is None:
            return contextlib.nullcontext()
        return self.tracers[s].span(
            "mpmd_op", device=False, op=kind, stage=s, mb=m,
            step=step, **extra)

    def _transfer(self, src: int, dst: int, value, *, step: int,
                  ctx=None, phase: str = "act"):
        from apex_tpu_torch.observability.fleetobs import emit_flow
        edge = Edge(src, dst, self._link_class(src, dst))
        # phase is "fwd.m3" / "bwd.m5" for schedule edges and
        # "head_grad" / "embed_total" for the tied-embedding sync
        kind, _, mbs = phase.partition(".m")
        cm = contextlib.nullcontext()
        if self.tracers is not None:
            emit_flow(self.tracers[src], ctx, "dcn_send",
                      edge=f"{src}->{dst}", payload=phase)
            cm = self.tracers[src].span(
                "mpmd_xfer", device=False, src=src, dst=dst,
                kind=kind, mb=int(mbs) if mbs else -1,
                link_class=edge.link_class, step=step)
        dst_device = self.stages[dst].device
        with cm:
            out = self._block(self.channel.send_with_retry(
                value, dst_device, step=step, edge=edge), dst_device)
        if self.tracers is not None:
            emit_flow(self.tracers[dst], ctx, "dcn_recv",
                      edge=f"{src}->{dst}", payload=phase)
        return out

    # -- one training step ------------------------------------------------

    def _place_inputs(self, tokens, targets):
        st0, stl = self.stages[0], self.stages[-1]
        tokens = torch.as_tensor(tokens)
        targets = torch.as_tensor(targets)
        rows, seq = tokens.shape
        if rows != self.dp * self.M * (rows // (self.dp * self.M)):
            raise ValueError(
                f"tokens rows ({rows}) must be dp*M*microbatch "
                f"(dp={self.dp}, M={self.M})")
        mb = rows // (self.dp * self.M)
        per = self.M * mb
        tokens_d = [tokens[d * per:(d + 1) * per].to(st0.device)
                    for d in range(self.dp)]
        targets_d = list(targets.reshape(self.dp, self.M, mb, seq)
                         .to(stl.device).unbind(0))
        return tokens_d, targets_d

    def loss_and_grads(self, tokens, targets, *,
                       step: Optional[int] = None):
        """Run one full schedule; returns ``(loss, per-stage grads)``, each
        stage's grads a dict by the stage model's parameter names covering
        its state (``StageProgram.state``)."""
        from apex_tpu_torch.observability.fleetobs import (TraceContext,
                                                           emit_flow)
        step = self.step_count if step is None else int(step)
        S, M = self.n_stages, self.M
        st0, stl = self.stages[0], self.stages[-1]
        tokens_d, targets_d = self._place_inputs(tokens, targets)

        accs = [st.fresh_acc(st.layer_names) for st in self.stages]
        lacc = stl.fresh_acc(stl.last_names)
        loss_acc = stl.fresh_loss_acc()
        x_all = st0.run_embed(tokens_d)
        dx0 = st0.fresh_dx0(x_all)

        ctxs = {}
        if self.tracers is not None:
            ctxs = {m: TraceContext.mint(f"s{step}.m{m}")
                    for m in range(M)}
            self.tracers[0].instant(
                "mpmd_schedule", n_stages=S, n_microbatches=M,
                schedule=self.schedule_name, step=step, dp=self.dp,
                link_classes={str(e): c for e, c
                              in self._edge_class.items()},
                measured=self.measure_ops)
        stash_x: Dict[Any, Any] = {}
        stash_dy: Dict[Any, Any] = {}

        for s, kind, m in self.order:
            st = self.stages[s]
            ctx = ctxs.get(m)
            if kind == "fwd":
                if st.is_last:
                    continue       # folded into the joint backward
                x = x_all if st.is_first else stash_x.pop((s, m))
                with self._op_span(s, "fwd", m, step):
                    y = self._block(st.run_fwd(x, m), st.device)
                stash_x[(s + 1, m)] = self._transfer(
                    s, s + 1, y, step=step, ctx=ctx, phase=f"fwd.m{m}")
            else:
                if st.is_last:
                    with self._op_span(s, "bwd", m, step,
                                       folded_fwd=True):
                        dx = self._block(st.run_bwd_last(
                            targets_d, stash_x.pop((s, m)), accs[s],
                            lacc, loss_acc, m), st.device)
                elif st.is_first:
                    with self._op_span(s, "bwd", m, step):
                        st.run_bwd(stash_dy.pop((s, m)), accs[s], m,
                                   dx0=dx0)
                        self._block(None, st.device)
                    if self.tracers is not None:
                        emit_flow(self.tracers[0], ctx, "mb_done",
                                  final=True)
                    continue
                else:
                    with self._op_span(s, "bwd", m, step):
                        dx = self._block(st.run_bwd(
                            stash_dy.pop((s, m)), accs[s], m), st.device)
                stash_dy[(s - 1, m)] = self._transfer(
                    s, s - 1, dx, step=step, ctx=ctx, phase=f"bwd.m{m}")

        # -- tied-embedding gradient sync: last -> first -> last ------
        sync_ctx = None
        if self.tracers is not None:
            sync_ctx = TraceContext.mint(f"s{step}.sync")
        emb = stl.last_names.index("embedding.weight")
        head_eg = self._transfer(
            S - 1, 0, [shard[emb] for shard in lacc], step=step,
            ctx=sync_ctx, phase="head_grad")
        g0 = st0.run_embed_bwd(dx0, head_eg)

        grads: List[Dict[str, Any]] = []
        for i, st in enumerate(self.stages):
            gi: Dict[str, Any] = st.run_finish_layers(accs[i])
            if st.is_first:
                gi.update(g0)
            if st.is_last:
                gi.update(st.run_finish_last(lacc))
                if not st.is_first:
                    gi["embedding.weight"] = self._transfer(
                        0, S - 1, g0["embedding.weight"], step=step,
                        ctx=sync_ctx, phase="embed_total")
            grads.append(gi)
        if self.tracers is not None:
            emit_flow(self.tracers[S - 1], sync_ctx, "sync_done",
                      final=True)
        loss = stl.run_loss_final(loss_acc)
        return loss, grads

    def train_step(self, tokens, targets, *,
                   step: Optional[int] = None):
        """Full schedule + each stage's optimizer step."""
        loss, grads = self.loss_and_grads(tokens, targets, step=step)
        for st, g in zip(self.stages, grads):
            st.apply_grads(g)
        self.step_count += 1
        return loss

    # -- checkpointing ----------------------------------------------------

    def _manager(self, directory: str, i: int, keep: int = 2):
        from apex_tpu_torch.resilience.checkpoint import CheckpointManager
        st = self.stages[i]
        return CheckpointManager(
            os.path.join(directory, f"stage_{i:02d}"), keep=keep,
            topology=st.plan.topology(), parallel_plan=st.plan)

    def save_checkpoint(self, directory: str, step: int, *,
                        keep: int = 2) -> None:
        """Per-stage checkpoint trees under one stamped cross-pod
        plan: ``directory/MPMD_PLAN.json`` + ``directory/stage_XX/``
        per stage — each stage's manifest carries ITS intra-pod plan,
        the top-level stamp the plan that binds them."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, MPMD_PLAN_FILE), "w",
                  encoding="utf-8") as f:
            json.dump({"version": _PLAN_VERSION,
                       "n_stages": self.n_stages,
                       "plan": self.plan.to_dict()}, f, indent=1)
        for i, st in enumerate(self.stages):
            self._manager(directory, i, keep).save(
                step, st.checkpoint_state())

    def _check_plan_stamp(self, directory: str) -> None:
        path = os.path.join(directory, MPMD_PLAN_FILE)
        with open(path, encoding="utf-8") as f:
            stamp = json.load(f)
        if stamp.get("plan") != self.plan.to_dict():
            raise ValueError(
                f"checkpoint at {directory} was saved under cross-pod "
                f"plan {stamp.get('plan')} but this engine runs "
                f"{self.plan.to_dict()}; restore onto a matching "
                "MpmdPipeline (per-stage states are packed for their "
                "stamped intra-pod layouts)")

    def restore_stage(self, i: int, directory: str, *,
                      step: Optional[int] = None,
                      _checked: bool = False) -> int:
        """Re-seat ONE stage from its checkpoint tree — the
        kill-one-stage recovery path: the surviving stages keep their
        live state, the replaced pod reloads."""
        if not _checked:
            self._check_plan_stamp(directory)
        st = self.stages[i]
        loaded, got = self._manager(directory, i).restore(
            st.checkpoint_state(), step=step)
        st.load_checkpoint_state(loaded)
        return got

    def restore_checkpoint(self, directory: str, *,
                           step: Optional[int] = None) -> int:
        """Restore every stage from the newest (or pinned) step after
        validating the cross-pod plan stamp."""
        self._check_plan_stamp(directory)
        got = None
        for i in range(self.n_stages):
            s = self.restore_stage(i, directory, step=step,
                                   _checked=True)
            if got is not None and s != got:
                raise ValueError(
                    f"stage {i} restored step {s} but earlier stages "
                    f"restored {got}; the per-stage trees are torn — "
                    "pin step= to a step present in every stage tree")
            got = s
        self.step_count = int(got)
        return int(got)

    # -- observability ----------------------------------------------------

    def collector(self):
        """A :class:`FleetCollector` with one lane per stage (requires
        ``trace=True``)."""
        if self.tracers is None:
            raise ValueError("engine built with trace=False; pass "
                             "trace=True to collect per-stage lanes")
        from apex_tpu_torch.observability.fleetobs import FleetCollector
        c = FleetCollector()
        for i, tr in enumerate(self.tracers):
            c.add_replica(f"stage{i}", tracer=tr)
        return c

    def anatomy_events(self) -> List[dict]:
        """Every stage tracer's events, merged (the tracers share one
        clock, so timestamps are directly comparable) — the input
        :func:`apex_tpu_torch.observability.anatomy.reconstruct` expects.
        Requires ``trace=True``; pass ``measure_ops=True`` for span
        durations that include device time."""
        if self.tracers is None:
            raise ValueError("engine built with trace=False; pass "
                             "trace=True (or measure_ops=True) to "
                             "record per-op anatomy events")
        events: List[dict] = []
        for tr in self.tracers:
            events.extend(tr.events)
        return events
