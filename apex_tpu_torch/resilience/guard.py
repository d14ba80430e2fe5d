"""Anomaly-guarded training — port of ``apex_tpu/resilience/guard.py``: the
loss-scaler overflow skip, generalized.

:class:`GuardedTrainStep` wraps a loss (or a gradient function) and a fused
optimizer into one step that

* detects: a non-finite loss, a non-finite gradient norm, and
  ``‖g‖ > spike_factor × EMA(‖g‖)`` (EMA over clean steps only, armed after
  ``warmup_steps``);
* skips: the anomaly becomes the optimizer's device ``noop_flag`` —
  parameters, moments and the step count are untouched, exactly the
  loss-scaler skip path, with no host sync inside the step;
* records: per-kind counters in the device-side :class:`GuardState` and
  host-side :attr:`~GuardedTrainStep.stats`;
* recovers: after ``max_consecutive`` anomalous steps in a row the wrapper
  restores the last complete checkpoint from its attached
  :class:`~apex_tpu_torch.resilience.checkpoint.CheckpointManager`,
  copying it into the live parameters and optimizer state in place (the
  optimizer holds references to them), and returns ``rolled_back=True``.

PyTorch idiom: ``loss_fn(model, *batch)`` returns the loss and the guard
runs ``backward()``; ``grad_fn(model, *batch)`` runs its own backward (a
micro-batch schedule such as ``forward_backward_no_pipelining``) and
returns the loss.  The guard sets the gradients to None first.  The
gradient norm is one sum of squares over every gradient with kernel #17
(:func:`~apex_tpu_torch.ops.multi_tensor.multi_tensor_sumsq`) — under a
ZeRO optimizer over the reduced gradient's shards, summed across its
group, so it is the norm of the gradient the step applies, as JAX's
adapter hands its guard the reduced gradient — and the
flags, norm, loss and loss scale come back in one 6-element readback a
step, as in JAX.

Fault injection stays data: the injector's per-step flags (``nan_grads``,
``inf_loss``, ``spike_scale``) are applied to the loss and gradients on the
steps that carry them; a clean step skips the identity multiply-add, so
its result is bit for bit an unguarded step's.

With ``group`` (a process group) the ranks decide together: the
non-finite flag and the norm are the largest over the group before the
spike test, so every rank skips, counts and rolls back at the same steps
(the checkpoint's restore agrees on the step as well).

The checkpointed state is ``{"params": {name: tensor}, "opt": ...,
"guard": GuardState, "step": int32, ["scaler": ...]}``;
:func:`optimizer_state` / :func:`load_optimizer_state` are the optimizer
part (per-parameter moments, or a ZeRO optimizer's shards as
:class:`~apex_tpu_torch.resilience.checkpoint.ShardedLeaf` blocks of the
packed buckets), :func:`scaler_state` / :func:`load_scaler_state` the loss
scaler's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from apex_tpu_torch.ops.multi_tensor import multi_tensor_sumsq
from apex_tpu_torch.resilience.checkpoint import ShardedLeaf

_f32 = torch.float32
_i32 = torch.int32

__all__ = ["GuardState", "GuardedTrainStep", "LossScaleState", "StepResult",
           "load_optimizer_state", "load_scaler_state", "optimizer_state",
           "scaler_state"]


class GuardState(NamedTuple):
    """Device-side guard state (checkpointable)."""
    ema_norm: torch.Tensor      # f32 — EMA of the unscaled grad norm
    clean_steps: torch.Tensor   # int32 — steps that fed the EMA
    consecutive: torch.Tensor   # int32 — current anomaly run length
    anomalies: torch.Tensor     # int32 — total skipped steps
    nonfinite: torch.Tensor     # int32 — NaN/inf loss-or-grad skips
    spikes: torch.Tensor        # int32 — grad-norm-spike skips


class LossScaleState(NamedTuple):
    """A :class:`~apex_tpu_torch.amp.LossScaler`'s tensors, in the JAX
    ``LossScaleState`` field order."""
    loss_scale: torch.Tensor
    unskipped: torch.Tensor
    overflows: torch.Tensor
    skipped: torch.Tensor


@dataclasses.dataclass
class StepResult:
    """Outcome of one guarded step.  ``next_step`` is the step the train
    loop runs next — ``step + 1`` normally, the restored step after a
    rollback.  ``params`` / ``opt_state`` / ``scaler_state`` are the live
    tensors (updated in place); ``loss_value`` / ``loss_scale_value`` are
    host floats from the step's one readback (``loss_scale_value`` is None
    without a scaler)."""
    loss: Any
    params: Any
    opt_state: Any
    guard_state: GuardState
    scaler_state: Any
    grad_norm: float
    skipped: bool
    anomaly: Optional[str]          # "nonfinite" | "spike" | None
    next_step: int
    rolled_back: bool = False
    restored_from: Optional[int] = None
    loss_value: float = float("nan")
    loss_scale_value: Optional[float] = None


# -- state trees ---------------------------------------------------------------

def _inner(optimizer):
    return getattr(optimizer, "inner", optimizer)


def _device(optimizer) -> torch.device:
    return _inner(optimizer).param_groups[0]["params"][0].device


def optimizer_state(optimizer):
    """The optimizer's state as a tree of its live tensors, created where
    the first step has not made them yet (as the JAX ``init`` would).

    Per-parameter optimizers: ``{"groups": [{"step": int32, "state":
    [{slot: tensor} per parameter]}]}``.  ZeRO optimizers: ``{"step":
    int32, "buckets": {key: {slot: ShardedLeaf}}}``, each slot this rank's
    rows of the packed ``(nrows, 128)`` bucket (the JAX state's global
    arrays)."""
    inner = _inner(optimizer)
    device = _device(inner)
    if hasattr(inner, "_shards"):
        buckets = {}
        for info in inner._layout().buckets:
            st, _ = inner._bucket(info)
            rows = inner._local_rows(info)
            lo = inner.rank * rows
            buckets[info.key] = {
                slot: ShardedLeaf(t, (info.meta.nrows, 128),
                                  ((lo, lo + rows), (0, 128)))
                for slot, t in st.items()}
        if inner._step_count is None:
            inner._step_count = torch.zeros((), dtype=_i32, device=device)
        return {"step": inner._step_count, "buckets": buckets}
    groups = []
    for group in inner.param_groups:
        if group.get("step") is None:
            group["step"] = torch.zeros((), dtype=_i32, device=device)
        groups.append({"step": group["step"],
                       "state": [dict(inner._state(p))
                                 for p in group["params"]]})
    return {"groups": groups}


@torch.no_grad()
def load_optimizer_state(optimizer, tree) -> None:
    """Copy a tree of :func:`optimizer_state`'s form into the optimizer's
    live state, in place."""
    inner = _inner(optimizer)
    live = optimizer_state(inner)
    device = _device(inner)
    if "buckets" in live:
        inner._step_count = tree["step"].to(device, _i32, copy=True)
        for key, slots in live["buckets"].items():
            for slot, leaf in slots.items():
                src = tree["buckets"][key][slot]
                leaf.data.copy_(src.data if isinstance(src, ShardedLeaf)
                                else src)
        return
    for group, saved in zip(inner.param_groups, tree["groups"]):
        group["step"] = saved["step"].to(device, _i32, copy=True)
        for p, st in zip(group["params"], saved["state"]):
            for slot, t in inner._state(p).items():
                t.copy_(st[slot])


def scaler_state(scaler) -> LossScaleState:
    """The scaler's live tensors."""
    return LossScaleState(scaler.loss_scale, scaler.unskipped,
                          scaler.overflows, scaler.skipped)


@torch.no_grad()
def load_scaler_state(scaler, state) -> None:
    for live, saved in zip(scaler_state(scaler), state):
        live.copy_(saved)


def _params(model) -> dict:
    return {name: p.detach() for name, p in model.named_parameters()}


_CLEAN_FLAGS = {"nan_grads": 0.0, "inf_loss": 0.0, "spike_scale": 1.0}


class GuardedTrainStep:
    """``GuardedTrainStep(loss_fn, optimizer, ...)`` then
    ``result = gstep(model, gstate, *batch, step=i)``.

    ``loss_fn(model, *batch) -> scalar``; or ``grad_fn(model, *batch) ->
    loss`` that runs its own backward (then scale inside it).  ``scaler``
    (a :class:`~apex_tpu_torch.amp.LossScaler`) threads dynamic loss
    scaling through the same skip: a non-finite anomaly counts as a scaler
    overflow (halving the scale and bumping its ``skipped`` counter) while
    spikes skip at the guard level only.  ``checkpoint`` arms rollback; call
    :meth:`save` from the train loop to keep it stocked.  ``lr``, when
    given, is set on every parameter group.  ``group``: the process group
    whose ranks decide together.  ``plan`` (a ``ParallelPlan`` or an
    ``ElasticPlan``) declares the layout the state lives under; a ZeRO
    optimizer's world size must equal its ``zero_shard``.
    """

    def __init__(self, loss_fn: Optional[Callable] = None,
                 optimizer=None, *, grad_fn: Optional[Callable] = None,
                 scaler=None, spike_factor: float = 10.0,
                 ema_decay: float = 0.99, warmup_steps: int = 5,
                 max_consecutive: int = 3, checkpoint=None,
                 fault_injector=None, lr=None, group=None, plan=None):
        if (loss_fn is None) == (grad_fn is None):
            raise ValueError("pass exactly one of loss_fn / grad_fn")
        if optimizer is None:
            raise ValueError("an optimizer is required")
        if grad_fn is not None and scaler is not None:
            raise ValueError(
                "scaler requires the loss_fn form (the guard scales the "
                "loss before backward); with grad_fn, scale inside it")
        self.plan = plan
        if plan is not None:
            zero = getattr(getattr(plan, "spec", plan), "zero_shard", None)
            ws = getattr(_inner(optimizer), "world_size", None)
            if ws is not None and zero is not None and ws != zero:
                raise ValueError(
                    f"optimizer world_size={ws} does not match "
                    f"plan.zero_shard={zero}; build the optimizer from the "
                    "same plan (DistributedFusedAdam(plan=plan))")
        self.loss_fn = loss_fn
        self.grad_fn = grad_fn
        self.optimizer = optimizer
        self.scaler = scaler
        self.spike_factor = float(spike_factor)
        self.ema_decay = float(ema_decay)
        self.warmup_steps = int(warmup_steps)
        self.max_consecutive = int(max_consecutive)
        self.checkpoint = checkpoint
        self.fault_injector = fault_injector
        self.lr = lr
        self.group = group
        self._consecutive = 0
        self.counters = {"steps": 0, "skipped": 0, "nonfinite": 0,
                         "spikes": 0, "rollbacks": 0}

    def init_state(self) -> GuardState:
        device = _device(self.optimizer)
        return GuardState(torch.zeros((), dtype=_f32, device=device),
                          *(torch.zeros((), dtype=_i32, device=device)
                            for _ in range(5)))

    def _parameters(self):
        return [p for g in _inner(self.optimizer).param_groups
                for p in g["params"]]

    # -- the device step -----------------------------------------------------

    def _device_step(self, model, gstate: GuardState, flags, batch):
        params = self._parameters()
        for p in params:
            p.grad = None
        scaler = self.scaler
        if self.grad_fn is not None:
            loss = self.grad_fn(model, *batch)
        else:
            loss = self.loss_fn(model, *batch)
            if scaler is not None:
                loss = scaler.scale(loss)
            loss.backward()
        loss = loss.detach()
        grads = [p.grad for p in params if p.grad is not None]
        # fault injection as data, on the steps that carry it
        if flags["inf_loss"] > 0:
            loss = torch.full_like(loss, float("inf"))
        if flags["spike_scale"] != 1.0:
            torch._foreach_mul_(grads, flags["spike_scale"])
        if flags["nan_grads"] > 0:
            torch._foreach_add_(grads, float("nan"))

        device = gstate.ema_norm.device
        inv_scale = (1.0 / scaler.loss_scale if scaler is not None
                     else None)
        total = self._sumsq(grads, device)
        gnorm = torch.sqrt(total)
        if inv_scale is not None:
            gnorm = gnorm * inv_scale          # unscaled grad norm
        bad = (~torch.isfinite(loss.to(_f32))) | (~torch.isfinite(gnorm))
        if self.group is not None:
            gnorm, bad = self._agree(gnorm, bad)
        armed = gstate.clean_steps >= self.warmup_steps
        spike = armed & ~bad & (gnorm > self.spike_factor * gstate.ema_norm)
        anomaly = bad | spike
        noop = anomaly.to(_i32)

        if self.lr is not None:
            for g in _inner(self.optimizer).param_groups:
                g["lr"] = self.lr
        self.optimizer.step(grad_scale=(1.0 if inv_scale is None
                                        else inv_scale), noop_flag=noop)

        first = gstate.clean_steps == 0
        ema = torch.where(
            anomaly, gstate.ema_norm,
            torch.where(first, gnorm, self.ema_decay * gstate.ema_norm
                        + (1.0 - self.ema_decay) * gnorm))
        new_gstate = GuardState(
            ema, gstate.clean_steps + (1 - noop),
            torch.where(anomaly, gstate.consecutive + 1,
                        torch.zeros_like(gstate.consecutive)),
            gstate.anomalies + noop,
            gstate.nonfinite + bad.to(_i32),
            gstate.spikes + spike.to(_i32))
        scale = torch.ones((), dtype=_f32, device=device)
        if scaler is not None:
            scaler.update(bad.to(_f32))
            loss = loss.to(_f32) * inv_scale
            scale = scaler.loss_scale
        telemetry = torch.stack([
            anomaly.to(_f32), bad.to(_f32), spike.to(_f32), gnorm.to(_f32),
            loss.to(_f32).reshape(()), scale.to(_f32)])
        return loss, new_gstate, telemetry

    def _sumsq(self, grads, device):
        """The sum of squares of the gradient the step applies: this
        rank's gradients, or under a ZeRO optimizer (whose step reduces
        them) the reduced gradient's shards summed across its group."""
        inner = _inner(self.optimizer)
        if hasattr(inner, "reduce_gradients"):
            grads = inner.reduce_gradients()
        if not grads:
            return torch.zeros((), dtype=_f32, device=device)
        total = multi_tensor_sumsq(grads)[0]
        if hasattr(inner, "reduce_gradients"):
            from apex_tpu_torch.utils.collectives import all_reduce_
            total = all_reduce_(total, inner.process_group)
        return total

    def _agree(self, gnorm, bad):
        """The group's non-finite flag and norm: the largest of the ranks'
        (a non-finite rank's norm enters as 0 and keeps its own)."""
        import torch.distributed as dist
        local = torch.stack([bad.to(_f32),
                             torch.where(bad, torch.zeros_like(gnorm),
                                         gnorm)])
        dist.all_reduce(local, op=dist.ReduceOp.MAX, group=self.group)
        bad = local[0] > 0
        return torch.where(bad, gnorm, local[1]), bad

    # -- host wrapper --------------------------------------------------------

    def __call__(self, model, guard_state: GuardState, *batch,
                 step: Optional[int] = None) -> StepResult:
        if any(p.dtype == torch.int8 for p in self._parameters()):
            raise ValueError(
                "params contain int8 leaves — a weight_quant='int8' "
                "decode model.  GuardedTrainStep differentiates and "
                "updates f32/bf16 master weights; quantization is "
                "inference-engine-init only.  Train the unquantized "
                "model and set weight_quant on the serving GPTConfig")
        if step is None:
            step = self.counters["steps"]
        inj = self.fault_injector
        flags = _CLEAN_FLAGS
        if inj is not None:
            inj.check_preempt(step)     # raises Preemption — no cleanup
            inj.maybe_slow_host(step)
            flags = inj.grad_flags(step)
        loss, new_gstate, telemetry = self._device_step(
            model, guard_state, flags, batch)
        (anomaly_f, bad_f, spike_f, gnorm_f, loss_f,
         scale_f) = telemetry.tolist()
        skipped = anomaly_f > 0
        kind = ("nonfinite" if bad_f > 0
                else "spike" if spike_f > 0 else None)
        self.counters["steps"] += 1
        self.counters["skipped"] += int(skipped)
        self.counters["nonfinite"] += int(bad_f > 0)
        self.counters["spikes"] += int(spike_f > 0)
        self._consecutive = self._consecutive + 1 if skipped else 0
        sstate = None if self.scaler is None else scaler_state(self.scaler)
        out_scale = scale_f if self.scaler is not None else None

        if (skipped and self.checkpoint is not None
                and self._consecutive >= self.max_consecutive):
            restored, ck_step = self.checkpoint.restore(self._template(
                model, new_gstate))
            self.load_state(model, restored)
            self.counters["rollbacks"] += 1
            self._consecutive = 0
            return StepResult(
                loss=loss, params=_params(model),
                opt_state=optimizer_state(self.optimizer),
                guard_state=restored["guard"], scaler_state=sstate,
                grad_norm=gnorm_f, skipped=True, anomaly=kind,
                next_step=int(restored["step"]), rolled_back=True,
                restored_from=ck_step, loss_value=loss_f,
                loss_scale_value=out_scale)
        return StepResult(
            loss=loss, params=_params(model),
            opt_state=optimizer_state(self.optimizer),
            guard_state=new_gstate, scaler_state=sstate, grad_norm=gnorm_f,
            skipped=skipped, anomaly=kind, next_step=step + 1,
            loss_value=loss_f, loss_scale_value=out_scale)

    # -- checkpoint plumbing -------------------------------------------------

    def _template(self, model, guard_state: GuardState, step=None) -> dict:
        """The checkpointed tree over the live state (``step`` as an int32
        tensor, 0 when None)."""
        device = guard_state.ema_norm.device
        t = {"params": _params(model),
             "opt": optimizer_state(self.optimizer), "guard": guard_state,
             "step": torch.tensor(0 if step is None else int(step),
                                  dtype=_i32, device=device)}
        if self.scaler is not None:
            t["scaler"] = scaler_state(self.scaler)
        return t

    @torch.no_grad()
    def load_state(self, model, state: dict) -> None:
        """Copy a restored tree of :meth:`_template`'s form into the live
        parameters, optimizer state and scaler, in place."""
        for name, p in model.named_parameters():
            p.copy_(state["params"][name])
        load_optimizer_state(self.optimizer, state["opt"])
        if self.scaler is not None:
            load_scaler_state(self.scaler, state["scaler"])

    def save(self, next_step: int, model, guard_state: GuardState, *,
             async_: bool = False) -> None:
        """Checkpoint the full guarded train state.  ``next_step`` is the
        step training would run next (call this AFTER step
        ``next_step - 1``); rollback resumes there."""
        if self.checkpoint is None:
            raise ValueError("no CheckpointManager attached")
        state = self._template(model, guard_state, next_step)
        if async_:
            self.checkpoint.save_async(next_step, state)
        else:
            self.checkpoint.save(next_step, state)

    @property
    def stats(self) -> dict:
        """Host-side counters; with a scaler also its cumulative
        ``skipped_steps`` (one device read)."""
        out = dict(self.counters)
        if self.scaler is not None:
            out["scaler_skipped_steps"] = int(self.scaler.skipped)
        return out
