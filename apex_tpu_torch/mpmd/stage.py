"""``StageProgram`` — one pipeline stage of the MPMD engine; port of
``apex_tpu/mpmd/stage.py``.

Where the ring engine runs every stage as one rank of a process group, the
MPMD engine (:class:`~apex_tpu_torch.mpmd.engine.MpmdPipeline`) holds one
``StageProgram`` a stage in one process, each on its own
:class:`torch.device`: the stage's ``GPTModel(cfg, device,
pipeline_stage=(S, 1, i))`` (the embedding and final LayerNorm whole, the
stage's contiguous layer chunk), its programs and its own optimizer over
the state its role updates:

* first stage: ``embed`` (the token embedding of all micro-batches at
  once, the ring's flattened-batch embed), ``fwd`` / ``bwd`` on
  micro-batch ``m`` of the stacked activations, and ``embed_bwd`` (the
  embedding pullback + tied-head gradient merge + mean over ``data``);
* interior stages: ``fwd`` and ``bwd``;
* last stage: a joint ``bwd`` that runs the stage forward AND the loss
  head (final LayerNorm, the tied head, the cross-entropy mean) and
  differentiates the loss seeded at ``1 / M`` — the ring's last-stage job.

**Saved graphs, not recompute.**  Where the JAX stage keeps its input and
recomputes its forward under a local ``jax.vjp`` in ``bwd``, ``fwd`` here
keeps its autograd graph and ``bwd`` differentiates it with
:func:`torch.autograd.grad`, seeded with the received cotangent (the
ring's choice, :mod:`apex_tpu_torch.transformer.pipeline_parallel.ring`).
Every stage input is a detached tensor with ``requires_grad``: autograd
never crosses a stage boundary, and the input's gradient travels back as
plain data.

``dp > 1`` runs the stage's data shards in turn on its device.  Each shard
keeps its own gradient accumulator (JAX's accumulators carry a leading
``data`` axis) and accumulates its micro-batches in ascending order, as
the ring does; the ``finish`` programs take the mean over the shards in
ascending shard order where JAX ``pmean`` s.  At ``dp == 1`` a stage's
gradients are bit for bit those of the port's ``pipeline_step`` at the
same stage count.

Tensor parallelism inside a stage (``tp > 1``) is not ported: the port's
TP layers need one process a shard, so it needs per-process stage
programs (``ROADMAP.md`` queue A, item 17's leftover).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

__all__ = ["StageProgram"]

_f32 = torch.float32


def _accumulate(acc: List[torch.Tensor], grads) -> None:
    for a, g in zip(acc, grads):
        if g is not None:
            a.add_(g)


def _data_mean(per_shard: List[List[torch.Tensor]]) -> List[torch.Tensor]:
    """Mean over the data shards of per-shard tensor lists: the sum in
    ascending shard order, then one division (JAX's ``pmean``)."""
    if len(per_shard) == 1:
        return list(per_shard[0])
    out = []
    for i in range(len(per_shard[0])):
        total = per_shard[0][i].clone()
        for shard in per_shard[1:]:
            total.add_(shard[i])
        out.append(total.div_(len(per_shard)))
    return out


class StageProgram:
    """One stage's model, programs and optimizer.

    ``cfg`` is the WHOLE model's :class:`~apex_tpu_torch.models.gpt.
    GPTConfig` (``num_layers`` the total; the stage holds layers ``[i·L/S,
    (i+1)·L/S)``); ``stage_params`` this stage's state dict (the keys of
    ``GPTModel(cfg, pipeline_stage=(n_stages, 1, stage_index))``, e.g.
    :func:`~apex_tpu_torch.models.gpt.stage_state_dict` of the serial one,
    or ``None`` to keep the fresh module's values); ``plan`` the intra-pod
    :class:`~apex_tpu_torch.parallel.plan.ParallelPlan` (``pp == 1``);
    ``device`` this stage's device (default ``"cuda"``; raises without CUDA
    unless ``"cpu"`` is passed).  The stage's optimizer is ``FusedAdam(lr=
    lr)`` over its state.
    """

    def __init__(self, cfg, stage_params, *, stage_index: int,
                 n_stages: int, n_microbatches: int, plan, device=None,
                 lr: float = 1e-3):
        from apex_tpu_torch.models.gpt import GPTModel, make_stage_fn
        from apex_tpu_torch.optimizers import FusedAdam
        from apex_tpu_torch.utils.device import resolve_device

        if cfg.n_experts > 0:
            raise ValueError(
                "MPMD v1 does not support MoE stages (expert-parallel "
                "collectives inside a stage program are untested "
                "against the cross-pod schedule); use the single-mesh "
                "ring engine for MoE models")
        if cfg.tensor_parallel_size > 1 and not cfg.sequence_parallel:
            raise ValueError(
                "MPMD stages under tensor parallelism require "
                "sequence_parallel=True — same rule as pipeline_step: "
                "the recompute backward never crosses shard_map's "
                "auto-psum, only the SP custom-VJP mappings reduce "
                "replicated-leaf grads")
        if cfg.tensor_parallel_size > 1 or int(plan.tp) > 1:
            raise NotImplementedError(
                "MPMD stages with tp > 1 are not ported: the port's "
                "tensor-parallel layers need one process a shard, so tp "
                "inside a stage needs per-process stage programs "
                "(ROADMAP.md queue A, item 17's leftover)")
        self.cfg = cfg
        self.index = int(stage_index)
        self.n_stages = int(n_stages)
        self.M = int(n_microbatches)
        self.is_first = self.index == 0
        self.is_last = self.index == self.n_stages - 1
        self.plan = plan
        self.dp = int(plan.dp)
        self.inv_m = 1.0 / self.M
        self.device = resolve_device(device)
        self.model = GPTModel(cfg, self.device,
                              pipeline_stage=(self.n_stages, 1, self.index))
        if stage_params is not None:
            self.model.load_state_dict(stage_params)
        self._stage_fn = make_stage_fn(self.model, None)

        # -- the train state is only what this stage's role updates --
        self.embed_keys = (["embedding"]
                           + ([] if cfg.rotary else ["position_embedding"]))
        keys = ["layers"]
        if self.is_first:
            keys = self.embed_keys + keys
        if self.is_last:
            keys += ["final_layernorm"]
            if not self.is_first:
                keys += ["embedding"]     # tied-head replica
        self.state_keys = keys
        self.last_keys = ["final_layernorm", "embedding"]
        named = dict(self.model.named_parameters())
        self.state: Dict[str, torch.Tensor] = {
            name: named[name] for key in keys for name in self._names(key)}
        self.layer_names = self._names("layers")
        self.embed_names = [n for k in self.embed_keys
                            for n in self._names(k)]
        self.last_names = [n for k in self.last_keys for n in self._names(k)]
        self.opt = FusedAdam(list(self.state.values()), lr=lr)
        self._saved: Dict[tuple, tuple] = {}
        self._embed_graph: Optional[List[torch.Tensor]] = None

    def _names(self, key: str) -> List[str]:
        """The parameter names of one role key, in module order."""
        return [n for n, _ in self.model.named_parameters()
                if n == key or n.startswith(key + ".")]

    def _params(self, names) -> List[torch.Tensor]:
        named = dict(self.model.named_parameters())
        return [named[n] for n in names]

    def _on_device(self):
        """A context in which launches go to this stage's card (a no-op on
        the CPU): the kernels launch on the current device's stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- accumulators (one a data shard) ----------------------------------

    def fresh_acc(self, names) -> List[List[torch.Tensor]]:
        """Zeroed per-data-shard accumulators for the parameters ``names``
        (a list of tensors a shard)."""
        params = self._params(names)
        return [[torch.zeros_like(p) for p in params]
                for _ in range(self.dp)]

    def fresh_loss_acc(self) -> List[torch.Tensor]:
        return [torch.zeros((), dtype=_f32, device=self.device)
                for _ in range(self.dp)]

    def fresh_dx0(self, x_all) -> List[torch.Tensor]:
        """Zeroed ``(M, mb, s, h)`` buffers (one a data shard) the first
        stage's backward scatters per-micro-batch input cotangents into —
        the ring's ``dx0``."""
        return [torch.zeros_like(x) for x in x_all]

    # -- programs (called by the engine in schedule order) ----------------

    def _info(self, m: int):
        from apex_tpu_torch.transformer.pipeline_parallel.ring import JobInfo
        return JobInfo(m, self.index, 0)

    def _last_fn(self, y, tgt):
        return torch.mean(self.model.head_loss(y, tgt))

    def run_embed(self, tokens: List[torch.Tensor]) -> List[torch.Tensor]:
        """Embed every micro-batch of each data shard's ``(M·mb, s)``
        tokens at once; keeps the graph for :meth:`run_embed_bwd` and
        returns the detached ``(M, mb, s, h)`` activations."""
        graphs, out = [], []
        with self._on_device(), torch.enable_grad():
            for tk in tokens:
                x = self.model.embed(tk)
                x = x.reshape((self.M, -1) + tuple(x.shape[1:]))
                graphs.append(x)
                out.append(x.detach())
        self._embed_graph = graphs
        return out

    def run_fwd(self, x: List[torch.Tensor], m: int) -> List[torch.Tensor]:
        """The stage's layers over micro-batch ``m`` of each shard (the
        first stage slices it out of :meth:`run_embed`'s activations);
        keeps each shard's graph for :meth:`run_bwd`."""
        if self.is_last:
            raise RuntimeError("the last stage's forward is folded "
                               "into its joint backward")
        ys = []
        with self._on_device(), torch.enable_grad():
            for d in range(self.dp):
                src = x[d][m] if self.is_first else x[d]
                xin = src.detach().requires_grad_()
                y = self._stage_fn(self.model.layers, xin, self._info(m))
                self._saved[(d, m)] = (xin, y)
                ys.append(y.detach())
        return ys

    def run_bwd(self, dy: List[torch.Tensor], acc, m: int, *, dx0=None):
        """Differentiate micro-batch ``m``'s saved graphs seeded with
        ``dy``, adding the layer gradients into ``acc``.  Returns the
        input cotangents (one a shard); the first stage scatters them
        into ``dx0`` instead and returns None."""
        layer_params = self._params(self.layer_names)
        n = len(layer_params)
        dxs = []
        with self._on_device():
            for d in range(self.dp):
                xin, y = self._saved.pop((d, m))
                grads = torch.autograd.grad([y], layer_params + [xin],
                                            [dy[d]], allow_unused=True)
                _accumulate(acc[d], grads[:n])
                dx = grads[n] if grads[n] is not None \
                    else torch.zeros_like(xin)
                if self.is_first:
                    dx0[d][m] += dx
                else:
                    dxs.append(dx)
        return None if self.is_first else dxs

    def run_bwd_last(self, targets: List[torch.Tensor],
                     x: List[torch.Tensor], acc, lacc, loss_acc, m: int):
        """The last stage's joint job on micro-batch ``m``: the layers and
        the loss head forward, then their gradients with the loss seeded
        at ``1 / M`` (the activation's cotangent is zero: nothing reads
        it), added into ``acc`` (layers) and ``lacc`` (final LayerNorm,
        tied embedding); the loss into ``loss_acc``.  Returns the input
        cotangents, one a shard."""
        layer_params = self._params(self.layer_names)
        last_params = self._params(self.last_names)
        n, k = len(layer_params), len(last_params)
        dxs = []
        with self._on_device():
            for d in range(self.dp):
                xin = x[d].detach().requires_grad_()
                with torch.enable_grad():
                    y = self._stage_fn(self.model.layers, xin,
                                       self._info(m))
                    lm = self._last_fn(y, targets[d][m])
                grads = torch.autograd.grad(
                    [lm], layer_params + last_params + [xin],
                    [torch.full_like(lm, self.inv_m)], allow_unused=True)
                _accumulate(acc[d], grads[:n])
                _accumulate(lacc[d], grads[n:n + k])
                loss_acc[d] = loss_acc[d] + lm.detach().to(_f32)
                dxs.append(grads[n + k] if grads[n + k] is not None
                           else torch.zeros_like(xin))
        return dxs

    def run_embed_bwd(self, dx0: List[torch.Tensor],
                      head_eg: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The embedding pullback of each shard's ``dx0``, the tied head's
        gradient ``head_eg`` (one a shard) added BEFORE the mean over
        ``data`` (the ring sums then averages: pmean(a) + pmean(b) is not
        bitwise pmean(a + b)).  Returns the embedding keys' gradients."""
        params = self._params(self.embed_names)
        per = []
        with self._on_device():
            for d in range(self.dp):
                grads = torch.autograd.grad(self._embed_graph[d], params,
                                            dx0[d], allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params, grads)]
                grads[0] = grads[0] + head_eg[d]  # embedding.weight first
                per.append(grads)
            self._embed_graph = None
            return dict(zip(self.embed_names, _data_mean(per)))

    def run_finish_layers(self, acc) -> Dict[str, torch.Tensor]:
        with self._on_device():
            return dict(zip(self.layer_names, _data_mean(acc)))

    def run_finish_last(self, lacc) -> Dict[str, torch.Tensor]:
        """The final LayerNorm's gradients (the tied embedding's part of
        ``lacc`` goes to the first stage instead)."""
        n = len(self.last_names) - 1
        with self._on_device():
            return dict(zip(self.last_names[:n],
                            _data_mean([g[:n] for g in lacc])))

    def run_loss_final(self, loss_acc) -> torch.Tensor:
        with self._on_device():
            return _data_mean([[a * self.inv_m] for a in loss_acc])[0]

    def apply_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer step on this stage's state.  ``grads`` must cover
        exactly the state's parameter names."""
        if set(grads) != set(self.state):
            raise KeyError(
                f"stage {self.index}: gradients for "
                f"{sorted(set(grads) ^ set(self.state))[:4]} do not match "
                "its state")
        with self._on_device():
            for name, p in self.state.items():
                p.grad = grads[name].to(p.dtype)
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)

    # -- checkpoint state ---------------------------------------------------

    def checkpoint_state(self) -> dict:
        """The live tensors a checkpoint of this stage holds: its state's
        parameters by name and its optimizer's state."""
        from apex_tpu_torch.resilience import optimizer_state
        return {"state": {n: p.detach() for n, p in self.state.items()},
                "opt": optimizer_state(self.opt)}

    @torch.no_grad()
    def load_checkpoint_state(self, tree: dict) -> None:
        """Copy a tree of :meth:`checkpoint_state`'s form into the live
        parameters and optimizer state, in place."""
        from apex_tpu_torch.resilience import load_optimizer_state
        for name, p in self.state.items():
            p.copy_(tree["state"][name])
        load_optimizer_state(self.opt, tree["opt"])
