"""The ring pipeline engine — port of
``apex_tpu/transformer/pipeline_parallel/ring.py``.

The JAX engine is one ``lax.scan`` of uniform ticks: every pipeline device
runs at most one forward job and one backward job a tick, and both rings
advance one hop a tick.  The port runs the same ticks as a host loop with
the same job arithmetic, so the two schedules do the same work in the same
order: 1F1B when ``n_virtual == 1``, interleaved otherwise (each rank owns
``n_virtual`` model chunks; the wrap hop carries a micro-batch from chunk
``c`` on the last rank to chunk ``c + 1`` on the first).

Schedule arithmetic (S = pipe group size, v = virtual chunks a rank, L =
v·S logical stages, M micro-batches, logical stage ℓ = c·S + s):

* forward job of rank ``s`` at tick ``t``: ``z = t − s``; valid iff ``0 ≤
  z < M·v``; ``q = z // (vS)``, ``c = (z % (vS)) // S``, ``i = z % S``; the
  job runs micro-batch ``m = q·S + i`` through chunk ``c``;
* backward job at tick ``t``: ``z = t + s + 2 − (v+1)·S``; the same decode
  with the chunks in reverse, ``c = v − 1 − (z % (vS)) // S``;
* ``T = M·v + (v+1)·S − 2`` ticks.

**Saved graphs, not recompute.**  Where the JAX engine keeps each job's
stage input and recomputes its forward under a local ``jax.vjp`` in the
backward job, the port keeps the forward job's autograd graph (upstream
apex's PyTorch design) and the backward job differentiates it with
:func:`torch.autograd.grad`, seeded with the ring's cotangent (or, on the
last logical stage, ``1 / M`` on the loss).  A job's backward runs ``Δ =
2S(v − c) − 2s − 2 ≤ 2L − 2`` ticks after its forward, so at most ``2L −
1`` graphs are held at once (the warm-up depth; JAX's ring buffer of
stage inputs has the same ``B = 2L − 1`` slots).  The engine never
differentiates through a collective: activations and cotangents hop as
plain data (:func:`~.p2p_communication.exchange`, one
``batch_isend_irecv`` a tick, the same ordered operations on every rank;
a local hand-back at one stage).  The per-chunk gradients accumulate in
ascending micro-batch order, as in JAX, and the results that cross ranks
(the loss, the last function's gradients, ``dx0``) are sums over the pipe
group of one nonzero and zeros: exact.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    exchange)
from apex_tpu_torch.utils.collectives import all_reduce_, flatten_tree

__all__ = [
    "JobInfo", "pipeline_schedule_step", "pipeline_forward",
    "pipeline_value_and_grad", "schedule_ticks", "bubble_fraction",
]

_f32 = torch.float32


class JobInfo(NamedTuple):
    """Identity of the job a stage function runs: ``stage`` is the
    LOGICAL stage ``chunk·S + rank`` in ``[0, n_virtual·S)`` (what a
    dropout seed wants), ``microbatch`` indexes the engine's ``x0`` /
    ``targets``."""
    microbatch: Any
    stage: Any
    chunk: Any


def schedule_ticks(n_microbatches: int, n_stages: int,
                   n_virtual: int = 1) -> int:
    """Ticks of the schedule: ``M·v + (v+1)·S − 2``."""
    return n_microbatches * n_virtual + (n_virtual + 1) * n_stages - 2


def bubble_fraction(n_microbatches: int, n_stages: int,
                    n_virtual: int = 1) -> float:
    """Idle fraction of the schedule in tick units: each rank has ``M·v``
    forward and ``M·v`` backward job slots over ``T`` ticks of two slots
    each, so the bubble is ``1 − M·v/T``."""
    t = schedule_ticks(n_microbatches, n_stages, n_virtual)
    return 1.0 - (n_microbatches * n_virtual) / t


def _tensors(obj):
    """The differentiable tensors of a chunk's parameters: a module's
    parameters, or the tensors of a tensor / list / tuple / dict."""
    if isinstance(obj, nn.Module):
        return [p for p in obj.parameters() if p.requires_grad]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    out = []
    for x in obj or ():
        out.extend(_tensors(x))
    return out


def _pipe(axis_name):
    group = ps.resolve_group(axis_name)
    n = ps.group_size(group)
    return (None if n == 1 else group), n, ps.group_rank(group)


def _check(M, S, v):
    if v < 1:
        raise ValueError(f"n_virtual must be >= 1, got {v}")
    if v > 1 and M % S != 0:
        raise ValueError(
            f"interleaved schedule needs n_microbatches % n_stages == 0, "
            f"got M={M}, S={S}")


def _chunks(stage_params, v):
    if v == 1:
        return [stage_params]
    chunks = list(stage_params)
    if len(chunks) != v:
        raise ValueError(f"n_virtual={v} needs one parameter set a chunk, "
                         f"got {len(chunks)}")
    return chunks


def _decode(z, S, v, reverse):
    c = (z % (v * S)) // S
    return (v - 1 - c) if reverse else c, (z // (v * S)) * S + z % S


def pipeline_schedule_step(stage_fn: Callable, last_fn: Callable,
                           stage_params, last_params, x0, targets, *,
                           axis_name: str = ps.PIPELINE_AXIS,
                           n_virtual: int = 1):
    """Run one pipeline training step (loss and gradients).

    ``stage_fn(chunk_params, x, info) -> y`` applies one model chunk (``x``
    and ``y`` a tensor or a tuple of tensors of the same shapes: the ring
    carries them); ``last_fn(last_params, y, target, info) -> scalar`` is
    the micro-batch loss of the last chunk's output.  ``stage_params``:
    this rank's chunk parameters (a module, or a list / tuple / dict of
    tensors), with ``n_virtual > 1`` a sequence of one a chunk (chunk ``c``
    is logical stage ``c·S + rank``).  ``last_params``: the parameters of
    ``last_fn`` (the same on every rank).  ``x0``: first-stage inputs with a
    leading micro-batch axis ``(M, ...)`` (a tensor or tuple), ``targets``
    ``(M, ...)``.

    Returns ``(loss, stage_grads, last_grads, dx0)``: the mean micro-batch
    loss (f32, the same on every rank), the gradients of this rank's chunk
    tensors (a list, with ``n_virtual > 1`` a list a chunk), of
    ``last_params``' tensors (summed over the group) and of ``x0`` (summed
    over the group), each ``None``-free (zeros where nothing reached)."""
    group, S, s = _pipe(axis_name)
    v = int(n_virtual)
    x0_leaves, x_rebuild = flatten_tree(x0)
    M = int(x0_leaves[0].shape[0])
    _check(M, S, v)
    L = v * S
    T = schedule_ticks(M, S, v)
    inv_m = 1.0 / M
    chunks = _chunks(stage_params, v)
    chunk_tensors = [_tensors(c) for c in chunks]
    last_tensors = _tensors(last_params)
    x0_leaves = [x.detach() for x in x0_leaves]

    sgrad = [[torch.zeros_like(p) for p in ct] for ct in chunk_tensors]
    lgrad = [torch.zeros_like(p) for p in last_tensors]
    dx0 = [torch.zeros_like(x) for x in x0_leaves]
    loss_acc = torch.zeros((), dtype=_f32, device=x0_leaves[0].device)
    blank = [torch.zeros_like(x[0]) for x in x0_leaves]
    fwd_msg, bwd_msg = list(blank), list(blank)
    saved = {}

    for t in range(T):
        # ---- forward job -------------------------------------------------
        y_send = blank
        zf = t - s
        if 0 <= zf < M * v:
            cf, mf = _decode(zf, S, v, reverse=False)
            info = JobInfo(mf, cf * S + s, cf)
            src = [x[mf] for x in x0_leaves] if (s == 0 and cf == 0) \
                else fwd_msg
            xin = [x.detach().requires_grad_() for x in src]
            with torch.enable_grad():
                y = stage_fn(chunks[cf], x_rebuild(xin), info)
                lm = (last_fn(last_params, y, targets[mf], info)
                      if info.stage == L - 1 else None)
            y_leaves = flatten_tree(y)[0]
            saved[(mf, cf)] = (xin, y_leaves, lm)
            y_send = [yy.detach() for yy in y_leaves]

        # ---- backward job ------------------------------------------------
        dx_send = blank
        zb = t + s + 2 - (v + 1) * S
        if 0 <= zb < M * v:
            cb, mb = _decode(zb, S, v, reverse=True)
            is_last = cb * S + s == L - 1
            xin, y_leaves, lm = saved.pop((mb, cb))
            inputs = chunk_tensors[cb] + (last_tensors if is_last else []) \
                + xin
            if is_last:
                outs, seeds = [lm], [torch.full_like(lm, inv_m)]
            else:
                outs, seeds = y_leaves, bwd_msg
            grads = torch.autograd.grad(outs, inputs, seeds,
                                        allow_unused=True)
            nc = len(chunk_tensors[cb])
            for a, g in zip(sgrad[cb], grads[:nc]):
                if g is not None:
                    a.add_(g)
            if is_last:
                for a, g in zip(lgrad, grads[nc:nc + len(last_tensors)]):
                    if g is not None:
                        a.add_(g)
                loss_acc = loss_acc + lm.detach().to(_f32)
            dx = [torch.zeros_like(x) if g is None else g
                  for x, g in zip(xin, grads[len(grads) - len(xin):])]
            if s == 0 and cb == 0:
                for a, g in zip(dx0, dx):
                    a[mb] += g
            dx_send = dx

        # ---- ring hops (the wrap carries the virtual-chunk advance) ------
        fwd_msg, bwd_msg = exchange(y_send, dx_send, group)

    # sums over the group of one nonzero and zeros: exact
    for tensor in [loss_acc, *lgrad, *dx0]:
        all_reduce_(tensor, group)
    stage_grads = sgrad if v > 1 else sgrad[0]
    return loss_acc * inv_m, stage_grads, lgrad, x_rebuild(dx0)


def pipeline_forward(stage_fn: Callable, stage_params, x0, *,
                     axis_name: str = ps.PIPELINE_AXIS, n_virtual: int = 1):
    """Forward-only pipeline: every micro-batch through all logical stages,
    the last stage's outputs stacked ``(M, ...)`` and summed over the group
    (the same on every rank).  ``T = M·v + S − 1`` ticks."""
    group, S, s = _pipe(axis_name)
    v = int(n_virtual)
    x0_leaves, x_rebuild = flatten_tree(x0)
    M = int(x0_leaves[0].shape[0])
    _check(M, S, v)
    chunks = _chunks(stage_params, v)
    blank = [torch.zeros_like(x[0]) for x in x0_leaves]
    outs = [torch.zeros_like(x) for x in x0_leaves]
    fwd_msg = list(blank)
    with torch.no_grad():
        for t in range(M * v + S - 1):
            y_send = blank
            zf = t - s
            if 0 <= zf < M * v:
                cf, mf = _decode(zf, S, v, reverse=False)
                src = [x[mf] for x in x0_leaves] if (s == 0 and cf == 0) \
                    else fwd_msg
                y = flatten_tree(stage_fn(chunks[cf], x_rebuild(list(src)),
                                          JobInfo(mf, cf * S + s, cf)))[0]
                if s == S - 1 and cf == v - 1:
                    for a, yy in zip(outs, y):
                        a[mf] += yy
                y_send = y
            fwd_msg, _ = exchange(y_send, [], group)
        for a in outs:
            all_reduce_(a, group)
    return x_rebuild(outs)


def pipeline_value_and_grad(stage_fn: Callable, loss_fn: Callable, params,
                            microbatches, targets, *,
                            axis_name: str = ps.PIPELINE_AXIS,
                            n_virtual: int = 1):
    """:func:`pipeline_schedule_step` for parameter-free losses: plain
    ``stage_fn(params, x)`` / ``loss_fn(y, target)``; returns ``(loss,
    stage_grads)``."""
    loss, sgrad, _, _ = pipeline_schedule_step(
        lambda p, x, info: stage_fn(p, x),
        lambda lp, y, tgt, info: loss_fn(y, tgt),
        params, (), microbatches, targets,
        axis_name=axis_name, n_virtual=n_virtual)
    return loss, sgrad
