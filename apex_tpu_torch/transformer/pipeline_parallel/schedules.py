"""Micro-batch schedules — port of
``apex_tpu/transformer/pipeline_parallel/schedules/__init__.py``.

``get_forward_backward_func`` dispatches as apex does: no pipelining when
the ``pipe`` group has one rank, interleaved when a virtual size is set,
1F1B otherwise.  Every schedule takes ``(stage_fn, loss_fn, params,
microbatches, targets, forward_only=False, ...)`` with ``stage_fn(params,
x) -> y`` and ``loss_fn(y, target) -> scalar``, runs the micro-batches in
ascending order with each one's loss cotangent seeded at ``1/M``, adds the
gradients of the mean loss to the ``.grad`` of every parameter reached
(f32 parameters give f32 sums; clear them first, ``optimizer.zero_grad()``,
for one step's sum) and returns the mean loss as a detached f32 scalar.

The pipelined schedules run the ring engine of :mod:`.ring` over the
``pipe`` group: ``params`` is this rank's chunk (a module or a list of
tensors; interleaved: a sequence of ``n_virtual`` chunks, chunk ``c`` being
logical stage ``c·S + rank``), ``microbatches`` / ``targets`` the whole
``(M, ...)`` batch on every rank.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel.ring import (
    _tensors, pipeline_forward, pipeline_schedule_step,
    pipeline_value_and_grad)

_f32 = torch.float32

__all__ = ["get_forward_backward_func", "forward_backward_no_pipelining",
           "forward_backward_pipelining_without_interleaving",
           "forward_backward_pipelining_with_interleaving",
           "pipeline_forward", "pipeline_value_and_grad"]


def forward_backward_no_pipelining(stage_fn: Callable, loss_fn: Callable,
                                   params, microbatches, targets,
                                   forward_only: bool = False, **kw):
    """Sequential micro-batches with gradient accumulation.

    ``microbatches``/``targets`` are sequences (or tensors with a leading
    micro-batch axis) of equal length M.  Returns the mean loss over the M
    micro-batches as a detached f32 scalar; unless ``forward_only``, the
    gradients of the mean are added to the parameters' ``.grad``.
    """
    del kw
    m = len(microbatches)
    if m == 0 or len(targets) != m:
        raise ValueError(f"need as many targets as micro-batches (>= 1), "
                         f"got {m} and {len(targets)}")
    inv_m = 1.0 / m
    total = None
    for x, t in zip(microbatches, targets):
        if forward_only:
            with torch.no_grad():
                loss = loss_fn(stage_fn(params, x), t)
        else:
            loss = loss_fn(stage_fn(params, x), t)
            loss.backward(torch.full_like(loss, inv_m))
        loss = loss.detach().to(_f32)
        total = loss if total is None else total + loss
    return total * inv_m


def _adapt(stage_fn: Callable, remat: bool):
    """Lift ``stage_fn(params, x)`` to the engine's ``(params, x, info)``,
    under activation checkpointing with ``remat``."""
    if remat:
        return lambda p, x, info: checkpoint(stage_fn, p, x,
                                             use_reentrant=False)
    return lambda p, x, info: stage_fn(p, x)


def _pipelined(stage_fn, loss_fn, params, microbatches, targets,
               forward_only, axis_name, n_virtual, remat):
    m = len(microbatches)
    if forward_only:
        outs = pipeline_forward(_adapt(stage_fn, remat), params,
                                microbatches, axis_name=axis_name,
                                n_virtual=n_virtual)
        with torch.no_grad():
            total = sum(loss_fn(y, t).to(_f32) for y, t in zip(outs,
                                                               targets))
        return total * (1.0 / m)
    loss, grads, _, _ = pipeline_schedule_step(
        _adapt(stage_fn, remat), lambda lp, y, tgt, info: loss_fn(y, tgt),
        params, (), microbatches, targets, axis_name=axis_name,
        n_virtual=n_virtual)
    chunks = list(params) if n_virtual > 1 else [params]
    per_chunk = grads if n_virtual > 1 else [grads]
    for chunk, gs in zip(chunks, per_chunk):
        for p, g in zip(_tensors(chunk), gs):
            if p.grad is None:
                p.grad = g.to(p.dtype)
            else:
                p.grad.add_(g)
    return loss


def forward_backward_pipelining_without_interleaving(
        stage_fn: Callable, loss_fn: Callable, params, microbatches,
        targets, forward_only: bool = False,
        axis_name: str = ps.PIPELINE_AXIS, remat: bool = False, **kw):
    """1F1B (apex ``forward_backward_pipelining_without_interleaving``):
    one model chunk a rank, ``M + 2S − 2`` ticks."""
    del kw
    return _pipelined(stage_fn, loss_fn, params, microbatches, targets,
                      forward_only, axis_name, 1, remat)


def forward_backward_pipelining_with_interleaving(
        stage_fn: Callable, loss_fn: Callable, params, microbatches,
        targets, forward_only: bool = False,
        axis_name: str = ps.PIPELINE_AXIS, n_virtual: int = 2,
        remat: bool = False, **kw):
    """Interleaved / virtual pipeline (apex
    ``_forward_backward_pipelining_with_interleaving``): ``params`` is a
    sequence of ``n_virtual`` chunks; needs ``M % S == 0``."""
    del kw
    return _pipelined(stage_fn, loss_fn, params, microbatches, targets,
                      forward_only, axis_name, n_virtual, remat)


def get_forward_backward_func(
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        pipeline_model_parallel_size: Optional[int] = None):
    """apex ``get_forward_backward_func`` dispatch."""
    if pipeline_model_parallel_size is None:
        pipeline_model_parallel_size = \
            ps.get_pipeline_model_parallel_world_size()
    if virtual_pipeline_model_parallel_size is None:
        virtual_pipeline_model_parallel_size = \
            ps.get_virtual_pipeline_model_parallel_world_size()
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None and \
                virtual_pipeline_model_parallel_size > 1:
            return functools.partial(
                forward_backward_pipelining_with_interleaving,
                n_virtual=virtual_pipeline_model_parallel_size)
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining
