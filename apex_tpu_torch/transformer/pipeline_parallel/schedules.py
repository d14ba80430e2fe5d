"""Micro-batch schedules — port of
``apex_tpu/transformer/pipeline_parallel/schedules/__init__.py`` (the
no-pipelining schedule; the pipelined ones come with the pipeline-parallel
slice).

``forward_backward_no_pipelining`` keeps the JAX signature and order:
micro-batches run in ascending order, each one's loss cotangent is seeded
at ``1/M``, and the gradients accumulate in the ``.grad`` of every
parameter the loss reaches (f32 parameters give f32 sums).  Clear the
gradients first (``optimizer.zero_grad()``) for one step's sum.
"""

from __future__ import annotations

from typing import Callable

import torch

_f32 = torch.float32

__all__ = ["forward_backward_no_pipelining"]


def forward_backward_no_pipelining(stage_fn: Callable, loss_fn: Callable,
                                   params, microbatches, targets,
                                   forward_only: bool = False):
    """Sequential micro-batches with gradient accumulation.

    ``stage_fn(params, x) -> y`` and ``loss_fn(y, target) -> scalar``;
    ``microbatches``/``targets`` are sequences (or tensors with a leading
    micro-batch axis) of equal length M.  Returns the mean loss over the M
    micro-batches as a detached f32 scalar; unless ``forward_only``, the
    gradients of the mean are added to the parameters' ``.grad``.
    """
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
