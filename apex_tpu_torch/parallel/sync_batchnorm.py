"""SyncBatchNorm — port of ``apex_tpu/parallel/sync_batchnorm.py`` (apex
``parallel/optimized_sync_batchnorm.py``).

In training mode the batch statistics are the mean and the biased variance
over every axis but the channels, in f32; the running statistics take
``(1 - momentum) * running + momentum * batch`` with the *unbiased*
variance; eval mode normalises with the running statistics.  The JAX
package computes this with f32 sums (``var = E[x^2] - mean^2``) and has no
Pallas kernel for it; the port calls ``F.batch_norm`` (cuDNN on the card),
which takes the same statistics in f32 (its variance by Welford's update,
the same value to f32 rounding) and updates the running buffers by the
same rule.  The output keeps the input's dtype, as the JAX function's
``astype(x.dtype)`` does; a bf16 input is normalised in f32 with f32
weights.  Under amp O1 ``batch_norm`` is on the f32 list
(:mod:`apex_tpu_torch.amp.lists`), so a bf16 convolution output is
normalised, and comes back, in f32, as in JAX O1.

Statistics across ranks (``axis_name`` / ``process_group``, resolved
through :mod:`apex_tpu_torch.transformer.parallel_state`) take the JAX
package's route: the f32 sums of x and x^2 over the local batch, one
``all_reduce`` of the stacked ``[sum, sumsq]`` over the group, the count
times the world size, ``var = E[x^2] - mean^2``, the normalisation in f32
returned in x's dtype (f32 under amp O1, whose cast lists put
``batch_norm`` on the f32 list).  The backward is what JAX's autodiff
through ``psum`` gives: each rank's dx carries every rank's share of the
statistics' gradient, from the two sums ``sum(dy w)`` and ``sum(dy w
xhat)`` reduced in one ``all_reduce``; the parameters' gradients are the
rank's own (DDP reduces them).  Like cuDNN's it keeps only x and the
statistics for the backward.  Where the axis is this rank
alone (no ``torch.distributed``, or no group), the local path runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.collectives import all_reduce_

_f32 = torch.float32

__all__ = ["BatchNormState", "sync_batch_norm", "SyncBatchNorm",
           "convert_syncbn_model"]


class BatchNormState(NamedTuple):
    """Running stats (the mutable part of torch BN modules)."""

    running_mean: torch.Tensor
    running_var: torch.Tensor
    num_batches_tracked: torch.Tensor


class _SyncBatchNorm(torch.autograd.Function):
    """Batch norm over every rank of ``group`` (channels on axis 1): the
    JAX ``sync_batch_norm`` forward, and the backward its autodiff through
    ``psum`` gives, with the two sums of the statistics' gradient reduced
    in one all-reduce.  Saves only x (in its dtype) and the statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, group, count,
                out_dtype):
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        rstd = torch.rsqrt(var + eps)
        y = (x.to(_f32) - mean.reshape(shape)) * rstd.reshape(shape)
        if weight is not None:
            y = y * weight.to(_f32).reshape(shape)
        if bias is not None:
            y = y + bias.to(_f32).reshape(shape)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.group, ctx.count = group, count
        ctx.has_bias = bias is not None
        return y.to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        red = [d for d in range(x.dim()) if d != 1]
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        xhat = (x.to(_f32) - mean.reshape(shape)) * rstd.reshape(shape)
        dy = dy.to(_f32)
        g = dy if weight is None else dy * weight.to(_f32).reshape(shape)
        dw = (None if weight is None
              else (dy * xhat).sum(red).to(weight.dtype))
        db = dy.sum(red) if ctx.has_bias else None
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.count is None:            # eval: constant statistics
                dx = g * rstd.reshape(shape)
            else:
                sums = all_reduce_(torch.stack([g.sum(red),
                                                (g * xhat).sum(red)]),
                                   ctx.group) / ctx.count
                dx = rstd.reshape(shape) * (
                    g - sums[0].reshape(shape) - xhat * sums[1].reshape(
                        shape))
            dx = dx.to(x.dtype)
        return dx, dw, db, None, None, None, None, None, None


def _synced_batch_norm(x, weight, bias, running_mean, running_var,
                       num_batches_tracked, *, training, momentum, eps,
                       group):
    """The JAX ``sync_batch_norm`` with channels on axis 1: batch statistics
    over every rank of ``group`` in training mode (running statistics
    updated in place), the running ones in eval mode."""
    from apex_tpu_torch.amp.interpreter import autocast_dtype
    # batch_norm is on O1's f32 list: under O1 the output is f32
    out_dtype = _f32 if autocast_dtype() is not None else x.dtype
    count = None
    if training:
        red = [d for d in range(x.dim()) if d != 1]
        with torch.no_grad():
            xf = x.to(_f32)
            total = all_reduce_(torch.stack([xf.sum(red),
                                             (xf * xf).sum(red)]), group)
            del xf
            count = float(x.numel() // x.shape[1]) * ps.group_size(group)
            mean = total[0] / count
            var = total[1] / count - mean * mean
            if running_mean is not None:
                unbiased = var * (count / max(count - 1.0, 1.0))
                running_mean.mul_(1 - momentum).add_(momentum * mean)
                running_var.mul_(1 - momentum).add_(momentum * unbiased)
                if num_batches_tracked is not None:
                    num_batches_tracked.add_(1)
    else:
        mean, var = running_mean, running_var
    return _SyncBatchNorm.apply(x, weight, bias, mean, var, eps, group,
                                count, out_dtype)


def batch_norm_(x, weight, bias, running_mean, running_var,
                num_batches_tracked, *, training: bool, momentum: float,
                eps: float, channel_last: bool = False, group=None):
    """Batch norm of ``x`` (channels on axis 1, or last when
    ``channel_last``), updating the running buffers in place in training
    mode (where they are given); returns y in x's dtype.  With a process
    ``group`` the batch statistics are those of every rank's batch."""
    if channel_last:
        x = torch.movedim(x, -1, 1)
    if group is not None:
        y = _synced_batch_norm(x, weight, bias, running_mean, running_var,
                               num_batches_tracked, training=training,
                               momentum=momentum, eps=eps, group=group)
    else:
        y = F.batch_norm(x, running_mean, running_var, weight, bias,
                         training=training, momentum=momentum, eps=eps)
        if training and num_batches_tracked is not None:
            num_batches_tracked.add_(1)
    return torch.movedim(y, 1, -1) if channel_last else y


def sync_batch_norm(x, weight, bias, state: BatchNormState, *,
                    training: bool, momentum: float = 0.1, eps: float = 1e-5,
                    axis_name: Optional[str] = None,
                    channel_last: bool = False,
                    update_running_stats: bool = True, process_group=None):
    """Functional SyncBatchNorm.  Returns ``(y, new_state)``; ``state`` is
    not modified.  ``update_running_stats=False`` normalises with the batch
    statistics in training mode and returns ``state`` as it is.  In
    training mode the statistics combine across ``axis_name`` (or
    ``process_group``)."""
    group = ps.resolve_group(axis_name, process_group)
    if training and update_running_stats:
        new_state = BatchNormState(*(t.clone() for t in state))
    else:
        new_state = state
    track = not training or update_running_stats
    y = batch_norm_(x, weight, bias,
                    new_state.running_mean if track else None,
                    new_state.running_var if track else None,
                    new_state.num_batches_tracked if track else None,
                    training=training, momentum=momentum, eps=eps,
                    channel_last=channel_last, group=group)
    return y, new_state


class SyncBatchNorm(nn.Module):
    """apex ``SyncBatchNorm(num_features, eps, momentum, affine,
    track_running_stats, process_group, channel_last, fuse_relu)`` as an
    ``nn.Module``: ``weight`` / ``bias`` parameters (f32) and the running
    statistics in buffers, updated by ``forward`` in training mode (as
    ``nn.BatchNorm2d``).  Without running statistics, batch statistics
    are used in both modes.  ``process_group`` (a group, or a mesh axis
    name of :mod:`~apex_tpu_torch.transformer.parallel_state`) combines
    the statistics across its ranks."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_group=None,
                 channel_last=False, fuse_relu=False, device=None):
        super().__init__()
        self.num_features = int(num_features)
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.affine = bool(affine)
        self.track_running_stats = bool(track_running_stats)
        self.process_group = process_group
        self.channel_last = bool(channel_last)
        self.fuse_relu = bool(fuse_relu)
        n = self.num_features
        if self.affine:
            self.weight = nn.Parameter(torch.ones(n, device=device))
            self.bias = nn.Parameter(torch.zeros(n, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        if self.track_running_stats:
            self.register_buffer("running_mean",
                                 torch.zeros(n, device=device))
            self.register_buffer("running_var", torch.ones(n, device=device))
            self.register_buffer("num_batches_tracked", torch.zeros(
                (), dtype=torch.int32, device=device))
        else:
            self.running_mean = self.running_var = None
            self.num_batches_tracked = None

    def forward(self, x):
        y = batch_norm_(x, self.weight, self.bias, self.running_mean,
                        self.running_var, self.num_batches_tracked,
                        training=self.training or not self.track_running_stats,
                        momentum=self.momentum, eps=self.eps,
                        channel_last=self.channel_last,
                        group=group_of(self.process_group))
        return F.relu(y) if self.fuse_relu else y


def group_of(process_group):
    """A module's ``process_group`` setting as a group: a mesh axis name
    resolves through ``parallel_state``; None stays local."""
    if isinstance(process_group, str):
        return ps.get_group(process_group)
    return process_group


def convert_syncbn_model(module, process_group=None, channel_last=False):
    """apex ``convert_syncbn_model``: every ``torch.nn`` batch-norm layer of
    ``module`` becomes a :class:`SyncBatchNorm` with its parameters and
    running statistics and ``process_group``; existing
    :class:`SyncBatchNorm` layers take ``process_group`` and
    ``channel_last``, and a model's own batch-norm units (those with
    ``sync_bn_unit = True``, as ``models.resnet``'s) take
    ``process_group``.  Returns the converted module (``module`` itself
    unless it is a batch-norm layer)."""
    if isinstance(module, SyncBatchNorm):
        module.process_group = process_group
        module.channel_last = bool(channel_last)
        return module
    if getattr(module, "sync_bn_unit", False):
        module.process_group = process_group
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        ref = module.weight if module.weight is not None else \
            module.running_mean
        out = SyncBatchNorm(module.num_features, module.eps,
                            module.momentum if module.momentum is not None
                            else 0.1, module.affine,
                            module.track_running_stats,
                            process_group=process_group,
                            channel_last=channel_last,
                            device=None if ref is None else ref.device)
        with torch.no_grad():
            if module.affine:
                out.weight.copy_(module.weight)
                out.bias.copy_(module.bias)
            if module.track_running_stats:
                out.running_mean.copy_(module.running_mean)
                out.running_var.copy_(module.running_var)
                out.num_batches_tracked.copy_(module.num_batches_tracked)
        out.train(module.training)
        return out
    for name, child in module.named_children():
        new = convert_syncbn_model(child, process_group, channel_last)
        if new is not child:
            setattr(module, name, new)
    return module
