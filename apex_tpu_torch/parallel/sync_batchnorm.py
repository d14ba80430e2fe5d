"""SyncBatchNorm on one device — port of
``apex_tpu/parallel/sync_batchnorm.py`` (apex
``parallel/optimized_sync_batchnorm.py``), its local path.

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

Statistics across devices (``axis_name`` / ``process_group``) come with
the multi-GPU slice and raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

_f32 = torch.float32

MULTI_GPU_SLICE = "the multi-GPU slice"

__all__ = ["BatchNormState", "sync_batch_norm", "SyncBatchNorm",
           "convert_syncbn_model"]


class BatchNormState(NamedTuple):
    """Running stats (the mutable part of torch BN modules)."""

    running_mean: torch.Tensor
    running_var: torch.Tensor
    num_batches_tracked: torch.Tensor


def _local_only(axis_name, what="axis_name"):
    if axis_name is not None:
        raise NotImplementedError(
            f"SyncBatchNorm {what}={axis_name!r}: statistics across devices "
            f"come with {MULTI_GPU_SLICE} of apex_tpu_torch")


def batch_norm_(x, weight, bias, running_mean, running_var,
                num_batches_tracked, *, training: bool, momentum: float,
                eps: float, channel_last: bool = False):
    """Batch norm of ``x`` (channels on axis 1, or last when
    ``channel_last``), updating the running buffers in place in training
    mode (where they are given); returns y in x's dtype."""
    if channel_last:
        x = torch.movedim(x, -1, 1)
    y = F.batch_norm(x, running_mean, running_var, weight, bias,
                     training=training, momentum=momentum, eps=eps)
    if training and num_batches_tracked is not None:
        num_batches_tracked.add_(1)
    return torch.movedim(y, 1, -1) if channel_last else y


def sync_batch_norm(x, weight, bias, state: BatchNormState, *,
                    training: bool, momentum: float = 0.1, eps: float = 1e-5,
                    axis_name: Optional[str] = None,
                    channel_last: bool = False,
                    update_running_stats: bool = True):
    """Functional SyncBatchNorm.  Returns ``(y, new_state)``; ``state`` is
    not modified.  ``update_running_stats=False`` normalises with the batch
    statistics in training mode and returns ``state`` as it is."""
    _local_only(axis_name)
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
                    channel_last=channel_last)
    return y, new_state


class SyncBatchNorm(nn.Module):
    """apex ``SyncBatchNorm(num_features, eps, momentum, affine,
    track_running_stats, process_group, channel_last, fuse_relu)`` as an
    ``nn.Module``: ``weight`` / ``bias`` parameters (f32) and the running
    statistics in buffers, updated by ``forward`` in training mode (as
    ``nn.BatchNorm2d``).  Without running statistics, batch statistics
    are used in both modes."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_group=None,
                 channel_last=False, fuse_relu=False, device=None):
        super().__init__()
        _local_only(process_group, "process_group")
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
                        channel_last=self.channel_last)
        return F.relu(y) if self.fuse_relu else y


def convert_syncbn_model(module, process_group=None, channel_last=False):
    """apex ``convert_syncbn_model``: every ``torch.nn`` batch-norm layer of
    ``module`` becomes a :class:`SyncBatchNorm` with its parameters and
    running statistics; existing :class:`SyncBatchNorm` layers take
    ``channel_last``.  Returns the converted module (``module`` itself
    unless it is a batch-norm layer)."""
    _local_only(process_group, "process_group")
    if isinstance(module, SyncBatchNorm):
        module.channel_last = bool(channel_last)
        return module
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        ref = module.weight if module.weight is not None else \
            module.running_mean
        out = SyncBatchNorm(module.num_features, module.eps,
                            module.momentum if module.momentum is not None
                            else 0.1, module.affine,
                            module.track_running_stats,
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
