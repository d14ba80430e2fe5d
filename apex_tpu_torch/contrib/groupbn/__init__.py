"""NHWC batch norm with the fused residual add and ReLU — port of
``apex_tpu/contrib/groupbn/__init__.py`` (apex ``BatchNorm2d_NHWC``, the
MLPerf-ResNet kernels).

JAX's conventions are kept, not ``torch.nn.BatchNorm``'s:

* the running statistics take ``running = m * running + (1 - m) * batch``
  with ``momentum`` m (default 0.9) and the *unbiased* batch variance;
* the batch statistics are f32 sums of x and x^2 over (N, H, W), ``var =
  E[x^2] - mean^2``, and the output comes back in x's dtype;
* ``z`` (the residual) is added after the affine and forces the ReLU
  (``bn_addrelu``); ``fuse_relu`` applies it without a residual.

``bn_group > 1`` takes its statistics over a group of ranks: the sums (s,
sq, n) are summed over ``process_group`` in one ``all_reduce`` (the
reduction of :mod:`apex_tpu_torch.parallel.sync_batchnorm`), whose backward
sums the statistics' gradients over the group, as JAX's autodiff through
``psum`` does.  Without a group it raises, as the JAX module does without
``axis_name``.  Eval mode (``module.eval()``) normalises with the running
statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.collectives import all_reduce_
from apex_tpu_torch.utils.device import resolve_device

__all__ = ["BatchNorm2d_NHWC"]

_f32 = torch.float32


class _GroupSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class BatchNorm2d_NHWC(nn.Module):
    """``(N, H, W, C)`` batch norm; ``forward(x, z=None)`` returns y and,
    in training mode, updates ``running_mean`` / ``running_var`` in
    place."""

    def __init__(self, num_features, eps=1e-5, momentum=0.9,
                 fuse_relu=False, bn_group=1, process_group=None,
                 param_dtype=_f32, device=None):
        super().__init__()
        self.num_features = int(num_features)
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.fuse_relu = bool(fuse_relu)
        # bn_group > 1: the statistics of a device group; the group is a
        # process group here, as it is a mesh axis in JAX
        if bn_group > 1 and process_group is None:
            raise ValueError(
                "bn_group>1 requires process_group: the statistics are "
                "summed over that group of ranks")
        self.bn_group = int(bn_group)
        self.process_group = process_group
        dev = resolve_device(device)
        c = self.num_features
        self.weight = nn.Parameter(torch.ones(c, dtype=param_dtype,
                                              device=dev))
        self.bias = nn.Parameter(torch.zeros(c, dtype=param_dtype,
                                             device=dev))
        self.register_buffer("running_mean",
                             torch.zeros(c, dtype=_f32, device=dev))
        self.register_buffer("running_var",
                             torch.ones(c, dtype=_f32, device=dev))

    def _group(self):
        """The process group, or the group of an axis name (``"data"``)."""
        g = self.process_group
        return ps.get_group(g) if isinstance(g, str) else g

    def forward(self, x, z=None):
        xf = x.to(_f32)
        if self.training:
            red = (0, 1, 2)
            n = torch.full((1,), float(x.numel() // x.shape[-1]),
                           dtype=_f32, device=x.device)
            stats = torch.cat([xf.sum(red), (xf * xf).sum(red), n])
            group = self._group()
            if group is not None:
                stats = _GroupSum.apply(stats, group)
            c = self.num_features
            s, sq, n = stats[:c], stats[c:2 * c], stats[2 * c]
            mean = s / n
            var = sq / n - mean * mean
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.to(_f32) + self.bias.to(_f32)
        if z is not None:                 # the fused bn_addrelu residual
            y = y + z.to(_f32)
        if self.fuse_relu or z is not None:
            y = torch.relu(y)
        return y.to(x.dtype)
