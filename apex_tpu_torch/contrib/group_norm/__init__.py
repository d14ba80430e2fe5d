"""NHWC GroupNorm — port of ``apex_tpu/contrib/group_norm/__init__.py``
(apex's channels-last GroupNorm with the optional fused SiLU / Swish).

Statistics per (sample, group) over every spatial position, in f32; the
output comes back in the input's dtype.  A chain of PyTorch ops, as the
JAX function is a jnp composition with no kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.utils.device import resolve_device

__all__ = ["GroupNorm", "group_norm_nhwc"]

_f32 = torch.float32


def group_norm_nhwc(x, num_groups, weight=None, bias=None, eps=1e-5,
                    act=""):
    """GroupNorm over the trailing channel axis of ``(N, ..., C)`` input."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups "
                         f"{num_groups}")
    if act not in ("", "silu", "swish"):
        raise ValueError(f"unsupported act {act!r}")
    n = x.shape[0]
    xf = x.to(_f32).reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        y = y * weight.to(_f32)
    if bias is not None:
        y = y + bias.to(_f32)
    if act:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class GroupNorm(nn.Module):
    """apex ``contrib.group_norm.GroupNorm(num_groups, num_channels, eps,
    affine, act)`` over ``(N, H, W, C)`` input; weight 1 and bias 0 at
    init."""

    def __init__(self, num_groups, num_channels, eps=1e-5, affine=True,
                 act="", param_dtype=_f32, device=None):
        super().__init__()
        self.num_groups = int(num_groups)
        self.num_channels = int(num_channels)
        self.eps = float(eps)
        self.affine = bool(affine)
        self.act = act
        if self.affine:
            dev = resolve_device(device)
            self.weight = nn.Parameter(torch.ones(
                self.num_channels, dtype=param_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                self.num_channels, dtype=param_dtype, device=dev))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        return group_norm_nhwc(x, self.num_groups, self.weight, self.bias,
                               self.eps, self.act)
