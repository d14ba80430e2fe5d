"""FusedDense / FusedDenseGeluDense — port of
``apex_tpu/fused_dense/__init__.py`` (apex ``apex.fused_dense``).

By default plain PyTorch chains (GEMMs on cuBLAS, as the JAX package
leaves them to XLA) with apex's module and ``_function`` surface.
``fused_ffn=True`` runs the Linear → GELU → Linear pair as the fused FFN op
(:func:`apex_tpu_torch.ops.fused_ffn.fused_ffn`: the forward, dX and dW
kernels the models' ``fused_ffn`` knob runs), with the pre-activation as
its only saved residual.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from apex_tpu_torch.mlp import _linear, _uniform
from apex_tpu_torch.utils.device import resolve_device

__all__ = [
    "FusedDense",
    "FusedDenseGeluDense",
    "fused_dense_function",
    "fused_dense_gelu_dense_function",
]


def fused_dense_function(x, weight, bias=None):
    """``x @ W.T + b`` (apex ``fused_dense_function``)."""
    return _linear(x, weight, bias)


def fused_dense_gelu_dense_function(x, weight1, bias1, weight2, bias2,
                                    fused_ffn=False):
    """Linear → GELU → Linear (apex ``fused_dense_gelu_dense_function``).

    ``fused_ffn=True`` runs the pair as the fused FFN op; the default keeps
    the plain chain."""
    if fused_ffn:
        from apex_tpu_torch.ops.fused_ffn import fused_ffn as _fused_ffn
        return _fused_ffn(x, weight1, bias1, weight2, bias2)
    h = F.gelu(_linear(x, weight1, bias1), approximate="tanh")
    return _linear(h, weight2, bias2)


def _param(shape, dtype, device):
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


class _DenseBase(nn.Module):
    def _init_linear(self, weight, bias, generator):
        """U(-1/sqrt(in), 1/sqrt(in)) weight and bias, as the JAX
        ``_init_linear`` draws them."""
        bound = weight.shape[1] ** -0.5
        with torch.no_grad():
            weight.copy_(_uniform(weight.shape, bound, generator))
            if bias is not None:
                bias.copy_(_uniform(bias.shape, bound, generator))


class FusedDense(_DenseBase):
    """apex ``FusedDense(in_features, out_features, bias=True)``: parameters
    ``weight`` ``(out, in)`` and ``bias``.  ``device`` defaults to
    ``"cuda"``."""

    def __init__(self, in_features, out_features, bias=True,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        dev = resolve_device(device)
        self.weight = _param((self.out_features, self.in_features),
                             param_dtype, dev)
        self.bias = (_param((self.out_features,), param_dtype, dev)
                     if bias else None)

    def init_params(self, generator: torch.Generator) -> "FusedDense":
        self._init_linear(self.weight, self.bias, generator)
        return self

    def forward(self, x):
        return fused_dense_function(x, self.weight, self.bias)


class FusedDenseGeluDense(_DenseBase):
    """apex ``FusedDenseGeluDense(in, intermediate, out)``: parameters
    ``weight1``, ``bias1``, ``weight2``, ``bias2``; ``fused_ffn=True`` runs
    the fused FFN op.  ``bias=False`` raises, as apex does."""

    def __init__(self, in_features, intermediate_features, out_features,
                 bias=True, param_dtype=torch.float32, fused_ffn=False,
                 device=None):
        super().__init__()
        if not bias:
            raise ValueError(
                "FusedDenseGeluDense module without bias is currently not "
                "supported")  # apex parity
        self.in_features = int(in_features)
        self.intermediate_features = int(intermediate_features)
        self.out_features = int(out_features)
        self.fused_ffn = bool(fused_ffn)
        dev = resolve_device(device)
        self.weight1 = _param((self.intermediate_features, self.in_features),
                              param_dtype, dev)
        self.bias1 = _param((self.intermediate_features,), param_dtype, dev)
        self.weight2 = _param((self.out_features,
                               self.intermediate_features), param_dtype, dev)
        self.bias2 = _param((self.out_features,), param_dtype, dev)

    def init_params(self, generator: torch.Generator) -> "FusedDenseGeluDense":
        self._init_linear(self.weight1, self.bias1, generator)
        self._init_linear(self.weight2, self.bias2, generator)
        return self

    def forward(self, x):
        return fused_dense_gelu_dense_function(
            x, self.weight1, self.bias1, self.weight2, self.bias2,
            fused_ffn=self.fused_ffn)
