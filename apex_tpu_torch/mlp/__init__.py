"""Fused MLP — port of ``apex_tpu/mlp/__init__.py`` (apex ``apex.mlp``).

A chain of ``x @ W.T + b`` layers with an activation between them (the
last layer linear), weights stored ``(out, in)``.  The chain is plain
PyTorch: its GEMMs go to cuBLAS, as the JAX package leaves them to XLA.
``fused_ffn=True`` runs the canonical 2-layer biased GELU MLP as the fused
FFN op (:func:`apex_tpu_torch.ops.fused_ffn.fused_ffn`, the kernels the
models' ``fused_ffn`` knob runs); any other shape raises, so that an
unfused chain never stands in for the kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from apex_tpu_torch.utils.device import resolve_device

__all__ = ["MLP", "mlp_forward"]


def _linear(x, w, b=None):
    """``x @ w.T (+ b)`` in the promoted dtype of the operands (jnp's
    promotion: a bf16 activation with an f32 weight computes in f32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt).t()
    return y if b is None else y + b


def _activate(h, activation):
    if activation == "none":
        return h
    if activation == "relu":
        return torch.relu(h)
    if activation == "sigmoid":
        return torch.sigmoid(h)
    if activation == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unsupported activation {activation!r}")


def mlp_forward(params, x, activation="relu", fused_ffn=False):
    """Chained ``x @ W.T + b`` with ``activation`` between layers (last
    layer linear) — apex ``mlp_function`` semantics.  ``params`` is
    ``{"weights": [...], "biases": [...]}`` (``biases`` absent or None for
    an MLP without bias).

    ``fused_ffn=True`` covers the 2-layer biased GELU MLP only (the fused
    FFN op); other shapes raise ``ValueError``."""
    weights = list(params["weights"])
    biases = params.get("biases")
    n = len(weights)
    if fused_ffn:
        if n != 2 or activation != "gelu" or biases is None:
            raise ValueError(
                "fused_ffn covers the 2-layer biased GELU MLP "
                f"(got {n} layers, activation={activation!r}, "
                f"biases={'yes' if biases else 'no'})")
        from apex_tpu_torch.ops.fused_ffn import fused_ffn as _fused_ffn
        return _fused_ffn(x, weights[0], biases[0], weights[1], biases[1])
    h = x
    for i, w in enumerate(weights):
        h = _linear(h, w, None if biases is None else biases[i])
        if i + 1 < n:
            h = _activate(h, activation)
    return h


class MLP(nn.Module):
    """apex ``apex.mlp.MLP(mlp_sizes, bias=True, relu=True,
    activation=...)``.

    ``mlp_sizes`` includes the input size: ``MLP([in, h1, h2])`` builds two
    layers, parameters ``weights.i`` ``(out, in)`` and ``biases.i`` (the
    JAX tree's names).  ``device`` defaults to ``"cuda"`` (pass
    ``device="cpu"`` for the plain path); parameters start at zero until
    :meth:`init_params` draws them.
    """

    def __init__(self, mlp_sizes: Sequence[int], bias=True, relu=True,
                 activation=None, param_dtype=torch.float32,
                 fused_ffn=False, device=None):
        super().__init__()
        if len(mlp_sizes) < 2:
            raise ValueError("MLP needs at least an input and output size")
        self.mlp_sizes = tuple(int(s) for s in mlp_sizes)
        self.bias = bool(bias)
        if activation is None:
            activation = "relu" if relu else "none"
        self.activation = activation
        self.fused_ffn = bool(fused_ffn)
        dev = resolve_device(device)
        pairs = list(zip(self.mlp_sizes[:-1], self.mlp_sizes[1:]))
        self.weights = nn.ParameterList(
            nn.Parameter(torch.zeros((o, i), dtype=param_dtype, device=dev))
            for i, o in pairs)
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros((o,), dtype=param_dtype, device=dev))
            for _, o in pairs) if self.bias else None

    def init_params(self, generator: torch.Generator) -> "MLP":
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases, as the
        JAX ``init_params`` draws them, from a CPU generator."""
        with torch.no_grad():
            for i, w in enumerate(self.weights):
                bound = self.mlp_sizes[i] ** -0.5
                w.copy_(_uniform(w.shape, bound, generator))
                if self.biases is not None:
                    b = self.biases[i]
                    b.copy_(_uniform(b.shape, bound, generator))
        return self

    def params(self):
        """The JAX-layout parameter dict of :func:`mlp_forward`."""
        out = {"weights": list(self.weights)}
        if self.biases is not None:
            out["biases"] = list(self.biases)
        return out

    def forward(self, x):
        return mlp_forward(self.params(), x, self.activation,
                           fused_ffn=self.fused_ffn)


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound
