"""Tensor-parallel layers at world size 1 — port of
``apex_tpu/transformer/tensor_parallel/layers.py``.

``ColumnParallelLinear`` / ``RowParallelLinear`` compute
``y = x @ W.to(x.dtype).T + b`` at the activation dtype, as the JAX layers
do (``layers.py:117, :289``); these are plain products that the JAX
package leaves to XLA and the port leaves to ``torch.matmul``.  They are
trainable through autograd: the gradient of an f32 weight comes back
through the ``W.to(x.dtype)`` cast (computed at the activation dtype, then
widened), as through JAX's ``astype``.  Weights are initialised N(0, 0.02)
and biases 0, as the JAX ``init_params``.  A world size above 1 (and
sequence parallelism) waits for the multi-GPU slice and raises.  Like
apex's layers, both linears return ``(output, None)`` (apex's second item
is the bias under ``skip_bias_add``, which the port does not use).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32
INIT_STD = 0.02

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


def _serial_only(world_size, sequence_parallel_enabled=False):
    if (world_size or 1) != 1 or sequence_parallel_enabled:
        raise NotImplementedError(
            "tensor/sequence parallelism (world_size > 1) comes with the "
            "multi-GPU slice of apex_tpu_torch")


def _normal_(param, generator, std=INIT_STD):
    """Fill ``param`` with N(0, std^2) drawn in f32 on the CPU from
    ``generator`` (so a seed gives the same weights on every device)."""
    with torch.no_grad():
        w = torch.randn(param.shape, generator=generator, dtype=_f32) * std
        param.copy_(w)


class _Linear(nn.Module):
    def __init__(self, input_size, output_size, bias=True,
                 sequence_parallel_enabled=False,
                 world_size: Optional[int] = None, param_dtype=_f32,
                 device=None):
        super().__init__()
        _serial_only(world_size, sequence_parallel_enabled)
        dev = resolve_device(device)
        self.input_size = int(input_size)
        self.output_size = int(output_size)
        self.weight = nn.Parameter(torch.zeros(
            (self.output_size, self.input_size), dtype=param_dtype,
            device=dev))
        self.bias = nn.Parameter(torch.zeros(
            (self.output_size,), dtype=param_dtype, device=dev)) if bias \
            else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        # compute at the ACTIVATION dtype (bf16 activations keep f32 params)
        y = torch.matmul(x, self.weight.to(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y, None


class ColumnParallelLinear(_Linear):
    """Y = XAᵀ with A sharded over its output rows (one shard here)."""


class RowParallelLinear(_Linear):
    """Y = XAᵀ with A sharded over its input columns (one shard here)."""


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocab dim sharded over the tensor axis (one
    shard here)."""

    def __init__(self, num_embeddings, embedding_dim,
                 world_size: Optional[int] = None, param_dtype=_f32,
                 device=None):
        super().__init__()
        _serial_only(world_size)
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.weight = nn.Parameter(torch.zeros(
            (self.num_embeddings, self.embedding_dim), dtype=param_dtype,
            device=resolve_device(device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator)

    def forward(self, token_ids):
        return self.weight[token_ids]
