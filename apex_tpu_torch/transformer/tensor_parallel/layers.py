"""Tensor-parallel layers at world size 1 — port of
``apex_tpu/transformer/tensor_parallel/layers.py``.

``ColumnParallelLinear`` / ``RowParallelLinear`` compute
``y = x @ W.to(x.dtype).T + b`` at the activation dtype, as the JAX layers
do (``layers.py:117, :289``); these are plain products that the JAX
package leaves to XLA and the port leaves to ``torch.matmul``.  They are
trainable through autograd: the gradient of an f32 weight comes back
through the ``W.to(x.dtype)`` cast (computed at the activation dtype, then
widened), as through JAX's ``astype``.  Weights are initialised N(0, 0.02)
and biases 0, as the JAX ``init_params``, unless an ``init_method`` is
given: apex's in-place initializer (``init_method(weight)``, e.g.
``torch.nn.init.xavier_normal_``), applied to an f32 tensor that the
weight then copies.  A world size above 1 (and sequence parallelism) waits
for the multi-GPU slice and raises.

The constructors take the JAX layers' keywords (apex's, plus ``axis_name``,
``seq_dim`` and ``overlap_chunks``) with their defaults and their
refusals.  At world size 1 the collectives they steer are identities
(``axis_name`` names an axis of size 1; ``gather_output`` and
``input_is_parallel`` gather and scatter over it), and ``stride``,
``keep_master_weight_for_test``, ``gradient_accumulation_fusion`` and
``no_async_tensor_model_parallel_allreduce`` change nothing, as in JAX.
Like apex's layers, both linears return ``(output, None)``, or ``(x @ W.T,
bias)`` with the bias not added under ``skip_bias_add``.

Int8 decode weights (``GPTConfig(weight_quant="int8")``): after
:func:`install_int8_weight` a layer's ``weight`` is an int8 buffer with an
f32 per-output-row ``weight_scale`` buffer beside it (they are not
``Parameter`` objects: nothing trains them).  The linears then run
``quant_gemm(x, w8, scale).to(x.dtype)`` and add the bias in x's dtype
(``layers.py:102-111, :278-285`` of the JAX package); the embedding
dequantizes the gathered rows only, ``rows.float() * scale[ids]``
(``:349-360``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.ops.quant_gemm import quant_gemm
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32
INIT_STD = 0.02
TENSOR_AXIS = "model"      # the JAX package's tensor-parallel mesh axis

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "install_int8_weight"]


def _serial_only(world_size, sequence_parallel_enabled=False):
    if (world_size or 1) != 1 or sequence_parallel_enabled:
        raise NotImplementedError(
            "tensor/sequence parallelism (world_size > 1) comes with the "
            "multi-GPU slice of apex_tpu_torch")


def _normal_(param, generator, std=INIT_STD, init_method=None):
    """Fill ``param`` with N(0, std^2) drawn in f32 on the CPU from
    ``generator`` (so a seed gives the same weights on every device), or
    with what ``init_method`` writes into an f32 tensor of its shape."""
    with torch.no_grad():
        if init_method is None:
            w = torch.randn(param.shape, generator=generator,
                            dtype=_f32) * std
        else:
            w = torch.empty(param.shape, dtype=_f32)
            init_method(w)
        param.copy_(w)


class _Linear(nn.Module):
    def __init__(self, input_size, output_size, bias, init_method,
                 skip_bias_add, sequence_parallel_enabled, world_size,
                 axis_name, seq_dim, overlap_chunks, param_dtype, device):
        super().__init__()
        if overlap_chunks > 0 and not sequence_parallel_enabled:
            raise RuntimeError(
                "`overlap_chunks` rings the sequence-parallel GEMM and its "
                "collective; it requires `sequence_parallel_enabled=True`")
        _serial_only(world_size, sequence_parallel_enabled)
        dev = resolve_device(device)
        self.input_size = int(input_size)
        self.output_size = int(output_size)
        self.init_method = init_method
        self.skip_bias_add = bool(skip_bias_add)
        self.axis_name = axis_name
        self.seq_dim = int(seq_dim)
        self.overlap_chunks = int(overlap_chunks)
        self.weight = nn.Parameter(torch.zeros(
            (self.output_size, self.input_size), dtype=param_dtype,
            device=dev))
        self.bias = nn.Parameter(torch.zeros(
            (self.output_size,), dtype=param_dtype, device=dev)) if bias \
            else None
        self.register_buffer("weight_scale", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator, init_method=self.init_method)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        if self.weight_scale is not None:
            # int8 weights: the dequant-GEMM, f32 out, then x's dtype
            y = quant_gemm(x, self.weight, self.weight_scale).to(x.dtype)
        else:
            # compute at the ACTIVATION dtype (bf16 activations keep f32
            # params)
            y = torch.matmul(x, self.weight.to(x.dtype).t())
        if self.skip_bias_add:
            return y, self.bias
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y, None


class ColumnParallelLinear(_Linear):
    """Y = XAᵀ with A sharded over its output rows (one shard here)."""

    def __init__(self, input_size, output_size, bias=True,
                 gather_output=True, init_method: Optional[Callable] = None,
                 stride=1, keep_master_weight_for_test=False,
                 skip_bias_add=False,
                 no_async_tensor_model_parallel_allreduce=False,
                 sequence_parallel_enabled=False,
                 gradient_accumulation_fusion=False,
                 world_size: Optional[int] = None,
                 axis_name: Optional[str] = TENSOR_AXIS, seq_dim: int = 0,
                 overlap_chunks: int = 0, param_dtype=_f32, device=None):
        if gather_output and sequence_parallel_enabled:
            raise RuntimeError(
                "`gather_output` and `sequence_parallel_enabled` cannot "
                "both be True")  # apex parity
        self.gather_output = bool(gather_output)
        super().__init__(input_size, output_size, bias, init_method,
                         skip_bias_add, sequence_parallel_enabled,
                         world_size, axis_name, seq_dim, overlap_chunks,
                         param_dtype, device)


class RowParallelLinear(_Linear):
    """Y = XAᵀ with A sharded over its input columns (one shard here)."""

    def __init__(self, input_size, output_size, bias=True,
                 input_is_parallel=False,
                 init_method: Optional[Callable] = None, stride=1,
                 keep_master_weight_for_test=False, skip_bias_add=False,
                 sequence_parallel_enabled=False,
                 gradient_accumulation_fusion=False,
                 world_size: Optional[int] = None,
                 axis_name: Optional[str] = TENSOR_AXIS, seq_dim: int = 0,
                 overlap_chunks: int = 0, param_dtype=_f32, device=None):
        if sequence_parallel_enabled and not input_is_parallel:
            raise RuntimeError(
                "To enable `sequence_parallel_enabled`, "
                "`input_is_parallel` must be `True`")  # apex parity
        self.input_is_parallel = bool(input_is_parallel)
        super().__init__(input_size, output_size, bias, init_method,
                         skip_bias_add, sequence_parallel_enabled,
                         world_size, axis_name, seq_dim, overlap_chunks,
                         param_dtype, device)


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocab dim sharded over the tensor axis (one
    shard here)."""

    def __init__(self, num_embeddings, embedding_dim,
                 init_method: Optional[Callable] = None,
                 world_size: Optional[int] = None,
                 axis_name: Optional[str] = TENSOR_AXIS, param_dtype=_f32,
                 device=None):
        super().__init__()
        _serial_only(world_size)
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.init_method = init_method
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.zeros(
            (self.num_embeddings, self.embedding_dim), dtype=param_dtype,
            device=resolve_device(device)))
        self.register_buffer("weight_scale", None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _normal_(self.weight, generator, init_method=self.init_method)

    def forward(self, token_ids):
        rows = self.weight[token_ids]
        if self.weight_scale is None:
            return rows
        # per-row dequantization of the gathered rows only: bitwise the
        # rows of the dequantized table, which is never built
        return rows.to(_f32) * self.weight_scale[token_ids][..., None]


def install_int8_weight(module: nn.Module, w8, scale) -> None:
    """Make ``module`` (a TP linear or the embedding) an int8 layer in
    place: its ``weight`` Parameter becomes the int8 buffer ``w8`` and
    ``weight_scale`` the f32 buffer ``scale``, both on the module's
    device."""
    dev = module.weight.device
    if tuple(w8.shape) != tuple(module.weight.shape):
        raise ValueError(f"int8 weight {tuple(w8.shape)} does not match "
                         f"{tuple(module.weight.shape)}")
    if w8.dtype != torch.int8 or tuple(scale.shape) != (w8.shape[0],):
        raise ValueError("install_int8_weight takes an int8 (out, in) weight "
                         "and an (out,) scale")
    del module.weight
    module.register_buffer("weight", w8.to(dev))
    module.weight_scale = scale.to(dev, _f32)
