"""Tensor-parallel layers — port of
``apex_tpu/transformer/tensor_parallel/layers.py``.

Megatron's tensor parallelism over the process group of ``axis_name``
(``model`` by default, :mod:`apex_tpu_torch.transformer.parallel_state`):
``ColumnParallelLinear`` holds the ``(out / t, in)`` rows of the weight
(and its bias's slice), ``RowParallelLinear`` the ``(out, in / t)``
columns (its bias whole, added after the reduction), and
``VocabParallelEmbedding`` the ``(vocab / t, hidden)`` rows, where ``t`` is
``world_size``; the collectives around them are the mappings of
:mod:`.mappings`.  ``y = x @ W.to(x.dtype).T + b`` is computed at the
activation dtype, as the JAX layers do (``layers.py:117, :289``); these
are plain products that the JAX package leaves to XLA and the port to
``torch.matmul``.  The gradient of an f32 weight comes back through the
``W.to(x.dtype)`` cast (computed at the activation dtype, then widened),
as through JAX's ``astype``.

The JAX keywords and refusals: ``gather_output`` gathers a column layer's
output over the group; ``input_is_parallel=False`` splits a row layer's
input; ``sequence_parallel_enabled`` takes the sequence-parallel edges
(the column layer gathers its input along ``seq_dim``, the row layer
reduce-scatters its output along it, and the row bias, which lands on a
sequence shard, is wrapped in ``copy_to_tensor_model_parallel_region`` so
that its gradient is summed over the ranks); ``overlap_chunks > 0`` takes
the overlap rings of :mod:`.mappings` instead.  ``axis_name=None`` (or an
axis of one rank) makes every collective the identity.  ``stride``,
``keep_master_weight_for_test``, ``gradient_accumulation_fusion`` and
``no_async_tensor_model_parallel_allreduce`` change nothing, as in JAX.
Both linears return ``(output, None)``, or ``(x @ W.T, bias)`` with the
bias not added under ``skip_bias_add``.  The group of ``axis_name`` must
have ``world_size`` ranks when a layer runs.

Weights are built at the local shard's shape; :meth:`_Linear.
reset_parameters` draws the full N(0, 0.02) weight (or fills it with
apex's in-place ``init_method``) in f32 on the CPU and keeps this rank's
slice, as JAX's ``init_params(partition_rank=)`` does, so that every
rank's shards are those of one serial weight.  Biases start at 0.

Int8 decode weights (``GPTConfig(weight_quant="int8")``): after
:func:`install_int8_weight` a layer's ``weight`` is an int8 buffer with an
f32 per-output-row ``weight_scale`` buffer beside it (not ``Parameter``
objects: nothing trains them).  Under tensor parallelism they are the
shard's: a column layer's scales are the slice of the full weight's, a row
layer's those of its own columns.  The linears then run ``quant_gemm(x,
w8, scale).to(x.dtype)`` and add the bias in x's dtype (``layers.py:102-
111, :278-285`` of the JAX package); the embedding dequantizes the
gathered rows only, ``rows.float() * scale[ids]`` (``:349-360``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.ops.quant_gemm import quant_gemm
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel import mappings as M
from apex_tpu_torch.transformer.tensor_parallel.utils import divide
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32
INIT_STD = 0.02
TENSOR_AXIS = ps.TENSOR_AXIS   # the JAX package's tensor-parallel mesh axis

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "install_int8_weight",
           "linear_with_grad_accumulation_and_async_allreduce"]


def _axis_rank(axis_name):
    return ps.group_rank(M.axis_group(axis_name))


def _check_world(layer):
    """Raise unless the group of ``layer.axis_name`` has the layer's
    ``world_size`` ranks (one rank for ``axis_name=None``)."""
    ranks = ps.group_size(M.axis_group(layer.axis_name))
    if ranks != layer.world_size:
        raise ValueError(
            f"{type(layer).__name__} has world_size={layer.world_size} but "
            f"the group of axis {layer.axis_name!r} has {ranks} rank(s)")


def _normal_(param, generator, std=INIT_STD, init_method=None, full=None,
             rows=None, cols=None):
    """Fill ``param`` with N(0, std^2) drawn in f32 on the CPU from
    ``generator`` (so a seed gives the same weights on every device), or
    with what ``init_method`` writes into an f32 tensor.  With ``full``
    (the shape of the whole weight) the numbers are drawn at that shape
    and ``param`` takes the ``rows`` / ``cols`` slice of them."""
    shape = tuple(full or param.shape)
    with torch.no_grad():
        if init_method is None:
            w = torch.randn(shape, generator=generator, dtype=_f32) * std
        else:
            w = torch.empty(shape, dtype=_f32)
            init_method(w)
        if rows is not None:
            w = w[rows]
        if cols is not None:
            w = w[:, cols]
        param.copy_(w)


def linear_with_grad_accumulation_and_async_allreduce(
        x, weight, bias=None, gradient_accumulation_fusion: bool = False,
        async_grad_allreduce: bool = True,
        sequence_parallel_enabled: bool = False,
        axis_name: Optional[str] = TENSOR_AXIS, seq_dim: int = 0,
        overlap_chunks: int = 0, weight_scale=None):
    """The column-parallel product with apex's collective pairing: ``x``
    copied into the region (all-reduce backward), or under sequence
    parallelism gathered along ``seq_dim`` (reduce-scatter backward), or
    with ``overlap_chunks > 0`` the gather and the product as one ring.
    ``gradient_accumulation_fusion`` and ``async_grad_allreduce`` change
    nothing, as in the JAX package."""
    del gradient_accumulation_fusion, async_grad_allreduce
    if axis_name is not None:
        if sequence_parallel_enabled and overlap_chunks > 0:
            y = M.column_parallel_linear_overlap(x, weight, axis_name,
                                                 seq_dim, overlap_chunks)
            return y if bias is None else y + bias.to(y.dtype)
        if sequence_parallel_enabled:
            x = M.gather_from_sequence_parallel_region(x, axis_name, seq_dim)
        else:
            x = M.copy_to_tensor_model_parallel_region(x, axis_name)
    y = _product(x, weight, weight_scale)
    return y if bias is None else y + bias.to(y.dtype)


def _product(x, weight, weight_scale):
    if weight_scale is not None:
        # int8 weights: the dequant-GEMM, f32 out, then x's dtype
        return quant_gemm(x, weight, weight_scale).to(x.dtype)
    # at the ACTIVATION dtype (bf16 activations keep f32 params)
    return torch.matmul(x, weight.to(x.dtype).t())


class _Linear(nn.Module):
    def __init__(self, input_size, output_size, bias, init_method,
                 skip_bias_add, sequence_parallel_enabled, world_size,
                 axis_name, seq_dim, overlap_chunks, param_dtype, device,
                 shard_rows):
        super().__init__()
        if overlap_chunks > 0 and not sequence_parallel_enabled:
            raise RuntimeError(
                "`overlap_chunks` rings the sequence-parallel GEMM and its "
                "collective; it requires `sequence_parallel_enabled=True`")
        dev = resolve_device(device)
        self.input_size = int(input_size)
        self.output_size = int(output_size)
        self.world_size = int(world_size) if world_size else 1
        self.init_method = init_method
        self.skip_bias_add = bool(skip_bias_add)
        self.sequence_parallel_enabled = bool(sequence_parallel_enabled)
        self.axis_name = axis_name
        self.seq_dim = int(seq_dim)
        self.overlap_chunks = int(overlap_chunks)
        self.shard_rows = shard_rows
        out, inp = self.output_size, self.input_size
        if shard_rows:
            out = divide(out, self.world_size)
        else:
            inp = divide(inp, self.world_size)
        self.weight = nn.Parameter(torch.zeros((out, inp), dtype=param_dtype,
                                               device=dev))
        bias_len = out if shard_rows else self.output_size
        self.bias = nn.Parameter(torch.zeros(
            (bias_len,), dtype=param_dtype, device=dev)) if bias else None
        self.register_buffer("weight_scale", None)

    def reset_parameters(self, generator: torch.Generator,
                         partition_rank: Optional[int] = None) -> None:
        """Draw the full weight from ``generator`` and keep shard
        ``partition_rank`` (default: this rank along ``axis_name``); zero
        the bias."""
        r = _axis_rank(self.axis_name) if partition_rank is None \
            else int(partition_rank)
        out, inp = self.weight.shape
        sl = slice(r * (out if self.shard_rows else inp),
                   (r + 1) * (out if self.shard_rows else inp))
        _normal_(self.weight, generator, init_method=self.init_method,
                 full=(self.output_size, self.input_size),
                 rows=sl if self.shard_rows else None,
                 cols=None if self.shard_rows else sl)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class ColumnParallelLinear(_Linear):
    """Y = XAᵀ with A sharded over its output rows."""

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
                         param_dtype, device, shard_rows=True)
        self.output_size_per_partition = self.weight.shape[0]

    def forward(self, x):
        _check_world(self)
        bias = self.bias
        y = linear_with_grad_accumulation_and_async_allreduce(
            x, self.weight, None if self.skip_bias_add else bias,
            sequence_parallel_enabled=self.sequence_parallel_enabled,
            axis_name=self.axis_name, seq_dim=self.seq_dim,
            overlap_chunks=self.overlap_chunks,
            weight_scale=self.weight_scale)
        if self.gather_output and self.axis_name is not None:
            y = M.gather_from_tensor_model_parallel_region(y, self.axis_name)
        return (y, bias) if self.skip_bias_add else (y, None)


class RowParallelLinear(_Linear):
    """Y = XAᵀ with A sharded over its input columns."""

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
                         param_dtype, device, shard_rows=False)
        self.input_size_per_partition = self.weight.shape[1]

    def forward(self, x):
        _check_world(self)
        axis = self.axis_name
        if axis is not None and not self.input_is_parallel:
            x = M.scatter_to_tensor_model_parallel_region(x, axis)
        if (axis is not None and self.sequence_parallel_enabled
                and self.overlap_chunks > 0):
            # the product and the reduce-scatter as one ring
            y = M.row_parallel_linear_overlap(x, self.weight, axis,
                                              self.seq_dim,
                                              self.overlap_chunks)
        else:
            y = _product(x, self.weight, self.weight_scale)
            if axis is not None:
                if self.sequence_parallel_enabled:
                    y = M.reduce_scatter_to_sequence_parallel_region(
                        y, axis, self.seq_dim)
                else:
                    y = M.reduce_from_tensor_model_parallel_region(y, axis)
        bias = self._bias()
        if self.skip_bias_add:
            return y, bias
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y, None

    def _bias(self):
        bias = self.bias
        if (bias is not None and self.sequence_parallel_enabled
                and self.axis_name is not None):
            # the bias lands on the sequence-sharded output, so each rank's
            # gradient covers its tokens only: identity forward, all-reduce
            # backward sums them (Megatron's sequence-parallel bias grads)
            bias = M.copy_to_tensor_model_parallel_region(bias,
                                                          self.axis_name)
        return bias


class VocabParallelEmbedding(nn.Module):
    """Embedding with the vocab rows sharded over the group of
    ``axis_name``: each rank looks up the ids in its range (zero rows for
    the others) and the rows are all-reduced."""

    def __init__(self, num_embeddings, embedding_dim,
                 init_method: Optional[Callable] = None,
                 world_size: Optional[int] = None,
                 axis_name: Optional[str] = TENSOR_AXIS, param_dtype=_f32,
                 device=None):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.world_size = int(world_size) if world_size else 1
        self.num_embeddings_per_partition = divide(self.num_embeddings,
                                                   self.world_size)
        self.init_method = init_method
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.zeros(
            (self.num_embeddings_per_partition, self.embedding_dim),
            dtype=param_dtype, device=resolve_device(device)))
        self.register_buffer("weight_scale", None)

    def reset_parameters(self, generator: torch.Generator,
                         partition_rank: Optional[int] = None) -> None:
        r = _axis_rank(self.axis_name) if partition_rank is None \
            else int(partition_rank)
        per = self.num_embeddings_per_partition
        _normal_(self.weight, generator, init_method=self.init_method,
                 full=(self.num_embeddings, self.embedding_dim),
                 rows=slice(r * per, (r + 1) * per))

    def _rows(self, ids):
        rows = self.weight[ids]
        if self.weight_scale is None:
            return rows
        # per-row dequantization of the gathered rows only: bitwise the
        # rows of the dequantized table, which is never built
        return rows.to(_f32) * self.weight_scale[ids][..., None]

    def forward(self, token_ids):
        _check_world(self)
        group = M.axis_group(self.axis_name)
        if group is None:
            return self._rows(token_ids)
        start = ps.group_rank(group) * self.num_embeddings_per_partition
        local = token_ids - start
        in_range = (local >= 0) & (local < self.num_embeddings_per_partition)
        emb = self._rows(torch.where(in_range, local,
                                     torch.zeros_like(local)))
        emb = torch.where(in_range[..., None], emb, torch.zeros_like(emb))
        return M.reduce_from_tensor_model_parallel_region(emb,
                                                          self.axis_name)


def install_int8_weight(module: nn.Module, w8, scale) -> None:
    """Make ``module`` (a TP linear or the embedding) an int8 layer in
    place: its ``weight`` Parameter becomes the int8 buffer ``w8`` and
    ``weight_scale`` the f32 buffer ``scale``, both on the module's
    device (under tensor parallelism the shard's own)."""
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
