"""Tensor-parallel region mappings — port of
``apex_tpu/transformer/tensor_parallel/mappings.py``.

Each mapping is a forward / backward pair of collectives over the process
group of a mesh axis (``model`` by default; :mod:`apex_tpu_torch.
transformer.parallel_state` maps the axis to a group), written as a
:class:`torch.autograd.Function`:

| function                                         | forward        | backward       |
|--------------------------------------------------|----------------|----------------|
| ``copy_to_tensor_model_parallel_region``         | identity       | all-reduce     |
| ``reduce_from_tensor_model_parallel_region``     | all-reduce     | identity       |
| ``scatter_to_tensor_model_parallel_region``      | split (last)   | all-gather     |
| ``gather_from_tensor_model_parallel_region``     | all-gather     | split (last)   |
| ``scatter_to_sequence_parallel_region``          | split (seq)    | all-gather     |
| ``gather_from_sequence_parallel_region``         | all-gather     | reduce-scatter |
| ``reduce_scatter_to_sequence_parallel_region``   | reduce-scatter | all-gather     |

The sequence mappings take a ``seq_dim`` (default 0, apex's ``(s, b, h)``
layout; the GPT and BERT activations are ``(b, s, h)`` and pass
``seq_dim=1``).  An axis of one rank (no group) makes every mapping the
identity, as a JAX collective over an axis of size 1.  A CUDA tensor needs
an NCCL group and a CPU tensor a gloo group
(:func:`apex_tpu_torch.utils.collectives.check_backend`).

The overlap forms :func:`column_parallel_linear_overlap` and
:func:`row_parallel_linear_overlap` fuse the sequence-parallel collective
with its GEMM as a ring: the JAX package's ``ppermute`` steps become
:func:`torch.distributed.batch_isend_irecv` to the neighbouring ranks, in
the order of its ``_ring_perm`` (rank ``i`` sends to ``i - 1`` and
receives from ``i + 1``, so after ``k`` steps rank ``r`` holds shard ``(r
+ k) % t``).  Their backward rings the reduce-scatter (column) or the
gather (row) the same way and accumulates the weight gradient in f32
shard by shard, as ``_column_overlap_bwd`` / ``_row_overlap_bwd`` do.
Each step's GEMM is split into ``chunks`` products along ``seq_dim``
(:func:`_chunked_matmul`), which reorders no output element's sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.collectives import check_backend

TENSOR_AXIS = ps.TENSOR_AXIS
_f32 = torch.float32

__all__ = ["copy_to_tensor_model_parallel_region",
           "reduce_from_tensor_model_parallel_region",
           "scatter_to_tensor_model_parallel_region",
           "gather_from_tensor_model_parallel_region",
           "scatter_to_sequence_parallel_region",
           "gather_from_sequence_parallel_region",
           "reduce_scatter_to_sequence_parallel_region",
           "column_parallel_linear_overlap", "row_parallel_linear_overlap",
           "axis_group"]


def axis_group(axis_name):
    """The process group of mesh axis ``axis_name``, or None where the
    axis is this rank alone (no axis, no ``torch.distributed``, or a group
    of one rank): its collectives are identities."""
    group = ps.resolve_group(axis_name)
    return None if ps.group_size(group) == 1 else group


# -- the collectives ---------------------------------------------------------

def _all_reduce(x, group):
    check_backend(x, group, "all_reduce")
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _split(x, dim, group):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible "
                         f"by the {n} ranks of the group")
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


def _gather(x, dim, group):
    check_backend(x, group, "all_gather")
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x, dim, group):
    check_backend(x, group, "reduce_scatter")
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible "
                         f"by the {n} ranks of the group")
    out = moved.new_empty((moved.shape[0] // n,) + tuple(moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def _identity(x, dim, group):
    return x.view_as(x)


def _reduce(x, dim, group):
    return _all_reduce(x, group)


def _mapping(name, fwd, bwd):
    """``apply(x, axis_name, dim)``: ``fwd`` forward and ``bwd`` backward
    along ``dim`` over the axis's group; the identity where the axis is
    one rank."""

    class _Map(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            ctx.group, ctx.dim = group, dim
            return fwd(x, dim, group)

        @staticmethod
        def backward(ctx, g):
            return bwd(g, ctx.dim, ctx.group), None, None

    _Map.__name__ = _Map.__qualname__ = "_" + name

    def apply(x, axis_name=TENSOR_AXIS, dim=-1):
        group = axis_group(axis_name)
        if group is None:
            return x
        return _Map.apply(x, group, dim)

    return apply


_copy = _mapping("copy", _identity, _reduce)
_reduce_from = _mapping("reduce", _reduce, _identity)
_scatter = _mapping("scatter", _split, _gather)
_gather_from = _mapping("gather", _gather, _split)
_seq_gather = _mapping("seq_gather", _gather, _reduce_scatter)
_seq_rs = _mapping("seq_reduce_scatter", _reduce_scatter, _gather)


def copy_to_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """Identity forward, all-reduce backward.  On a replicated parameter
    used by rank-local work (a LayerNorm on the sequence shard, a bias on
    a shard's output) it sums the ranks' partial gradients."""
    return _copy(x, axis_name)


def reduce_from_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """All-reduce forward, identity backward."""
    return _reduce_from(x, axis_name)


def scatter_to_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """This rank's split of the last dim forward, all-gather backward."""
    return _scatter(x, axis_name, -1)


def gather_from_tensor_model_parallel_region(x, axis_name=TENSOR_AXIS):
    """All-gather along the last dim forward, this rank's split
    backward."""
    return _gather_from(x, axis_name, -1)


def scatter_to_sequence_parallel_region(x, axis_name=TENSOR_AXIS,
                                        seq_dim=0):
    """This rank's split of ``seq_dim`` forward, all-gather backward."""
    return _scatter(x, axis_name, seq_dim)


def gather_from_sequence_parallel_region(x, axis_name=TENSOR_AXIS,
                                         seq_dim=0,
                                         tensor_parallel_output_grad=True):
    """All-gather along ``seq_dim`` forward, reduce-scatter backward.
    ``tensor_parallel_output_grad=False`` (Megatron's keyword): the
    backward is this rank's split, for an output whose cotangent is the
    same on every rank (work replicated across the ranks, such as BERT's
    pooler), which a reduce-scatter would count once a rank."""
    if not tensor_parallel_output_grad:
        return _gather_from(x, axis_name, seq_dim)
    return _seq_gather(x, axis_name, seq_dim)


def reduce_scatter_to_sequence_parallel_region(x, axis_name=TENSOR_AXIS,
                                               seq_dim=0):
    """Reduce-scatter along ``seq_dim`` forward, all-gather backward."""
    return _seq_rs(x, axis_name, seq_dim)


# -- the overlap rings ---------------------------------------------------------

def _ring_shift(tensors, group):
    """Each tensor sent to the group's rank ``r - 1`` and its counterpart
    received from rank ``r + 1`` (JAX's ``_ring_perm``), all in one
    :func:`torch.distributed.batch_isend_irecv`; every rank posts the same
    operations in the same order."""
    t, r = dist.get_world_size(group), dist.get_rank(group)
    left = dist.get_global_rank(group, (r - 1) % t)
    right = dist.get_global_rank(group, (r + 1) % t)
    sends = [x.contiguous() for x in tensors]
    outs = [torch.empty_like(x) for x in sends]
    ops = []
    for i, (x, o) in enumerate(zip(sends, outs)):
        check_backend(x, group, "ring step")
        ops.append(dist.P2POp(dist.isend, x, left, group, tag=i))
        ops.append(dist.P2POp(dist.irecv, o, right, group, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _chunked_matmul(block, w_t, chunks, seq_dim):
    """``block @ w_t`` as ``chunks`` products along ``seq_dim``; equal to
    the one product (splitting rows reorders no output element's sum)."""
    if chunks <= 1:
        return torch.matmul(block, w_t)
    if block.shape[seq_dim] % chunks:
        raise ValueError(f"overlap chunks {chunks} do not divide the "
                         f"sequence shard of {block.shape[seq_dim]}")
    pieces = torch.split(block, block.shape[seq_dim] // chunks, dim=seq_dim)
    return torch.cat([torch.matmul(p, w_t) for p in pieces], dim=seq_dim)


def _size_rank(group):
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _dw_f32(g, x):
    """``einsum("...o,...h->oh", g, x)`` with f32 products and sums (the
    JAX ``preferred_element_type=f32``)."""
    return torch.matmul(g.reshape(-1, g.shape[-1]).to(_f32).t(),
                        x.reshape(-1, x.shape[-1]).to(_f32))


def _ring_gather_matmul(x, w_t, group, seq_dim, chunks):
    """``all_gather(x, seq_dim) @ w_t`` as a ring: the local shard's
    product, then each arriving shard's, placed at its rank's rows."""
    t, r = _size_rank(group)
    s_local = x.shape[seq_dim]
    shape = list(x.shape)
    shape[seq_dim] = s_local * t
    shape[-1] = w_t.shape[-1]
    y = x.new_empty(shape)
    buf = x
    for k in range(t):
        blk = _chunked_matmul(buf, w_t, chunks, seq_dim)
        y.narrow(seq_dim, ((r + k) % t) * s_local, s_local).copy_(blk)
        if k + 1 < t:
            (buf,) = _ring_shift([buf], group)
    return y


def _ring_matmul_reduce_scatter(x, w_t, group, seq_dim, chunks):
    """``reduce_scatter(x @ w_t, seq_dim)`` as a ring: at step ``k`` rank
    ``d`` adds its product for shard ``(d + k + 1) % t`` to the
    accumulator arriving from its neighbour and passes the sum on; after
    ``t`` steps each rank holds its own shard, summed."""
    t, r = _size_rank(group)
    s_local = x.shape[seq_dim] // t
    acc = None
    for k in range(t):
        blk = x.narrow(seq_dim, ((r + k + 1) % t) * s_local, s_local)
        part = _chunked_matmul(blk, w_t, chunks, seq_dim)
        acc = part if acc is None else acc + part
        if k + 1 < t:
            (acc,) = _ring_shift([acc], group)
    return acc


def _column_overlap_bwd(x, weight, g, group, seq_dim, chunks):
    """dX = reduce_scatter(g @ W) and dW = Σₖ g[shard k]ᵀ x[shard k] on
    one ring: the dX accumulator and the regathered x shard travel
    together."""
    w_c = weight.to(g.dtype)
    t, r = _size_rank(group)
    s_local = x.shape[seq_dim]
    acc, xbuf = None, x
    dw = torch.zeros(weight.shape, dtype=_f32, device=weight.device)
    for k in range(t):
        blk = g.narrow(seq_dim, ((r + k + 1) % t) * s_local, s_local)
        part = _chunked_matmul(blk, w_c, chunks, seq_dim)
        acc = part if acc is None else acc + part
        gk = g.narrow(seq_dim, ((r + k) % t) * s_local, s_local)
        dw += _dw_f32(gk, xbuf)
        if k + 1 < t:
            acc, xbuf = _ring_shift([acc, xbuf], group)
    return acc.to(x.dtype), dw.to(weight.dtype)


def _row_overlap_bwd(x, weight, g, group, seq_dim, chunks):
    """dX = all_gather(g) @ W and dW = Σₖ g[shard k]ᵀ x[shard k] on the
    ring that regathers g."""
    w_c = weight.to(g.dtype)
    t, r = _size_rank(group)
    s_local = g.shape[seq_dim]
    dx = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.zeros(weight.shape, dtype=_f32, device=weight.device)
    buf = g
    for k in range(t):
        j = (r + k) % t
        blk = _chunked_matmul(buf, w_c, chunks, seq_dim)
        dx.narrow(seq_dim, j * s_local, s_local).copy_(blk)
        dw += _dw_f32(buf, x.narrow(seq_dim, j * s_local, s_local))
        if k + 1 < t:
            (buf,) = _ring_shift([buf], group)
    return dx, dw.to(weight.dtype)


class _ColumnOverlap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, group, seq_dim, chunks):
        ctx.save_for_backward(x, weight)
        ctx.args = (group, seq_dim, chunks)
        return _ring_gather_matmul(x, weight.to(x.dtype).t(), group,
                                   seq_dim, chunks)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _column_overlap_bwd(x, weight, g.contiguous(), *ctx.args)
        return dx, dw, None, None, None


class _RowOverlap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, group, seq_dim, chunks):
        ctx.save_for_backward(x, weight)
        ctx.args = (group, seq_dim, chunks)
        return _ring_matmul_reduce_scatter(x, weight.to(x.dtype).t(), group,
                                           seq_dim, chunks)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _row_overlap_bwd(x, weight, g.contiguous(), *ctx.args)
        return dx, dw, None, None, None


def column_parallel_linear_overlap(x, weight, axis_name=TENSOR_AXIS,
                                   seq_dim=0, chunks=1):
    """``all_gather(x, seq_dim) @ weight.T`` as one ring (``x`` the local
    sequence shard, ``weight`` the ``(out / t, in)`` column shard); the
    product at x's dtype."""
    return _ColumnOverlap.apply(x, weight, axis_group(axis_name),
                                seq_dim % x.dim(), int(chunks))


def row_parallel_linear_overlap(x, weight, axis_name=TENSOR_AXIS, seq_dim=0,
                                chunks=1):
    """``reduce_scatter(x @ weight.T, seq_dim)`` as one ring (``x`` the
    whole sequence of this rank's input columns, ``weight`` the ``(out,
    in / t)`` row shard)."""
    return _RowOverlap.apply(x, weight, axis_group(axis_name),
                             seq_dim % x.dim(), int(chunks))
