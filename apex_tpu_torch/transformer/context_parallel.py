"""Context parallelism: ring attention and all-to-all (Ulysses) sequence
parallelism over a ``context`` process group — port of
``apex_tpu/transformer/context_parallel.py``.

The sequence is sharded contiguously over the group: rank ``r`` holds rows
``[r * s_local, (r + 1) * s_local)``.

* :func:`ring_attention` — the local queries stay; the K/V chunks travel
  around the ring (rank ``i`` sends to ``i + 1`` by
  :func:`torch.distributed.batch_isend_irecv`, every rank posting the same
  ordered operations), and each chunk's partial attention merges into the
  streaming softmax (running max, running sum, accumulator), f32 and plain
  PyTorch as in JAX.  Causality comes from global positions.  It is an
  autograd Function whose backward is the reverse ring (the transpose of
  the forward rotation, as JAX's autodiff of its scan gives it): the
  chunks travel back with their dK / dV accumulators riding along, which
  reach each chunk's owner at the last step, and each step's chunk scores
  are recomputed from the saved log-sum-exp (``remat=True``, JAX's
  ``jax.checkpoint`` of the combine) or taken from the forward
  (``remat=False``).
* :func:`ulysses_attention` — DeepSpeed-Ulysses: an ``all_to_all`` swaps
  the sequence shard for a head shard (JAX's tiled ``split_axis=1,
  concat_axis=2`` layout), the port's flash-attention kernels (#3 forward,
  #4 / #5 backward) run over the whole sequence for the local heads, and a
  second ``all_to_all`` swaps back; both exchanges are autograd Functions
  whose backward is the inverse exchange.

At a group of one rank both are exactly :func:`~apex_tpu_torch.ops.
flash_attention.flash_attention` (the JAX functions' ``n == 1`` branch).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.collectives import check_backend

__all__ = ["ring_attention", "ulysses_attention"]

_f32 = torch.float32
_NEG = -1e30


def _context_group(axis_name):
    group = ps.resolve_group(axis_name)
    return group, ps.group_size(group), ps.group_rank(group)


def _ring_hop(tensors, group, step=1):
    """Each tensor sent to the group's rank ``r + step`` and the counterpart
    from rank ``r - step`` received (JAX ``ppermute`` with ``(i, i + 1)``;
    ``step=-1`` is the reverse ring), in one ``batch_isend_irecv`` whose
    operations every rank posts in the same order."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + step) % n)
    prv = dist.get_global_rank(group, (r - step) % n)
    sends = [x.contiguous() for x in tensors]
    outs = [torch.empty_like(x) for x in sends]
    ops = []
    for i, (x, o) in enumerate(zip(sends, outs)):
        check_backend(x, group, "ring hop")
        ops.append(dist.P2POp(dist.isend, x, nxt, group, tag=i))
        ops.append(dist.P2POp(dist.irecv, o, prv, group, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def _scores(qf, kc, scale, causal, rank, chunk_id):
    """``(b, h, sl, sl)`` f32 scores of the local queries on chunk
    ``chunk_id``, masked to -1e30 past each query's global position."""
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.to(_f32)) * scale
    if causal:
        sl = qf.shape[2]
        rows = torch.arange(sl, device=qf.device)
        valid = (chunk_id * sl + rows)[None, :] <= (rank * sl + rows)[:, None]
        s = torch.where(valid[None, None], s, torch.full_like(s, _NEG))
    return s


def _skipped(causal, rank, chunk_id):
    """A causal chunk wholly after the local rows adds exactly nothing (its
    probabilities are exp(-1e30 - m) = 0): its products are left out."""
    return causal and chunk_id > rank


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, remat):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        b, h, sl, d = q.shape
        qf = q.to(_f32)
        m = torch.full((b, h, sl, 1), _NEG, dtype=_f32, device=q.device)
        l = torch.zeros((b, h, sl, 1), dtype=_f32, device=q.device)
        acc = torch.zeros((b, h, sl, d), dtype=_f32, device=q.device)
        kc, vc = k, v
        kept = []
        for t in range(n):
            chunk = (rank - t) % n
            if not _skipped(causal, rank, chunk):
                s = _scores(qf, kc, scale, causal, rank, chunk)
                if not remat:
                    kept.append(s)
                m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * corr + torch.sum(p, dim=-1, keepdim=True)
                acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p,
                                                vc.to(_f32))
                m = m_new
            if t < n - 1:
                # n - 1 hops: the last chunk is combined without one
                kc, vc = _ring_hop([kc, vc], group)
        out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
        lse = m + torch.log(torch.where(l == 0.0, torch.ones_like(l), l))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        ctx.save_for_backward(q, k, v, out, lse, *kept)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, *kept = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        qf, do = q.to(_f32), dout.to(_f32)
        delta = torch.sum(do * out, dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        # the reverse ring: one hop back brings the chunk the forward
        # ended on (rank + 1's); each step then sends the chunk and its
        # dK / dV accumulators one rank back, so they reach the chunk's
        # owner at the last step
        kc, vc = _ring_hop([k, v], group, step=-1)
        dk = torch.zeros(k.shape, dtype=_f32, device=k.device)
        dv = torch.zeros(v.shape, dtype=_f32, device=v.device)
        kept = list(kept)
        for t in range(n - 1, -1, -1):
            chunk = (rank - t) % n
            if not _skipped(causal, rank, chunk):
                s = kept.pop() if kept else _scores(qf, kc, scale, causal,
                                                    rank, chunk)
                p = torch.exp(s - lse)
                dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, do)
                dp = torch.einsum("bhqd,bhkd->bhqk", do, vc.to(_f32))
                ds = p * (dp - delta)
                dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds,
                                       kc.to(_f32)) * scale
                dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
            if t > 0:
                kc, vc, dk, dv = _ring_hop([kc, vc, dk, dv], group, step=-1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q, k, v, axis_name: str = ps.CONTEXT_AXIS,
                   causal: bool = False, softmax_scale=None,
                   remat: bool = True):
    """Exact global attention over a ring-sharded sequence.

    ``q``, ``k``, ``v``: ``(batch, heads, s_local, head_dim)``, this rank's
    sequence shard.  Returns ``(batch, heads, s_local, head_dim)``: the
    local queries' attention over the GLOBAL key / value sequence.
    ``remat`` recomputes each ring step's chunk scores in the backward
    instead of keeping them (memory of one chunk instead of ``n``)."""
    group, n, _ = _context_group(axis_name)
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if n == 1:
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=softmax_scale)
    return _RingAttention.apply(q, k, v, group, causal, float(scale),
                                bool(remat))


class _Reshard(torch.autograd.Function):
    """The tiled ``all_to_all`` of ``x`` ``(b, h, s, d)`` from ``split`` to
    ``concat`` (JAX ``all_to_all(split_axis, concat_axis, tiled=True)``):
    ``x`` split into ``n`` blocks along ``split``, block ``j`` sent to rank
    ``j``, the received blocks concatenated along ``concat`` in rank order.
    Its backward is the exchange from ``concat`` back to ``split``."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _tiled_all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_tiled_all_to_all(g, ctx.group, ctx.concat, ctx.split),
                None, None, None)


def _tiled_all_to_all(x, group, split, concat):
    n = dist.get_world_size(group)
    check_backend(x, group, "all_to_all")
    shape = list(x.shape)
    blocks = x.reshape(shape[:split] + [n, shape[split] // n]
                       + shape[split + 1:]).movedim(split, 0).contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    # (n_src, ...) -> concatenated along `concat`
    out = out.movedim(0, concat)
    new = list(blocks.shape[1:])
    new[concat] = new[concat] * n
    return out.reshape(new).contiguous()


def ulysses_attention(q, k, v, axis_name: str = ps.CONTEXT_AXIS,
                      causal: bool = False, softmax_scale=None,
                      block_q: int = 128, block_k: int = 128):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): ``(b, h, s /
    n, d)`` → ``(b, h / n, s, d)``, the flash kernels over the whole
    sequence, and back.  ``heads`` must be divisible by the group's size.
    ``block_q`` / ``block_k`` are the JAX kernel's tiling and have no
    effect here (the port's kernels pick their tiles)."""
    del block_q, block_k
    group, n, _ = _context_group(axis_name)
    h = q.shape[1]
    if n == 1:
        return flash_attention(q, k, v, causal=causal,
                               softmax_scale=softmax_scale)
    if h % n:
        raise ValueError(
            f"heads ({h}) must be divisible by the context axis size ({n})")

    def to_seq(x):
        return _Reshard.apply(x, group, 1, 2)

    out = flash_attention(to_seq(q), to_seq(k), to_seq(v), causal=causal,
                          softmax_scale=softmax_scale)
    return _Reshard.apply(out, group, 2, 1)
