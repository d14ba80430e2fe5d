"""Expert parallelism: the Switch / GShard mixture-of-experts FFN over an
``expert`` process group — port of ``apex_tpu/transformer/expert_parallel.py``.

The dataflow of the JAX module, step for step: every rank holds
``n_experts / ep`` expert FFNs and its own tokens.  Per rank: the top-k gate
in f32 (``top_k=1`` Switch, the raw top-1 probability; ``top_k=2`` GShard,
renormalized over the pair; ties go to the lower expert index, as
``jax.lax.top_k`` breaks them) → the capacity-bounded dispatch into an
``(n_experts, capacity, hidden)`` buffer in the compute dtype (integer
cumsums; second choices claim slots after every first choice) →
``all_to_all`` over the ``expert`` group (an autograd Function whose
backward is the same exchange: it is its own inverse) → the batched expert
FFN, ReLU between two batched products with no biases → the inverse
``all_to_all`` in the compute dtype → the gate-weighted combine.  A token
over capacity adds ``x * 0`` into a clipped slot and is multiplied out by
its ``keep`` flag in the combine (dropped: it contributes zero), as in JAX.
The auxiliary output is the Switch load-balancing loss over first choices.

Under tensor parallelism (``tensor_parallel_size``, ``tensor_axis``) each
expert's FFN dimension is split over the ``model`` group with the
Megatron column → row pair of :mod:`~apex_tpu_torch.transformer.
tensor_parallel.mappings` (``copy_to`` before the first product,
``reduce_from`` after the second).  The expert and tensor groups are
independent.

The batched products are ``torch.bmm``, as JAX computes its einsums
outside any Pallas kernel; the dispatch and combine are plain PyTorch.
With a bf16 compute dtype the second product rounds its output to bf16,
where JAX keeps it in f32 until the combine (on one rank; under EP JAX also
rounds it for the return trip).

JAX's ``vary_params_over_axis`` marks parameters as varying over a mesh
axis for JAX's type system inside ``shard_map`` and has no counterpart: in
torch every rank's tensors are its own and nothing reduces a gradient by
itself (:func:`reduce_moe_grads` does it explicitly).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.collectives import check_backend

__all__ = ["MoEConfig", "MoEMLP", "is_gpt_expert_leaf",
           "localize_expert_params", "reduce_moe_grads"]

_f32 = torch.float32


@dataclasses.dataclass
class MoEConfig:
    hidden_size: int
    ffn_hidden_size: int
    n_experts: int
    capacity_factor: float = 1.25
    top_k: int = 1                           # 1 = Switch, 2 = GShard
    expert_parallel_size: int = 1
    axis_name: Optional[str] = None          # "expert": the process group
    tensor_parallel_size: int = 1            # shard each expert's FFN dim
    tensor_axis: Optional[str] = None        # "model"
    param_dtype: torch.dtype = _f32
    compute_dtype: torch.dtype = _f32        # expert products / dispatch
    # (gate softmax + aux loss always run f32)

    def __post_init__(self):
        if self.n_experts % self.expert_parallel_size:
            raise ValueError("n_experts must be divisible by "
                             "expert_parallel_size")
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError("top_k must be in [1, n_experts]")
        if self.expert_parallel_size > 1 and self.axis_name is None:
            raise ValueError(
                "expert_parallel_size > 1 requires axis_name (the expert "
                "mesh axis the call runs under)")
        if self.ffn_hidden_size % self.tensor_parallel_size:
            raise ValueError("ffn_hidden_size must be divisible by "
                             "tensor_parallel_size")
        if self.tensor_parallel_size > 1 and self.tensor_axis is None:
            raise ValueError(
                "tensor_parallel_size > 1 requires tensor_axis (the "
                "tensor mesh axis the call runs under)")

    @property
    def local_experts(self):
        return self.n_experts // self.expert_parallel_size

    @property
    def local_ffn(self):
        return self.ffn_hidden_size // self.tensor_parallel_size


def _expert_group(axis_name, ep):
    """The ``expert`` group of ``ep`` ranks, or None at one rank."""
    if axis_name is None or ep == 1:
        return None
    group = ps.resolve_group(axis_name)
    if ps.group_size(group) != ep:
        raise ValueError(
            f"expert_parallel_size={ep} but the {axis_name!r} group has "
            f"{ps.group_size(group)} ranks")
    return group


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of dim 0's equal chunks over ``group``: chunk ``j``
    goes to rank ``j``, chunk ``i`` of the output came from rank ``i``
    (JAX ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``).  The
    exchange is its own inverse, so the backward is the same exchange of
    the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    check_backend(x, group, "all_to_all")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x, group):
    """Differentiable exchange of ``x``'s dim-0 chunks over ``group`` (the
    identity for None)."""
    if group is None:
        return x
    return _AllToAll.apply(x, group)


def top_k_by_index(probs, k):
    """``(values, indices)`` of the ``k`` largest entries of each row in
    descending order, ties to the lower index (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none on the card)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class MoEMLP(nn.Module):
    """Top-k MoE FFN (``top_k=1`` Switch, ``top_k=2`` GShard).

    Parameters are this rank's: the replicated ``gate`` ``(hidden,
    n_experts)`` and the expert stacks ``w1`` ``(local_experts, hidden,
    local_ffn)``, ``w2`` ``(local_experts, local_ffn, hidden)`` (the JAX
    leaves' layout).  ``out, aux = m(x)`` with ``x`` ``(tokens, hidden)``.
    With ``count_drops = True`` each call adds its dropped and routed
    token-choices to ``dropped`` / ``routed`` and its first choices per
    expert to ``chosen`` (device tensors; no sync), over the rows that
    ``count_rows`` marks (a bool tensor over the call's tokens: a caller's
    real tokens, not a bucket's padding or idle decode slots; None counts
    every row).
    """

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, h, f = cfg.local_experts, cfg.hidden_size, cfg.local_ffn
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.gate = nn.Parameter(torch.zeros((h, cfg.n_experts), **kw))
        self.w1 = nn.Parameter(torch.zeros((e, h, f), **kw))
        self.w2 = nn.Parameter(torch.zeros((e, f, h), **kw))
        self.count_drops = False
        self.count_rows = None
        self.dropped = self.routed = self.chosen = None

    def reset_parameters(self, generator, expert_rank=0, tensor_rank=0):
        """Random weights with the JAX ``init_params`` scales (gate N(0,
        0.02), w1 N(0, 1/hidden), w2 N(0, 1/ffn)) from a CPU generator:
        the whole stacks of every expert are drawn and this rank's experts
        (``expert_rank``) and FFN columns (``tensor_rank``) kept, so the
        shards are those of the one-rank module from the same stream.  The
        draws cannot replay ``jax.random``."""
        cfg = self.cfg
        e, h, f = cfg.n_experts, cfg.hidden_size, cfg.ffn_hidden_size
        nl, fl = cfg.local_experts, cfg.local_ffn
        gate = torch.randn((h, e), generator=generator) * 0.02
        w1 = torch.randn((e, h, f), generator=generator) * h ** -0.5
        w2 = torch.randn((e, f, h), generator=generator) * f ** -0.5
        experts = slice(expert_rank * nl, (expert_rank + 1) * nl)
        cols = slice(tensor_rank * fl, (tensor_rank + 1) * fl)
        with torch.no_grad():
            self.gate.copy_(gate)
            self.w1.copy_(w1[experts, :, cols])
            self.w2.copy_(w2[experts, cols])

    def _capacity(self, n_tokens: int) -> int:
        cfg = self.cfg
        cap = int(cfg.capacity_factor * cfg.top_k * n_tokens
                  / cfg.n_experts)
        return max(cap, 1)

    def forward(self, x):
        cfg = self.cfg
        ep = cfg.expert_parallel_size
        t, h = x.shape
        ne, nl = cfg.n_experts, cfg.local_experts
        k = cfg.top_k
        cap = self._capacity(t)
        group = _expert_group(cfg.axis_name, ep)

        xf = x.to(_f32)
        logits = xf @ self.gate.to(_f32)                     # (T, E)
        probs = torch.softmax(logits, dim=-1)
        topk_prob, topk_idx = top_k_by_index(probs, k)       # (T, k)
        if k > 1:
            gate_probs = topk_prob / torch.sum(topk_prob, dim=-1,
                                               keepdim=True)
        else:
            gate_probs = topk_prob

        # aux loss over FIRST choices: n_e * sum_e(fraction_e * mean_prob_e)
        onehot1 = nn.functional.one_hot(topk_idx[:, 0], ne).to(_f32)
        fraction = torch.mean(onehot1, dim=0)
        mean_prob = torch.mean(probs, dim=0)
        aux_loss = ne * torch.sum(fraction * mean_prob)

        # first choices claim slots first, then second choices append;
        # int32 cumsums (exact counts)
        expert_idx, slot, keep = [], [], []
        claimed = torch.zeros((ne,), dtype=torch.int32, device=x.device)
        for c in range(k):
            idx_c = topk_idx[:, c]
            onehot_i = nn.functional.one_hot(idx_c, ne).to(torch.int32)
            pos = torch.cumsum(onehot_i, dim=0, dtype=torch.int32) * onehot_i
            pos_c = torch.amax(pos, dim=-1) - 1 + claimed[idx_c]
            keep_c = pos_c < cap
            expert_idx.append(idx_c)
            slot.append(torch.clamp(pos_c, 0, cap - 1).long())
            keep.append(keep_c)
            claimed = claimed + torch.sum(onehot_i, dim=0, dtype=torch.int32)
        if self.count_drops:
            rows = self.count_rows
            if rows is None:
                rows = torch.ones((t,), dtype=torch.bool, device=x.device)
            counts = (sum(((~kc) & rows).sum() for kc in keep),
                      rows.sum() * k, (onehot1 * rows[:, None]).sum(0))
            if self.dropped is None:
                self.dropped, self.routed, self.chosen = counts
            else:
                self.dropped, self.routed, self.chosen = (
                    a + b for a, b in zip((self.dropped, self.routed,
                                           self.chosen), counts))

        # dispatch: each slot receives at most one token (a dropped one
        # adds x * 0), so the compute-dtype sum is exact
        cdt = cfg.compute_dtype
        xc = x.to(cdt)
        buf = torch.zeros((ne, cap, h), dtype=cdt, device=x.device)
        for c in range(k):
            buf = buf.index_put((expert_idx[c], slot[c]),
                                xc * keep[c][:, None].to(cdt),
                                accumulate=True)

        if group is not None:
            # (ep, nl, cap, H): chunk e goes to the rank owning expert
            # group e; received chunks stack on dim 0 by SOURCE rank
            buf = all_to_all(buf.reshape(ep, nl, cap, h), group)
            expert_in = buf.transpose(0, 1).reshape(nl, ep * cap, h)
        else:
            expert_in = buf                                  # (E, cap, H)

        tp_on = cfg.tensor_axis is not None and cfg.tensor_parallel_size > 1
        if tp_on:
            from apex_tpu_torch.transformer.tensor_parallel import mappings
            expert_in = mappings.copy_to_tensor_model_parallel_region(
                expert_in, cfg.tensor_axis)
        h1 = torch.relu(torch.bmm(expert_in, self.w1.to(cdt)))
        out_e = torch.bmm(h1, self.w2.to(cdt))
        if tp_on:
            out_e = mappings.reduce_from_tensor_model_parallel_region(
                out_e, cfg.tensor_axis)

        if group is not None:
            # return trip in the compute dtype
            out_e = out_e.to(cdt).reshape(nl, ep, cap, h).transpose(0, 1)
            out_e = all_to_all(out_e, group).reshape(ne, cap, h)

        # combine: gather each choice's slot, weight by its gate prob
        out = torch.zeros((t, h), dtype=_f32, device=x.device)
        for c in range(k):
            out = out + out_e[expert_idx[c], slot[c]].to(_f32) * (
                gate_probs[:, c] * keep[c].to(_f32))[:, None]
        return out.to(x.dtype), aux_loss


# -- EP training-recipe helpers ---------------------------------------------

_EXPERT_LEAF = re.compile(r"(.*\.)?mlp\.(w1|w2)")


def is_gpt_expert_leaf(name: str) -> bool:
    """True for a GPT MoE expert-stack parameter (``...mlp.w1`` /
    ``...mlp.w2``; JAX takes the leaf's tree path, the port its name)."""
    return _EXPERT_LEAF.fullmatch(name) is not None


def localize_expert_params(state_dict, rank: int, expert_parallel_size: int,
                           is_expert=is_gpt_expert_leaf) -> dict:
    """Rank ``rank``'s state dict of ``expert_parallel_size`` from a whole
    one: each expert stack cut to its ``rank``-th block of
    ``n_experts / ep`` experts along dim 0, every other entry as it is.
    (The JAX function drops the unit mesh axis of a stacked ``(1, nl, ...)``
    leaf inside ``shard_map``; here the rank's shard is cut directly.)"""
    ep = int(expert_parallel_size)
    if not 0 <= rank < ep:
        raise ValueError(f"rank {rank} is not in [0, {ep})")
    out = {}
    for name, v in state_dict.items():
        if is_expert(name):
            if v.shape[0] % ep:
                raise ValueError(f"{name}: {v.shape[0]} experts do not "
                                 f"split over {ep} ranks")
            nl = v.shape[0] // ep
            v = v[rank * nl:(rank + 1) * nl].contiguous()
        out[name] = v
    return out


def reduce_moe_grads(named_params, axis_name: str = ps.EXPERT_AXIS,
                     is_expert=is_gpt_expert_leaf):
    """The EP gradient reduction (JAX ``reduce_moe_grads``), in place on
    the ``.grad`` of ``named_params`` (a module or ``(name, parameter)``
    pairs): each rank differentiated its LOCAL loss of a mean over the
    ranks, so the dense gradients take the mean over the expert group and
    the expert stacks' gradients — whose other ranks' contributions the
    ``all_to_all`` backward already routed to their owner — divide by the
    group's size.  The identity at one rank."""
    if isinstance(named_params, nn.Module):
        named_params = named_params.named_parameters()
    group = ps.resolve_group(axis_name)
    ep = ps.group_size(group)
    if ep == 1:
        return
    dense = []
    for name, p in named_params:
        if p.grad is None:
            continue
        if is_expert(name):
            p.grad.div_(ep)
        else:
            dense.append(p.grad)
    by_dtype = {}
    for g in dense:
        by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        check_backend(flat, group, "reduce_moe_grads")
        dist.all_reduce(flat, group=group)
        flat.div_(ep)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
