"""Shared collective helpers — port of ``apex_tpu/utils/collectives.py``.

A mesh axis of the JAX package is a :mod:`torch.distributed` process group
here (:mod:`apex_tpu_torch.transformer.parallel_state`).  The helpers take
``axis_name=`` (resolved through ``parallel_state``) or an explicit
``process_group=``; where there is no group (None: no
``torch.distributed``, or an axis of one rank before
``initialize_model_parallel``) the axis has size 1 and every collective is
the identity, as a JAX collective is outside ``shard_map``.

Every collective checks the backend against the tensor's device: a CUDA
tensor needs an NCCL group and a CPU tensor a gloo group; anything else
raises.  There is no fallback from one backend to the other.

``shard_map_compat``, ``ensure_varying``, ``manual_axes``, ``is_varying``
and ``sds_like`` serve JAX's typing of ``shard_map`` (which values vary
across devices) and have no counterpart: in torch every rank's tensors are
its own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps

_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


def axis_size(axis_name=ps.DATA_AXIS, process_group=None) -> int:
    """Ranks along ``axis_name`` (or in ``process_group``); 1 without
    ``torch.distributed``."""
    return ps.group_size(ps.resolve_group(axis_name, process_group))


def check_backend(tensor, group, what="collective"):
    """Raise unless ``group``'s backend serves ``tensor``'s device (NCCL
    for CUDA, gloo for the CPU)."""
    want = _BACKEND_OF.get(tensor.device.type)
    have = dist.get_backend(group)
    if want is None or have != want:
        raise RuntimeError(
            f"{what}: a {tensor.device.type} tensor needs a {want} process "
            f"group, this one is {have}")


def all_reduce_(tensor, group, op=None):
    """In-place SUM (or ``op``) all-reduce of ``tensor`` over ``group``;
    the identity for None.  Returns ``tensor``."""
    if group is not None:
        check_backend(tensor, group, "all_reduce")
        dist.all_reduce(tensor, op=op or dist.ReduceOp.SUM, group=group)
    return tensor


def flatten_tree(tree):
    """``(leaves, rebuild)`` of a tensor, list, tuple or dict of tensors:
    ``rebuild(new_leaves)`` makes the same structure."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda xs: type(tree)(xs)
    raise TypeError(f"expected a tensor, list, tuple or dict of tensors, "
                    f"got {type(tree).__name__}")


def tree_map(fn, tree):
    """``fn`` over the tensors of a tensor, list, tuple or dict."""
    leaves, rebuild = flatten_tree(tree)
    return rebuild([fn(x) for x in leaves])


def psum_if_varying(tree, axis_name=ps.DATA_AXIS, strict: bool = False, *,
                    process_group=None):
    """The SUM over the axis of every tensor of ``tree`` (a tensor, list,
    tuple or dict), as new tensors; one all-reduce per dtype over the
    tensors flattened together.

    In the JAX package a leaf that is already invariant across the axis
    (an already-summed gradient) passes through; in torch every rank's
    gradient is its own, so every leaf is reduced and ``strict`` (which
    makes the JAX function raise on an invariant leaf) has nothing to
    check."""
    del strict
    group = ps.resolve_group(axis_name, process_group)
    leaves, rebuild = flatten_tree(tree)
    out = [x.clone() for x in leaves]
    if group is not None:
        by_dtype: dict = {}
        for i, x in enumerate(out):
            by_dtype.setdefault((x.dtype, x.device), []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            all_reduce_(flat, group)
            off = 0
            for i in idx:
                n = out[i].numel()
                out[i] = flat[off:off + n].view_as(out[i])
                off += n
    return rebuild(out)
