"""Batch broadcast across tensor-parallel ranks — port of
``apex_tpu/transformer/tensor_parallel/data.py``.

apex's ``broadcast_data``: tensor-parallel rank 0 holds the batch and
broadcasts it over the ``model`` group, sizes first, so the other ranks
need not know the shapes.  The JAX package places the batch replicated
instead; the dtype check is the same.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.collectives import check_backend

_MAX_DATA_DIM = 5

__all__ = ["broadcast_data"]


def _check_data_types(keys, data, target_dtype):
    for k in keys:
        if data[k].dtype != target_dtype:
            raise AssertionError(
                f"{k} has data type {data[k].dtype} which "
                f"is different than {target_dtype}")


def broadcast_data(keys, data, datatype):
    """``{k: data[k]}`` on every rank of the tensor-parallel group, from
    its rank 0 (apex ``broadcast_data``).  Rank 0's ``data[k]`` must have
    ``datatype``; the other ranks may pass ``data=None``.  Tensors land on
    the group's device (CUDA for NCCL, the CPU for gloo)."""
    group = ps.get_tensor_model_parallel_group()
    src = ps.get_tensor_model_parallel_src_rank()
    first = ps.group_rank(group) == 0
    if first:
        _check_data_types(keys, data, datatype)
    if group is None or ps.group_size(group) == 1:
        return {k: data[k] for k in keys}
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    sizes = torch.zeros((len(keys), _MAX_DATA_DIM + 1), dtype=torch.int64,
                        device=device)
    if first:
        for i, k in enumerate(keys):
            if data[k].dim() > _MAX_DATA_DIM:
                raise ValueError(f"{k} has more than {_MAX_DATA_DIM} dims")
            sizes[i, 0] = data[k].dim()
            sizes[i, 1:1 + data[k].dim()] = torch.tensor(data[k].shape)
    dist.broadcast(sizes, src, group=group)
    shapes = [tuple(int(d) for d in row[1:1 + int(row[0])])
              for row in sizes.cpu()]
    total = sum(int(torch.Size(s).numel()) for s in shapes)
    if first:
        flat = torch.cat([data[k].reshape(-1).to(device) for k in keys])
    else:
        flat = torch.empty(total, dtype=datatype, device=device)
    check_backend(flat, group, "broadcast_data")
    dist.broadcast(flat, src, group=group)
    out, off = {}, 0
    for k, s in zip(keys, shapes):
        n = int(torch.Size(s).numel())
        out[k] = flat[off:off + n].view(s)
        off += n
    return out
