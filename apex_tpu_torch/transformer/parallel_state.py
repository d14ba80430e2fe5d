"""Model-parallel topology — port of ``apex_tpu/transformer/parallel_state.py``.

The JAX package names its collectives by mesh axis inside ``shard_map``:
``data`` (data parallel), ``pipe`` (pipeline) and ``model`` (tensor model
parallel), over a ``(data, pipe, model)`` mesh, and ``context`` (the
sequence shards of context parallelism) and ``expert`` (the expert stacks
of a mixture of experts) where a model names them.  The port keeps the
names and maps each to a :mod:`torch.distributed` process group.
:func:`initialize_model_parallel` lays the ranks out as the JAX package lays
out its devices, ``np.arange(world).reshape(dp, pp, tp)``, so rank ``r``
holds what device ``r`` of the JAX mesh holds, and creates one group per
line of that array along each axis (every rank creates every group, in the
same order, as :func:`torch.distributed.new_group` requires).  The
``expert`` and ``context`` axes are carved out of the data axis, as
Megatron carves them: with ``expert_parallel_size_=e`` and
``context_parallel_size_=c`` the ranks lie as ``np.arange(world).reshape(
dp / (e c), e, c, pp, tp)``, so a context group is ``c`` neighbouring data
ranks, an expert group ``e`` of them ``c`` apart (with ``e == dp`` it is
the whole data axis: the experts double as the data replicas, as in the
JAX Switch example), and the ``data`` group what is left.  Their groups
exist only where they have more than one rank: an axis of one rank is
None and its collectives are identities.

Without ``torch.distributed`` every axis has size 1 and rank 0, and the
collectives over it are identities (the JAX package outside ``shard_map``).
With ``torch.distributed`` but no :func:`initialize_model_parallel`, the
``data`` axis is the whole world (apex's default data-parallel group) and
the other two have size 1.

The groups keep the default group's backend: NCCL for CUDA tensors, gloo
for CPU tensors; :mod:`apex_tpu_torch.utils.collectives` refuses a tensor
whose device does not match its group's backend.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
PIPELINE_AXIS = "pipe"
TENSOR_AXIS = "model"
CONTEXT_AXIS = "context"
EXPERT_AXIS = "expert"
AXES = (DATA_AXIS, PIPELINE_AXIS, TENSOR_AXIS)
# every axis of the rank mesh, in the order of its dimensions
MESH_AXES = (DATA_AXIS, EXPERT_AXIS, CONTEXT_AXIS, PIPELINE_AXIS,
             TENSOR_AXIS)

_LAYOUT: Optional[np.ndarray] = None      # (dp, pp, tp) global ranks
_MESH: Optional[np.ndarray] = None        # (dp', ep, cp, pp, tp)
_GROUPS: dict = {}                        # axis -> this rank's group
_GROUP_RANKS: dict = {}                   # axis -> the ranks of that group
_VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK: Optional[int] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE: Optional[int] = None
_PIPELINE_MODEL_PARALLEL_SPLIT_RANK: Optional[int] = None


def _world_and_rank():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_layout(world: int, tp: int = 1, pp: int = 1) -> np.ndarray:
    """The ``(dp, pp, tp)`` array of global ranks (the JAX mesh's device
    array for devices ``0 .. world - 1``)."""
    if world % (tp * pp) != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor parallel "
            f"size ({tp}) x pipeline parallel size ({pp})")
    return np.arange(world).reshape(world // (tp * pp), pp, tp)


def mesh_layout(world: int, tp: int = 1, pp: int = 1, cp: int = 1,
                ep: int = 1) -> np.ndarray:
    """The ``(dp / (ep cp), ep, cp, pp, tp)`` array of global ranks
    (:data:`MESH_AXES`): :func:`rank_layout` with the data axis split into
    its data, expert and context parts."""
    layout = rank_layout(world, tp, pp)
    dp = layout.shape[0]
    if dp % (cp * ep):
        raise RuntimeError(
            f"the data-parallel extent ({dp} = world / (tp x pp)) is not "
            f"divisible by context parallel size ({cp}) x expert parallel "
            f"size ({ep})")
    return np.arange(world).reshape(dp // (cp * ep), ep, cp, pp, tp)


def _lines(layout, axis):
    """Every line of ``layout`` along mesh axis ``axis`` (0 data, 1 pipe,
    2 model), as lists of ranks, in a fixed order."""
    moved = np.moveaxis(layout, axis, -1)
    return [list(map(int, line)) for line in moved.reshape(-1,
                                                           moved.shape[-1])]


def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        pipeline_model_parallel_split_rank_: Optional[int] = None,
        *, context_parallel_size_: int = 1, expert_parallel_size_: int = 1,
        default_backend=None) -> np.ndarray:
    """Build the ``data`` / ``pipe`` / ``model`` groups over the world of
    :mod:`torch.distributed` (one rank when it is not initialised), and the
    ``context`` / ``expert`` groups where their sizes exceed one; the
    data-parallel extent is ``world // (tp * pp)`` as in apex, of which the
    ``data`` group keeps ``1 / (cp * ep)``.  Returns the ``(dp, pp, tp)``
    rank layout (also :func:`get_rank_layout`; the five-axis one is
    :func:`get_mesh_layout`).
    ``default_backend`` (apex's NCCL / UCC choice) is accepted and unused:
    the groups keep the default group's backend."""
    global _LAYOUT, _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    del default_backend
    world, rank = _world_and_rank()
    global _MESH
    tp, pp = int(tensor_model_parallel_size_), int(
        pipeline_model_parallel_size_)
    layout = rank_layout(world, tp, pp)
    mesh = mesh_layout(world, tp, pp, int(context_parallel_size_),
                       int(expert_parallel_size_))
    groups, ranks = {}, {}
    for axis, name in enumerate(MESH_AXES):
        if name not in AXES and mesh.shape[axis] == 1:
            continue
        for line in _lines(mesh, axis):
            group = dist.new_group(line) if dist.is_initialized() else None
            if rank in line:
                groups[name], ranks[name] = group, line
    _LAYOUT = layout
    _MESH = mesh
    _GROUPS.clear()
    _GROUPS.update(groups)
    _GROUP_RANKS.clear()
    _GROUP_RANKS.update(ranks)
    if virtual_pipeline_model_parallel_size_ is not None:
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = 0
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = \
            int(virtual_pipeline_model_parallel_size_)
    else:
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = None
        _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = None
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = pipeline_model_parallel_split_rank_
    return layout


_SUBSET_GROUPS: dict = {}                 # tuple(ranks) -> process group


def _subset_group(line):
    """The process group of the global ranks ``line`` (made once: every
    rank of the world calls this with the same lines in the same order,
    as :func:`torch.distributed.new_group` requires)."""
    key = tuple(int(r) for r in line)
    if key not in _SUBSET_GROUPS:
        _SUBSET_GROUPS[key] = dist.new_group(list(key))
    return _SUBSET_GROUPS[key]


def subset_groups(ranks, tp: int = 1, pp: int = 1):
    """The ``data`` / ``pipe`` / ``model`` groups of a mesh over the global
    ranks ``ranks`` alone (the elastic layer's plans over the first ``n``
    ranks), laid out as :func:`rank_layout` lays out the world.  Returns
    ``(layout, groups, group)``: the ``(dp, pp, tp)`` rank array, this
    rank's group of each axis and the group of all of ``ranks``.  Under
    :mod:`torch.distributed` an axis of one rank gets a group of that rank
    alone (None would mean the whole world to :func:`resolve_group`); a
    rank outside ``ranks`` gets None, as does every axis without
    :mod:`torch.distributed`.  Every rank of the world must call it, in the
    same order, including ranks outside ``ranks``; the globals of
    :func:`initialize_model_parallel` are left alone."""
    ranks = [int(r) for r in ranks]
    layout = rank_layout(len(ranks), tp, pp)
    layout = np.asarray(ranks)[layout]
    _, rank = _world_and_rank()
    multi = dist.is_available() and dist.is_initialized()
    groups = {}
    if not multi:
        return layout, dict.fromkeys(AXES), None
    for axis, name in enumerate(AXES):
        for line in _lines(layout, axis):
            group = _subset_group(line)
            if rank in line:
                groups[name] = group
    whole = _subset_group(ranks)
    return layout, {name: groups.get(name) for name in AXES}, (
        whole if rank in ranks else None)


def model_parallel_is_initialized() -> bool:
    return _LAYOUT is not None


def get_mesh_layout() -> np.ndarray:
    """The ``(dp', ep, cp, pp, tp)`` rank array of :data:`MESH_AXES`."""
    if _MESH is None:
        raise RuntimeError("model parallel groups are not initialized "
                           "(call initialize_model_parallel first)")
    return _MESH


def get_rank_layout() -> np.ndarray:
    if _LAYOUT is None:
        raise RuntimeError("model parallel groups are not initialized "
                           "(call initialize_model_parallel first)")
    return _LAYOUT


def destroy_model_parallel():
    global _LAYOUT, _MESH, _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    _LAYOUT = None
    _MESH = None
    _GROUPS.clear()
    _GROUP_RANKS.clear()
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = None
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = None


# -- groups ------------------------------------------------------------------

def get_group(axis_name: str):
    """The process group of mesh axis ``axis_name`` holding this rank, or
    None where the axis is this rank alone (its collectives are then
    identities): without ``torch.distributed``, for ``pipe`` and
    ``model`` before :func:`initialize_model_parallel`, and for
    ``context`` and ``expert`` wherever they have one rank."""
    if axis_name not in MESH_AXES:
        raise ValueError(f"unknown mesh axis {axis_name!r}; the axes are "
                         f"{MESH_AXES}")
    if _LAYOUT is not None:
        return _GROUPS.get(axis_name)
    if axis_name == DATA_AXIS and dist.is_available() \
            and dist.is_initialized():
        return dist.group.WORLD
    return None


def resolve_group(axis_name: Optional[str] = DATA_AXIS, process_group=None):
    """``process_group`` when given (apex's keyword), else the group of
    ``axis_name`` (the JAX keyword); None for no axis at all."""
    if process_group is not None:
        return process_group
    if axis_name is None:
        return None
    return get_group(axis_name)


def group_size(group) -> int:
    """Ranks in ``group``; None (no group: this rank alone) has 1."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def get_data_parallel_group():
    return get_group(DATA_AXIS)


def get_pipeline_model_parallel_group():
    return get_group(PIPELINE_AXIS)


def get_tensor_model_parallel_group():
    return get_group(TENSOR_AXIS)


def get_context_parallel_group():
    return get_group(CONTEXT_AXIS)


def get_expert_parallel_group():
    return get_group(EXPERT_AXIS)


# -- world sizes and ranks -----------------------------------------------------

def _axis_size(axis):
    return group_size(get_group(axis))


def _axis_rank(axis):
    return group_rank(get_group(axis))


def get_tensor_model_parallel_world_size() -> int:
    return _axis_size(TENSOR_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _axis_size(PIPELINE_AXIS)


def get_data_parallel_world_size() -> int:
    return _axis_size(DATA_AXIS)


def get_model_parallel_world_size() -> int:
    """tp*pp (apex asserts pp==1 here; this returns the product)."""
    return (get_tensor_model_parallel_world_size()
            * get_pipeline_model_parallel_world_size())


def get_context_parallel_world_size() -> int:
    return _axis_size(CONTEXT_AXIS)


def get_expert_parallel_world_size() -> int:
    return _axis_size(EXPERT_AXIS)


def get_context_parallel_rank() -> int:
    return _axis_rank(CONTEXT_AXIS)


def get_expert_parallel_rank() -> int:
    return _axis_rank(EXPERT_AXIS)


def get_tensor_model_parallel_rank() -> int:
    return _axis_rank(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _axis_rank(PIPELINE_AXIS)


def get_data_parallel_rank() -> int:
    return _axis_rank(DATA_AXIS)


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vp = _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
        if vp is not None and \
                get_virtual_pipeline_model_parallel_rank() != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vp = _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
        if vp is not None and (get_virtual_pipeline_model_parallel_rank()
                               != vp - 1):
            return False
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)


# -- virtual pipeline ranks (host-side ints, as in apex) -----------------------

def get_virtual_pipeline_model_parallel_rank():
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK


def set_virtual_pipeline_model_parallel_rank(rank: int):
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = rank


def get_virtual_pipeline_model_parallel_world_size():
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE


def get_pipeline_model_parallel_split_rank():
    return _PIPELINE_MODEL_PARALLEL_SPLIT_RANK


def set_pipeline_model_parallel_split_rank(rank: int):
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = rank


def get_tensor_model_parallel_src_rank() -> int:
    """apex: the global rank of the first rank of this rank's tensor
    model parallel group (0 with one rank)."""
    return _GROUP_RANKS.get(TENSOR_AXIS, [0])[0]
