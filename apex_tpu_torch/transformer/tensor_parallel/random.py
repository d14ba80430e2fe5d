"""Model-parallel random streams and activation checkpointing — port of
``apex_tpu/transformer/tensor_parallel/random.py``.

apex forks one CUDA RNG state per tensor-parallel rank so that dropout in
tensor-parallel regions draws differently on each rank, and keeps those
states in a ``CudaRNGStatesTracker``.  The JAX package keys the streams
(``fold_in(key, 2718 + rank)``); here each stream is an explicit
:class:`torch.Generator`: :meth:`CudaRNGStatesTracker.add` seeds one per
name and :meth:`~CudaRNGStatesTracker.fork` hands it to the caller, who
passes it to the random ops (``torch.rand(..., generator=g)``); it advances
as they draw.  :func:`model_parallel_rng_key` is the per-rank stream,
seeded ``seed + 2718 + tp_rank`` as apex's
``model_parallel_cuda_manual_seed`` seeds it.  :func:`checkpoint` is
``torch.utils.checkpoint`` (non-reentrant); apex's
``distribute_saved_activations`` is accepted and ignored, as in the JAX
package (the checkpoint keeps only the inputs).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from apex_tpu_torch.transformer import parallel_state as ps

TENSOR_AXIS = ps.TENSOR_AXIS
_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
_MODEL_PARALLEL_SEED_OFFSET = 2718

__all__ = ["CudaRNGStatesTracker", "get_cuda_rng_tracker",
           "model_parallel_cuda_manual_seed", "model_parallel_rng_key",
           "checkpoint"]


def _generator(seed: int, device=None) -> torch.Generator:
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(int(seed))
    return gen


def model_parallel_rng_key(base_seed: int, axis_name: str = TENSOR_AXIS,
                           device=None) -> torch.Generator:
    """This rank's tensor-parallel stream: a generator seeded ``base_seed
    + 2718 + rank`` (the rank along ``axis_name``; 0 without a group)."""
    rank = ps.group_rank(ps.resolve_group(axis_name))
    return _generator(int(base_seed) + _MODEL_PARALLEL_SEED_OFFSET + rank,
                      device)


def model_parallel_cuda_manual_seed(seed: int, device=None):
    """``(data_parallel_generator, model_parallel_generator_fn)``: a
    generator seeded ``seed`` for the replicated regions (the same on every
    rank) and ``fn(axis_name="model")`` giving this rank's stream
    (:func:`model_parallel_rng_key`)."""
    return _generator(seed, device), (
        lambda axis_name=TENSOR_AXIS: model_parallel_rng_key(
            seed, axis_name, device))


class CudaRNGStatesTracker:
    """Named random streams (apex ``CudaRNGStatesTracker``), one
    :class:`torch.Generator` per name."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def get_states(self):
        """Each stream's generator state (a byte tensor), by name."""
        return {name: gen.get_state() for name, gen in self.states_.items()}

    def set_states(self, states):
        """Restore the states :meth:`get_states` returned."""
        for name, state in states.items():
            if name not in self.states_:
                self.states_[name] = torch.Generator()
            self.states_[name].set_state(state)

    def add(self, name, seed, device=None):
        if name in self.states_:
            raise Exception(f"cuda rng state {name} already exists")
        self.states_[name] = _generator(seed, device)

    @contextlib.contextmanager
    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Yield the stream's generator; what the block draws from it
        advances the stream."""
        if name not in self.states_:
            raise Exception(f"cuda rng state {name} is not added")
        yield self.states_[name]


_CUDA_RNG_STATE_TRACKER = CudaRNGStatesTracker()


def get_cuda_rng_tracker() -> CudaRNGStatesTracker:
    return _CUDA_RNG_STATE_TRACKER


def checkpoint(function: Callable, distribute_saved_activations: bool,
               *args):
    """apex ``tensor_parallel.checkpoint``: ``function(*args)`` whose
    activations are recomputed in the backward."""
    del distribute_saved_activations
    return _checkpoint(function, *args, use_reentrant=False)
