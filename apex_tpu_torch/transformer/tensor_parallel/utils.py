"""Tensor-parallel helpers — port of
``apex_tpu/transformer/tensor_parallel/utils.py``."""

from __future__ import annotations

import torch

__all__ = ["divide", "split_tensor_along_last_dim",
           "split_tensor_into_1d_equal_chunks", "gather_split_1d_tensor",
           "VocabUtility"]


def divide(numerator: int, denominator: int) -> int:
    """Integer division asserting divisibility (apex ``divide``)."""
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")
    return numerator // denominator


def split_tensor_along_last_dim(tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False):
    """Split along the last dim into ``num_partitions`` chunks (views, or
    contiguous copies with ``contiguous_split_chunks``)."""
    size = divide(tensor.shape[-1], num_partitions)
    chunks = torch.split(tensor, size, dim=-1)
    if contiguous_split_chunks:
        return tuple(c.contiguous() for c in chunks)
    return chunks


def split_tensor_into_1d_equal_chunks(tensor, rank: int, world: int):
    """Rank ``rank``'s 1-D equal chunk of ``tensor`` flattened (apex
    ``split_tensor_into_1d_equal_chunks``; the rank is explicit, as in
    the JAX package)."""
    flat = tensor.reshape(-1)
    size = divide(flat.shape[0], world)
    return flat[rank * size:(rank + 1) * size]


def gather_split_1d_tensor(chunks):
    """Inverse of the split: the chunks concatenated into one flat
    tensor."""
    return torch.cat(list(chunks))


class VocabUtility:
    """Vocab range helpers (apex ``VocabUtility``)."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(per_partition_vocab_size,
                                                  rank, world_size):
        f = rank * per_partition_vocab_size
        return f, f + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size, rank,
                                           world_size):
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, world_size)
