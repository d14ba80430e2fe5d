"""Token sampling for the decode loop: greedy, temperature, top-k, top-p —
port of ``apex_tpu/inference/sampling.py``.

``temperature == 0`` means greedy (argmax).  Stochastic modes draw from an
explicit :class:`torch.Generator`; the engine seeds one per token from
``(request seed, token index)`` (:func:`stream_generator`), so batch
composition never changes a request's stream.  The streams cannot replay
``jax.random``: the same seed gives other tokens than the JAX engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplingParams", "sample", "stream_generator"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature``: 0.0 → greedy; otherwise logits are divided by it.
    ``top_k``: keep the k most likely tokens (None → full vocab).
    ``top_p``: nucleus — keep the smallest prefix of the sorted vocab whose
    cumulative probability reaches ``top_p`` (None or 1.0 → full vocab);
    applied after ``top_k``.  Both are ignored under greedy.
    """
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k is not None and self.top_k <= 0:
            raise ValueError("top_k must be positive")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def stream_generator(seed: int, token_index: int) -> torch.Generator:
    """CPU generator for token ``token_index`` of the request seeded
    ``seed`` — a pure function of the pair."""
    mixed = ((int(seed) & 0xFFFFFFFF) << 32) | (int(token_index) & 0xFFFFFFFF)
    return torch.Generator().manual_seed(mixed)


def _nucleus_filter(scaled, top_p: float):
    """Mask logits outside the smallest probability-sorted prefix whose
    cumulative mass reaches ``top_p``.  A token is kept iff the mass
    *before* it is < ``top_p``; ties at the cut keep every tied token."""
    probs = torch.softmax(scaled, dim=-1)
    sorted_p = torch.sort(probs, dim=-1, descending=True).values
    cum_before = torch.cumsum(sorted_p, dim=-1) - sorted_p
    keep = cum_before < top_p
    thr = torch.where(keep, sorted_p, torch.inf).min(dim=-1,
                                                     keepdim=True).values
    return torch.where(probs >= thr, scaled, -torch.inf)


def sample(logits, params: SamplingParams = SamplingParams(),
           generator: Optional[torch.Generator] = None):
    """Draw token ids from ``logits`` (``(..., vocab)``).

    Greedy needs no generator; stochastic modes require one on the
    logits' device.  Returns an int64 tensor of shape
    ``logits.shape[:-1]``.
    """
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    scaled = logits.to(torch.float32) / params.temperature
    vocab = logits.shape[-1]
    if params.top_k is not None and params.top_k < vocab:
        kth = torch.sort(scaled, dim=-1).values[..., -params.top_k, None]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if params.top_p is not None and params.top_p < 1.0:
        scaled = _nucleus_filter(scaled, params.top_p)
    probs = torch.softmax(scaled, dim=-1).reshape(-1, vocab)
    ids = torch.multinomial(probs, 1, generator=generator)
    return ids.reshape(logits.shape[:-1])
