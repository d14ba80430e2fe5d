"""Token-budget tick scheduler: chunked prefill mixed into decode — port of
``apex_tpu/serving/scheduler.py`` (host-side policy, unchanged).

The classic continuous-batching engine prefills a whole prompt at
admission, so one 4k-token prompt stalls every decoding request for a
full prefill — head-of-line blocking in the worst place, the TTFT/TPOT
tail.  The fix (Sarathi/vLLM-style chunked prefill) is to give every
engine tick a *token budget* and fill it with a mix: each decoding slot
costs its decode tokens (1, or ``1 + spec_tokens`` under speculative
decoding), and whatever budget remains is granted to pending prefills as
prompt *chunks* processed against the paged cache.  Decode latency is
then bounded per tick regardless of prompt length, and prefills make
steady progress instead of monopolizing the device.

This module is pure policy — host-side arithmetic with no device or
engine state — so it is unit-testable in isolation and swappable.  The
engine asks :meth:`TickScheduler.plan` once per tick and executes the
answer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass
class TickPlan:
    """What one engine tick should run: ``chunks`` maps a prefilling
    slot to the number of prompt tokens to process this tick;
    ``decode`` says whether the batched decode step runs at all."""
    chunks: Dict[int, int]
    decode: bool


class TickScheduler:
    """Budgeted prefill/decode mixing policy.

    ``token_budget``: target tokens processed per tick across decode and
    prefill chunks.  ``min_chunk``: the progress guarantee — when
    prefills are pending, at least this many prefill tokens are granted
    per tick even if decode alone exceeds the budget (without it a full
    decode batch starves admission forever, the inverse head-of-line
    problem).  ``max_chunk`` caps any single grant so one prompt cannot
    soak the whole budget every tick when several are prefilling.
    """

    def __init__(self, token_budget: int = 64, min_chunk: int = 8,
                 max_chunk: int = 64):
        if token_budget < 1 or min_chunk < 1 or max_chunk < min_chunk:
            raise ValueError(
                "need token_budget >= 1 and max_chunk >= min_chunk >= 1")
        self.token_budget = token_budget
        self.min_chunk = min_chunk
        self.max_chunk = max_chunk

    def plan(self, decoding_slots: int,
             prefilling: Sequence[Tuple[int, int]],
             spec_tokens: int = 0) -> TickPlan:
        """``decoding_slots``: live decode rows this tick;
        ``prefilling``: ``(slot, remaining_prompt_tokens)`` in admission
        order (FCFS — earlier admissions finish their prefill first);
        ``spec_tokens``: extra per-slot tokens a speculative round
        verifies.  Returns the tick's :class:`TickPlan`."""
        decode_cost = decoding_slots * (1 + spec_tokens)
        left = self.token_budget - decode_cost
        chunks: Dict[int, int] = {}
        for i, (slot, remaining) in enumerate(prefilling):
            if remaining <= 0:
                continue
            grant = min(remaining, self.max_chunk, max(left, 0))
            if grant < min(remaining, self.min_chunk) and i == 0:
                # progress guarantee: the head prefill always advances
                grant = min(remaining, self.min_chunk)
            if grant <= 0:
                break
            chunks[slot] = grant
            left -= grant
        return TickPlan(chunks=chunks, decode=decoding_slots > 0)
