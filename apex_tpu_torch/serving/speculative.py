"""Speculative decoding: a small draft GPT proposes, the target verifies —
port of ``apex_tpu/serving/speculative.py``.

Per round the draft model proposes ``num_tokens`` tokens (one cheap decode
step each), then the target scores the current token plus every proposal
in ONE chunked forward (:meth:`~apex_tpu_torch.models.gpt.GPTModel.
decode_chunk`): γ+1 target logits for the latency of one wide step.

Acceptance is exact-match verification: the token at stream index ``i`` is
always the engine's sample of the target's logits ``i`` with the
request's ``(seed, i)`` stream, the very function of the very logits the
non-speculative engine uses.  A proposal is accepted when it equals that
token, letting the round consume the already-computed target logits of
later positions; the first mismatch ends the round.  Speculation changes
only how many target positions one device round evaluates, never what the
stream emits.  Rejected proposals leave stale K/V past the accepted point,
beyond every valid length (masked), overwritten when decoding reaches it.

The JAX config carries the draft's parameter tree beside its model; a
port model holds its own weights, so the port's config has no ``params``.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class SpeculativeConfig:
    """Draft-model bundle for :class:`~apex_tpu_torch.serving.
    PagedInferenceEngine`.

    ``model``: the draft :class:`~apex_tpu_torch.models.gpt.GPTModel`
    (same vocab as the target, on the same device; typically far fewer
    layers and heads).  ``num_tokens``: proposals per round (γ): each round
    costs γ draft steps and one (γ+1)-wide target chunk, and emits between
    1 and γ+1 stream tokens.
    """
    model: Any
    num_tokens: int = 3

    def __post_init__(self):
        if self.num_tokens < 1:
            raise ValueError("num_tokens must be >= 1")

    def validate_against(self, target_model) -> None:
        if self.model.cfg.vocab_size != target_model.cfg.vocab_size:
            raise ValueError(
                "draft and target models must share a vocabulary "
                f"({self.model.cfg.vocab_size} != "
                f"{target_model.cfg.vocab_size})")
        draft = next(self.model.parameters()).device
        target = next(target_model.parameters()).device
        if draft != target:
            raise ValueError(f"the draft model is on {draft}, the target "
                             f"on {target}")
