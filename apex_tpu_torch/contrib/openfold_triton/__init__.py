"""OpenFold's fused ops — port of
``apex_tpu/contrib/openfold_triton/__init__.py`` (apex's Triton kernels for
OpenFold training: evoformer attention with pair bias and mask, the small-
shape LayerNorm, and ``FusedAdamSWA``).

* :func:`attention_core`: with no mask and no bias,
  :func:`~apex_tpu_torch.ops.flash_attention.flash_attention` (#3; #4 and
  #5 in the backward; head dims 16, 32, 64 on the card, another raises);
  otherwise explicit f32 scores with the additive bias and OpenFold's
  ``-inf * (1 - mask)`` (``inf`` = 1e9), as JAX does.
* :class:`LayerNormSmallShapeOptImpl`: ``apply(x, w, b, eps)`` over the
  port's fused LayerNorm (#1 / #2).
* :class:`FusedAdamSWA`: the port's :class:`~apex_tpu_torch.optimizers.
  FusedAdam` (#18) plus the stochastic weight average: after a step whose
  count ``c`` has ``c > swa_start`` and ``(c - 1 - swa_start) % swa_freq ==
  0``, the f32 average takes ``swa += (p - swa) / n_avg`` (JAX's rule and
  its device-side step count; no host sync).  The average starts at the
  parameters the optimizer was built with.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm_affine
from apex_tpu_torch.optimizers import FusedAdam

__all__ = ["attention_core", "LayerNormSmallShapeOptImpl", "FusedAdamSWA"]

_f32 = torch.float32


def attention_core(q, k, v, mask=None, bias=None, inf: float = 1e9):
    """OpenFold evoformer attention.

    ``q, k, v``: ``(*batch, heads, seq_q|seq_k, head_dim)``; ``mask``:
    broadcastable over ``(*batch, 1, 1, seq_k)``, 1 = keep (OpenFold's
    convention); ``bias``: additive, broadcastable over the scores.  The
    scores are scaled by ``head_dim ** -0.5``.
    """
    *batch, h, sq, d = q.shape
    sk = k.shape[-2]
    if mask is None and bias is None:
        out = flash_attention(q.reshape(-1, h, sq, d), k.reshape(-1, h, sk, d),
                              v.reshape(-1, h, sk, d))
        return out.reshape(*batch, h, sq, d)
    s = torch.einsum("...qd,...kd->...qk", q.to(_f32), k.to(_f32)) * d ** -0.5
    if bias is not None:
        s = s + bias.to(_f32)
    if mask is not None:
        s = s - (1.0 - mask.to(_f32)) * inf
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v.to(_f32)).to(q.dtype)


class LayerNormSmallShapeOptImpl:
    """The reference's ``LayerNormSmallShapeOptImpl.apply(x, w, b, eps)``:
    the port's fused LayerNorm over the last axis."""

    @staticmethod
    def apply(x, weight, bias, eps: float = 1e-5):
        return fused_layer_norm_affine(x, weight, bias,
                                       normalized_shape=(x.shape[-1],),
                                       eps=eps)


class FusedAdamSWA(FusedAdam):
    """Adam + stochastic weight averaging; ``swa_params()`` returns the
    averages in the parameters' dtypes."""

    def __init__(self, params, lr=1e-3, swa_start: int = 0,
                 swa_freq: int = 1, **adam_kw):
        super().__init__(params, lr=lr, **adam_kw)
        self.swa_start = int(swa_start)
        self.swa_freq = max(int(swa_freq), 1)
        for group in self.param_groups:
            for p in group["params"]:
                self._state(p)           # the average starts at p now
        dev = self.param_groups[0]["params"][0].device
        self.n_avg = torch.zeros((), dtype=torch.int32, device=dev)

    def _init_state(self, p, st):
        super()._init_state(p, st)
        st["swa"] = p.detach().to(_f32).clone()

    @torch.no_grad()
    def step(self, closure=None, **kw):
        loss = super().step(closure, **kw)
        step_count = self.param_groups[0]["step"]
        do_avg = (step_count > self.swa_start) & (
            (step_count - 1 - self.swa_start) % self.swa_freq == 0)
        self.n_avg = torch.where(do_avg, self.n_avg + 1, self.n_avg)
        # guarded divisor: on a step that does not average n_avg may be 0
        denom = torch.clamp(self.n_avg, min=1).to(_f32)
        for group in self.param_groups:
            for p in group["params"]:
                s = self.state[p]["swa"]
                s.copy_(torch.where(do_avg, s + (p.to(_f32) - s) / denom, s))
        return loss

    def swa_params(self):
        """The averaged parameters, one a parameter in ``param_groups``
        order, cast to the parameters' dtypes."""
        return [self.state[p]["swa"].to(p.dtype)
                for group in self.param_groups for p in group["params"]]
