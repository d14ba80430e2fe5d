"""LARC — port of ``apex_tpu/parallel/LARC.py`` (apex
``apex/parallel/LARC.py``).

Layer-wise Adaptive Rate Clipping / Scaling: per tensor the adaptive rate
``trust * ||p|| / (||g|| + wd * ||p|| + eps)`` (the base rate where either
norm is 0), clipped against the group's rate (``clip=True``: the gradient
scale is ``min(adaptive / lr, 1)``) or used as a pure scale
(``adaptive / lr``).  :class:`LARC` wraps one of the port's optimizers:
``step`` folds each group's weight decay into the gradient, scales it
(``g' = s * (g + wd * p)`` in f32, written back in the gradient's dtype),
runs the wrapped optimizer with the group's decay set to 0, and restores
it.  The norms of a group are one :func:`~apex_tpu_torch.ops.multi_tensor.
multi_tensor_sumsq` launch set (kernel #17 on the card).  :func:`larc` is
the functional (optax-style) transform.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apex_tpu_torch.ops.multi_tensor import multi_tensor_sumsq

_f32 = torch.float32

__all__ = ["LARC", "larc"]


def _larc_scales(params, grads, lr, trust_coefficient, clip, eps,
                 weight_decay):
    """The per-tensor gradient scales (f32 ``(n,)`` on the tensors'
    device)."""
    _, p_sq, _ = multi_tensor_sumsq(params, per_tensor=True)
    _, g_sq, _ = multi_tensor_sumsq(grads, per_tensor=True)
    pn, gn = torch.sqrt(p_sq), torch.sqrt(g_sq)
    adaptive = trust_coefficient * pn / (gn + weight_decay * pn + eps)
    adaptive = torch.where((pn > 0) & (gn > 0), adaptive,
                           torch.full_like(adaptive, lr))
    scale = adaptive / lr
    return torch.clamp(scale, max=1.0) if clip else scale


class LARC:
    """``LARC(FusedSGD(params, lr=...), trust_coefficient=0.02)``: a
    wrapper whose ``step`` rescales every gradient, then steps the wrapped
    optimizer.  A parameter without a gradient is left to the optimizer
    (which treats it as zero) unless its group decays weights, where it
    takes ``s * wd * p``, as the JAX wrapper's dense zero gradient does."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8):
        self.optimizer = optimizer
        self.trust_coefficient = float(trust_coefficient)
        self.clip = bool(clip)
        self.eps = float(eps)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, *args, **kwargs):
        self.optimizer.zero_grad(*args, **kwargs)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None, **kwargs):
        saved = []
        for group in self.optimizer.param_groups:
            wd = float(group.get("weight_decay", 0.0))
            params = [p for p in group["params"]
                      if p.grad is not None or wd != 0.0]
            saved.append(wd)
            if not params:
                continue
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            scales = _larc_scales(params, grads, float(group["lr"]),
                                  self.trust_coefficient, self.clip,
                                  self.eps, wd)
            for p, g, s in zip(params, grads, scales):
                gf = g.to(_f32)
                if wd != 0.0:
                    gf = gf + wd * p.to(_f32)
                p.grad = (s * gf).to(g.dtype)
            group["weight_decay"] = 0.0
        try:
            return self.optimizer.step(closure, **kwargs)
        finally:
            for group, wd in zip(self.optimizer.param_groups, saved):
                group["weight_decay"] = wd


class GradientTransformation(NamedTuple):
    """optax's ``(init, update)`` pair."""

    init: object
    update: object


def larc(trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8, weight_decay: float = 0.0,
         learning_rate: float = 1.0) -> GradientTransformation:
    """The JAX ``larc`` transform: ``update(grads, state, params)``
    returns each gradient (a list of tensors) scaled by its LARC factor,
    in its own dtype, and the state (None)."""

    def init_fn(params):
        return None

    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("larc requires params")
        scales = _larc_scales(list(params), list(updates), learning_rate,
                              trust_coefficient, clip, eps, weight_decay)
        return [(s * g.to(_f32)).to(g.dtype)
                for g, s in zip(updates, scales)], state

    return GradientTransformation(init_fn, update_fn)
