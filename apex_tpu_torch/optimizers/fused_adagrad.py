"""FusedAdagrad — port of ``apex_tpu/optimizers/fused_adagrad.py`` (the
per-leaf layout).

Adagrad (``h += g^2; p -= lr * g / (sqrt(h) + eps)``) with apex's
``adagrad_w_mode``: without it the weight decay is L2 in the gradient;
with it the decay is decoupled, ``p - lr * wd * p_old`` after the Adagrad
step, as the JAX optimizer applies it (``fused_adagrad.py:30-38``), here
fused into the kernel's pass.  A noop step keeps p and h.  One step is one
:func:`~apex_tpu_torch.ops.multi_tensor.multi_tensor_adagrad` launch set
(kernel #22) per parameter group over the per-parameter f32 ``sum``;
under ``master_weights`` the kernel also writes the model's parameters.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.multi_tensor import (device_scalars,
                                             multi_tensor_adagrad)
from apex_tpu_torch.optimizers.base import FusedOptimizer

_f32 = torch.float32


class FusedAdagrad(FusedOptimizer):
    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, adagrad_w_mode=False,
                 master_weights=False, bucketed=None):
        self.set_grad_none = bool(set_grad_none)
        super().__init__(params, dict(
            lr=lr, eps=eps, weight_decay=weight_decay,
            adagrad_w_mode=bool(adagrad_w_mode)),
            master_weights=master_weights, bucketed=bucketed)

    def zero_grad(self, set_to_none=None):
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    def _init_state(self, p, st):
        st["sum"] = torch.zeros_like(p, dtype=_f32)

    def _update_group(self, group, params, grads, targets, copies,
                      step_count, grad_scale, noop, extras):
        scal = device_scalars((group["lr"], group["eps"],
                               group["weight_decay"], grad_scale),
                              targets[0].device)
        multi_tensor_adagrad(grads, targets,
                             [self.state[p]["sum"] for p in params], copies,
                             scal, noop, group["adagrad_w_mode"])
