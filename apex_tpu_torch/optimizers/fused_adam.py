"""FusedAdam — port of ``apex_tpu/optimizers/fused_adam.py``.

apex semantics: ``adam_w_mode`` selects AdamW (decoupled decay, default) or
classic Adam (L2 in the gradient); ``bias_correction`` toggles the
``1-beta^t`` terms; ``amsgrad`` raises as apex does; ``set_grad_none``
makes ``zero_grad`` drop the gradients.  ``capturable`` is accepted for
signature parity: every step already reads its scalars and step count from
the device.  One step is one :func:`~apex_tpu_torch.ops.multi_tensor.
multi_tensor_adam` launch set per parameter group over the per-parameter
f32 moments ``exp_avg`` / ``exp_avg_sq``; under ``master_weights`` the
kernel updates the f32 masters and the parameters then take their masters'
values, rounded to their dtypes, in one
:func:`~apex_tpu_torch.ops.multi_tensor.multi_tensor_scale_` launch set
(a scale of 1).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.multi_tensor import (device_scalars, multi_tensor_adam,
                                             multi_tensor_scale_)
from apex_tpu_torch.optimizers.base import FusedOptimizer

_f32 = torch.float32


class FusedAdam(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 capturable=False, master_weights=False, bucketed=None):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")  # apex parity
        del capturable  # signature parity only
        self.set_grad_none = bool(set_grad_none)
        super().__init__(params, dict(
            lr=lr, bias_correction=bool(bias_correction),
            betas=tuple(betas), eps=eps, adam_w_mode=bool(adam_w_mode),
            weight_decay=weight_decay), master_weights=master_weights,
            bucketed=bucketed)

    def zero_grad(self, set_to_none=None):
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    def _init_state(self, p, st):
        st["exp_avg"] = torch.zeros_like(p, dtype=_f32)
        st["exp_avg_sq"] = torch.zeros_like(p, dtype=_f32)

    def _update_group(self, group, params, grads, targets, copies,
                      step_count, grad_scale, noop, extras):
        beta1, beta2 = group["betas"]
        bc1, bc2 = self._bias_corrections(group, step_count)
        scal = device_scalars((group["lr"], beta1, beta2, group["eps"],
                               group["weight_decay"], bc1, bc2, grad_scale),
                              targets[0].device)
        states = [self.state[p] for p in params]
        multi_tensor_adam(grads, targets, [st["exp_avg"] for st in states],
                          [st["exp_avg_sq"] for st in states], scal, noop,
                          group["adam_w_mode"])
        pairs = [(t, c) for t, c in zip(targets, copies) if c is not None]
        if pairs:
            multi_tensor_scale_(*map(list, zip(*pairs)), 1.0)
