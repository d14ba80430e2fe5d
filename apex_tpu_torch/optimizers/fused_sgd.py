"""FusedSGD — port of ``apex_tpu/optimizers/fused_sgd.py`` (the per-leaf
layout).

torch.optim.SGD semantics (momentum, dampening, nesterov, weight decay)
with apex's ``wd_after_momentum``.  The momentum buffer starts at zero and
the dampening is zero on the first step, so the first step's buffer is the
gradient (torch's and apex's ``first_run``); the JAX optimizer selects the
dampening from its traced step count (``fused_sgd.py:47,67``), and so does
this one, from the group's int32 device step count: no host sync.  A
momentum of exactly 0 (a Python number) takes the kernel's static
shortcut that neither reads nor writes the buffer.  One step is one
:func:`~apex_tpu_torch.ops.multi_tensor.multi_tensor_sgd` launch set
(kernel #19) per parameter group over the per-parameter f32
``momentum_buffer``; under ``master_weights`` the kernel updates the f32
masters and writes the model's parameters, rounded to their dtypes, in the
same pass.  ``materialize_master_grads`` is accepted for signature parity.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.multi_tensor import device_scalars, multi_tensor_sgd
from apex_tpu_torch.optimizers.base import FusedOptimizer

_f32 = torch.float32


class FusedSGD(FusedOptimizer):
    def __init__(self, params, lr=1e-3, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True, set_grad_none=False,
                 master_weights=False, bucketed=None):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        del materialize_master_grads  # signature parity only
        self.set_grad_none = bool(set_grad_none)
        super().__init__(params, dict(
            lr=lr, momentum=momentum, dampening=dampening,
            weight_decay=weight_decay, nesterov=bool(nesterov),
            wd_after_momentum=bool(wd_after_momentum)),
            master_weights=master_weights, bucketed=bucketed)

    def zero_grad(self, set_to_none=None):
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    def _init_state(self, p, st):
        st["momentum_buffer"] = torch.zeros_like(p, dtype=_f32)

    def _update_group(self, group, params, grads, targets, copies,
                      step_count, grad_scale, noop, extras):
        device = targets[0].device
        damp = torch.where(step_count == 1,
                           torch.zeros((), dtype=_f32, device=device),
                           torch.full((), float(group["dampening"]),
                                      dtype=_f32, device=device))
        momentum = group["momentum"]
        scal = device_scalars((group["lr"], group["weight_decay"], momentum,
                               damp, grad_scale), device)
        momentum_zero = (isinstance(momentum, (int, float))
                         and momentum == 0.0)
        multi_tensor_sgd(grads, targets,
                         [self.state[p]["momentum_buffer"] for p in params],
                         copies, scal, noop, nesterov=group["nesterov"],
                         wd_after_momentum=group["wd_after_momentum"],
                         momentum_zero=momentum_zero)
