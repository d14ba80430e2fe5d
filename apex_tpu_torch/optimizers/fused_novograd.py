"""FusedNovoGrad — port of ``apex_tpu/optimizers/fused_novograd.py`` (the
per-leaf layout).

NovoGrad keeps its second moment per *tensor*: ``v = beta2 * v + (1 -
beta2) * ||g||^2``, set to the first ``||g||^2`` on step 1 unless
``init_zero``, and kept by a noop step.  Per step and group:

1. the per-tensor sums of squares of the raw gradients, one
   :func:`~apex_tpu_torch.ops.multi_tensor.multi_tensor_sumsq` launch set
   (kernel #17), times ``grad_scale^2``;
2. v updated on the device, one ``(n,)`` f32 vector per group (each
   parameter's ``state["exp_avg_sq"]`` is its 0-dim view, and a restored
   state is read back into it);
3. the element-wise stage, one
   :func:`~apex_tpu_torch.ops.multi_tensor.multi_tensor_novograd` launch set
   (kernel #23): each gradient over its tensor's ``sqrt(v) + eps``, the
   first moment ``exp_avg`` with ``beta3`` (``1 - beta1`` under
   ``grad_averaging``, else 1), weight decay inside the moment
   (``reg_inside_moment``) or at the update, and the bias corrections
   folded into the learning rate, ``lr * sqrt(1 - beta2^t) / (1 -
   beta1^t)``, from the device step count.

``norm_type`` 2 only and no AMSGrad, as apex.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.multi_tensor import (device_scalars,
                                             multi_tensor_novograd,
                                             multi_tensor_sumsq)
from apex_tpu_torch.optimizers.base import FusedOptimizer

_f32 = torch.float32


class FusedNovoGrad(FusedOptimizer):
    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.95, 0.98), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False, grad_averaging=True,
                 norm_type=2, init_zero=False, set_grad_none=True,
                 master_weights=False, bucketed=None):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")  # apex parity
        if norm_type != 2:
            raise RuntimeError("FusedNovoGrad only supports l2 norm.")
        self.set_grad_none = bool(set_grad_none)
        self._v = {}           # first parameter of a group -> its (n,) v
        super().__init__(params, dict(
            lr=lr, bias_correction=bool(bias_correction),
            betas=tuple(betas), eps=eps, weight_decay=weight_decay,
            reg_inside_moment=bool(reg_inside_moment),
            grad_averaging=bool(grad_averaging), init_zero=bool(init_zero)),
            master_weights=master_weights, bucketed=bucketed)

    def zero_grad(self, set_to_none=None):
        super().zero_grad(self.set_grad_none if set_to_none is None
                          else set_to_none)

    def _init_state(self, p, st):
        st["exp_avg"] = torch.zeros_like(p, dtype=_f32)

    def _second_moments(self, params, device):
        """The group's per-tensor v as one (n,) f32 tensor, of which each
        ``state[p]["exp_avg_sq"]`` is a 0-dim view.  Where an entry is not
        such a view (the first step, or a state restored by
        ``load_state_dict``), v is made anew from the entries, zero where a
        parameter has none."""
        v = self._v.get(params[0])
        entries = [self.state[p].get("exp_avg_sq") for p in params]
        if v is None or v.numel() != len(params) or any(
                e is None or e._base is not v for e in entries):
            zero = torch.zeros((), dtype=_f32, device=device)
            v = torch.stack([zero if e is None else
                             e.to(device=device, dtype=_f32).reshape(())
                             for e in entries])
            self._v[params[0]] = v
            for i, p in enumerate(params):
                self.state[p]["exp_avg_sq"] = v[i]
        return v

    def _update_group(self, group, params, grads, targets, copies,
                      step_count, grad_scale, noop, extras):
        beta1, beta2 = group["betas"]
        device = targets[0].device
        _, sums, _ = multi_tensor_sumsq(grads, per_tensor=True)
        gscale = torch.as_tensor(grad_scale, dtype=_f32).to(device)
        gnorm_sq = sums * gscale ** 2
        v = self._second_moments(params, device)
        v_new = beta2 * v + (1.0 - beta2) * gnorm_sq
        if not group["init_zero"]:   # apex: v starts at the first ||g||^2
            v_new = torch.where(step_count == 1, gnorm_sq, v_new)
        if noop is not None:
            v_new = torch.where(noop != 0, v, v_new)
        v.copy_(v_new)
        lr = group["lr"]
        if group["bias_correction"]:
            t = step_count.to(_f32)
            lr = lr * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        beta3 = 1.0 - beta1 if group["grad_averaging"] else 1.0
        scal = device_scalars((lr, beta1, group["weight_decay"],
                               group["eps"], grad_scale, beta3), device)
        multi_tensor_novograd(grads, targets,
                              [self.state[p]["exp_avg"] for p in params],
                              copies, v, scal, noop,
                              group["reg_inside_moment"])
