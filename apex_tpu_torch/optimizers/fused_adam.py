"""FusedAdam — port of ``apex_tpu/optimizers/fused_adam.py``.

apex semantics: ``adam_w_mode`` selects AdamW (decoupled decay, default) or
classic Adam (L2 in the gradient); ``bias_correction`` toggles the
``1-beta^t`` terms; ``amsgrad`` raises as apex does; ``set_grad_none``
makes ``zero_grad`` drop the gradients.  ``capturable`` is accepted for
signature parity: every step already reads its scalars and step count from
the device.  One step is one :func:`~apex_tpu_torch.ops.multi_tensor.
multi_tensor_adam` launch set per parameter group over the per-parameter
f32 moments ``exp_avg`` / ``exp_avg_sq``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.multi_tensor import multi_tensor_adam
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

    def _update_group(self, group, params, step_count, grad_scale, noop):
        beta1, beta2 = group["betas"]
        bc1, bc2 = self._bias_corrections(group, step_count)
        device = params[0].device
        # one f32 device tensor: floats and device scalars alike
        scal = torch.stack([
            torch.as_tensor(v, dtype=_f32, device=device).reshape(())
            for v in (group["lr"], beta1, beta2, group["eps"],
                      group["weight_decay"], bc1, bc2, grad_scale)])
        ms, vs = [], []
        for p in params:
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p, dtype=_f32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=_f32)
            ms.append(st["exp_avg"])
            vs.append(st["exp_avg_sq"])
        multi_tensor_adam([p.grad for p in params], params, ms, vs, scal,
                          noop, group["adam_w_mode"])
