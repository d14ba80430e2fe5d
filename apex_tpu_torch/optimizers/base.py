"""Shared machinery of the fused optimizers — port of
``apex_tpu/optimizers/base.py`` in its per-leaf layout.

A :class:`FusedOptimizer` is a :class:`torch.optim.Optimizer`: parameters
and hyperparameters live in ``param_groups`` (torch's own grouping takes the
place of the JAX ``param_group_fn``), per-parameter moments in ``state``,
and parameters are updated in place.  Each group keeps its step count as an
int32 tensor on the parameters' device, so the bias corrections, the step
advance and a dynamic-loss-scale skip (``noop_flag``) never need a host
sync.  One step is one multi-tensor kernel launch set per group.

The packed ``bucketed=True`` layout (the ZeRO optimizers' sharding unit)
and fp32 ``master_weights`` (amp O2) are not ported yet and raise.
"""

from __future__ import annotations

import torch

_f32 = torch.float32

ZERO_SLICE = "the ZeRO / multi-GPU slice"
AMP_O2_SLICE = "the BERT + amp O2 slice"


class FusedOptimizer(torch.optim.Optimizer):
    """Base class: the device step count, the bias corrections and the
    ``step(grad_scale, noop_flag)`` semantics of the JAX optimizers
    (torch's ``defaults`` fill each group's hyperparameters in)."""

    def __init__(self, params, defaults, *, master_weights=False,
                 bucketed=None):
        if bucketed:
            raise NotImplementedError(
                "bucketed=True (the packed multi_tensor layout) is not ported "
                f"yet: it comes with {ZERO_SLICE} of apex_tpu_torch")
        if master_weights:
            raise NotImplementedError(
                "master_weights=True (fp32 master copies of low-precision "
                f"params) is not ported yet: it comes with {AMP_O2_SLICE} of "
                "apex_tpu_torch")
        super().__init__(params, defaults)

    @staticmethod
    def _bias_corrections(group, step_count):
        """Adam-family ``1 - beta^t`` terms as f32 device tensors (1.0 when
        disabled); ``step_count`` is the group's int32 step tensor."""
        beta1, beta2 = group["betas"]
        if group["bias_correction"]:
            t = step_count.to(_f32)
            return 1.0 - beta1 ** t, 1.0 - beta2 ** t
        return 1.0, 1.0

    @torch.no_grad()
    def step(self, closure=None, *, grad_scale=1.0, noop_flag=None):
        """One fused step over every parameter that has a gradient.

        ``grad_scale`` (a float or a device scalar) multiplies the gradients
        (pass ``1/loss_scale`` to fuse amp unscaling); a non-zero
        ``noop_flag`` (int or device scalar) skips the update on the device,
        the step count included (apex's ``noop`` buffer).
        """
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            device = params[0].device
            step = group.get("step")
            if step is None:
                step = torch.zeros((), dtype=torch.int32, device=device)
            noop = None
            if noop_flag is None:
                step_count = step + 1
            else:
                noop = torch.as_tensor(noop_flag, device=device).reshape(
                    ()).to(torch.int32)
                step_count = step + (noop == 0).to(torch.int32)
            self._update_group(group, params, step_count, grad_scale, noop)
            group["step"] = step_count
        return loss

    def _update_group(self, group, params, step_count, grad_scale, noop):
        raise NotImplementedError
