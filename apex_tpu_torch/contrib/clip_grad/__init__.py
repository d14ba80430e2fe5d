"""Fast gradient clipping — port of ``apex_tpu/contrib/clip_grad``
(apex ``contrib/clip_grad/clip_grad.py``).

As in apex, the global norm is one multi-tensor L2-norm pass (kernel #17)
and the rescale one multi-tensor scale pass (kernel #15), in place on the
gradients; the total norm stays a device tensor (no host sync).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.multi_tensor_apply import (multi_tensor_l2norm,
                                               multi_tensor_scale)

_f32 = torch.float32

__all__ = ["clip_grad_norm_"]


def clip_grad_norm_(parameters, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False):
    """Clip the gradients of ``parameters`` (an iterable of tensors, or one
    tensor; those without ``.grad`` are skipped) to the global
    ``max_norm``, in place.  Returns the total norm, an f32 device scalar.

    ``norm_type`` 2.0 uses the kernels; other norms take a plain reduction,
    as apex does (only L2 is multi-tensor).  ``error_if_nonfinite``
    poisons the returned norm with NaN where a gradient is not finite (the
    JAX package's in-step form of apex's host-side raise)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=_f32)
    if norm_type == 2.0:
        total_norm, _, found_inf = multi_tensor_l2norm(grads)
    else:
        acc = torch.zeros((), dtype=_f32, device=grads[0].device)
        for g in grads:
            acc = acc + torch.sum(torch.abs(g.to(_f32)) ** norm_type)
        total_norm = acc ** (1.0 / norm_type)
        found_inf = (~torch.isfinite(total_norm)).to(_f32)
    if error_if_nonfinite:
        total_norm = torch.where(found_inf > 0,
                                 torch.full_like(total_norm, float("nan")),
                                 total_norm)
    clip_coef = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
    multi_tensor_scale(grads, clip_coef, out=grads)
    return total_norm
