"""Train-loop helpers — port of ``apex_tpu/amp/handle.py``.

apex's ``with amp.scale_loss(loss, optimizer) as scaled: scaled.backward()``
is split, as in the JAX package, into :func:`scale_loss` (before
``backward``) and :func:`unscale_step` (after it): the overflow check on
the scaled gradients, the optimizer step with ``grad_scale=1/scale`` (the
unscale fused into the update) skipped on the device on overflow, then the
scale update — with no host sync.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.scaler import LossScaler

__all__ = ["scale_loss", "unscale_step"]


def global_found_inf(optimizer, found_inf):
    """``found_inf`` as the optimizer's data-parallel group sees it: a
    ZeRO optimizer's ``global_found_inf`` (the flag taken over the ranks,
    whose gradients it reduces only in its step), else the flag itself."""
    reduce = getattr(optimizer, "global_found_inf", None)
    return found_inf if reduce is None else reduce(found_inf)


def scale_loss(loss, scaler: LossScaler):
    """The loss times the scaler's current scale (call ``backward`` on
    it)."""
    return scaler.scale(loss)


def unscale_step(optimizer, scaler: LossScaler):
    """Overflow check + optimizer step + scale update; returns the f32
    found-inf flag (a device scalar).

    Under a static scaler (the bf16 default) the check is skipped, as apex
    skips it: no found-inf pass, no noop.  A ZeRO optimizer, whose step
    reduces the gradients, makes the flag the group's
    (``global_found_inf``), so every rank skips and rescales together.
    """
    if scaler.dynamic:
        found_inf = global_found_inf(optimizer, LossScaler.found_inf(
            [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]))
        noop = found_inf.to(torch.int32)
    else:
        found_inf = torch.zeros((), dtype=torch.float32,
                                device=scaler.device)
        noop = None
    optimizer.step(grad_scale=1.0 / scaler.loss_scale, noop_flag=noop)
    scaler.update(found_inf)
    return found_inf
