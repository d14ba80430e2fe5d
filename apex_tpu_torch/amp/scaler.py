"""Loss scaling — port of ``apex_tpu/amp/scaler.py`` (apex
``amp/scaler.py::LossScaler``).

The scaler's mutable fields (the current scale, the clean-step counter, the
overflow and skipped-step counters) are device tensors updated in place, so
a training step that scales, checks and updates never syncs with the host.
Overflow detection is the found-inf flag of a multi-tensor pass (kernels
#15 and #17), and the skip decision rides to the optimizer as a device
``noop`` flag.

bf16 rarely overflows, so the bf16 opt levels default to the static scale
1.0 (the machinery stays for fp16 and for users who want it).
"""

from __future__ import annotations

import torch

from apex_tpu_torch.multi_tensor_apply import (multi_tensor_l2norm,
                                               multi_tensor_scale)
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32
_i32 = torch.int32

__all__ = ["LossScaler"]


class LossScaler:
    """``loss_scale``: a number for static scaling or ``"dynamic"``.
    ``device`` holds the state (default ``"cuda"``)."""

    def __init__(self, loss_scale="dynamic", init_scale=2.0 ** 16,
                 scale_factor=2.0, scale_window=2000, min_loss_scale=None,
                 max_loss_scale=2.0 ** 24, device=None):
        self.dynamic = loss_scale == "dynamic"
        self._init_scale = float(init_scale if self.dynamic else loss_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_loss_scale = (None if min_loss_scale is None
                               else float(min_loss_scale))
        self.max_loss_scale = float(max_loss_scale)
        self.device = resolve_device(device)
        dev = self.device
        self.loss_scale = torch.full((), self._init_scale, dtype=_f32,
                                     device=dev)
        self.unskipped = torch.zeros((), dtype=_i32, device=dev)
        self.overflows = torch.zeros((), dtype=_i32, device=dev)
        self.skipped = torch.zeros((), dtype=_i32, device=dev)

    def scale(self, loss):
        """The loss times the current scale (apex ``scale_loss`` entry)."""
        return loss * self.loss_scale.to(loss.dtype)

    def unscale(self, grads, out=None):
        """Gradients times ``1/scale`` with fused overflow detection (kernel
        #15); returns ``(unscaled, found_inf)``.  ``out`` (a list, which may
        be ``grads``) receives the results in place.  Passing
        ``grad_scale=1/scale`` to a fused optimizer saves this pass
        (:func:`~apex_tpu_torch.amp.unscale_step`)."""
        return multi_tensor_scale(list(grads), 1.0 / self.loss_scale,
                                  out=out)

    @staticmethod
    def found_inf(grads):
        """f32 0/1 device flag: a non-finite value in ``grads`` (the
        found-inf of one multi-tensor L2-norm pass, kernel #17)."""
        return multi_tensor_l2norm(list(grads))[2]

    @torch.no_grad()
    def update(self, found_inf):
        """Post-step scale adjustment (apex ``update_scale``): halve on
        overflow, grow by ``scale_factor`` every ``scale_window`` clean
        steps, within ``[min_loss_scale, max_loss_scale]``.  The skipped
        counter advances on every overflow, under a static scaler too."""
        overflow = torch.as_tensor(found_inf).to(self.device) > 0
        self.skipped += overflow.to(_i32)
        if not self.dynamic:
            return
        new_scale = torch.where(overflow,
                                self.loss_scale / self.scale_factor,
                                self.loss_scale)
        if self.min_loss_scale is not None:
            new_scale = torch.clamp(new_scale, min=self.min_loss_scale)
        unskipped = torch.where(overflow, torch.zeros_like(self.unskipped),
                                self.unskipped + 1)
        grow = unskipped >= self.scale_window
        new_scale = torch.where(
            grow, torch.clamp(new_scale * self.scale_factor,
                              max=self.max_loss_scale), new_scale)
        self.loss_scale.copy_(new_scale)
        self.unskipped.copy_(torch.where(grow, torch.zeros_like(unskipped),
                                         unskipped))
        self.overflows += overflow.to(_i32)

    # apex checkpoint surface (tests/L0/run_amp/test_checkpointing.py)
    def state_dict(self) -> dict:
        return {"loss_scale": float(self.loss_scale),
                "unskipped": int(self.unskipped),
                "overflows": int(self.overflows),
                "skipped": int(self.skipped)}

    def load_state_dict(self, d: dict) -> None:
        self.loss_scale.fill_(float(d["loss_scale"]))
        self.unskipped.fill_(int(d["unskipped"]))
        self.overflows.fill_(int(d.get("overflows", 0)))
        self.skipped.fill_(int(d.get("skipped", 0)))
