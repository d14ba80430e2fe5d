"""fp16_utils — port of ``apex_tpu/fp16_utils`` (apex's legacy
``fp16_utils`` package: ``fp16util.py``, ``loss_scaler.py``,
``fp16_optimizer.py``).

Pre-amp manual mixed precision in the torch idiom: cast a module's
parameters to the half type (bf16 by default) keeping the normalization
parameters f32, keep f32 master copies, move values and gradients between
the two, and scale the loss.  :class:`FP16_Optimizer` wraps a fused
optimizer of :mod:`apex_tpu_torch.optimizers` with f32 masters
(``master_weights=True``) and a :class:`LossScaler`, as the JAX
``FP16_Optimizer`` wraps its functional optimizer.  The modern path is
:mod:`apex_tpu_torch.amp`.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.amp.frontend import _is_norm_param
from apex_tpu_torch.amp.handle import global_found_inf
from apex_tpu_torch.amp.scaler import LossScaler

__all__ = [
    "network_to_half",
    "BN_convert_float",
    "prep_param_lists",
    "master_params_to_model_params",
    "model_grads_to_master_grads",
    "FP16_Optimizer",
    "LossScaler",
    "DynamicLossScaler",
]

_f32 = torch.float32


@torch.no_grad()
def _cast_params(module, dtype_of):
    for name, p in module.named_parameters():
        if p.is_floating_point():
            want = dtype_of(name, p)
            if p.dtype != want:
                p.data = p.data.to(want)
    return module


def network_to_half(module, half_dtype=torch.bfloat16):
    """Cast ``module``'s floating parameters to ``half_dtype`` in place,
    the normalization parameters (by name, the amp O2 pattern) to f32
    (apex ``network_to_half`` + ``BN_convert_float``).  Returns
    ``module``; every ``Parameter`` object is kept."""
    return _cast_params(module, lambda name, p: (
        _f32 if _is_norm_param(name) else half_dtype))


def BN_convert_float(module):
    """Put ``module``'s normalization parameters back in f32, in place."""
    return _cast_params(module, lambda name, p: (
        _f32 if _is_norm_param(name) else p.dtype))


def prep_param_lists(model):
    """``(model_params, master_params)``: the trainable parameters and an
    f32 leaf copy of each, with ``requires_grad`` (apex
    ``prep_param_lists``)."""
    model_params = [p for p in model.parameters() if p.requires_grad]
    master_params = [p.detach().clone().to(_f32).requires_grad_()
                     for p in model_params]
    return model_params, master_params


@torch.no_grad()
def master_params_to_model_params(model_params, master_params):
    """Copy the master values into the model parameters, each rounded to
    its parameter's dtype."""
    for p, m in zip(model_params, master_params):
        p.copy_(m)


def model_grads_to_master_grads(model_params, master_params):
    """Each master's ``.grad`` becomes its model parameter's gradient in
    f32 (``None`` where the parameter has none)."""
    for p, m in zip(model_params, master_params):
        m.grad = None if p.grad is None else p.grad.detach().to(_f32)


class DynamicLossScaler(LossScaler):
    """Always-dynamic scaler (apex ``fp16_utils.DynamicLossScaler``:
    initial scale 2**32, growth every 1000 clean steps)."""

    def __init__(self, init_scale=2.0 ** 32, scale_factor=2.0,
                 scale_window=1000, device=None):
        super().__init__("dynamic", init_scale=init_scale,
                         scale_factor=scale_factor, scale_window=scale_window,
                         device=device)


class FP16_Optimizer:
    """A fused optimizer with f32 master weights and loss scaling in one
    object (apex ``fp16_optimizer.py``)::

        opt = FP16_Optimizer(FusedAdam(network_to_half(model).parameters()),
                             dynamic_loss_scale=True)
        opt.zero_grad()
        opt.backward(loss)          # the scaled loss's backward
        opt.step()                  # skipped on the device on overflow

    ``step`` runs the found-inf check over the gradients, the wrapped
    optimizer's step with ``grad_scale=1/scale`` and that flag as its
    ``noop``, then the scale update — the JAX ``FP16_Optimizer.step``.
    The scaler lives on the parameters' device.
    """

    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=False):
        del verbose
        self.optimizer = init_optimizer
        self.optimizer.master_weights = True
        device = init_optimizer.param_groups[0]["params"][0].device
        args = dict(dynamic_loss_args or {}, device=device)
        self.loss_scaler = (LossScaler("dynamic", **args)
                            if dynamic_loss_scale
                            else LossScaler(static_loss_scale, device=device))

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def loss_scale(self):
        return float(self.loss_scaler.loss_scale)

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none)

    def scale_loss(self, loss):
        return self.loss_scaler.scale(loss)

    def backward(self, loss):
        """``backward`` of the scaled loss (apex ``optimizer.backward``)."""
        self.scale_loss(loss).backward()

    def step(self):
        """Returns the f32 found-inf device flag."""
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        found_inf = global_found_inf(self.optimizer,
                                     LossScaler.found_inf(grads))
        self.optimizer.step(grad_scale=1.0 / self.loss_scaler.loss_scale,
                            noop_flag=found_inf.to(torch.int32))
        self.loss_scaler.update(found_inf)
        return found_inf
