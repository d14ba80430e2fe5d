"""amp frontend — port of ``apex_tpu/amp/frontend.py`` (apex
``amp/frontend.py``).

Opt levels keep apex's meaning, with bf16 as the default half type:

* **O0** — f32 everything.
* **O1** — per-op autocast: convolutions and matrix products in half,
  precision-sensitive ops in f32, multi-argument ops promoted
  (:func:`~apex_tpu_torch.amp.interpreter.autocast` over the lists of
  :mod:`~apex_tpu_torch.amp.lists`); the model's ``forward`` is wrapped in
  place, as apex patches the functions it calls.
* **O2** — "almost half": model parameters and inputs cast to half, except
  normalization layers (``keep_batchnorm_fp32``), f32 master weights held
  by the optimizer, loss scaling (static 1.0 for bf16, dynamic for fp16).
* **O3** — half everything.

:func:`initialize` casts an ``nn.Module`` in place (apex's
``amp.initialize`` does the same to the model it is given), turns on the
optimizer's master weights where the level asks for them, and returns an
:class:`AmpState` with the :class:`~apex_tpu_torch.amp.scaler.LossScaler`.
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch

from apex_tpu_torch.amp.interpreter import autocast
from apex_tpu_torch.amp.scaler import LossScaler

_BN_PATTERN = re.compile(
    r"(batch_?norm|bn|layer_?norm|ln|group_?norm|rms_?norm|norm)",
    re.IGNORECASE)

__all__ = ["AmpState", "Properties", "initialize"]


class Properties:
    """Resolved opt-level properties (apex ``frontend.py::Properties``)."""

    def __init__(self, **kw):
        self.opt_level = kw.get("opt_level")
        self.cast_model_type = kw.get("cast_model_type")
        self.patch_torch_functions = kw.get("patch_torch_functions", False)
        self.keep_batchnorm_fp32 = kw.get("keep_batchnorm_fp32")
        self.master_weights = kw.get("master_weights", False)
        self.loss_scale = kw.get("loss_scale", 1.0)

    def _asdict(self):
        return dict(opt_level=self.opt_level,
                    cast_model_type=self.cast_model_type,
                    patch_torch_functions=self.patch_torch_functions,
                    keep_batchnorm_fp32=self.keep_batchnorm_fp32,
                    master_weights=self.master_weights,
                    loss_scale=self.loss_scale)


def _opt_level_properties(opt_level: str, half_dtype) -> Properties:
    # bf16 needs no loss scaling (8-bit exponent = f32 range); fp16 does.
    dyn = "dynamic" if half_dtype == torch.float16 else 1.0
    table = {
        "O0": Properties(opt_level="O0", cast_model_type=torch.float32,
                         patch_torch_functions=False,
                         keep_batchnorm_fp32=None, master_weights=False,
                         loss_scale=1.0),
        "O1": Properties(opt_level="O1", cast_model_type=None,
                         patch_torch_functions=True,
                         keep_batchnorm_fp32=None, master_weights=False,
                         loss_scale=dyn),
        "O2": Properties(opt_level="O2", cast_model_type=half_dtype,
                         patch_torch_functions=False,
                         keep_batchnorm_fp32=True, master_weights=True,
                         loss_scale=dyn),
        "O3": Properties(opt_level="O3", cast_model_type=half_dtype,
                         patch_torch_functions=False,
                         keep_batchnorm_fp32=False, master_weights=False,
                         loss_scale=1.0),
    }
    if opt_level not in table:
        raise ValueError(f"Unexpected optimization level {opt_level}; "
                         "options are 'O0', 'O1', 'O2', 'O3'.")
    return table[opt_level]


def _is_norm_param(name: str) -> bool:
    return bool(_BN_PATTERN.search(name))


class AmpState(NamedTuple):
    """Everything :func:`initialize` wires together."""

    model: Any                  # the (cast) nn.Module, or None
    optimizer: Any              # the (possibly master-weight) optimizer
    scaler: LossScaler
    properties: Properties

    def cast_params(self, model):
        """Apply the opt level's model-weight cast (O2/O3) in place: every
        floating parameter to ``cast_model_type``, except — under
        ``keep_batchnorm_fp32`` — those whose dotted name matches the
        normalization pattern, which stay (or become) f32.  Returns
        ``model``."""
        dtype = self.properties.cast_model_type
        if dtype is None or dtype == torch.float32:
            return model
        keep_bn = self.properties.keep_batchnorm_fp32
        with torch.no_grad():
            for name, p in model.named_parameters():
                if not p.is_floating_point():
                    continue
                want = (torch.float32 if keep_bn and _is_norm_param(name)
                        else dtype)
                if p.dtype != want:
                    p.data = p.data.to(want)
        return model

    def cast_inputs(self, *args):
        """Floating tensors among ``args`` cast to ``cast_model_type``."""
        dtype = self.properties.cast_model_type
        if dtype is None or dtype == torch.float32:
            return args
        return tuple(a.to(dtype) if isinstance(a, torch.Tensor)
                     and a.is_floating_point() else a for a in args)

    def master_params(self):
        """The optimizer's f32 master values (apex
        ``amp.master_params(optimizer)``)."""
        return self.optimizer.master_params()


def initialize(model=None, optimizer=None, opt_level: str = "O1",
               half_dtype=torch.bfloat16, cast_model_type=None,
               patch_torch_functions=None, keep_batchnorm_fp32=None,
               master_weights=None, loss_scale=None, min_loss_scale=None,
               max_loss_scale=2.0 ** 24, verbosity=1, device=None,
               **unused):
    """``apex.amp.initialize(model, optimizer, ...)`` for one
    ``nn.Module`` and one fused optimizer: resolves the opt level's
    properties (keyword overrides win), casts ``model`` in place (or, where
    the level patches functions, O1, wraps its ``forward`` in
    :func:`autocast` at ``half_dtype``), sets the optimizer's
    ``master_weights`` where the level asks for them, and makes the
    :class:`LossScaler` (on the model's device, else ``device``).
    Build the optimizer over ``model.parameters()`` before or after: the
    cast keeps every ``Parameter`` object.  Returns an :class:`AmpState`.
    """
    props = _opt_level_properties(opt_level, half_dtype)
    for name, val in dict(cast_model_type=cast_model_type,
                          patch_torch_functions=patch_torch_functions,
                          keep_batchnorm_fp32=keep_batchnorm_fp32,
                          master_weights=master_weights,
                          loss_scale=loss_scale).items():
        if val is not None:
            setattr(props, name, val)
    if optimizer is not None and props.master_weights:
        optimizer.master_weights = True
    if model is not None:
        param = next(model.parameters(), None)
        if param is not None:
            device = param.device
    scaler = LossScaler(loss_scale=props.loss_scale,
                        min_loss_scale=min_loss_scale,
                        max_loss_scale=max_loss_scale, device=device)
    state = AmpState(model, optimizer, scaler, props)
    if model is not None:
        state.cast_params(model)
        if props.patch_torch_functions:
            model.forward = autocast(model.forward, half_dtype)
    return state
