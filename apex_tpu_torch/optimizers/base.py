"""Shared machinery of the fused optimizers — port of
``apex_tpu/optimizers/base.py`` in its per-leaf layout.

A :class:`FusedOptimizer` is a :class:`torch.optim.Optimizer`: parameters
and hyperparameters live in ``param_groups`` (torch's own grouping takes the
place of the JAX ``param_group_fn``), per-parameter state in ``state``, and
parameters are updated in place.  Each group keeps its step count as an
int32 tensor on the parameters' device, so the bias corrections, the step
advance and a dynamic-loss-scale skip (``noop_flag``) never need a host
sync.  One step is one multi-tensor kernel launch set per group.

Every parameter of a group is stepped, as the JAX optimizers step every
leaf: one that the loss did not reach (``.grad`` is None) takes a zero
gradient, so weight decay still moves it.

``master_weights=True`` (amp O2) keeps an f32 master copy of every
parameter that is not f32 (``state[p]["master"]``, made from the parameter
at its first step): the update runs on the master, and the parameter
receives the master rounded to its dtype (JAX ``base.py:165-181,
273-303``).  ``load_state_dict`` keeps the saved dtypes of the state.
The packed ``bucketed=True`` layout (the ZeRO optimizers' sharding unit)
is not ported yet and raises.
"""

from __future__ import annotations

import torch

_f32 = torch.float32

ZERO_SLICE = "the ZeRO / multi-GPU slice"


class FusedOptimizer(torch.optim.Optimizer):
    """Base class: the device step count, the bias corrections, master
    weights and the ``step(grad_scale, noop_flag)`` semantics of the JAX
    optimizers (torch's ``defaults`` fill each group's hyperparameters
    in)."""

    def __init__(self, params, defaults, *, master_weights=False,
                 bucketed=None):
        if bucketed:
            raise NotImplementedError(
                "bucketed=True (the packed multi_tensor layout) is not ported "
                f"yet: it comes with {ZERO_SLICE} of apex_tpu_torch")
        self.master_weights = bool(master_weights)
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

    def _state(self, p):
        """``state[p]``, filled at first use: the subclass's moments and,
        under master weights, the f32 master of a non-f32 parameter."""
        st = self.state[p]
        if not st:
            self._init_state(p, st)
            if self.master_weights and p.dtype != _f32:
                st["master"] = p.detach().to(_f32)
        return st

    def _init_state(self, p, st):
        raise NotImplementedError

    def load_state_dict(self, state_dict):
        """torch's, with each state tensor kept in its saved dtype: torch
        casts floating state to its parameter's dtype, which would round
        the f32 masters and moments of a bf16 parameter."""
        super().load_state_dict(state_dict)
        saved = state_dict["state"]
        for saved_group, group in zip(state_dict["param_groups"],
                                      self.param_groups):
            for i, p in zip(saved_group["params"], group["params"]):
                for key, value in saved.get(i, {}).items():
                    if torch.is_tensor(value):
                        self.state[p][key] = value.to(device=p.device)

    def master_params(self):
        """The f32 values the optimizer updates, one per parameter in group
        order: the master where there is one, else the parameter (upcast
        when it is not f32) — apex ``amp.master_params(optimizer)``."""
        for group in self.param_groups:
            for p in group["params"]:
                st = self._state(p)
                yield st["master"] if "master" in st else p.detach().to(_f32)

    def _group_lists(self, group):
        """``(params, grads, targets, copies)`` of a group: every
        parameter, its gradient (zeros where ``.grad`` is None), the tensor
        the update writes (the master, else the parameter) and the model
        copy the update also writes (the parameter under a master, else
        None)."""
        params = list(group["params"])
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        targets, copies = [], []
        for p in params:
            master = self._state(p).get("master")
            targets.append(p if master is None else master)
            copies.append(None if master is None else p)
        return params, grads, targets, copies

    @torch.no_grad()
    def step(self, closure=None, *, grad_scale=1.0, noop_flag=None):
        """One fused step over every parameter.

        ``grad_scale`` (a float or a device scalar) multiplies the gradients
        (pass ``1/loss_scale`` to fuse amp unscaling); a non-zero
        ``noop_flag`` (int or device scalar) skips the update on the device,
        the step count included (apex's ``noop`` buffer).
        """
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        groups = [(g, self._group_lists(g)) for g in self.param_groups
                  if g["params"]]
        if not groups:
            return loss
        extras = self._pre_step([grad for _, lists in groups
                                 for grad in lists[1]], grad_scale)
        for group, (params, grads, targets, copies) in groups:
            device = params[0].device
            step = group.get("step")
            if step is None:
                step = torch.zeros((), dtype=torch.int32, device=device)
            noop = None
            if noop_flag is None:
                step_count = step + 1
            elif isinstance(noop_flag, torch.Tensor):
                noop = noop_flag.to(device=device,
                                    dtype=torch.int32).reshape(())
                step_count = step + (noop == 0).to(torch.int32)
            else:
                noop = torch.full((), int(noop_flag), dtype=torch.int32,
                                  device=device)
                step_count = step + (noop == 0).to(torch.int32)
            self._update_group(group, params, grads, targets, copies,
                               step_count, grad_scale, noop, extras)
            group["step"] = step_count
        return loss

    def _pre_step(self, grads, grad_scale):
        """Cross-group pre-pass over every gradient (LAMB's global norm)."""
        return None

    def _update_group(self, group, params, grads, targets, copies,
                      step_count, grad_scale, noop, extras):
        raise NotImplementedError
