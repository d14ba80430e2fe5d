"""Carry weights and optimizer state from the JAX package into the port.

:func:`gpt_params_from_jax` takes the parameter tree of
``apex_tpu.models.gpt.GPTModel.init_params`` with its leaves as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``; this module never
imports JAX) and returns a state dict for
:class:`apex_tpu_torch.models.gpt.GPTModel`.  The port's parameter names
are the tree's paths joined by dots, so the mapping is a flatten; shapes
are checked against the model the config describes.

:func:`fused_adam_state_from_jax` carries the per-leaf moments of the JAX
``FusedAdam(bucketed=False)`` state over to the port's ``FusedAdam``.
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = ["gpt_params_from_jax", "fused_adam_state_from_jax"]


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}{key}.")


def gpt_params_from_jax(tree, cfg: GPTConfig) -> dict:
    """State dict (CPU tensors in ``cfg.param_dtype``) for
    ``GPTModel(cfg)`` from a JAX GPT parameter tree of numpy arrays.
    Load it with ``model.load_state_dict(sd)``.  Raises when the tree's
    names or shapes do not match the model."""
    expected = {name: tuple(p.shape) for name, p in
                GPTModel(cfg, device="meta").state_dict().items()}
    sd = {}
    for name, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        if name not in expected:
            raise KeyError(f"JAX parameter {name!r} has no counterpart in "
                           "apex_tpu_torch's GPTModel")
        if arr.shape != expected[name]:
            raise ValueError(f"{name}: JAX shape {arr.shape} != port shape "
                             f"{expected[name]}")
        sd[name] = torch.from_numpy(arr.copy()).to(cfg.param_dtype)
    missing = sorted(set(expected) - set(sd))
    if missing:
        raise KeyError(f"JAX tree lacks {missing}")
    return sd


def _jax_leaf_order(names):
    """``names`` (dotted parameter paths) in the order ``jax.tree_util``
    flattens the nested tree they spell: dict keys sorted, list items
    (numeric components) by index."""
    def key(name):
        return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                     for c in name.split("."))
    return sorted(names, key=key)


def fused_adam_state_from_jax(state, model) -> dict:
    """The JAX per-leaf ``FusedAdam`` state of ``model``'s parameter tree,
    for the port's :class:`~apex_tpu_torch.optimizers.FusedAdam`.

    ``state``: ``{"step": int, "buckets": {"<group>/<dtype>": {"m": [...],
    "v": [...]}}}`` with numpy leaves (``jax.tree_util.tree_map(np.asarray,
    opt_state)``) of a ``bucketed=False`` optimizer over one parameter
    group.  Returns ``{"step": int, "state": {name: {"exp_avg": tensor,
    "exp_avg_sq": tensor}}}`` keyed by ``model.named_parameters()`` names,
    on the parameters' devices: copy ``state[name]`` into
    ``optimizer.state[param]`` and ``step`` into the group's ``"step"``.
    """
    params = dict(model.named_parameters())
    names = _jax_leaf_order(params)
    buckets = list(state["buckets"].values())
    if len(buckets) != 1:
        raise ValueError(f"expected one per-leaf bucket (one group, one "
                         f"dtype), got {list(state['buckets'])}")
    ms, vs = buckets[0]["m"], buckets[0]["v"]
    if len(ms) != len(names) or len(vs) != len(names):
        raise ValueError(f"the JAX state has {len(ms)} leaves, the model "
                         f"{len(names)} parameters")
    out = {}
    for name, m, v in zip(names, ms, vs):
        p = params[name]
        m, v = np.asarray(m, np.float32), np.asarray(v, np.float32)
        if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
            raise ValueError(f"{name}: JAX moment shape {m.shape} != "
                             f"parameter shape {tuple(p.shape)}")
        out[name] = {"exp_avg": torch.from_numpy(m.copy()).to(p.device),
                     "exp_avg_sq": torch.from_numpy(v.copy()).to(p.device)}
    return {"step": int(np.asarray(state["step"])), "state": out}
