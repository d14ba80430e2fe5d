"""Carry weights from the JAX package into the port.

:func:`gpt_params_from_jax` takes the parameter tree of
``apex_tpu.models.gpt.GPTModel.init_params`` with its leaves as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``; this module never
imports JAX) and returns a state dict for
:class:`apex_tpu_torch.models.gpt.GPTModel`.  The port's parameter names
are the tree's paths joined by dots, so the mapping is a flatten; shapes
are checked against the model the config describes.
"""

from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = ["gpt_params_from_jax"]


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
