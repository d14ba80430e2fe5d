"""O1 autocast — port of ``apex_tpu/amp/interpreter.py``.

apex implements O1 by patching the torch functional surface with
cast-inserting wrappers; the JAX package re-interprets the traced jaxpr and
inserts a cast per primitive.  The port does what both do with a
:class:`torch.overrides.TorchFunctionMode`: while a wrapped function runs,
every torch function and ``Tensor`` method it calls passes through
:meth:`_AutocastMode.__torch_function__`, which casts the floating tensor
arguments per :mod:`apex_tpu_torch.amp.lists` and calls the function:
whitelisted ops (convolutions, matrix products) take the compute dtype
when all their tensor inputs are floating, blacklisted ops take f32, and
promoting ops take the widest floating dtype among their tensors (Python
scalars stay weak, as in JAX).  Autograd differentiates through the
inserted casts, so the backward runs each product at its forward's
precision and hands f32 parameters f32 gradients.  In-place methods are
not cast (a cast copy would drop the write).

The mode also sees the torch calls made inside a
``torch.autograd.Function``'s forward (the kernel wrappers' plain versions
on the CPU; a kernel launch itself is a ``ctypes`` call it cannot see),
where the JAX interpreter re-binds a custom-derivative call whole with its
traced dtypes.  No ported O1 path runs such a Function (ResNet has none).
"""

from __future__ import annotations

import functools

import torch
from torch.overrides import TorchFunctionMode

from apex_tpu_torch.amp.lists import classify

__all__ = ["autocast", "autocast_dtype"]


def _floats(args, kwargs):
    out = []

    def visit(a):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            for b in a:
                visit(b)
    visit(args)
    visit(list(kwargs.values()))
    return out


def _cast_all(args, kwargs, dtype):
    def cast(a):
        if isinstance(a, torch.Tensor):
            if a.is_floating_point() and a.dtype != dtype:
                return a.to(dtype)
            return a
        if isinstance(a, (list, tuple)):
            return type(a)(cast(b) for b in a)
        return a
    return cast(args), {k: cast(v) for k, v in kwargs.items()}


class _AutocastMode(TorchFunctionMode):
    def __init__(self, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = classify(func)
        if kind != "passthrough":
            tensors = _floats(args, kwargs)
            floats = [t for t in tensors if t.is_floating_point()]
            if kind == "whitelist":
                if tensors and len(floats) == len(tensors):
                    args, kwargs = _cast_all(args, kwargs,
                                             self.compute_dtype)
            elif kind == "blacklist":
                args, kwargs = _cast_all(args, kwargs, torch.float32)
            elif floats:
                wide = functools.reduce(torch.promote_types,
                                        [t.dtype for t in floats])
                args, kwargs = _cast_all(args, kwargs, wide)
        return func(*args, **kwargs)


def autocast(fn, compute_dtype=torch.bfloat16):
    """Wrap ``fn`` (a function or module) so that each torch op it calls
    runs at its O1-classified precision.  Outputs keep the dtype their last
    op gives (a matrix product's output is ``compute_dtype``), as apex O1's
    patched ops return half tensors."""

    def wrapped(*args, **kwargs):
        with _AutocastMode(compute_dtype):
            return fn(*args, **kwargs)

    return functools.update_wrapper(wrapped, fn, updated=())


def autocast_dtype():
    """The compute dtype of the innermost active O1 autocast, or None."""
    for mode in reversed(torch.overrides._get_current_function_mode_stack()):
        if isinstance(mode, _AutocastMode):
            return mode.compute_dtype
    return None
