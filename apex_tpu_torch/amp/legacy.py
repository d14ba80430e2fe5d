"""Legacy pre-``initialize`` amp surface — port of
``apex_tpu/amp/legacy.py`` (apex ``amp/amp.py``'s ``amp.init()`` and
function registry, ``amp/opt.py``'s ``OptimWrapper`` and
``amp/rnn_compat.py``).

* :func:`init` returns an :class:`AmpHandle` (or a :class:`NoOpHandle`
  when disabled), which owns a :class:`~apex_tpu_torch.amp.LossScaler` and
  the patches it applied.
* :func:`half_function` / :func:`float_function` / :func:`promote_function`
  wrap a callable so that its floating tensor arguments are cast to the
  half type (bf16 by default), to f32, or to the widest floating dtype
  among them.
* :func:`register_half_function` (and the float / promote forms) stage
  ``module.name`` to be replaced by its wrapped form at the next
  :func:`init`; ``AmpHandle._deactivate()`` puts the originals back.
* :class:`OptimWrapper` (``handle.wrap_optimizer``): ``step()`` is
  :func:`~apex_tpu_torch.amp.unscale_step` on the handle's scaler — the
  overflow check, the fused optimizer's step with ``grad_scale=1/scale``
  and the ``noop`` flag, then the scale update, with no host sync.

As in the JAX package, ``handle.scale_loss(loss)`` yields the scaled loss
(call ``backward`` on it) and the unscale happens in ``OptimWrapper.step``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch

from apex_tpu_torch.amp.handle import unscale_step
from apex_tpu_torch.amp.scaler import LossScaler

__all__ = [
    "init", "half_function", "float_function", "promote_function",
    "register_half_function", "register_float_function",
    "register_promote_function", "AmpHandle", "NoOpHandle", "OptimWrapper",
    "whitelist_rnn_cells", "has_old_rnns",
]

_HALF_DTYPE = torch.bfloat16


def _map_floating(fn, obj):
    """``fn`` applied to every floating tensor in nested tuples, lists and
    dicts (the JAX ``tree_map`` over the arguments)."""
    if torch.is_tensor(obj):
        return fn(obj) if obj.is_floating_point() else obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_floating(fn, x) for x in obj)
    if isinstance(obj, dict):
        return {k: _map_floating(fn, v) for k, v in obj.items()}
    return obj


def _widest(obj):
    dtypes = []

    def note(t):
        dtypes.append(t.dtype)
        return t
    _map_floating(note, obj)
    return functools.reduce(torch.promote_types, dtypes) if dtypes else None


def _casting_wrapper(fn: Callable, mode: str, half_dtype) -> Callable:
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        dtype = {"half": half_dtype, "float": torch.float32}.get(mode)
        if mode == "promote":
            dtype = _widest((args, kwargs))
        if dtype is not None:
            args, kwargs = _map_floating(lambda t: t.to(dtype),
                                         (args, kwargs))
        return fn(*args, **kwargs)

    wrapped._amp_original = fn
    return wrapped


def half_function(fn: Callable) -> Callable:
    """apex ``amp.half_function``: run ``fn`` with half-cast float args."""
    return _casting_wrapper(fn, "half", _HALF_DTYPE)


def float_function(fn: Callable) -> Callable:
    """apex ``amp.float_function``: run ``fn`` with f32-cast float args."""
    return _casting_wrapper(fn, "float", _HALF_DTYPE)


def promote_function(fn: Callable) -> Callable:
    """apex ``amp.promote_function``: promote float args to the widest."""
    return _casting_wrapper(fn, "promote", _HALF_DTYPE)


# registrations staged by register_* and applied by init() (apex
# semantics: register before init)
_PENDING: list = []


def register_half_function(module: Any, name: str) -> None:
    _PENDING.append((module, name, "half"))


def register_float_function(module: Any, name: str) -> None:
    _PENDING.append((module, name, "float"))


def register_promote_function(module: Any, name: str) -> None:
    _PENDING.append((module, name, "promote"))


class NoOpHandle:
    """``amp.init(enabled=False)``: every hook is the identity."""

    is_active = False

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer=None):
        yield loss

    def wrap_optimizer(self, optimizer):
        return OptimWrapper(optimizer, self)

    def loss_scale(self):
        return 1.0

    def _deactivate(self):
        pass


class AmpHandle:
    """apex ``AmpHandle``: owns the loss scaler (on ``device``, default
    ``"cuda"``) and the functions it patched."""

    is_active = True

    def __init__(self, loss_scale="dynamic", half_dtype=_HALF_DTYPE,
                 verbose=False, device=None):
        del verbose
        self.half_dtype = half_dtype
        self.scaler = LossScaler(loss_scale=loss_scale, device=device)
        self._patched: list = []
        for module, name, mode in _PENDING:
            orig = getattr(module, name)
            setattr(module, name, _casting_wrapper(orig, mode, half_dtype))
            self._patched.append((module, name, orig))
        _PENDING.clear()

    def loss_scale(self):
        return float(self.scaler.loss_scale)

    @contextlib.contextmanager
    def scale_loss(self, loss, optimizer=None):
        """Yields the SCALED loss: call ``backward`` on it; the unscale
        happens in :meth:`OptimWrapper.step`."""
        yield self.scaler.scale(loss)

    def wrap_optimizer(self, optimizer):
        return OptimWrapper(optimizer, self)

    def _deactivate(self):
        """Restore every patched function (apex handle teardown)."""
        for module, name, orig in reversed(self._patched):
            setattr(module, name, orig)
        self._patched.clear()


class OptimWrapper:
    """apex ``opt.py::OptimWrapper``: ``step()`` runs the overflow check,
    the fused step with the unscale folded in (skipped on the device on
    overflow) and the scale update on the handle's scaler.  Every other
    attribute is the wrapped optimizer's."""

    def __init__(self, optimizer, handle):
        self.optimizer = optimizer
        self.handle = handle

    def step(self, closure=None):
        """Returns the f32 found-inf device flag; a disabled handle steps
        the optimizer as it is and returns what its ``step`` returns."""
        if not self.handle.is_active:
            return self.optimizer.step(closure)
        if closure is not None:
            raise NotImplementedError(
                "OptimWrapper.step takes no closure under an active handle: "
                "compute the scaled loss's backward before the step")
        return unscale_step(self.optimizer, self.handle.scaler)

    def __getattr__(self, name):
        return getattr(self.optimizer, name)


def init(enabled: bool = True, loss_scale="dynamic",
         half_dtype=_HALF_DTYPE, enable_caching: bool = True,
         verbose: bool = False, allow_banned: bool = False, device=None):
    """apex ``amp.init()``: the active :class:`AmpHandle` (its scaler on
    ``device``, default ``"cuda"``), or the no-op handle when disabled.
    ``enable_caching`` / ``allow_banned`` are accepted for signature
    parity."""
    del enable_caching, allow_banned
    if not enabled:
        # staged registrations must not leak into a later init() (apex: a
        # disabled init deactivates everything)
        _PENDING.clear()
        return NoOpHandle()
    return AmpHandle(loss_scale=loss_scale, half_dtype=half_dtype,
                     verbose=verbose, device=device)


# -- rnn_compat -------------------------------------------------------------

has_old_rnns = False    # apex detected pre-0.4 torch RNN internals


def whitelist_rnn_cells(handle=None, verbose=False):
    """apex ``rnn_compat.whitelist_rnn_cells``: patched torch's RNN cell
    backends into the cast registry.  The port has no RNN package of its
    own to patch, so this validates its arguments and returns."""
    if handle is not None and not isinstance(handle,
                                             (AmpHandle, NoOpHandle)):
        raise TypeError(f"whitelist_rnn_cells: handle must be an amp handle "
                        f"or None, got {type(handle).__name__}")
    if not isinstance(verbose, bool):
        raise TypeError(f"whitelist_rnn_cells: verbose must be a bool, got "
                        f"{type(verbose).__name__}")
