"""Multi-tensor Adam — port of the Adam part of
``apex_tpu/ops/multi_tensor.py``.

:func:`multi_tensor_adam` updates lists of parameters and their f32 moments
in place with one multi-tensor launch set (apex's ``multi_tensor_apply``
design): a CUDA tensor launches ``csrc/multi_tensor_adam.cu`` (the
counterpart of the Pallas ``_adam_kernel``), a CPU tensor takes
:func:`multi_tensor_adam_reference`, which applies :func:`_adam_math` (the
JAX single-source update) tensor by tensor.

The scalars ride in one f32 device tensor ``scal = [lr, beta1, beta2, eps,
weight_decay, bias_correction1, bias_correction2, grad_scale]`` and the skip
flag in an int32 device tensor ``noop``: the kernel reads both on the card,
so neither a learning-rate change nor a dynamic-loss-scale skip needs a host
sync.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

__all__ = ["multi_tensor_adam", "multi_tensor_adam_reference", "_adam_math"]


def _adam_math(adam_w_mode, scal, skip, g, p, m, v):
    """Pure f32 Adam/AdamW update (the JAX ``_adam_math``).

    ``scal``: f32 ``[lr, beta1, beta2, eps, weight_decay, bc1, bc2,
    grad_scale]``; ``skip``: bool tensor.  Returns ``(p, m, v)`` in f32.
    """
    lr, beta1, beta2, eps, wd, bc1, bc2, gscale = (scal[k] for k in range(8))
    g = g * gscale
    if not adam_w_mode:            # classic Adam: L2 folded into the gradient
        g = g + wd * p
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w_mode:                # AdamW: decoupled weight decay
        update = update + wd * p
    p_new = p - lr * update
    return (torch.where(skip, p, p_new), torch.where(skip, m, m_new),
            torch.where(skip, v, v_new))


def _skip(noop, device):
    if noop is None:
        return torch.zeros((), dtype=torch.bool, device=device)
    return noop.reshape(()) != 0


@torch.no_grad()
def multi_tensor_adam_reference(grads, params, exp_avgs, exp_avg_sqs, scal,
                                noop=None, adam_w_mode=True):
    """Plain version: :func:`_adam_math` per tensor, results copied into
    ``params`` (rounded to their dtype), ``exp_avgs`` and
    ``exp_avg_sqs``."""
    for g, p, m, v in zip(grads, params, exp_avgs, exp_avg_sqs):
        p2, m2, v2 = _adam_math(bool(adam_w_mode), scal.to(_f32),
                                _skip(noop, p.device), g.to(_f32),
                                p.to(_f32), m, v)
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)


def _pointers(tensors):
    return np.array([t.data_ptr() for t in tensors], dtype=np.uint64)


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


@torch.no_grad()
def multi_tensor_adam(grads, params, exp_avgs, exp_avg_sqs, scal, noop=None,
                      adam_w_mode=True):
    """One Adam/AdamW step over lists of tensors, in place.

    ``grads``/``params``: same-shape contiguous tensors (f32, bf16 or f16,
    each pair may differ); ``exp_avgs``/``exp_avg_sqs``: contiguous f32
    moments; ``scal``: f32 ``(8,)`` tensor as in :func:`_adam_math`;
    ``noop``: optional int32 scalar tensor, non-zero skips the update.
    CPU tensors take :func:`multi_tensor_adam_reference`; CUDA tensors
    launch the kernel (as many launches as its tables need, added to
    ``multi_tensor_adam.launches``) or raise.
    """
    lists = (grads, params, exp_avgs, exp_avg_sqs)
    n = len(params)
    if any(len(x) != n for x in lists):
        raise ValueError("multi_tensor_adam: the four lists differ in length")
    if n == 0:
        return
    device = params[0].device
    if device.type == "cpu":
        return multi_tensor_adam_reference(grads, params, exp_avgs,
                                           exp_avg_sqs, scal, noop,
                                           adam_w_mode)
    if device.type != "cuda":
        raise ValueError(f"multi_tensor_adam: unsupported device {device}")
    for g, p, m, v in zip(*lists):
        if not (g.shape == p.shape == m.shape == v.shape):
            raise ValueError("multi_tensor_adam: a gradient, parameter and "
                             f"moments disagree in shape: {tuple(g.shape)}, "
                             f"{tuple(p.shape)}, {tuple(m.shape)}")
        if m.dtype != _f32 or v.dtype != _f32:
            raise TypeError("multi_tensor_adam: moments must be f32")
        if any(t.device != device or not t.is_contiguous()
               for t in (g, p, m, v)):
            raise ValueError("multi_tensor_adam: every tensor must be "
                             f"contiguous and on {device}")
    if (scal.dtype != _f32 or scal.shape != (8,) or scal.device != device
            or not scal.is_contiguous()):
        raise ValueError(f"multi_tensor_adam: scal must be a contiguous f32 "
                         f"(8,) tensor on {device}")
    if noop is not None and (noop.dtype != torch.int32 or noop.numel() != 1
                             or noop.device != device):
        raise ValueError(f"multi_tensor_adam: noop must be an int32 scalar "
                         f"tensor on {device}")
    numels = np.array([p.numel() for p in params], dtype=np.int64)
    g_codes = np.array([_kernels.dtype_code(g, "multi_tensor_adam")
                        for g in grads], dtype=np.int32)
    p_codes = np.array([_kernels.dtype_code(p, "multi_tensor_adam")
                        for p in params], dtype=np.int32)
    arrays = [_pointers(x) for x in lists]
    launches = ctypes.c_int(0)
    rc = _kernels.lib().apex_multi_tensor_adam(
        n, *(_ptr(a) for a in arrays), _ptr(numels), _ptr(g_codes),
        _ptr(p_codes), scal.data_ptr(),
        None if noop is None else noop.data_ptr(), int(bool(adam_w_mode)),
        ctypes.byref(launches), _kernels.stream())
    _kernels.check(rc, "multi_tensor_adam")
    multi_tensor_adam.launches += launches.value


multi_tensor_adam.launches = 0
