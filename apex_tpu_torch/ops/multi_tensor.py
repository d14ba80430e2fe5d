"""Multi-tensor kernels — port of ``apex_tpu/ops/multi_tensor.py`` (scale,
axpby, L2 norm, Adam, SGD, the two LAMB stages, Adagrad, NovoGrad).

Each function updates or reads lists of tensors with one multi-tensor
launch set (apex's ``multi_tensor_apply`` design, the by-value table of
``csrc/multi_tensor.cuh``): a CUDA tensor launches its kernel, a CPU tensor
takes the function's plain version (``*_reference``), which applies the JAX
single-source math (:func:`_adam_math`, :func:`_sgd_math`,
:func:`_lamb_stage1_math`, :func:`_adagrad_math`, :func:`_novograd_math`)
tensor by tensor.

* :func:`multi_tensor_scale_` — ``out = x * s`` with found-inf
  (``csrc/multi_tensor_scale.cu``, the Pallas ``_scale_kernel``);
* :func:`multi_tensor_axpby_` — ``out = a * x + b * y`` with found-inf
  (``csrc/multi_tensor_axpby.cu``, ``_axpby_kernel``);
* :func:`multi_tensor_sumsq` — sums of squares, global and per tensor,
  with found-inf (``csrc/multi_tensor_l2norm.cu``, ``_l2norm_kernel``; the
  norms are :func:`apex_tpu_torch.multi_tensor_apply.multi_tensor_l2norm`);
* :func:`multi_tensor_adam` (``csrc/multi_tensor_adam.cu``,
  ``_adam_kernel``);
* :func:`multi_tensor_sgd` (``csrc/multi_tensor_sgd.cu``, ``_sgd_kernel``);
* :func:`multi_tensor_lamb_stage1` / :func:`multi_tensor_lamb_stage2`
  (``csrc/multi_tensor_lamb.cu``, ``_lamb_stage1_kernel`` /
  ``_lamb_stage2_kernel``);
* :func:`multi_tensor_adagrad` (``csrc/multi_tensor_adagrad.cu``,
  ``_adagrad_kernel``);
* :func:`multi_tensor_novograd` (``csrc/multi_tensor_novograd.cu``,
  ``_novograd_kernel``; the per-tensor second moment comes from
  :func:`multi_tensor_sumsq`).

The optimizer kernels (SGD, Adagrad, NovoGrad) take a ``copies`` list
beside the parameters, as LAMB stage 2 does: where an entry is set (the
parameter is an f32 master) the new value is also written there, rounded
to its dtype (the model's parameter), in the same pass.

The TPU kernels reduce per 128-lane row; these reduce per 64K-element chunk
of each tensor (:data:`CHUNK`), and the chunk partials of a call are laid
out tensor after tensor (:func:`chunk_counts`).  Scalars ride in f32 device
tensors (``scal``) and the skip flag in an int32 device tensor ``noop``;
found-inf flags are f32 device scalars (0.0 / 1.0): the kernels read and
write them on the card, so neither a learning-rate change nor a
dynamic-loss-scale skip needs a host sync.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from apex_tpu_torch import _kernels

_f32 = torch.float32

# elements per block of the multi-tensor kernels (csrc/multi_tensor.cuh)
CHUNK = 65536

__all__ = ["multi_tensor_scale_", "multi_tensor_scale_reference",
           "multi_tensor_sumsq", "multi_tensor_sumsq_reference",
           "multi_tensor_adam", "multi_tensor_adam_reference",
           "multi_tensor_lamb_stage1", "multi_tensor_lamb_stage1_reference",
           "multi_tensor_lamb_stage2", "multi_tensor_lamb_stage2_reference",
           "multi_tensor_axpby_", "multi_tensor_axpby_reference",
           "multi_tensor_sgd", "multi_tensor_sgd_reference",
           "multi_tensor_adagrad", "multi_tensor_adagrad_reference",
           "multi_tensor_novograd", "multi_tensor_novograd_reference",
           "chunk_counts", "device_scalars", "_adam_math", "_sgd_math",
           "_lamb_stage1_math", "_adagrad_math", "_novograd_math"]


def chunk_counts(numels):
    """Chunks (one block, one partial each) of tensors of these sizes."""
    return [-(-int(n) // CHUNK) if n > 0 else 0 for n in numels]


def device_scalars(values, device):
    """One f32 ``(len(values),)`` tensor on ``device`` from Python numbers
    and device scalars, with no host-to-device copy (a copy from pageable
    host memory would wait for the stream)."""
    return torch.stack([
        v.to(device=device, dtype=_f32).reshape(())
        if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=_f32, device=device)
        for v in values])


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


# ---------------------------------------------------------------------------
# shared checks of the CUDA wrappers
# ---------------------------------------------------------------------------

def _cuda_device(kernel, tensors):
    """The one device of ``tensors``: "cpu" (the plain version runs) or a
    CUDA device; anything else raises."""
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {device}")
    return device


def _check_lists(kernel, device, lists, f32_lists=()):
    """Per position the tensors of ``lists`` share one shape; every tensor
    is contiguous and on ``device``; the lists named in ``f32_lists`` (by
    index) hold f32 tensors.  ``None`` entries are skipped."""
    for row in zip(*lists):
        shape = row[0].shape
        for j, t in enumerate(row):
            if t is None:
                continue
            if t.shape != shape:
                raise ValueError(f"{kernel}: tensors of one position disagree "
                                 f"in shape: {tuple(shape)} and "
                                 f"{tuple(t.shape)}")
            if t.device != device or not t.is_contiguous():
                raise ValueError(f"{kernel}: every tensor must be contiguous "
                                 f"and on {device}")
            if j in f32_lists and t.dtype != _f32:
                raise TypeError(f"{kernel}: list {j} must hold f32 tensors")


def _check_scalars(kernel, device, t, n, dtype=_f32):
    if (t.dtype != dtype or t.numel() != n or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{kernel}: expected a contiguous {dtype} tensor of "
                         f"{n} element(s) on {device}")


def _codes(tensors, kernel):
    return np.array([0 if t is None else _kernels.dtype_code(t, kernel)
                     for t in tensors], dtype=np.int32)


def _numels(tensors):
    return np.array([t.numel() for t in tensors], dtype=np.int64)


def _addresses(tensors):
    return np.array([0 if t is None else t.data_ptr() for t in tensors],
                    dtype=np.uint64)


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)



# ---------------------------------------------------------------------------
# adam (#18)
# ---------------------------------------------------------------------------

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
    if any(len(x) != len(params) for x in lists):
        raise ValueError("multi_tensor_adam: the four lists differ in length")
    if not params:
        return
    device = _cuda_device("multi_tensor_adam", params)
    if device.type == "cpu":
        return multi_tensor_adam_reference(grads, params, exp_avgs,
                                           exp_avg_sqs, scal, noop,
                                           adam_w_mode)
    _check_lists("multi_tensor_adam", device, lists, f32_lists=(2, 3))
    _check_scalars("multi_tensor_adam", device, scal, 8)
    if noop is not None:
        _check_scalars("multi_tensor_adam", device, noop, 1, torch.int32)
    arrays = [_addresses(x) for x in lists] + [
        _numels(params), _codes(grads, "multi_tensor_adam"),
        _codes(params, "multi_tensor_adam")]
    launches = ctypes.c_int(0)
    rc = _kernels.lib().apex_multi_tensor_adam(
        len(params), *(_ptr(a) for a in arrays), scal.data_ptr(),
        None if noop is None else noop.data_ptr(), int(bool(adam_w_mode)),
        ctypes.byref(launches), _kernels.stream())
    _kernels.check(rc, "multi_tensor_adam")
    multi_tensor_adam.launches += launches.value


multi_tensor_adam.launches = 0


# ---------------------------------------------------------------------------
# scale (#15)
# ---------------------------------------------------------------------------

@torch.no_grad()
def multi_tensor_scale_reference(inputs, outputs, scale):
    """Plain version: ``out = (x in f32) * scale`` rounded to each output's
    dtype; returns the f32 found-inf flag of the scaled values."""
    s = torch.as_tensor(scale, dtype=_f32).reshape(())
    bad = torch.zeros((), dtype=torch.bool, device=inputs[0].device)
    for x, out in zip(inputs, outputs):
        y = x.to(_f32) * s.to(x.device)
        bad = bad | ~torch.all(torch.isfinite(y))
        out.copy_(y)
    return bad.to(_f32)


@torch.no_grad()
def multi_tensor_scale_(inputs, outputs, scale):
    """``outputs[i] = inputs[i] * scale`` for all ``i``, in place in
    ``outputs`` (same shapes; dtypes f32, bf16 or f16 each, and an output
    may be its input).  ``scale``: a float or an f32 device scalar.
    Returns the found-inf flag (f32 scalar tensor, 1.0 where a scaled value
    is not finite).  CPU tensors take :func:`multi_tensor_scale_reference`;
    CUDA tensors launch ``csrc/multi_tensor_scale.cu`` (launches added to
    ``multi_tensor_scale_.launches``) or raise."""
    if len(outputs) != len(inputs):
        raise ValueError("multi_tensor_scale_: the lists differ in length")
    if not inputs:
        return torch.zeros((), dtype=_f32)
    device = _cuda_device("multi_tensor_scale_", inputs)
    if device.type == "cpu":
        return multi_tensor_scale_reference(inputs, outputs, scale)
    _check_lists("multi_tensor_scale_", device, (inputs, outputs))
    s = device_scalars([scale], device)
    found_inf = torch.zeros((), dtype=_f32, device=device)
    arrays = [_addresses(inputs), _addresses(outputs), _numels(inputs),
              _codes(inputs, "multi_tensor_scale_"),
              _codes(outputs, "multi_tensor_scale_")]
    launches = ctypes.c_int(0)
    rc = _kernels.lib().apex_multi_tensor_scale(
        len(inputs), *(_ptr(a) for a in arrays), s.data_ptr(),
        found_inf.data_ptr(), ctypes.byref(launches), _kernels.stream())
    _kernels.check(rc, "multi_tensor_scale_")
    multi_tensor_scale_.launches += launches.value
    return found_inf


multi_tensor_scale_.launches = 0


# ---------------------------------------------------------------------------
# sums of squares (#17)
# ---------------------------------------------------------------------------

@torch.no_grad()
def multi_tensor_sumsq_reference(tensors, per_tensor=False):
    """Plain version: ``(sum of x^2 over all tensors, per-tensor sums or
    None, found-inf of the inputs)``, all f32 and in f32."""
    sums = torch.stack([torch.sum(torch.square(x.to(_f32))) for x in tensors])
    bad = torch.zeros((), dtype=torch.bool, device=tensors[0].device)
    for x in tensors:
        bad = bad | ~torch.all(torch.isfinite(x))
    return torch.sum(sums), (sums if per_tensor else None), bad.to(_f32)


@torch.no_grad()
def multi_tensor_sumsq(tensors, per_tensor=False):
    """Sums of squares of a list of tensors (f32, bf16 or f16 each, any
    shapes): returns ``(total, per_tensor_sums, found_inf)``: ``total`` the
    f32 sum of x^2 over every element, ``per_tensor_sums`` an f32 ``(n,)``
    tensor when ``per_tensor`` (else None), ``found_inf`` 1.0 where an
    input is not finite.  The norms are their square roots
    (:func:`apex_tpu_torch.multi_tensor_apply.multi_tensor_l2norm`).  CPU
    tensors take :func:`multi_tensor_sumsq_reference`; CUDA tensors launch
    ``csrc/multi_tensor_l2norm.cu`` (per-chunk partials, then a fixed-order
    sum by a second kernel: bit for bit repeatable; the launches of both
    added to ``multi_tensor_sumsq.launches``) or raise."""
    if not tensors:
        raise ValueError("multi_tensor_sumsq: no tensors")
    device = _cuda_device("multi_tensor_sumsq", tensors)
    if device.type == "cpu":
        return multi_tensor_sumsq_reference(tensors, per_tensor)
    _check_lists("multi_tensor_sumsq", device, (tensors,))
    numels = _numels(tensors)
    partials = torch.empty(max(1, sum(chunk_counts(numels))), dtype=_f32,
                           device=device)
    per = (torch.empty(len(tensors), dtype=_f32, device=device)
           if per_tensor else None)
    total = torch.empty((), dtype=_f32, device=device)
    found_inf = torch.zeros((), dtype=_f32, device=device)
    arrays = [_addresses(tensors), numels, _codes(tensors,
                                                  "multi_tensor_sumsq")]
    launches = ctypes.c_int(0)
    rc = _kernels.lib().apex_multi_tensor_l2norm(
        len(tensors), *(_ptr(a) for a in arrays), partials.data_ptr(),
        None if per is None else per.data_ptr(), total.data_ptr(),
        found_inf.data_ptr(), ctypes.byref(launches), _kernels.stream())
    _kernels.check(rc, "multi_tensor_sumsq")
    multi_tensor_sumsq.launches += launches.value
    return total, per, found_inf


multi_tensor_sumsq.launches = 0


# ---------------------------------------------------------------------------
# LAMB stage 1 (#20) and stage 2 (#21)
# ---------------------------------------------------------------------------

def _lamb_stage1_math(adam_w_mode, scal, skip, g, p, m, v):
    """Pure f32 LAMB stage 1 (the JAX ``_lamb_stage1_math``): moments, raw
    update ``u`` and the row sums of u^2 and p^2.

    scal: [beta1, beta2, eps, wd, bc1, bc2, grad_scale, clip, beta3]
    (beta3 = 1-beta1 with grad averaging, else 1.0).
    """
    beta1, beta2, eps, wd, bc1, bc2, gscale, clip, beta3 = (
        scal[k] for k in range(9))
    g = g * gscale * clip
    if not adam_w_mode:
        g = g + wd * p
    m_new = beta1 * m + beta3 * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w_mode:
        u = u + wd * p
    u = torch.where(skip, torch.zeros_like(u), u)
    return (u,
            torch.where(skip, m, m_new),
            torch.where(skip, v, v_new),
            torch.sum(u * u, dim=1, keepdim=True),
            torch.sum(p * p, dim=1, keepdim=True))


def _chunked(x):
    """``x`` flattened in f32 and zero-padded to ``(chunks, CHUNK)`` rows:
    row sums are the kernels' chunk partials (a zero pad adds nothing)."""
    flat = x.reshape(-1).to(_f32)
    pad = -flat.numel() % CHUNK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, CHUNK)


@torch.no_grad()
def multi_tensor_lamb_stage1_reference(grads, params, exp_avgs, exp_avg_sqs,
                                       updates, scal, noop=None,
                                       adam_w_mode=True):
    """Plain version: :func:`_lamb_stage1_math` over each tensor's chunks;
    m, v and u copied into their tensors.  Returns the chunk partials
    ``(u_sq, p_sq)``."""
    skip = _skip(noop, params[0].device)
    scal = scal.to(_f32)
    usq, psq = [], []
    for g, p, m, v, u in zip(grads, params, exp_avgs, exp_avg_sqs, updates):
        n = p.numel()
        u2, m2, v2, us, ps = _lamb_stage1_math(
            bool(adam_w_mode), scal, skip, _chunked(g), _chunked(p),
            _chunked(m), _chunked(v))
        for dst, src in ((u, u2), (m, m2), (v, v2)):
            dst.copy_(src.reshape(-1)[:n].reshape(dst.shape))
        usq.append(us.reshape(-1))
        psq.append(ps.reshape(-1))
    return torch.cat(usq), torch.cat(psq)


@torch.no_grad()
def multi_tensor_lamb_stage1(grads, params, exp_avgs, exp_avg_sqs, updates,
                             scal, noop=None, adam_w_mode=True):
    """LAMB stage 1 over lists of tensors: moments (in place), the raw
    update ``u`` (into ``updates``) and the chunk partials of u^2 and p^2.

    ``grads``/``params``: f32, bf16 or f16 (``params`` are the f32 masters
    under master weights); ``exp_avgs``/``exp_avg_sqs``/``updates``: f32;
    ``scal``: f32 ``(9,)`` device tensor as in :func:`_lamb_stage1_math`;
    ``noop``: optional int32 scalar tensor (non-zero: u = 0, moments kept).
    Returns ``(u_sq, p_sq)``, f32 ``(chunks,)`` partials laid out tensor
    after tensor (:func:`chunk_counts`), for
    :func:`multi_tensor_lamb_stage2`.  CPU tensors take
    :func:`multi_tensor_lamb_stage1_reference`; CUDA tensors launch
    ``csrc/multi_tensor_lamb.cu`` (launches added to
    ``multi_tensor_lamb_stage1.launches``) or raise."""
    lists = (grads, params, exp_avgs, exp_avg_sqs, updates)
    if any(len(x) != len(params) for x in lists) or not params:
        raise ValueError("multi_tensor_lamb_stage1: the five lists must have "
                         "one (non-zero) length")
    device = _cuda_device("multi_tensor_lamb_stage1", params)
    if device.type == "cpu":
        return multi_tensor_lamb_stage1_reference(*lists, scal, noop,
                                                  adam_w_mode)
    _check_lists("multi_tensor_lamb_stage1", device, lists, f32_lists=(2, 3,
                                                                      4))
    _check_scalars("multi_tensor_lamb_stage1", device, scal, 9)
    if noop is not None:
        _check_scalars("multi_tensor_lamb_stage1", device, noop, 1,
                       torch.int32)
    numels = _numels(params)
    n_chunks = max(1, sum(chunk_counts(numels)))
    usq = torch.empty(n_chunks, dtype=_f32, device=device)
    psq = torch.empty(n_chunks, dtype=_f32, device=device)
    arrays = [_addresses(x) for x in lists] + [
        numels, _codes(grads, "multi_tensor_lamb_stage1"),
        _codes(params, "multi_tensor_lamb_stage1")]
    launches = ctypes.c_int(0)
    rc = _kernels.lib().apex_multi_tensor_lamb_stage1(
        len(params), *(_ptr(a) for a in arrays), scal.data_ptr(),
        None if noop is None else noop.data_ptr(), int(bool(adam_w_mode)),
        usq.data_ptr(), psq.data_ptr(), ctypes.byref(launches),
        _kernels.stream())
    _kernels.check(rc, "multi_tensor_lamb_stage1")
    multi_tensor_lamb_stage1.launches += launches.value
    return usq, psq


multi_tensor_lamb_stage1.launches = 0


def _trust_ratio(u_sq, p_sq, use_nvlamb):
    """||p|| / ||u|| with the JAX rule: 1 where a norm is 0 (use_nvlamb:
    only where ||u|| is 0)."""
    u_norm, p_norm = torch.sqrt(u_sq), torch.sqrt(p_sq)
    apply = u_norm > 0 if use_nvlamb else (p_norm > 0) & (u_norm > 0)
    return torch.where(apply, p_norm / u_norm, torch.ones_like(u_norm))


@torch.no_grad()
def multi_tensor_lamb_stage2_reference(updates, params, copies, u_sq, p_sq,
                                       lr, noop=None, use_nvlamb=False):
    """Plain version: each tensor's trust ratio from its chunk partials,
    then ``p - (lr * ratio) * u`` in f32, copied into ``params`` and, where
    given, ``copies`` (rounded to their dtypes); under ``noop`` nothing
    changes."""
    skip = _skip(noop, params[0].device)
    lr = torch.as_tensor(lr, dtype=_f32).reshape(())
    off = 0
    for u, p, c, nc in zip(updates, params, copies,
                           chunk_counts(t.numel() for t in params)):
        ratio = _trust_ratio(torch.sum(u_sq[off:off + nc]),
                             torch.sum(p_sq[off:off + nc]), use_nvlamb)
        off += nc
        pf = p.to(_f32)
        p_new = torch.where(skip, pf, pf - lr * ratio * u)
        p.copy_(p_new)
        if c is not None:
            c.copy_(torch.where(skip, c, p_new.to(c.dtype)))


@torch.no_grad()
def multi_tensor_lamb_stage2(updates, params, copies, u_sq, p_sq, lr,
                             noop=None, use_nvlamb=False):
    """LAMB stage 2 over the lists stage 1 ran on: per tensor the trust
    ratio from ``u_sq``/``p_sq`` (stage 1's partials), then ``p <- p -
    (lr * ratio) * u`` in place; a non-zero ``noop`` skips the update
    (params and copies keep their values).

    ``updates``: f32; ``params``: f32, bf16 or f16; ``copies``: a list of
    tensors or ``None`` entries — where set (``params`` holds f32 masters)
    the new value is also written there, rounded to its dtype (the model's
    parameter).  ``lr``: a float or f32 device scalar.  CPU tensors take
    :func:`multi_tensor_lamb_stage2_reference`; CUDA tensors launch
    ``csrc/multi_tensor_lamb.cu`` (launches added to
    ``multi_tensor_lamb_stage2.launches``) or raise."""
    if (len(updates) != len(params) or len(copies) != len(params)
            or not params):
        raise ValueError("multi_tensor_lamb_stage2: the three lists must "
                         "have one (non-zero) length")
    device = _cuda_device("multi_tensor_lamb_stage2", params)
    if device.type == "cpu":
        return multi_tensor_lamb_stage2_reference(
            updates, params, copies, u_sq, p_sq, lr, noop, use_nvlamb)
    _check_lists("multi_tensor_lamb_stage2", device,
                 (updates, params, copies), f32_lists=(0,))
    numels = _numels(params)
    n_chunks = max(1, sum(chunk_counts(numels)))
    for t in (u_sq, p_sq):
        _check_scalars("multi_tensor_lamb_stage2", device, t, n_chunks)
    if noop is not None:
        _check_scalars("multi_tensor_lamb_stage2", device, noop, 1,
                       torch.int32)
    lr_t = device_scalars([lr], device)
    arrays = [_addresses(updates), _addresses(params), _addresses(copies),
              numels, _codes(params, "multi_tensor_lamb_stage2"),
              _codes(copies, "multi_tensor_lamb_stage2")]
    launches = ctypes.c_int(0)
    rc = _kernels.lib().apex_multi_tensor_lamb_stage2(
        len(params), *(_ptr(a) for a in arrays), u_sq.data_ptr(),
        p_sq.data_ptr(), lr_t.data_ptr(),
        None if noop is None else noop.data_ptr(), int(bool(use_nvlamb)),
        ctypes.byref(launches), _kernels.stream())
    _kernels.check(rc, "multi_tensor_lamb_stage2")
    multi_tensor_lamb_stage2.launches += launches.value


multi_tensor_lamb_stage2.launches = 0



# ---------------------------------------------------------------------------
# axpby (#16)
# ---------------------------------------------------------------------------

@torch.no_grad()
def multi_tensor_axpby_reference(xs, ys, outs, a, b):
    """Plain version: ``out = a * (x in f32) + b * (y in f32)`` rounded to
    each output's dtype; returns the f32 found-inf flag of the f32 results
    (taken on the output, as the JAX kernel takes it)."""
    a, b = device_scalars([a, b], xs[0].device)
    bad = torch.zeros((), dtype=torch.bool, device=xs[0].device)
    for x, y, out in zip(xs, ys, outs):
        r = a * x.to(_f32) + b * y.to(_f32)
        bad = bad | ~torch.all(torch.isfinite(r))
        out.copy_(r)
    return bad.to(_f32)


@torch.no_grad()
def multi_tensor_axpby_(xs, ys, outs, a, b):
    """``outs[i] = a * xs[i] + b * ys[i]`` for all ``i``, in f32, stored
    in place in ``outs`` (same shapes; f32, bf16 or f16 each, x, y and out
    may all differ, and an output may be one of its inputs).  ``a``, ``b``:
    floats or f32 device scalars.  Returns the found-inf flag (f32 scalar,
    1.0 where a result is not finite).  CPU tensors take
    :func:`multi_tensor_axpby_reference`; CUDA tensors launch
    ``csrc/multi_tensor_axpby.cu`` (launches added to
    ``multi_tensor_axpby_.launches``) or raise."""
    if not len(xs) == len(ys) == len(outs):
        raise ValueError("multi_tensor_axpby_: the lists differ in length")
    if not xs:
        return torch.zeros((), dtype=_f32)
    device = _cuda_device("multi_tensor_axpby_", xs)
    if device.type == "cpu":
        return multi_tensor_axpby_reference(xs, ys, outs, a, b)
    _check_lists("multi_tensor_axpby_", device, (xs, ys, outs))
    ab = device_scalars([a, b], device)
    found_inf = torch.zeros((), dtype=_f32, device=device)
    arrays = [_addresses(xs), _addresses(ys), _addresses(outs), _numels(xs)]
    arrays += [_codes(t, "multi_tensor_axpby_") for t in (xs, ys, outs)]
    launches = ctypes.c_int(0)
    rc = _kernels.lib().apex_multi_tensor_axpby(
        len(xs), *(_ptr(arr) for arr in arrays), ab.data_ptr(),
        found_inf.data_ptr(), ctypes.byref(launches), _kernels.stream())
    _kernels.check(rc, "multi_tensor_axpby_")
    multi_tensor_axpby_.launches += launches.value
    return found_inf


multi_tensor_axpby_.launches = 0


# ---------------------------------------------------------------------------
# the optimizer kernels' shared plain-version loop and launch
# ---------------------------------------------------------------------------

def _copies(copies, n):
    return [None] * n if copies is None else list(copies)


def _write_back(skip, p, p_new, copy):
    """``p_new`` (f32) into the parameter (rounded to its dtype) and, where
    given, into its model copy; under ``skip`` both keep their values."""
    p.copy_(p_new)
    if copy is not None:
        copy.copy_(torch.where(skip, copy, p_new.to(copy.dtype)))


def _launch_optimizer(kernel, fn, lists, scal, n_scal, noop, extra,
                      more_addresses=()):
    """Checks, then the C entry point ``apex_<kernel>`` over ``lists``
    (grads, params, f32 state, copies) with their addresses (and the
    address arrays ``more_addresses``), numels, the dtype codes of grads,
    params and copies, the device scalars, the noop flag and ``extra``
    ints; adds the launches made to ``fn.launches``."""
    device = lists[1][0].device
    _check_lists(kernel, device, lists, f32_lists=(2,))
    _check_scalars(kernel, device, scal, n_scal)
    if noop is not None:
        _check_scalars(kernel, device, noop, 1, torch.int32)
    arrays = [_addresses(x) for x in lists] + list(more_addresses) + [
        _numels(lists[1])] + [_codes(lists[i], kernel) for i in (0, 1, 3)]
    launches = ctypes.c_int(0)
    rc = getattr(_kernels.lib(), "apex_" + kernel)(
        len(lists[1]), *(_ptr(a) for a in arrays), scal.data_ptr(),
        None if noop is None else noop.data_ptr(), *extra,
        ctypes.byref(launches), _kernels.stream())
    _kernels.check(rc, kernel)
    fn.launches += launches.value


# ---------------------------------------------------------------------------
# sgd (#19)
# ---------------------------------------------------------------------------

def _sgd_math(nesterov, first_run, wd_after_momentum, momentum_zero,
              scal, skip, g, p, buf):
    """Pure f32 SGD update (the JAX ``_sgd_math``).
    scal: [lr, wd, momentum, dampening, grad_scale]."""
    lr, wd, mom_c, damp, gscale = (scal[k] for k in range(5))
    g = g * gscale
    if not wd_after_momentum:
        g = g + wd * p
    if momentum_zero:
        new_buf, upd = buf, g
    else:
        new_buf = g if first_run else mom_c * buf + (1.0 - damp) * g
        upd = g + mom_c * new_buf if nesterov else new_buf
    if wd_after_momentum:
        upd = upd + wd * p
    p_new = p - lr * upd
    return torch.where(skip, p, p_new), torch.where(skip, buf, new_buf)


@torch.no_grad()
def multi_tensor_sgd_reference(grads, params, momentum_buffers, copies, scal,
                               noop=None, nesterov=False, first_run=False,
                               wd_after_momentum=False, momentum_zero=False):
    """Plain version: :func:`_sgd_math` per tensor; the new values copied
    into ``params`` (rounded to their dtype), ``momentum_buffers`` and,
    where set, ``copies``."""
    flags = (bool(nesterov), bool(first_run), bool(wd_after_momentum),
             bool(momentum_zero))
    skip = _skip(noop, params[0].device)
    scal = scal.to(_f32)
    for g, p, buf, c in zip(grads, params, momentum_buffers,
                            _copies(copies, len(params))):
        p2, b2 = _sgd_math(*flags, scal, skip, g.to(_f32), p.to(_f32), buf)
        buf.copy_(b2)
        _write_back(skip, p, p2, c)


@torch.no_grad()
def multi_tensor_sgd(grads, params, momentum_buffers, copies, scal,
                     noop=None, nesterov=False, first_run=False,
                     wd_after_momentum=False, momentum_zero=False):
    """One SGD (+ momentum) step over lists of tensors, in place.

    ``grads``/``params``: same-shape contiguous tensors (f32, bf16 or f16;
    ``params`` are the f32 masters under master weights);
    ``momentum_buffers``: f32; ``copies``: None or a list of tensors or
    ``None`` entries, each written with its new parameter rounded to its
    dtype; ``scal``: f32 ``(5,)`` device tensor ``[lr, wd, momentum,
    dampening, grad_scale]``; ``noop``: optional int32 scalar tensor,
    non-zero skips the step (parameters, buffers and copies keep their
    values).  The flags are static, as in JAX: ``first_run`` seeds the
    buffer with the gradient, ``momentum_zero`` skips the buffer.  CPU
    tensors take :func:`multi_tensor_sgd_reference`; CUDA tensors launch
    ``csrc/multi_tensor_sgd.cu`` (launches added to
    ``multi_tensor_sgd.launches``) or raise."""
    copies = _copies(copies, len(params))
    lists = (grads, params, momentum_buffers, copies)
    if any(len(x) != len(params) for x in lists) or not params:
        raise ValueError("multi_tensor_sgd: the four lists must have one "
                         "(non-zero) length")
    device = _cuda_device("multi_tensor_sgd", params)
    if device.type == "cpu":
        return multi_tensor_sgd_reference(grads, params, momentum_buffers,
                                          copies, scal, noop, nesterov,
                                          first_run, wd_after_momentum,
                                          momentum_zero)
    _launch_optimizer("multi_tensor_sgd", multi_tensor_sgd, lists, scal, 5,
                      noop, [int(bool(nesterov)), int(bool(first_run)),
                       int(bool(wd_after_momentum)),
                       int(bool(momentum_zero))])


multi_tensor_sgd.launches = 0


# ---------------------------------------------------------------------------
# adagrad (#22)
# ---------------------------------------------------------------------------

def _adagrad_math(scal, skip, g, p, h):
    """Pure f32 Adagrad update (the JAX ``_adagrad_math``).
    scal: [lr, eps, weight_decay, grad_scale]."""
    lr, eps, wd, gscale = (scal[k] for k in range(4))
    g = g * gscale + wd * p
    h_new = h + g * g
    p_new = p - lr * g / (torch.sqrt(h_new) + eps)
    return torch.where(skip, p, p_new), torch.where(skip, h, h_new)


@torch.no_grad()
def multi_tensor_adagrad_reference(grads, params, sums, copies, scal,
                                   noop=None, adagrad_w_mode=False):
    """Plain version: :func:`_adagrad_math` per tensor (with a zero L2 term
    and then ``p - lr * wd * p_old`` under ``adagrad_w_mode``, the JAX
    optimizer's order); the new values copied into ``params`` (rounded),
    ``sums`` and, where set, ``copies``."""
    skip = _skip(noop, params[0].device)
    scal = scal.to(_f32)
    lr, wd = scal[0], scal[2]
    if adagrad_w_mode:
        scal = torch.stack([scal[0], scal[1], torch.zeros_like(wd), scal[3]])
    for g, p, h, c in zip(grads, params, sums, _copies(copies, len(params))):
        pf = p.to(_f32)
        p2, h2 = _adagrad_math(scal, skip, g.to(_f32), pf, h)
        if adagrad_w_mode:
            p2 = torch.where(skip, pf, p2 - (lr * wd) * pf)
        h.copy_(h2)
        _write_back(skip, p, p2, c)


@torch.no_grad()
def multi_tensor_adagrad(grads, params, sums, copies, scal, noop=None,
                         adagrad_w_mode=False):
    """One Adagrad step over lists of tensors, in place.

    ``sums``: the f32 accumulators h; ``scal``: f32 ``(4,)`` device tensor
    ``[lr, eps, weight_decay, grad_scale]``.  Without ``adagrad_w_mode``
    the decay is L2 in the gradient (the JAX ``_adagrad_math``); with it
    the decay is decoupled, ``p <- p_adagrad - lr * wd * p_old``, in the
    same pass (the JAX optimizer applies it after the kernel, from the old
    p).  ``copies``, ``noop`` and the dtypes as in :func:`multi_tensor_sgd`.
    CPU tensors take :func:`multi_tensor_adagrad_reference`; CUDA tensors
    launch ``csrc/multi_tensor_adagrad.cu`` (launches added to
    ``multi_tensor_adagrad.launches``) or raise."""
    copies = _copies(copies, len(params))
    lists = (grads, params, sums, copies)
    if any(len(x) != len(params) for x in lists) or not params:
        raise ValueError("multi_tensor_adagrad: the four lists must have one "
                         "(non-zero) length")
    device = _cuda_device("multi_tensor_adagrad", params)
    if device.type == "cpu":
        return multi_tensor_adagrad_reference(grads, params, sums, copies,
                                              scal, noop, adagrad_w_mode)
    _launch_optimizer("multi_tensor_adagrad", multi_tensor_adagrad, lists,
                      scal, 4, noop, [int(bool(adagrad_w_mode))])


multi_tensor_adagrad.launches = 0


# ---------------------------------------------------------------------------
# novograd (#23)
# ---------------------------------------------------------------------------

def _novograd_math(reg_inside_moment, scal, skip, g, p, m, v_row):
    """Pure f32 NovoGrad element-wise stage (the JAX ``_novograd_math``).
    scal: [lr, beta1, weight_decay, eps, grad_scale, beta3]; ``v_row`` is
    the tensor's second moment (a scalar, broadcast)."""
    lr, beta1, wd, eps, gscale, beta3 = (scal[k] for k in range(6))
    g = g * gscale
    g = g / (torch.sqrt(v_row) + eps)
    if reg_inside_moment:
        g = g + wd * p
    m_new = beta1 * m + beta3 * g
    update = m_new if reg_inside_moment else m_new + wd * p
    p_new = p - lr * update
    return torch.where(skip, p, p_new), torch.where(skip, m, m_new)


@torch.no_grad()
def multi_tensor_novograd_reference(grads, params, exp_avgs, copies, v, scal,
                                    noop=None, reg_inside_moment=False):
    """Plain version: :func:`_novograd_math` per tensor with its entry of
    ``v``; the new values copied into ``params`` (rounded), ``exp_avgs``
    and, where set, ``copies``."""
    skip = _skip(noop, params[0].device)
    scal = scal.to(_f32)
    for i, (g, p, m, c) in enumerate(zip(grads, params, exp_avgs,
                                         _copies(copies, len(params)))):
        p2, m2 = _novograd_math(bool(reg_inside_moment), scal, skip,
                                g.to(_f32), p.to(_f32), m, v[i])
        m.copy_(m2)
        _write_back(skip, p, p2, c)


@torch.no_grad()
def multi_tensor_novograd(grads, params, exp_avgs, copies, v, scal, noop=None,
                          reg_inside_moment=False):
    """NovoGrad's element-wise stage over lists of tensors, in place.

    ``exp_avgs``: the f32 first moments m; ``v``: one contiguous f32
    ``(n,)`` device tensor, the per-tensor second moments (already updated
    for this step, as the JAX ``novograd_packed`` takes them); ``scal``:
    f32 ``(6,)`` device tensor ``[lr, beta1, weight_decay, eps,
    grad_scale, beta3]``.  ``copies``, ``noop`` and the dtypes as in
    :func:`multi_tensor_sgd`.  CPU tensors take
    :func:`multi_tensor_novograd_reference`; CUDA tensors launch
    ``csrc/multi_tensor_novograd.cu`` (launches added to
    ``multi_tensor_novograd.launches``) or raise."""
    copies = _copies(copies, len(params))
    if (any(len(x) != len(params) for x in (grads, exp_avgs, copies))
            or not params):
        raise ValueError("multi_tensor_novograd: the four lists must have "
                         "one (non-zero) length")
    device = _cuda_device("multi_tensor_novograd", params)
    if device.type == "cpu":
        return multi_tensor_novograd_reference(grads, params, exp_avgs,
                                               copies, v, scal, noop,
                                               reg_inside_moment)
    _check_scalars("multi_tensor_novograd", device, v, len(params))
    # each tensor's v is one f32: the table carries its address as a fifth
    # list (a block knows its table slot, not the tensor's index in the call)
    v_addresses = np.uint64(v.data_ptr()) + np.arange(
        len(params), dtype=np.uint64) * np.uint64(4)
    _launch_optimizer("multi_tensor_novograd", multi_tensor_novograd,
                      (grads, params, exp_avgs, copies), scal, 6, noop,
                      [int(bool(reg_inside_moment))], [v_addresses])


multi_tensor_novograd.launches = 0
