"""Fused bias-GELU FFN — port of ``apex_tpu/ops/fused_ffn.py``.

``y = gelu_tanh(x @ W1^T + b1) @ W2^T + b2`` as one op whose forward saves
only the pre-activation ``z1`` (in the activation dtype) and whose backward
recomputes the GELU terms from it, so the ``(tokens, ffn)`` activation
never reaches device memory.  ``W1`` is ``(ffn, k)`` and ``W2`` ``(n, ffn)``,
the ``(out, in)`` layout of the linear layers.

Three kernel wrappers, each with its plain PyTorch version beside it:

* :func:`ffn_fwd` (``csrc/ffn_fwd.cu``, the Pallas ``_ffn_fwd_kernel``)
  returns ``(y, z1)``; a CPU tensor takes :func:`ffn_fwd_reference`;
* :func:`ffn_dx` (``csrc/ffn_bwd.cu``, ``_ffn_dx_kernel``); a CPU tensor
  takes :func:`ffn_dx_reference`;
* :func:`ffn_dw` (``csrc/ffn_bwd.cu``, ``_ffn_dw_kernel``) returns
  ``(dW1, db1, dW2)``; a CPU tensor takes :func:`ffn_dw_reference`.

The plain versions take the kernels' own casts: both products of every
kernel run on operands in the activation dtype (the weights cast to it, as
JAX's ``astype``) with f32 accumulation; the biases are added in f32; the
forward's GELU takes the unrounded f32 z, the backward's GELU and GELU'
the rounded z1; dz is rounded to the activation dtype before dX and dW1,
and db1 sums the f32 dz.  :func:`fused_ffn` is the public op, a
:class:`torch.autograd.Function` over the three (db2 is the f32 row sum of
the output cotangent, a plain reduction as in JAX).  The unfused op order
the model layers run is :func:`fused_ffn_reference`.

The JAX signature's ``block_m`` / ``block_f`` are TPU tile sizes that only
change the order of f32 sums; the port drops them.  A bf16 activation runs
the kernels on the tensor cores; f32 and f16 run their FMA instantiation
(f32 products, f16 casts where JAX casts), about 15x slower in bound.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_tpu_torch import _kernels

_f32 = torch.float32

_GELU_C = 0.7978845608028654   # sqrt(2/pi)
_GELU_A = 0.044715

__all__ = ["fused_ffn", "fused_ffn_reference", "fused_ffn_tp", "ffn_fwd",
           "ffn_fwd_reference", "ffn_dx", "ffn_dx_reference", "ffn_dw",
           "ffn_dw_reference"]


def _gelu(z):
    """tanh-approximate GELU (``jax.nn.gelu(z, approximate=True)``)."""
    return F.gelu(z, approximate="tanh")


def _gelu_grad(z):
    """d/dz of the tanh GELU in closed form, on an f32 tensor."""
    z2 = z * z
    t = torch.tanh(_GELU_C * z * (1.0 + _GELU_A * z2))
    return (0.5 * (1.0 + t)
            + 0.5 * z * (1.0 - t * t) * _GELU_C * (1.0 + 3.0 * _GELU_A * z2))


def _mm(a, b, dt):
    """``a @ b`` in f32 from operands rounded to ``dt`` (the products of
    two bf16 values are exact in f32, as on the tensor cores)."""
    return a.to(dt).to(_f32) @ b.to(dt).to(_f32)


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def fused_ffn_reference(x, w1, b1, w2, b2=None):
    """Unfused reference: the op order of the model FFN path
    (``ColumnParallelLinear`` GEMM + bias, tanh GELU,
    ``RowParallelLinear`` GEMM [+ bias]) at the activation dtype."""
    h = x @ w1.to(x.dtype).t()
    h = h + b1.to(h.dtype)
    h = _gelu(h)
    y = h @ w2.to(h.dtype).t()
    if b2 is not None:
        y = y + b2.to(y.dtype)
    return y


def ffn_fwd_reference(x, w1, b1, w2, b2=None):
    """Plain version of the forward kernel on ``(m, k)`` x: ``(y, z1)``,
    both in x's dtype."""
    dt = x.dtype
    z = _mm(x, w1.t(), dt) + b1.to(_f32)
    h = _gelu(z).to(dt)
    y = _mm(h, w2.t(), dt)
    if b2 is not None:
        y = y + b2.to(_f32)
    return y.to(dt), z.to(dt)


def _dh(dy, z1, w2):
    """``dy @ W2`` (f32) and the f32 GELU' of the rounded z1."""
    return _mm(dy, w2, dy.dtype), z1.to(_f32)


def ffn_dx_reference(dy, z1, w1, w2):
    """Plain version of the dX kernel: ``[(dy W2) * gelu'(z1)] W1`` with dz
    rounded to dy's dtype; returns ``(m, k)`` in dy's dtype."""
    dh, z = _dh(dy, z1, w2)
    dz = (dh * _gelu_grad(z)).to(dy.dtype)
    return _mm(dz, w1, dy.dtype).to(dy.dtype)


def ffn_dw_reference(x, dy, z1, w1, w2):
    """Plain version of the dW kernel: ``(dW1, db1, dW2)`` with dW1 = dz^T x
    (dz rounded to x's dtype) in w1's dtype, db1 the f32 column sums of the
    unrounded dz, dW2 = dy^T gelu(z1) in w2's dtype."""
    dt = x.dtype
    dh, z = _dh(dy, z1, w2)
    dz = dh * _gelu_grad(z)
    dw1 = _mm(dz.t(), x, dt).to(w1.dtype)
    dw2 = _mm(dy.t(), _gelu(z).to(dt), dt).to(w2.dtype)
    return dw1, dz.sum(0), dw2


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_card(kernel, *tensors):
    """Raise unless every tensor is on one CUDA device."""
    dev = tensors[0].device
    if not (dev.type == "cuda" and all(t.device == dev for t in tensors)):
        raise ValueError(f"{kernel}: every operand must be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")


def _check_shapes(kernel, m, k, f, n, **shapes):
    want = dict(x=(m, k), dy=(m, n), z1=(m, f), w1=(f, k), w2=(n, f),
                b1=(f,), b2=(n,))
    for name, shape in shapes.items():
        if tuple(shape) != want[name]:
            raise ValueError(f"{kernel}: {name} is {tuple(shape)}, want "
                             f"{want[name]} (x (m, k), w1 (f, k), w2 (n, f))")


def _operand(t, dt):
    """``t`` in the activation dtype, contiguous (a weight's cast is JAX's
    ``astype``)."""
    return t.to(dt).contiguous()


def _splits(m, f, n_out, device):
    lib = _kernels.lib()
    return lib.apex_ffn_splits(m, f, n_out,
                               _kernels.sm_count(device.index or 0))


def ffn_fwd(x, w1, b1, w2, b2=None):
    """Forward kernel wrapper on ``(m, k)`` x: ``(y (m, n), z1 (m, f))`` in
    x's dtype.  Two launches (the split row kernel, then the fixed-order
    combine of its partials with b2), both counted.  A CPU tensor takes
    :func:`ffn_fwd_reference`."""
    if x.device.type == "cpu":
        return ffn_fwd_reference(x, w1, b1, w2, b2)
    kernel = "ffn_fwd"
    _on_card(kernel, x, w1, b1, w2, *(() if b2 is None else (b2,)))
    m, k = x.shape
    f, n = w1.shape[0], w2.shape[0]
    _check_shapes(kernel, m, k, f, n, x=x.shape, w1=w1.shape, w2=w2.shape,
                  b1=b1.shape, **({} if b2 is None else dict(b2=b2.shape)))
    dt = x.dtype
    code = _kernels.dtype_code(x, kernel)
    x = x.contiguous()
    w1c, w2c = _operand(w1, dt), _operand(w2, dt)
    b1f = _operand(b1, _f32)
    b2f = None if b2 is None else _operand(b2, _f32)
    y = torch.empty((m, n), dtype=dt, device=x.device)
    z1 = torch.empty((m, f), dtype=dt, device=x.device)
    if m == 0:
        return y, z1
    splits = _splits(m, f, n, x.device)
    partial = torch.empty((splits, m, n), dtype=_f32, device=x.device)
    rc = _kernels.lib().apex_ffn_fwd(
        x.data_ptr(), w1c.data_ptr(), b1f.data_ptr(), w2c.data_ptr(),
        None if b2f is None else b2f.data_ptr(), y.data_ptr(),
        z1.data_ptr(), partial.data_ptr(), m, k, f, n, splits, code,
        _kernels.stream())
    _kernels.check(rc, kernel)
    ffn_fwd.launches += 2
    return y, z1


ffn_fwd.launches = 0


def ffn_dx(dy, z1, w1, w2):
    """dX kernel wrapper: ``dy`` ``(m, n)`` and ``z1`` ``(m, f)`` in the
    activation dtype; returns ``(m, k)`` in it.  Two launches (the split
    row kernel, then the fixed-order combine), both counted.  A CPU tensor
    takes :func:`ffn_dx_reference`."""
    if dy.device.type == "cpu":
        return ffn_dx_reference(dy, z1, w1, w2)
    kernel = "ffn_dx"
    _on_card(kernel, dy, z1, w1, w2)
    m, n = dy.shape
    f, k = w1.shape
    _check_shapes(kernel, m, k, f, n, dy=dy.shape, z1=z1.shape, w1=w1.shape,
                  w2=w2.shape)
    dt = dy.dtype
    code = _kernels.dtype_code(dy, kernel)
    if z1.dtype != dt:
        raise TypeError(f"{kernel}: z1 is {z1.dtype}, dy {dt}")
    dy, z1 = dy.contiguous(), z1.contiguous()
    w1c, w2c = _operand(w1, dt), _operand(w2, dt)
    dx = torch.empty((m, k), dtype=dt, device=dy.device)
    if m == 0:
        return dx
    splits = _splits(m, f, k, dy.device)
    partial = torch.empty((splits, m, k), dtype=_f32, device=dy.device)
    rc = _kernels.lib().apex_ffn_dx(
        dy.data_ptr(), z1.data_ptr(), w1c.data_ptr(), w2c.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), m, k, f, n, splits, code,
        _kernels.stream())
    _kernels.check(rc, kernel)
    ffn_dx.launches += 2
    return dx


ffn_dx.launches = 0


def ffn_dw(x, dy, z1, w1, w2):
    """dW kernel wrapper: ``(dW1 (f, k) in w1's dtype, db1 (f,) f32, dW2
    (n, f) in w2's dtype)``, each entry summed over all tokens by one block
    in a fixed order (no atomics).  One launch.  A CPU tensor takes
    :func:`ffn_dw_reference`."""
    if x.device.type == "cpu":
        return ffn_dw_reference(x, dy, z1, w1, w2)
    kernel = "ffn_dw"
    _on_card(kernel, x, dy, z1, w1, w2)
    m, k = x.shape
    f, n = w1.shape[0], w2.shape[0]
    _check_shapes(kernel, m, k, f, n, x=x.shape, dy=dy.shape, z1=z1.shape,
                  w1=w1.shape, w2=w2.shape)
    dt = x.dtype
    code = _kernels.dtype_code(x, kernel)
    if dy.dtype != dt or z1.dtype != dt:
        raise TypeError(f"{kernel}: x, dy and z1 must share a dtype, got "
                        f"{x.dtype}, {dy.dtype}, {z1.dtype}")
    c1, c2 = _kernels.dtype_code(w1, kernel), _kernels.dtype_code(w2, kernel)
    x, dy, z1 = x.contiguous(), dy.contiguous(), z1.contiguous()
    w2c = _operand(w2, dt)
    dw1 = torch.empty((f, k), dtype=w1.dtype, device=x.device)
    db1 = torch.empty((f,), dtype=_f32, device=x.device)
    dw2 = torch.empty((n, f), dtype=w2.dtype, device=x.device)
    rc = _kernels.lib().apex_ffn_dw(
        x.data_ptr(), dy.data_ptr(), z1.data_ptr(), w2c.data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), m, k, f, n, code,
        c1, c2, _kernels.stream())
    _kernels.check(rc, kernel)
    ffn_dw.launches += 1
    return dw1, db1, dw2


ffn_dw.launches = 0


class _FusedFFN(torch.autograd.Function):
    """Forward kernel, then the dX and dW kernels (the JAX ``_ffn`` custom
    VJP).  Saves ``(x, w1, b1, w2, b2, z1)``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        y, z1 = ffn_fwd(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, b1, w2, b2, z1)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, z1 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dy = dy.to(x.dtype).contiguous()
        dx = dw1 = db1 = dw2 = db2 = None
        if need[0]:
            dx = ffn_dx(dy, z1, w1, w2)
        if need[1] or need[2] or need[3]:
            dw1, db1, dw2 = ffn_dw(x, dy, z1, w1, w2)
            dw1 = dw1 if need[1] else None
            db1 = db1.to(b1.dtype) if need[2] else None
            dw2 = dw2 if need[3] else None
        if b2 is not None and need[4]:
            db2 = dy.to(_f32).sum(0).to(b2.dtype)
        return dx, dw1, db1, dw2, db2


def fused_ffn(x, w1, b1, w2, b2=None):
    """Fused ``gelu(x @ w1^T + b1) @ w2^T [+ b2]`` over ``(..., k)``.

    ``w1`` is ``(ffn_hidden, k)`` and ``w2`` ``(out, ffn_hidden)``;
    ``b2=None`` skips the second bias.  Differentiable in every operand;
    the forward saves only the ``(m, ffn_hidden)`` pre-activation for the
    backward.  A CUDA tensor runs the three kernels; a CPU tensor their
    plain versions."""
    if x.shape[-1] != w1.shape[1]:
        raise ValueError(f"x features {x.shape[-1]} != w1 in-dim "
                         f"{w1.shape[1]}")
    if tuple(b1.shape) != (w1.shape[0],):
        raise ValueError(f"b1 shape {tuple(b1.shape)} != ({w1.shape[0]},)")
    if w2.shape[1] != w1.shape[0]:
        raise ValueError(f"w2 in-dim {w2.shape[1]} != w1 out-dim "
                         f"{w1.shape[0]}")
    if b2 is not None and tuple(b2.shape) != (w2.shape[0],):
        raise ValueError(f"b2 shape {tuple(b2.shape)} != ({w2.shape[0]},)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    lead = x.shape[:-1]
    y = _FusedFFN.apply(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2)
    return y.reshape(*lead, w2.shape[0])


def fused_ffn_tp(x, w1, b1, w2, b2, *, tensor_parallel_size=1,
                 axis_name=None, sequence_parallel=False, seq_dim=1):
    """The model-side fused FFN block at tensor-parallel size 1:
    :func:`fused_ffn`.  The sharded forms (column-sharded fc1, row-sharded
    fc2 and their collectives) come with the multi-GPU slice."""
    if (tensor_parallel_size or 1) != 1 or sequence_parallel:
        raise NotImplementedError(
            "fused_ffn_tp with tensor_parallel_size > 1 or "
            "sequence_parallel comes with the multi-GPU slice of "
            "apex_tpu_torch")
    return fused_ffn(x, w1, b1, w2, b2)
