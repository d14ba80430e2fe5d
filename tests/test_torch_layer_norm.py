"""apex_tpu_torch LayerNorm/RMSNorm forward and backward against apex_tpu on
the CPU.

The JAX side runs twice — through its Pallas kernels in interpret mode
(``set_force_pallas(True)``) and through its default path — and both are
held against the port's plain versions (what a CPU tensor takes).
Tolerances: f32 atol 1e-5; bf16 inputs compared in f32 at 1e-2 (one bf16
ulp at |y| ~ 2).  Backward: dx at 1e-5 (f32) / one bf16 ulp 2e-2 (bf16);
dgamma/dbeta, f32 sums over 6 rows of the same products, at 1e-5 (f32) /
1e-4 (bf16 inputs, the sums run in f32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import (FusedLayerNorm as JFusedLayerNorm,
                                    FusedRMSNorm as JFusedRMSNorm,
                                    MixedFusedLayerNorm as JMixedLayerNorm,
                                    MixedFusedRMSNorm as JMixedRMSNorm)
from apex_tpu.ops import layer_norm as jln
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch import normalization as tnorm
from apex_tpu_torch.ops import layer_norm as tln

ROWS, HIDDEN = 6, 40        # hidden off the TPU's 128-lane multiple


@pytest.fixture(params=["pallas_interpret", "jax_default"])
def jax_path(request):
    set_force_pallas(True if request.param == "pallas_interpret" else None)
    yield request.param
    set_force_pallas(None)


def _inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 2, HIDDEN).astype(np.float32) * 2 + 0.5
    w = (1 + 0.1 * rng.randn(HIDDEN)).astype(np.float32)
    b = (0.1 * rng.randn(HIDDEN)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x)
    tx = tx.bfloat16() if dtype == "bf16" else tx
    return jx, tx, w, b


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rms", [False, True])
def test_affine_matches_jax(jax_path, dtype, rms):
    jx, tx, w, b = _inputs(0, dtype)
    if rms:
        ref = jln.fused_rms_norm_affine(jx, jnp.asarray(w))
        out = tln.fused_rms_norm_affine(tx, torch.from_numpy(w))
    else:
        ref = jln.fused_layer_norm_affine(jx, jnp.asarray(w), jnp.asarray(b))
        out = tln.fused_layer_norm_affine(tx, torch.from_numpy(w),
                                          torch.from_numpy(b))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("rms", [False, True])
def test_non_affine_matches_jax(jax_path, rms):
    jx, tx, _, _ = _inputs(1, "f32")
    fn_j = jln.fused_rms_norm if rms else jln.fused_layer_norm
    fn_t = tln.fused_rms_norm if rms else tln.fused_layer_norm
    np.testing.assert_allclose(_f32(fn_t(tx, (HIDDEN,))),
                               _f32(fn_j(jx, (HIDDEN,))),
                               rtol=1e-5, atol=1e-5)


def test_reference_statistics_match_float64():
    """mean/rstd of the plain version are the f64 statistics (E[x^2] -
    mean^2 form), and RMS reports mean 0."""
    rng = np.random.RandomState(2)
    x = rng.randn(ROWS, HIDDEN).astype(np.float32)
    w = np.ones(HIDDEN, np.float32)
    _, mean, rstd = tln.layer_norm_fwd(torch.from_numpy(x),
                                       torch.from_numpy(w), None, 1e-5, False)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mean.numpy()[:, 0], x64.mean(1), atol=1e-6)
    np.testing.assert_allclose(rstd.numpy()[:, 0],
                               1 / np.sqrt(x64.var(1) + 1e-5), rtol=1e-5)
    _, mean, rstd = tln.layer_norm_fwd(torch.from_numpy(x),
                                       torch.from_numpy(w), None, 1e-5, True)
    assert not mean.any()
    np.testing.assert_allclose(rstd.numpy()[:, 0],
                               1 / np.sqrt((x64 ** 2).mean(1) + 1e-5),
                               rtol=1e-5)


@pytest.mark.parametrize("cls_name", ["FusedLayerNorm", "FusedRMSNorm",
                                      "MixedFusedLayerNorm",
                                      "MixedFusedRMSNorm"])
def test_modules_match_jax(cls_name):
    jcls = {"FusedLayerNorm": JFusedLayerNorm, "FusedRMSNorm": JFusedRMSNorm,
            "MixedFusedLayerNorm": JMixedLayerNorm,
            "MixedFusedRMSNorm": JMixedRMSNorm}[cls_name]
    jx, tx, w, b = _inputs(3, "bf16")
    jm = jcls(HIDDEN)
    params = {"weight": jnp.asarray(w)}
    tm = getattr(tnorm, cls_name)(HIDDEN, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(w))
        if tm.bias is not None:
            params["bias"] = jnp.asarray(b)
            tm.bias.copy_(torch.from_numpy(b))
        out = tm(tx)
    ref = jm(params, jx)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=1e-2, atol=1e-2)


def test_forward_only_refuses_grad():
    """Under ``torch.no_grad()`` (the serving path) the module records no
    graph; with grad enabled it is trainable: its output carries the
    backward, and gamma, beta and x all receive gradients."""
    m = tnorm.MixedFusedLayerNorm(HIDDEN, device="cpu")
    x = torch.randn(2, HIDDEN, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    with torch.no_grad():
        assert m(x).grad_fn is None
    y = m(x)
    assert y.grad_fn is not None
    (y * torch.arange(HIDDEN, dtype=torch.float32)).sum().backward()
    assert x.grad is not None and m.weight.grad is not None
    assert m.bias.grad is not None and x.grad.abs().sum() > 0


def _bwd_inputs(dtype):
    jx, tx, w, b = _inputs(4, dtype)
    dy = np.random.RandomState(5).randn(*tx.shape).astype(np.float32)
    jdy = jnp.asarray(dy, jx.dtype)
    tdy = torch.from_numpy(dy).to(tx.dtype)
    return jx, tx, w, b, jdy, tdy


def _jax_grads(jx, w, b, jdy, rms, memory_efficient):
    if rms:
        def f(x, w):
            return jln.fused_rms_norm_affine(
                x, w, memory_efficient=memory_efficient)
        _, pull = jax.vjp(f, jx, jnp.asarray(w))
        return pull(jdy) + (None,)
    def f(x, w, b):
        return jln.fused_layer_norm_affine(
            x, w, b, memory_efficient=memory_efficient)
    _, pull = jax.vjp(f, jx, jnp.asarray(w), jnp.asarray(b))
    return pull(jdy)


def _assert_grads(got, ref, dtype):
    tol_x = 1e-5 if dtype == "f32" else 2e-2
    tol_w = 1e-5 if dtype == "f32" else 1e-4
    np.testing.assert_allclose(_f32(got[0]), _f32(ref[0]), rtol=tol_x,
                               atol=tol_x)
    for g, r in zip(got[1:], ref[1:]):
        if r is None:
            assert g is None
            continue
        np.testing.assert_allclose(_f32(g), _f32(r), rtol=tol_w, atol=tol_w)


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rms", [False, True])
def test_autograd_grads_match_jax(jax_path, rms, dtype, memory_efficient):
    """``jax.vjp`` of the JAX op against ``backward`` through the port's
    autograd Function (forward kernel wrapper + backward kernel wrapper)."""
    jx, tx, w, b, jdy, tdy = _bwd_inputs(dtype)
    ref = _jax_grads(jx, w, b, jdy, rms, memory_efficient)
    x = tx.clone().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = None if rms else torch.from_numpy(b).requires_grad_()
    if rms:
        y = tln.fused_rms_norm_affine(x, tw, memory_efficient=memory_efficient)
    else:
        y = tln.fused_layer_norm_affine(x, tw, tb,
                                        memory_efficient=memory_efficient)
    y.backward(tdy)
    assert x.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32
    _assert_grads((x.grad, tw.grad, None if rms else tb.grad), ref, dtype)


@pytest.mark.parametrize("memory_efficient", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rms", [False, True])
def test_bwd_reference_matches_jax(jax_path, rms, dtype, memory_efficient):
    """The backward kernel's plain version called directly on the saved
    residual (x, or y when ``memory_efficient``) and mean/rstd."""
    jx, tx, w, b, jdy, tdy = _bwd_inputs(dtype)
    ref = _jax_grads(jx, w, b, jdy, rms, memory_efficient)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    x2 = tx.reshape(-1, HIDDEN)
    y2, mean, rstd = tln.layer_norm_fwd_reference(x2, tw, None if rms else tb,
                                                  1e-5, rms)
    dx, dw, db = tln.layer_norm_bwd_reference(
        tdy.reshape(-1, HIDDEN), y2 if memory_efficient else x2, tw,
        None if rms else tb, mean, rstd, rms, memory_efficient)
    assert dx.dtype == tx.dtype and dw.shape == (HIDDEN,)
    _assert_grads((dx.reshape(tx.shape), dw, None if rms else db), ref,
                  dtype)


def test_from_y_guards_zero_gamma():
    """memory_efficient rebuilds xhat as y / gamma: a zero gamma entry is
    guarded (no NaN), as in the JAX backward."""
    x = torch.randn(4, HIDDEN, generator=torch.Generator().manual_seed(1))
    w = torch.ones(HIDDEN)
    w[3] = 0.0
    b = torch.zeros(HIDDEN)
    y, mean, rstd = tln.layer_norm_fwd_reference(x, w, b, 1e-5, False)
    dx, dw, db = tln.layer_norm_bwd_reference(torch.ones_like(x), y, w, b,
                                              mean, rstd, False, True)
    assert torch.isfinite(dx).all() and torch.isfinite(dw).all()
