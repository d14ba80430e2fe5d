"""apex_tpu_torch LayerNorm/RMSNorm forward against apex_tpu on the CPU.

The JAX side runs twice — through its Pallas kernel in interpret mode
(``set_force_pallas(True)``) and through its default path — and both are
held against the port's plain version (what a CPU tensor takes).
Tolerances: f32 atol 1e-5; bf16 inputs compared in f32 at 1e-2 (one bf16
ulp at |y| ~ 2).
"""

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
    m = tnorm.MixedFusedLayerNorm(HIDDEN, device="cpu")
    with pytest.raises(NotImplementedError, match="training slice"):
        m(torch.zeros(2, HIDDEN))
