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


# ---------------------------------------------------------------------------
# the card kernel's body choice and its summation orders (csrc/layer_norm_fwd.cu)
# ---------------------------------------------------------------------------

_WIDTHS = [8, 48, 1000, 1024, 1600, 4096, 8192]
# 16-byte vectors a lane of the row-per-warp body holds, by dtype and
# hidden, on the 16-byte grid (0: the block-per-row body)
_PATHS = {"bf16": {8: 1, 48: 1, 1000: 4, 1024: 4, 1600: 0, 4096: 0, 8192: 0,
                   12: 0, 1001: 0},
          "f16": {8: 1, 48: 1, 1000: 4, 1024: 4, 1600: 0, 4096: 0, 8192: 0,
                  12: 0, 1001: 0},
          "f32": {8: 1, 48: 1, 1000: 8, 1024: 8, 1600: 0, 4096: 0, 8192: 0,
                  12: 1, 1001: 0}}
_DT = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


@pytest.mark.parametrize("hidden", _WIDTHS + [12, 1001])
@pytest.mark.parametrize("dtype", sorted(_PATHS))
def test_fwd_path_choice(dtype, hidden):
    """The row-per-warp body takes a row of whole 16-byte vectors, at most
    LN_FWD_LANE_ELEMS elements a lane (hidden <= 1024), with x, w and b on
    the 16-byte grid; every other row takes the block-per-row body."""
    want = _PATHS[dtype][hidden]
    assert tln.layer_norm_fwd_path(hidden, _DT[dtype], True) == want
    assert tln.layer_norm_fwd_path(hidden, _DT[dtype], False) == 0
    if want:
        per_vec = 16 // _DT[dtype].itemsize
        assert hidden % per_vec == 0
        assert (want - 1) * 32 * per_vec < hidden <= want * 32 * per_vec
        assert want * per_vec <= tln.LN_FWD_LANE_ELEMS


def test_fwd_lane_elements_are_the_kernels():
    import re
    from apex_tpu_torch import _kernels
    src = (_kernels.CSRC / "layer_norm_fwd.cu").read_text()
    assert int(re.search(r"kLnMaxLaneElems = (\d+);", src).group(1)) \
        == tln.LN_FWD_LANE_ELEMS


def _xor_tree(partials):
    """``warp_sum`` over the last axis (32 lanes): lane ^ 16, ^ 8, ... ^ 1,
    in f32; every lane ends with the same value."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        partials = partials + partials[..., lanes ^ o]
    return partials[..., 0]


def _fma32(acc, a, b):
    """fma(a, b, acc) in f32: the exact product, one rounding (the kernel's
    ``ss += v * v`` contracts)."""
    return (acc.astype(np.float64) + a.astype(np.float64) * b).astype(
        np.float32)


def _kernel_order_sums(xf, itemsize):
    """sum x and sum x*x of each row in the order of the body
    ``layer_norm_fwd_path`` picks: the row-per-warp body's lane partials
    (lane l takes vectors l, l + 32, ..., element by element) combined by
    ``warp_sum``; or the block-per-row body's 256 thread partials (stride
    256), ``warp_sum`` in each of the 8 warps, then over the 8 warp sums.
    Returns (s, ss, chain): chain is the longest run of f32 additions from
    an element to the row's sum."""
    rows, hidden = xf.shape
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    nv = tln.layer_norm_fwd_path(hidden, dtype, True)
    if nv:
        per_vec = 16 // itemsize
        s = np.zeros((rows, 32), np.float32)
        ss = np.zeros((rows, 32), np.float32)
        lanes = np.arange(32)
        for j in range(nv):
            v = j * 32 + lanes
            ok = v < hidden // per_vec
            for k in range(per_vec):
                e = xf[:, v[ok] * per_vec + k]
                s[:, ok] = s[:, ok] + e
                ss[:, ok] = _fma32(ss[:, ok], e, e)
        return _xor_tree(s), _xor_tree(ss), nv * per_vec + 5
    s = np.zeros((rows, 256), np.float32)
    ss = np.zeros((rows, 256), np.float32)
    for i in range(hidden):
        e = xf[:, i]
        s[:, i % 256] = s[:, i % 256] + e
        ss[:, i % 256] = _fma32(ss[:, i % 256], e, e)
    pad = np.zeros((rows, 24), np.float32)
    s = np.concatenate([_xor_tree(s.reshape(rows, 8, 32)), pad], 1)
    ss = np.concatenate([_xor_tree(ss.reshape(rows, 8, 32)), pad], 1)
    return _xor_tree(s), _xor_tree(ss), -(-hidden // 256) + 10


def _kernel_order_fwd(x, w, b, eps, rms, itemsize):
    """f32 emulation of the card kernel's forward: its sums
    (``_kernel_order_sums``), then the JAX math (mean, E[x^2] - mean^2,
    1 / sqrt in place of rsqrtf)."""
    xf = np.asarray(x, np.float32)
    s, ss, chain = _kernel_order_sums(xf, itemsize)
    inv_h = np.float32(1.0 / xf.shape[1])
    mean = np.zeros_like(s) if rms else s * inv_h
    ms = ss * inv_h
    var = ms if rms else ms - mean * mean
    rstd = (np.float32(1.0) / np.sqrt(var + np.float32(eps))).astype(
        np.float32)
    y = (xf - mean[:, None]) * rstd[:, None] * w
    if b is not None:
        y = y + b
    return y, mean[:, None], rstd[:, None], chain


def _ln_rows(seed, hidden, ratio):
    """12 rows of 2 N(0, 1) + 0.5 and 4 rows of N(0, 1) + ratio (|mean| /
    std = ratio: E[x^2] - mean^2 cancels), and f32 w, b."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.randn(12, hidden) * 2 + 0.5,
                        rng.randn(4, hidden) + ratio]).astype(np.float32)
    w = (1 + 0.1 * rng.randn(hidden)).astype(np.float32)
    b = (0.1 * rng.randn(hidden)).astype(np.float32)
    return x, w, b


# phase-2 tolerances of chip_smoke.py (y by dtype; mean, rstd)
_Y_TOL = {"bf16": (2e-2, 2e-2), "f32": (1e-5, 1e-5)}
_MEAN_TOL, _RSTD_TOL = (1e-5, 1e-5), (1e-5, 1e-4)


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("hidden", _WIDTHS)
def test_kernel_order_matches_jax_kernel_and_reference(hidden, dtype, rms):
    """The card kernel's summation order, emulated in f32, against the JAX
    ``_fwd_kernel`` (Pallas, interpret mode) and the plain version, at the
    phase-2 tolerances: normal rows and rows whose mean is 16 standard
    deviations (where E[x^2] - mean^2 loses about 8 bits in f32; there y
    is held at its tolerance plus the mean and rstd tolerances carried
    through y = (x - mean) rstd w + b: (1e-5 + 1e-5 |mean|) rstd max|w|
    more absolute, 1e-4 relative)."""
    x, w, b = _ln_rows(7, hidden, 16.0)
    bias = None if rms else b
    tx = torch.from_numpy(x).to(_DT[dtype])
    xq = tx.float().numpy()
    ey, emean, erstd, _ = _kernel_order_fwd(xq, w, bias, 1e-5, rms,
                                            tx.element_size())
    ey = torch.from_numpy(ey).to(_DT[dtype]).float().numpy()
    set_force_pallas(True)
    try:
        (jy, jmean, jrstd), _ = jln._norm_fwd(
            jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32),
            jnp.asarray(w), None if bias is None else jnp.asarray(bias),
            hidden, 1e-5, rms, False)
    finally:
        set_force_pallas(None)
    ry, rmean, rrstd = tln.layer_norm_fwd_reference(
        tx, torch.from_numpy(w), None if bias is None else
        torch.from_numpy(bias), 1e-5, rms)
    for ref_y, ref_mean, ref_rstd in ((_f32(jy), _f32(jmean), _f32(jrstd)),
                                      (_f32(ry), _f32(rmean), _f32(rrstd))):
        atol, rtol = _Y_TOL[dtype]
        np.testing.assert_allclose(ey[:12], ref_y[:12], atol=atol, rtol=rtol)
        carried = ((_MEAN_TOL[0] + _MEAN_TOL[1] * np.abs(ref_mean[12:]))
                   * ref_rstd[12:] * np.abs(w).max())
        assert (np.abs(ey[12:] - ref_y[12:])
                <= atol + carried + max(rtol, _RSTD_TOL[1])
                * np.abs(ref_y[12:])).all()
        np.testing.assert_allclose(emean, ref_mean, atol=_MEAN_TOL[0],
                                   rtol=_MEAN_TOL[1])
        np.testing.assert_allclose(erstd, ref_rstd, atol=_RSTD_TOL[0],
                                   rtol=_RSTD_TOL[1])


@pytest.mark.parametrize("hidden", _WIDTHS)
def test_kernel_order_error_is_within_its_bound_where_the_form_cancels(
        hidden):
    """At |mean| = 100 std the E[x^2] - mean^2 form in f32 keeps few bits
    in any order (the plain version's rstd is ~1e-3 off the f64 value at
    hidden 1024; f32 rows, the f32 body's order):
    the kernel order's rstd stays within the a-priori bound of its
    summation tree (chain c of additions: |d sum| <= gamma_c sum|.|, gamma_c
    = c u / (1 - c u), u = 2**-24), carried through var and rsqrt."""
    x, w, _ = _ln_rows(8, hidden, 100.0)
    _, _, erstd, chain = _kernel_order_fwd(x, w, None, 1e-5, False, 4)
    x64 = x.astype(np.float64)
    var = x64.var(1)
    truth = 1 / np.sqrt(var + 1e-5)
    u = 2.0 ** -24
    gamma = (chain + 2) * u / (1 - (chain + 2) * u)
    ms, amean = (x64 ** 2).mean(1), np.abs(x64).mean(1)
    d_var = gamma * ms + 2 * np.abs(x64.mean(1)) * gamma * amean \
        + (gamma * amean) ** 2 + 2 * u * ms
    bound = 0.5 * d_var / (var + 1e-5) + 4 * u
    err = np.abs(erstd[:, 0] - truth) / truth
    assert (err <= bound).all(), (err.max(), bound.min())
    if hidden >= 48:
        assert err[12:].max() > 1e-5      # the rows do cancel


# ---------------------------------------------------------------------------
# the backward kernel's body choice, row walk and summation orders
# (csrc/layer_norm_bwd.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden", _WIDTHS + [12, 1001])
@pytest.mark.parametrize("dtype", sorted(_PATHS))
def test_bwd_path_choice(dtype, hidden):
    """The backward's row-per-warp body takes the rows the forward's does
    (whole 16-byte vectors, at most LN_BWD_LANE_ELEMS elements a lane,
    hidden <= 1024, every operand on the 16-byte grid); every other row
    takes the block body."""
    want = _PATHS[dtype][hidden]
    assert tln.layer_norm_bwd_path(hidden, _DT[dtype], True) == want
    assert tln.layer_norm_bwd_path(hidden, _DT[dtype], False) == 0
    if want:
        assert want * (16 // _DT[dtype].itemsize) <= tln.LN_BWD_LANE_ELEMS


def test_bwd_constants_are_the_kernels():
    """The Python mirror's warps a block, row elements a lane and the
    cross-block sum's groups are the C source's."""
    import re
    from apex_tpu_torch import _kernels
    src = (_kernels.CSRC / "layer_norm_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert const("kLnBwdMaxLaneElems") == tln.LN_BWD_LANE_ELEMS
    assert const("kLnBwdBlocksPerSm") == tln.LN_BWD_BLOCKS_PER_SM
    assert const("kLnBwdThreads") // 32 == tln.LN_BWD_WARPS
    assert "kLnBwdWarps = kLnBwdThreads / 32;" in src
    assert const("kLnReduceGroups") == _REDUCE_GROUPS


# csrc/layer_norm_bwd.cu kLnReduceGroups: the cross-block sum's groups
_REDUCE_GROUPS = 32


def _warp_rows(rows, parts):
    """Rows of each (block, warp) of the row-per-warp body: warp k of
    block b takes b * W + k, then every parts * W rows."""
    w = tln.LN_BWD_WARPS
    return {(b, k): list(range(b * w + k, rows, parts * w))
            for b in range(parts) for k in range(w)}


@pytest.mark.parametrize("sms", [3, 132])
@pytest.mark.parametrize("rows", [1, 7, 8, 40, 300, 8192])
def test_bwd_row_walk_takes_each_row_once(rows, sms):
    """The row-per-warp body's grid is at most one wave of resident blocks
    and its warps' walks take every row exactly once; the block body's
    tiles of ceil(rows / blocks) rows do too."""
    parts = tln.layer_norm_bwd_parts(rows, 4, sms)
    assert 1 <= parts <= sms * tln.LN_BWD_BLOCKS_PER_SM
    assert parts <= -(-rows // tln.LN_BWD_WARPS)
    seen = np.zeros(rows, np.int32)
    for walk in _warp_rows(rows, parts).values():
        seen[walk] += 1
    assert (seen == 1).all()
    parts = tln.layer_norm_bwd_parts(rows, 0, sms)
    assert parts == -(-rows // tln.LN_BWD_ROWS_PER_BLOCK)
    tile = -(-rows // parts)
    seen = np.zeros(rows, np.int32)
    for b in range(parts):
        seen[b * tile:min(rows, (b + 1) * tile)] += 1
    assert (seen == 1).all()


def _fms32(acc, a, b):
    """fma(-a, b, acc) in f32: acc - a*b rounded once."""
    return (acc.astype(np.float64) - a.astype(np.float64) * b).astype(
        np.float32)


def _kernel_order_bwd(dy, res, w, b, mean, rstd, rms, from_y, itemsize,
                      sms):
    """f32 emulation of the backward's row-per-warp body (every rounding
    as the kernel pins it): xhat and dy*w per element; lane l's partials of
    dy*w*xhat (an FMA) and dy*w over its vectors l, l + 32, ... element by
    element, combined by ``warp_sum``; dx = (fma(-xhat, c1, dy*w) - c2) *
    rstd; each warp's dgamma (FMAs) and dbeta over its rows in walk order,
    the block's warps added in warp order, then the blocks' rows summed by
    the reduce kernel's groups (rows q, q + 32, ... in order), the groups
    in order.  Returns (dx f32, dgamma, dbeta)."""
    rows, hidden = dy.shape
    dtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    nv = tln.layer_norm_bwd_path(hidden, dtype, True)
    assert nv
    per_vec = 16 // itemsize
    n_vec = hidden // per_vec
    if from_y:
        y = res - b if b is not None else res
        xh = (y / np.where(w == 0, np.float32(1), w)).astype(np.float32)
    else:
        xh = (res * rstd if rms else (res - mean) * rstd).astype(np.float32)
    wdy = (dy * w).astype(np.float32)
    a = np.zeros((rows, 32), np.float32)
    c = np.zeros((rows, 32), np.float32)
    lanes = np.arange(32)
    for j in range(nv):
        v = j * 32 + lanes
        ok = v < n_vec
        for k in range(per_vec):
            e = v[ok] * per_vec + k
            a[:, ok] = _fma32(a[:, ok], wdy[:, e], xh[:, e])
            c[:, ok] = c[:, ok] + wdy[:, e]
    inv_h = np.float32(1.0 / hidden)
    c1 = (_xor_tree(a) * inv_h)[:, None]
    c2 = np.zeros_like(c1) if rms else (_xor_tree(c) * inv_h)[:, None]
    dx = ((_fms32(wdy, xh, c1) - c2) * rstd).astype(np.float32)
    parts = tln.layer_norm_bwd_parts(rows, nv, sms)
    part = np.zeros((2, parts, hidden), np.float32)
    for (blk, _), walk in sorted(_warp_rows(rows, parts).items()):
        dw = np.zeros(hidden, np.float32)
        db = np.zeros(hidden, np.float32)
        for r in walk:
            dw = _fma32(dw, dy[r], xh[r])
            db = db + dy[r]
        part[0, blk] = part[0, blk] + dw
        part[1, blk] = part[1, blk] + db
    groups = np.zeros((_REDUCE_GROUPS, 2, hidden), np.float32)
    for p in range(parts):
        groups[p % _REDUCE_GROUPS] = groups[p % _REDUCE_GROUPS] + part[:, p]
    total = np.zeros((2, hidden), np.float32)
    for q in range(_REDUCE_GROUPS):
        total = total + groups[q]
    return dx, total[0], total[1]


# dx: one bf16 ulp (phase 2 of chip_smoke.py) / f32 sums of `hidden`
# terms in other orders; dgamma / dbeta: f32 sums of 40 rows in other
# orders (phase 2 allows 1e-3 + 1e-4 |ref|)
_DX_TOL = {"bf16": (2e-2, 2e-2), "f32": (1e-5, 1e-5)}
_DWB_TOL = (2e-5, 1e-5)


@pytest.mark.parametrize("mode", ["ln", "rms", "from_y"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("hidden", [8, 48, 1000, 1024])
def test_bwd_kernel_order_matches_jax_kernel_and_reference(hidden, dtype,
                                                           mode):
    """The backward kernel's row-per-warp body, emulated in f32 in its
    summation order over the grid of 2 SMs (4 blocks of 8 warps for 40
    rows: a warp takes one or two rows), against the JAX ``_bwd_kernel`` (Pallas, interpret mode,
    through ``jax.vjp``) and the plain version: dx within 0.02 + 0.02
    |ref| (bf16, phase 2's tolerance) / 1e-5 + 1e-5 |ref| (f32), dgamma and
    dbeta within 2e-5 + 1e-5 |ref| (phase 2 allows 1e-3 + 1e-4 |ref|)."""
    rng = np.random.RandomState(11)
    x = (rng.randn(40, hidden) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(40, hidden).astype(np.float32)
    w = (1 + 0.1 * rng.randn(hidden)).astype(np.float32)
    b = None if mode == "rms" else (0.1 * rng.randn(hidden)).astype(
        np.float32)
    rms, from_y = mode == "rms", mode == "from_y"
    tx = torch.from_numpy(x).to(_DT[dtype])
    tdy = torch.from_numpy(dy).to(_DT[dtype])
    tw = torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    y, mean, rstd = tln.layer_norm_fwd_reference(tx, tw, tb, 1e-5, rms)
    res = y if from_y else tx
    edx, edw, edb = _kernel_order_bwd(
        tdy.float().numpy(), res.float().numpy(), w, b, mean.numpy(),
        rstd.numpy(), rms, from_y, tx.element_size(), sms=2)
    edx = torch.from_numpy(edx).to(_DT[dtype]).float().numpy()
    rdx, rdw, rdb = tln.layer_norm_bwd_reference(tdy, res, tw, tb, mean,
                                                 rstd, rms, from_y)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    set_force_pallas(True)
    try:
        jdx, jdw, jdb = _jax_grads(jnp.asarray(x, jdt), w, b,
                                   jnp.asarray(dy, jdt), rms, from_y)
    finally:
        set_force_pallas(None)
    for ref in ((_f32(jdx), _f32(jdw), None if rms else _f32(jdb)),
                (_f32(rdx), _f32(rdw), None if rms else _f32(rdb))):
        np.testing.assert_allclose(edx, ref[0], atol=_DX_TOL[dtype][0],
                                   rtol=_DX_TOL[dtype][1])
        np.testing.assert_allclose(edw, ref[1], atol=_DWB_TOL[0],
                                   rtol=_DWB_TOL[1])
        if ref[2] is not None:
            np.testing.assert_allclose(edb, ref[2], atol=_DWB_TOL[0],
                                       rtol=_DWB_TOL[1])
