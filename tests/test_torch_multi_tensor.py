"""apex_tpu_torch multi-tensor scale, axpby, L2 norm, LAMB stages, SGD,
Adagrad and NovoGrad against apex_tpu on the CPU.

The plain versions that CPU tensors take (the port's side of kernels #15,
#16, #17, #19-#23) are held against the JAX ``scale_packed``,
``axpby_packed``, ``l2norm_rowsq_packed``, ``lamb_stage1_packed``,
``lamb_stage2_packed``, ``sgd_packed``, ``adagrad_packed`` and
``novograd_packed`` over the packed bucket of the same leaves
(``bucketing.flatten_bucket``), through the Pallas kernels in interpret
mode and through the JAX default path, and the ``_*_math`` functions
against their JAX namesakes; the tensor-list functions
(``multi_tensor_scale``, ``multi_tensor_axpby``, ``multi_tensor_l2norm``,
``clip_grad_norm_``) against their JAX namesakes.

The leaves have odd sizes (off the 128-lane multiple) and, in some cases,
one tensor of two 64K-element chunks, so the port's per-chunk partials are
summed across a chunk boundary.  Both sides run the same f32 math:
f32 results agree to 1e-6 relative; a result rounded to bf16 or f16 is
within one ulp of its dtype (the f32 value before rounding may differ in
its last bit, by the order of the partial sums).
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.clip_grad import clip_grad_norm_ as j_clip
from apex_tpu.multi_tensor_apply import bucketing as jB
from apex_tpu.multi_tensor_apply import functional as jF
from apex_tpu.ops import multi_tensor as jK
from apex_tpu.optimizers.base import per_tensor_ratio_rows, per_tensor_sums
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.multi_tensor_apply import (MultiTensorApply,
                                               multi_tensor_applier,
                                               multi_tensor_axpby,
                                               multi_tensor_l2norm,
                                               multi_tensor_scale)
from apex_tpu_torch.ops import multi_tensor as tK

SHAPES = [(3, 5), (7,), (130,), (2, 3, 4), (1,)]
# plus a tensor of two 64K-element chunks (77,100 elements)
SHAPES_2CHUNK = SHAPES + [(257, 300)]
TOL = 1e-6
_J = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
_T = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
_ULP = {"f32": 1e-6, "bf16": 2.0 ** -7, "f16": 2.0 ** -10}


@pytest.fixture(params=["pallas_interpret", "jax_default"])
def jax_path(request):
    set_force_pallas(True if request.param == "pallas_interpret" else None)
    yield request.param
    set_force_pallas(None)


def _leaves(seed, shapes=SHAPES, positive=False, scale=1.0):
    rng = np.random.RandomState(seed)
    out = [(scale * rng.randn(*s)).astype(np.float32) for s in shapes]
    return [np.abs(a) for a in out] if positive else out


def _rounded(leaves, dt):
    """The leaves rounded to ``dt`` (as f32 numpy), so both sides start
    from the same values."""
    return [np.array(jnp.asarray(a, _J[dt]), np.float32) for a in leaves]


def _pack(leaves, dt, shapes):
    meta = jB.bucket_meta(shapes, _J[dt], block_rows=8)
    return jB.flatten_bucket([jnp.asarray(a, _J[dt]) for a in leaves],
                             meta), meta


def _torch(leaves, dt="f32"):
    return [torch.from_numpy(a.copy()).to(_T[dt]) for a in leaves]


def _assert_close(got, want, dt):
    """Within one ulp of ``dt`` (1e-6 relative for f32)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = _ULP[dt] * np.abs(want) + (1e-6 if dt == "f32" else 1e-30)
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want))


def _specials(leaves, special):
    if special == "inf":
        leaves[2][5] = np.inf
    elif special == "nan":
        leaves[0][1, 2] = np.nan
    return leaves


# the (in, out) dtype pairs #15 specialises: all nine
SCALE_PAIRS = [(i, o) for i in ("f32", "bf16", "f16")
               for o in ("f32", "bf16", "f16")]


@pytest.mark.parametrize("special", [None, "inf", "nan"])
@pytest.mark.parametrize("in_dt,out_dt", SCALE_PAIRS)
def test_scale_matches_scale_packed(jax_path, in_dt, out_dt, special):
    x = _specials(_rounded(_leaves(0), in_dt), special)
    scale = 0.37
    packed, meta = _pack(x, in_dt, SHAPES)
    out, finf = jK.scale_packed(packed, scale, _J[out_dt], block_rows=8)
    want = jB.unflatten_bucket(out, meta._replace(dtype=_J[out_dt]))
    tx = _torch(x, in_dt)
    touts = [torch.empty(t.shape, dtype=_T[out_dt]) for t in tx]
    tfinf = tK.multi_tensor_scale_(tx, touts, scale)
    assert float(tfinf) == float(finf) == (0.0 if special is None else 1.0)
    for got, w in zip(touts, want):
        g, w = got.float().numpy(), np.asarray(w, np.float32)
        ok = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), ok)
        _assert_close(g[ok], w[ok], out_dt)


@pytest.mark.parametrize("special", [None, "inf", "nan"])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
def test_scale_in_place_matches_scale_packed(jax_path, dt, special):
    """``out is x`` (the unscale in place): the outputs are JAX's, within
    one ulp of the dtype, and the flag is JAX's."""
    x = _specials(_rounded(_leaves(18), dt), special)
    packed, meta = _pack(x, dt, SHAPES)
    out, finf = jK.scale_packed(packed, 0.37, block_rows=8)
    want = jB.unflatten_bucket(out, meta)
    tx = _torch(x, dt)
    tfinf = tK.multi_tensor_scale_(tx, tx, 0.37)
    assert float(tfinf) == float(finf) == (0.0 if special is None else 1.0)
    for got, w in zip(tx, want):
        g, w = got.float().numpy(), np.asarray(w, np.float32)
        ok = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), ok)
        _assert_close(g[ok], w[ok], dt)


@pytest.mark.parametrize("out_dt", ["f16", "bf16", "f32"])
def test_scale_flag_is_taken_on_the_f32_product(jax_path, out_dt):
    """6e4 * 2 is finite in f32 and overflows f16: the output is inf and
    the flag stays 0, as JAX takes it on the f32 product; 3e38 * 2
    overflows f32 and sets it."""
    for value, want in ((6e4, 0.0), (3e38, 1.0)):
        x = np.full((3, 5), value, np.float32)
        packed, meta = _pack([x], "f32", [(3, 5)])
        out, finf = jK.scale_packed(packed, 2.0, _J[out_dt], block_rows=8)
        jout = np.asarray(jB.unflatten_bucket(
            out, meta._replace(dtype=_J[out_dt]))[0], np.float32)
        tout = torch.empty((3, 5), dtype=_T[out_dt])
        tfinf = tK.multi_tensor_scale_([torch.from_numpy(x)], [tout], 2.0)
        assert float(tfinf) == float(finf) == want
        np.testing.assert_array_equal(tout.float().numpy(), jout)
        assert np.isinf(jout).all() == (want == 1.0 or out_dt == "f16")


@pytest.mark.parametrize("special", [None, "inf", "nan"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_l2norm_matches_l2norm_rowsq_packed(jax_path, dt, special):
    x = _specials(_rounded(_leaves(1, SHAPES_2CHUNK), dt), special)
    packed, meta = _pack(x, dt, SHAPES_2CHUNK)
    rowsq, finf = jK.l2norm_rowsq_packed(packed, block_rows=8)
    total, per, tfinf = tK.multi_tensor_sumsq(_torch(x, dt),
                                              per_tensor=True)
    assert float(tfinf) == float(finf) == (0.0 if special is None else 1.0)
    if special is None:
        _assert_close(total.numpy(), np.sum(np.asarray(rowsq)), "f32")
        _assert_close(per.numpy(), per_tensor_sums(meta, rowsq), "f32")


def _stage1_scal(clip, beta1=0.9, grad_averaging=True):
    return [beta1, 0.999, 1e-6, 0.01, 1 - beta1 ** 3, 1 - 0.999 ** 3, 0.5,
            clip, 1 - beta1 if grad_averaging else 1.0]


@pytest.mark.parametrize("g_dt", ["f32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, 0.3])
@pytest.mark.parametrize("noop", [0, 1])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_lamb_stage1_matches_lamb_stage1_packed(jax_path, adam_w_mode, noop,
                                                clip, g_dt):
    g = _rounded(_leaves(2), g_dt)
    p, m = _leaves(3), _leaves(4, scale=0.1)
    v = _leaves(5, positive=True, scale=0.01)
    s = _stage1_scal(clip)
    pg, meta = _pack(g, g_dt, SHAPES)
    packed = [_pack(a, "f32", SHAPES)[0] for a in (p, m, v)]
    u, jm, jv, usq, psq = jK.lamb_stage1_packed(
        pg, *packed, beta1=s[0], beta2=s[1], eps=s[2], weight_decay=s[3],
        bias_correction1=s[4], bias_correction2=s[5], grad_scale=s[6],
        global_grad_clip=clip, adam_w_mode=adam_w_mode,
        noop_flag=jnp.int32(noop), block_rows=8)
    tg = _torch(g, g_dt)
    tp, tm, tv = _torch(p), _torch(m), _torch(v)
    tu = [torch.empty_like(t) for t in tp]
    t_usq, t_psq = tK.multi_tensor_lamb_stage1(
        tg, tp, tm, tv, tu, torch.tensor(s, dtype=torch.float32),
        torch.tensor(noop, dtype=torch.int32), adam_w_mode)
    for got, want in ((tu, u), (tm, jm), (tv, jv)):
        for a, b in zip(got, jB.unflatten_bucket(want, meta._replace(
                dtype=jnp.float32))):
            _assert_close(a.numpy(), b, "f32")
    # one chunk per tensor here: the chunk partials are the tensor sums
    _assert_close(t_usq.numpy(), per_tensor_sums(meta, usq), "f32")
    _assert_close(t_psq.numpy(), per_tensor_sums(meta, psq), "f32")
    if noop:
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(tm, m))
        assert not any(t.any() for t in tu)


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("use_nvlamb", [False, True])
@pytest.mark.parametrize("noop", [0, 1])
def test_lamb_stage2_matches_lamb_stage2_packed(jax_path, noop, use_nvlamb,
                                                masters):
    shapes = SHAPES_2CHUNK
    u = _leaves(6, shapes)
    p = _leaves(7, shapes, scale=0.05)
    p[1][:] = 0.0                     # ||p|| = 0: the two ratio rules differ
    u[3][:] = 0.0                     # ||u|| = 0: ratio 1 under both
    if masters:                       # f32 masters of bf16 parameters
        p = _rounded(p, "bf16")
    lr = 0.01
    tu, tp = _torch(u), _torch(p)
    # stage 1's partials: per 64K-element chunk, tensor after tensor
    t_usq, t_psq = (torch.cat([tK._chunked(t).square().sum(1) for t in ts])
                    for ts in (tu, tp))
    meta = jB.bucket_meta(shapes, jnp.float32, block_rows=8)
    u_norm = np.sqrt([np.sum(np.square(a)) for a in u])
    p_norm = np.sqrt([np.sum(np.square(a)) for a in p])
    apply = u_norm > 0 if use_nvlamb else (u_norm > 0) & (p_norm > 0)
    ratio = np.where(apply, p_norm / np.where(u_norm > 0, u_norm, 1), 1.0)
    want = jB.unflatten_bucket(jK.lamb_stage2_packed(
        _pack(u, "f32", shapes)[0], _pack(p, "f32", shapes)[0],
        per_tensor_ratio_rows(meta, jnp.asarray(ratio, jnp.float32)), lr=lr,
        noop_flag=jnp.int32(noop), block_rows=8), meta)
    copies = ([torch.full(t.shape, -7.0, dtype=torch.bfloat16) for t in tp]
              if masters else [None] * len(tp))
    tK.multi_tensor_lamb_stage2(tu, tp, copies, t_usq, t_psq, lr,
                                torch.tensor(noop, dtype=torch.int32),
                                use_nvlamb)
    for i, (a, b) in enumerate(zip(tp, want)):
        _assert_close(a.numpy(), b, "f32")
        if masters:   # the model copy: the master rounded to bf16
            want_copy = (np.full(a.shape, -7.0, np.float32) if noop else
                         np.asarray(jnp.asarray(b).astype(jnp.bfloat16),
                                    np.float32))
            np.testing.assert_array_equal(copies[i].float().numpy(),
                                          want_copy)
    if noop:
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(tp, p))


def test_chunk_partials_sum_to_the_tensor_sums():
    """Stage 1's partials are per 64K-element chunk, tensor after tensor:
    the two-chunk tensor has two."""
    x = _torch(_leaves(8, SHAPES_2CHUNK))
    counts = tK.chunk_counts(t.numel() for t in x)
    assert counts == [1] * len(SHAPES) + [2]
    zeros = [torch.zeros_like(t) for t in x]
    _, psq = tK.multi_tensor_lamb_stage1(
        zeros, x, [torch.zeros_like(t) for t in x],
        [torch.zeros_like(t) for t in x], [torch.empty_like(t) for t in x],
        torch.tensor(_stage1_scal(1.0), dtype=torch.float32))
    assert psq.shape == (sum(counts),)
    assert float(psq[-2]) > 0 and float(psq[-1]) > 0
    np.testing.assert_allclose(psq[-2:].sum().numpy(),
                               np.sum(np.square(x[-1].numpy())), rtol=TOL)


@pytest.mark.parametrize("per_tensor", [False, True])
def test_functional_l2norm_and_scale_match_jax(jax_path, per_tensor):
    """Mixed dtypes in one list (the JAX side groups them by dtype)."""
    f = _leaves(9, SHAPES)
    b = _rounded(_leaves(10, SHAPES), "bf16")
    jx = [jnp.asarray(a) for a in f] + [jnp.asarray(a, jnp.bfloat16)
                                        for a in b]
    tx = _torch(f) + _torch(b, "bf16")
    jn, jper, jfinf = jF.multi_tensor_l2norm(jx, per_tensor=per_tensor)
    tn, tper, tfinf = multi_tensor_l2norm(tx, per_tensor=per_tensor)
    _assert_close(tn.numpy(), jn, "f32")
    assert float(tfinf) == float(jfinf) == 0.0
    if per_tensor:
        _assert_close(tper.numpy(), jper, "f32")
    else:
        assert tper is None and jper is None
    jouts, jf = jF.multi_tensor_scale(jx, 2.5)
    touts, tf = multi_tensor_applier(multi_tensor_scale, None, [tx], 2.5)
    assert float(tf) == float(jf) == 0.0
    for a, w, dt in zip(touts, jouts, ["f32"] * len(f) + ["bf16"] * len(b)):
        assert a.dtype == _T[dt]
        _assert_close(a.float().numpy(), np.asarray(w, np.float32), dt)


@pytest.mark.parametrize("norm_type", [2.0, 3.0])
@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_grad_norm_matches_jax(jax_path, max_norm, norm_type):
    """In place on ``.grad`` (the torch form); the JAX function returns the
    clipped tree.  max_norm 1 clips, 100 leaves the gradients as they
    are (coefficient 1)."""
    g = _leaves(11)
    jclipped, jnorm = j_clip([jnp.asarray(a) for a in g], max_norm,
                             norm_type)
    params = [torch.nn.Parameter(torch.zeros(a.shape)) for a in g]
    for p, a in zip(params, g):
        p.grad = torch.from_numpy(a.copy())
    norm = clip_grad_norm_(params, max_norm, norm_type)
    _assert_close(norm.numpy(), jnorm, "f32")
    for p, w in zip(params, jclipped):
        _assert_close(p.grad.numpy(), w, "f32")


def test_clip_grad_norm_nonfinite_poisons_the_norm():
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([1.0, float("inf"), 2.0])
    assert torch.isnan(clip_grad_norm_(p, 1.0, error_if_nonfinite=True))


def test_axpby_names_its_slice():
    """The functional axpby runs kernel #16's plain version on the CPU (it
    raised, naming its slice, until the kernel was ported) and names the
    kernel it launches on the card."""
    outs, finf = multi_tensor_axpby(2.0, [torch.ones(2)], -1.0,
                                    [torch.full((2,), 3.0)])
    assert torch.equal(outs[0], torch.full((2,), -1.0))
    assert float(finf) == 0.0
    assert "#16" in multi_tensor_axpby.__doc__


def test_multi_tensor_apply_takes_only_the_kernels_chunk():
    """The kernels' chunk is fixed at 64K elements (apex's usual 2048 *
    32): another ``chunk_size`` raises instead of being ignored."""
    assert MultiTensorApply(2048 * 32).chunk_size == tK.CHUNK
    with pytest.raises(ValueError, match="chunk"):
        MultiTensorApply(1024)


# ---------------------------------------------------------------------------
# axpby (#16)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("special", [None, "inf", "nan"])
@pytest.mark.parametrize("x_dt,y_dt,out_dt", [
    ("f32", "f32", "f32"), ("bf16", "f32", "bf16"), ("f32", "bf16", "f32"),
    ("bf16", "bf16", "f32"), ("f16", "f32", "f16"), ("f32", "f16", "bf16")])
def test_axpby_matches_axpby_packed(jax_path, x_dt, y_dt, out_dt, special):
    """Mixed x / y / out dtypes; the found-inf flag is taken on the output
    (an inf in x with a = 0 would still give nan there)."""
    x = _specials(_rounded(_leaves(12), x_dt), special)
    y = _rounded(_leaves(13), y_dt)
    a, b = 0.75, -1.5
    px, meta = _pack(x, x_dt, SHAPES)
    py, _ = _pack(y, y_dt, SHAPES)
    out, finf = jK.axpby_packed(a, px, b, py, _J[out_dt], block_rows=8)
    want = jB.unflatten_bucket(out, meta._replace(dtype=_J[out_dt]))
    touts = [torch.empty(s, dtype=_T[out_dt]) for s in SHAPES]
    tfinf = tK.multi_tensor_axpby_(_torch(x, x_dt), _torch(y, y_dt), touts,
                                   a, b)
    assert float(tfinf) == float(finf) == (0.0 if special is None else 1.0)
    for got, w in zip(touts, want):
        g, w = got.float().numpy(), np.asarray(w, np.float32)
        ok = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), ok)
        _assert_close(g[ok], w[ok], out_dt)


def test_axpby_flag_is_taken_on_the_output():
    """a = 0 times a huge x is 0, not a non-finite value: no flag; an
    overflow of the sum (both finite) sets it, as the JAX kernel does."""
    big = [torch.full((3,), 3e38)]
    _, f0 = multi_tensor_axpby(0.0, big, 1.0, [torch.ones(3)])
    _, f1 = multi_tensor_axpby(1.0, big, 1.0, big)
    jf0 = jF.multi_tensor_axpby(0.0, [jnp.full((3,), 3e38)], 1.0,
                                [jnp.ones(3)])[1]
    jf1 = jF.multi_tensor_axpby(1.0, [jnp.full((3,), 3e38)], 1.0,
                                [jnp.full((3,), 3e38)])[1]
    assert (float(f0), float(f1)) == (float(jf0), float(jf1)) == (0.0, 1.0)


@pytest.mark.parametrize("out", ["new", "in_place"])
def test_functional_axpby_matches_jax(jax_path, out):
    """A list of f32 and bf16 xs with ys of the other dtype (the JAX side
    groups by x's dtype); through ``multi_tensor_applier`` with apex's
    ``[x, y, out]`` lists."""
    f = _leaves(14, SHAPES)
    b = _rounded(_leaves(15, SHAPES), "bf16")
    yf = _rounded(_leaves(16, SHAPES), "bf16")
    yb = _leaves(17, SHAPES)
    jx = [jnp.asarray(v) for v in f] + [jnp.asarray(v, jnp.bfloat16)
                                        for v in b]
    jy = [jnp.asarray(v, jnp.bfloat16) for v in yf] + [jnp.asarray(v)
                                                       for v in yb]
    tx = _torch(f) + _torch(b, "bf16")
    ty = _torch(yf, "bf16") + _torch(yb)
    jouts, jfinf = jF.multi_tensor_axpby(0.5, jx, 2.0, jy)
    lists = [tx, ty] + ([[torch.empty_like(t) for t in tx]]
                        if out == "in_place" else [])
    touts, tfinf = multi_tensor_applier(multi_tensor_axpby, None, lists, 0.5,
                                        2.0)
    assert float(tfinf) == float(jfinf) == 0.0
    if out == "in_place":
        assert all(a is b for a, b in zip(touts, lists[2]))
    for a, w, dt in zip(touts, jouts, ["f32"] * len(f) + ["bf16"] * len(b)):
        assert a.dtype == _T[dt]
        _assert_close(a.float().numpy(), np.asarray(w, np.float32), dt)


# ---------------------------------------------------------------------------
# the optimizer kernels: SGD (#19), Adagrad (#22), NovoGrad (#23)
# ---------------------------------------------------------------------------

def _opt_inputs(seed, p_dt, masters):
    """g (f32), p in ``p_dt`` (as f32 numpy, rounded) and, under
    ``masters``, p as f32 masters of bf16 model copies."""
    g = _leaves(seed, scale=0.3)
    p = _rounded(_leaves(seed + 1), "bf16" if masters else p_dt)
    return g, p


def _torch_params(p, p_dt, masters):
    """The port's params (f32 masters or the params) and their copies."""
    if masters:
        return _torch(p), [torch.full(a.shape, -7.0, dtype=torch.bfloat16)
                           for a in p]
    return _torch(p, p_dt), None


def _check_params(tp, copies, want_p, p_dt, noop, p0):
    """params against JAX's within one ulp of their dtype; the copies are
    the masters rounded to bf16 (kept under noop)."""
    for i, (a, w) in enumerate(zip(tp, want_p)):
        _assert_close(a.float().numpy(), np.asarray(w, np.float32),
                      "f32" if copies is not None else p_dt)
        if copies is not None:
            want_copy = (np.full(a.shape, -7.0, np.float32) if noop else
                         np.asarray(jnp.asarray(a.numpy()).astype(
                             jnp.bfloat16), np.float32))
            np.testing.assert_array_equal(copies[i].float().numpy(),
                                          want_copy)
    if noop:
        assert all(np.array_equal(a.float().numpy(), b)
                   for a, b in zip(tp, p0))


SGD_FLAGS = [  # nesterov, first_run, wd_after_momentum, momentum_zero
    (False, False, False, False), (True, False, False, False),
    (False, True, False, False), (False, False, True, False),
    (False, False, False, True), (True, True, True, False)]


@pytest.mark.parametrize("p_dt,masters", [("f32", False), ("bf16", False),
                                          ("f32", True)])
@pytest.mark.parametrize("noop", [0, 1])
@pytest.mark.parametrize("flags", SGD_FLAGS,
                         ids=["plain", "nesterov", "first_run",
                              "wd_after_momentum", "momentum_zero", "all"])
def test_sgd_matches_sgd_packed(jax_path, flags, noop, p_dt, masters):
    nesterov, first_run, wd_after, mom_zero = flags
    g, p = _opt_inputs(20, p_dt, masters)
    buf = _leaves(22, scale=0.1)
    momentum = 0.0 if mom_zero else 0.9
    hyper = dict(lr=0.05, weight_decay=0.01, momentum=momentum,
                 dampening=0.1, grad_scale=0.5)
    pdt_j = "f32" if masters else p_dt
    pg, meta = _pack(g, "f32", SHAPES)
    pp, pmeta = _pack(p, pdt_j, SHAPES)
    pb, _ = _pack(buf, "f32", SHAPES)
    jp, jb = jK.sgd_packed(pg, pp, pb, nesterov=nesterov,
                           first_run=first_run, wd_after_momentum=wd_after,
                           noop_flag=jnp.int32(noop), block_rows=8, **hyper)
    tp, copies = _torch_params(p, p_dt, masters)
    tb = _torch(buf)
    scal = torch.tensor([hyper[k] for k in ("lr", "weight_decay", "momentum",
                                            "dampening", "grad_scale")],
                        dtype=torch.float32)
    tK.multi_tensor_sgd(_torch(g), tp, tb, copies, scal,
                        torch.tensor(noop, dtype=torch.int32), nesterov,
                        first_run, wd_after, mom_zero)
    _check_params(tp, copies, jB.unflatten_bucket(jp, pmeta), p_dt, noop, p)
    for a, w in zip(tb, jB.unflatten_bucket(jb, meta)):
        _assert_close(a.numpy(), w, "f32")
    if noop or mom_zero:
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(tb, buf))


@pytest.mark.parametrize("flags", SGD_FLAGS)
def test_sgd_math_matches_jax(flags):
    g, p, buf = _leaves(23)[0], _leaves(24)[0], _leaves(25)[0]
    scal = np.array([0.05, 0.01, 0.9, 0.1, 0.5], np.float32)
    for skip in (False, True):
        jp, jb = jK._sgd_math(*flags, jnp.asarray(scal), skip,
                              *map(jnp.asarray, (g, p, buf)))
        tp, tb = tK._sgd_math(*flags, torch.from_numpy(scal),
                              torch.tensor(skip),
                              *map(torch.from_numpy, (g, p, buf)))
        _assert_close(tp.numpy(), jp, "f32")
        _assert_close(tb.numpy(), jb, "f32")


@pytest.mark.parametrize("p_dt,masters", [("f32", False), ("bf16", False),
                                          ("f32", True)])
@pytest.mark.parametrize("noop", [0, 1])
@pytest.mark.parametrize("w_mode", [False, True])
def test_adagrad_matches_adagrad_packed(jax_path, w_mode, noop, p_dt,
                                        masters):
    """``adagrad_w_mode`` against the JAX optimizer's order: the kernel
    with no L2 term, then ``p - lr * wd * p_old`` (skipped under noop)."""
    g, p = _opt_inputs(26, p_dt, masters)
    h = _leaves(28, positive=True, scale=0.1)
    lr, eps, wd, gscale = 0.05, 1e-10, 0.02, 0.5
    pdt_j = "f32" if masters else p_dt
    pg, meta = _pack(g, "f32", SHAPES)
    pp, pmeta = _pack(p, pdt_j, SHAPES)
    ph, _ = _pack(h, "f32", SHAPES)
    jp, jh = jK.adagrad_packed(pg, pp, ph, lr=lr, eps=eps,
                               weight_decay=0.0 if w_mode else wd,
                               grad_scale=gscale, noop_flag=jnp.int32(noop),
                               block_rows=8)
    if w_mode:
        p_old = pp.astype(jnp.float32)
        jp = jnp.where(noop != 0, pp, (jp.astype(jnp.float32)
                                       - lr * wd * p_old).astype(pp.dtype))
    tp, copies = _torch_params(p, p_dt, masters)
    th = _torch(h)
    tK.multi_tensor_adagrad(_torch(g), tp, th, copies,
                            torch.tensor([lr, eps, wd, gscale]),
                            torch.tensor(noop, dtype=torch.int32), w_mode)
    _check_params(tp, copies, jB.unflatten_bucket(jp, pmeta), p_dt, noop, p)
    for a, w in zip(th, jB.unflatten_bucket(jh, meta)):
        _assert_close(a.numpy(), w, "f32")


def test_adagrad_math_matches_jax():
    g, p = _leaves(29)[0], _leaves(30)[0]
    h = _leaves(31, positive=True)[0]
    scal = np.array([0.05, 1e-10, 0.02, 0.5], np.float32)
    for skip in (False, True):
        jp, jh = jK._adagrad_math(jnp.asarray(scal), skip,
                                  *map(jnp.asarray, (g, p, h)))
        tp, th = tK._adagrad_math(torch.from_numpy(scal), torch.tensor(skip),
                                  *map(torch.from_numpy, (g, p, h)))
        _assert_close(tp.numpy(), jp, "f32")
        _assert_close(th.numpy(), jh, "f32")


@pytest.mark.parametrize("p_dt,masters", [("f32", False), ("bf16", False),
                                          ("f32", True)])
@pytest.mark.parametrize("noop", [0, 1])
@pytest.mark.parametrize("grad_averaging", [True, False])
@pytest.mark.parametrize("reg_inside_moment", [False, True])
def test_novograd_matches_novograd_packed(jax_path, reg_inside_moment,
                                          grad_averaging, noop, p_dt,
                                          masters):
    """The per-tensor v broadcast per row on the JAX side; one f32 entry per
    tensor on the port's."""
    g, p = _opt_inputs(32, p_dt, masters)
    m = _leaves(34, scale=0.1)
    v = np.abs(np.random.RandomState(35).randn(len(SHAPES))).astype(
        np.float32) + 0.1
    hyper = dict(lr=0.05, beta1=0.95, weight_decay=0.01, eps=1e-8,
                 grad_scale=0.5)
    pdt_j = "f32" if masters else p_dt
    pg, meta = _pack(g, "f32", SHAPES)
    pp, pmeta = _pack(p, pdt_j, SHAPES)
    pm, _ = _pack(m, "f32", SHAPES)
    jp, jm = jK.novograd_packed(
        pg, pp, pm, per_tensor_ratio_rows(meta, jnp.asarray(v)),
        grad_averaging=grad_averaging, reg_inside_moment=reg_inside_moment,
        noop_flag=jnp.int32(noop), block_rows=8, **hyper)
    tp, copies = _torch_params(p, p_dt, masters)
    tm = _torch(m)
    beta3 = 1.0 - hyper["beta1"] if grad_averaging else 1.0
    scal = torch.tensor([hyper["lr"], hyper["beta1"], hyper["weight_decay"],
                         hyper["eps"], hyper["grad_scale"], beta3])
    tK.multi_tensor_novograd(_torch(g), tp, tm, copies, torch.from_numpy(v),
                             scal, torch.tensor(noop, dtype=torch.int32),
                             reg_inside_moment)
    _check_params(tp, copies, jB.unflatten_bucket(jp, pmeta), p_dt, noop, p)
    for a, w in zip(tm, jB.unflatten_bucket(jm, meta)):
        _assert_close(a.numpy(), w, "f32")


@pytest.mark.parametrize("reg_inside_moment", [False, True])
def test_novograd_math_matches_jax(reg_inside_moment):
    g, p, m = _leaves(36)[0], _leaves(37)[0], _leaves(38)[0]
    scal = np.array([0.05, 0.95, 0.01, 1e-8, 0.5, 0.05], np.float32)
    v = np.float32(2.5)
    for skip in (False, True):
        jp, jm = jK._novograd_math(reg_inside_moment, jnp.asarray(scal), skip,
                                   *map(jnp.asarray, (g, p, m)),
                                   jnp.asarray(v))
        tp, tm = tK._novograd_math(reg_inside_moment, torch.from_numpy(scal),
                                   torch.tensor(skip),
                                   *map(torch.from_numpy, (g, p, m)),
                                   torch.tensor(v))
        _assert_close(tp.numpy(), jp, "f32")
        _assert_close(tm.numpy(), jm, "f32")


# ---------------------------------------------------------------------------
# #19's launch table: the Python statement of the C entry's walk
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "apex_tpu_torch" / "csrc"
# csrc/multi_tensor_list.cuh: the head code of lists no scalar head aligns,
# and the bytes of kernel parameters CUDA 12.1 allows on sm_70 and later
SGD_NO_VECTOR = 8
KERNEL_PARAM_LIMIT = 32764


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The card script (it imports torch and numpy only), for the lists its
    phases 2 and 9 step."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sgd_lists():
    """Named lists of tensor sizes: ResNet-50's at O1 and O2 and GPT-350M's
    as the card script builds them (meta devices), 2000 tensors of 1-70,000
    elements, and a list with empty tensors around a table's worth."""
    cs = _chip_smoke()
    rng = np.random.RandomState(5)
    return {
        "resnet50_O1": [int(np.prod(s)) for s, _ in cs.resnet50_specs("O1")],
        "resnet50_O2": [int(np.prod(s)) for s, _ in cs.resnet50_specs("O2")],
        "gpt350m": [int(np.prod(s)) for s in cs.gpt350m_shapes()],
        "2000_tensors": [int(n) for n in rng.randint(1, 70001, 2000)],
        "empties": [0, 5, 0] + [1] * (tK.SGD_TABLE_TENSORS - 1) + [0, 0, 9,
                                                                   0]}


_SGD_LAUNCHES = {"resnet50_O1": 1, "resnet50_O2": 1, "gpt350m": 1,
                 "2000_tensors": 4, "empties": 2}


def _sgd_block_owner(chunk_start, block):
    """The kernel's binary search: the last tensor of the launch whose
    first chunk is at or before ``block``."""
    lo, hi = 0, len(chunk_start) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if chunk_start[mid] <= block:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("name", sorted(_SGD_LAUNCHES))
def test_sgd_walk_covers_every_element_once(name):
    """Each block of each launch of ``sgd_plan`` finds its tensor by the
    kernel's search, and the blocks' element ranges tile every non-empty
    tensor exactly once; empty tensors get no block; each launch holds at
    most a table's tensors, and the launches are those stated (one for
    ResNet-50's and GPT-350M's lists, ceil(2000 / 640) for 2000)."""
    numels = _sgd_lists()[name]
    plan = tK.sgd_plan(numels)
    assert len(plan) == tK.sgd_launches(numels) == _SGD_LAUNCHES[name]
    ranges = {}
    for table in plan:
        assert 0 < len(table) <= tK.SGD_TABLE_TENSORS
        starts = [first for _, first, _ in table]
        assert starts[0] == 0
        n_blocks = sum(chunks for _, _, chunks in table)
        for block in range(n_blocks):
            t = _sgd_block_owner(starts, block)
            i, first, _ = table[t]
            s = (block - first) * tK.SGD_CHUNK
            e = min(numels[i], s + tK.SGD_CHUNK)
            assert s < e
            ranges.setdefault(i, []).append((s, e))
    assert sorted(ranges) == [i for i, n in enumerate(numels) if n > 0]
    for i, rs in ranges.items():
        ends = [0] + [e for _, e in sorted(rs)]
        assert [s for s, _ in sorted(rs)] == ends[:-1]
        assert ends[-1] == numels[i]


def _sgd_vector_head(addresses, itemsizes):
    """The kernel's ``vector_head``: the fewest leading elements (0-7)
    after which every list of one tensor is on the 16-byte grid (address
    0: the list is absent), or SGD_NO_VECTOR when no count aligns them."""
    for h in range(8):
        if all(a == 0 or (a + h * s) % 16 == 0
               for a, s in zip(addresses, itemsizes)):
            return h
    return SGD_NO_VECTOR


def _list_param_bytes(tensors, lists, pointers, ints):
    """Bytes of a whole-list kernel's parameters with a table of
    ``tensors`` entries (the C ``ListTable``: a pointer per list, an
    element count, a first-chunk index and two bytes per tensor, one more
    chunk index, padded to 8 bytes), then ``pointers`` pointers and
    ``ints`` ints."""
    table = (8 * lists * tensors + 8 * tensors + 4 * (tensors + 1)
             + 2 * tensors)
    return -(-table // 8) * 8 + 8 * pointers + 4 * ints


def _sgd_param_bytes(tensors):
    """``multi_tensor_sgd_kernel``'s: four lists, then two pointers and
    five ints."""
    return _list_param_bytes(tensors, 4, 2, 5)


def _sgd_chunk_split(s, e, head):
    """The kernel's split of chunk [s, e) (``sgd_chunk``): elements one by
    one, then 8-element steps, then one by one."""
    vs = e if head == SGD_NO_VECTOR else min(e, s + head)
    ve = vs + 8 * ((e - vs) // 8)
    return list(range(s, vs)), list(range(vs, ve)), list(range(ve, e))


@pytest.mark.parametrize("head", list(range(8)) + [SGD_NO_VECTOR])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 64, 65537, 3 * tK.SGD_CHUNK])
def test_sgd_chunk_split_takes_each_element_once(n, head):
    """Over a tensor's chunks, the scalar head, the 16-byte steps and the
    tail take each element once; every step starts ``head`` elements past
    a chunk start plus a multiple of 8 (on the 16-byte grid when the lists'
    phases are those ``_sgd_vector_head`` returned ``head`` for)."""
    seen = np.zeros(n, np.int32)
    for s in range(0, n, tK.SGD_CHUNK):
        one, vec, tail = _sgd_chunk_split(s, min(n, s + tK.SGD_CHUNK), head)
        assert len(vec) % 8 == 0 and len(tail) < 8
        if head == SGD_NO_VECTOR:
            assert not vec and not tail
        else:
            assert len(one) <= head
            assert not vec or (vec[0] - s - head) % 8 == 0
        seen[one + vec + tail] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("offsets,itemsizes,head", [
    ((0, 0, 0, 0), (4, 4, 4, 0), 0),
    ((0, 0, 0, 0), (2, 4, 4, 2), 0),
    ((1, 1, 1, 1), (2, 4, 4, 2), 7),     # every list one element in
    ((1, 1, 1, 0), (4, 4, 4, 0), 3),
    ((1, 0, 0, 0), (2, 4, 4, 0), SGD_NO_VECTOR),   # g alone off
    ((1, 0, 0, 0), (4, 4, 4, 0), SGD_NO_VECTOR),
    ((2, 1, 1, 2), (2, 4, 4, 2), SGD_NO_VECTOR),
    ((4, 0, 0, 0), (2, 4, 4, 0), 4),
    ((4, 2, 2, 0), (2, 4, 4, 0), SGD_NO_VECTOR),
    ((3, 3, 3, 3), (2, 2, 4, 2), 5)])
def test_sgd_vector_head(offsets, itemsizes, head):
    """The kernel's rule for the scalar head that puts every list on the
    16-byte grid, for lists that start ``offsets`` elements into
    16-byte-aligned storage (a list of item size 0 is absent: address 0);
    the card script runs the kernel on such views."""
    base = 1 << 20
    addresses = [0 if size == 0 else base + 4096 * k + off * size
                 for k, (off, size) in enumerate(zip(offsets, itemsizes))]
    assert _sgd_vector_head(addresses, itemsizes) == head
    if head != SGD_NO_VECTOR:
        assert all(a == 0 or (a + head * s) % 16 == 0
                   for a, s in zip(addresses, itemsizes))


def test_sgd_table_is_the_kernels_and_fits_the_parameter_limit():
    """The Python walk's constants are the C source's, and the kernel's
    parameters (its table and the rest) stay under CUDA 12.1's 32,764
    bytes, as the source's static_assert says."""
    src = ((CSRC / "multi_tensor_sgd.cu").read_text()
           + (CSRC / "multi_tensor_list.cuh").read_text())

    def const(name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert const("kSgdMaxTensors") == tK.SGD_TABLE_TENSORS
    assert const("kSgdChunk") == tK.SGD_CHUNK
    assert const("kListNoVector") == SGD_NO_VECTOR
    assert const("kListParamLimit") == KERNEL_PARAM_LIMIT == 32764
    assert "using SgdTable = ListTable<4, kSgdMaxTensors>;" in src
    assert _sgd_param_bytes(tK.SGD_TABLE_TENSORS) <= KERNEL_PARAM_LIMIT
    assert _sgd_param_bytes(tK.SGD_TABLE_TENSORS + 80) \
        > KERNEL_PARAM_LIMIT
    assert tK.SGD_CHUNK % 8 == 0


# ---------------------------------------------------------------------------
# LAMB stage 1's whole-list table (csrc/multi_tensor_lamb.cu on
# csrc/multi_tensor_list.cuh)
# ---------------------------------------------------------------------------

def _lamb_lists():
    """Named lists of tensor sizes: BERT-large's O2 parameters and
    GPT-350M's as the card script builds them (meta devices), 2000 tensors
    of 1-70,000 elements, and a list with empty tensors around a table's
    worth."""
    cs = _chip_smoke()
    rng = np.random.RandomState(5)
    return {
        "bert_large_O2": [int(np.prod(s)) for s, _ in cs.bert_param_specs()],
        "gpt350m": [int(np.prod(s)) for s in cs.gpt350m_shapes()],
        "2000_tensors": [int(n) for n in rng.randint(1, 70001, 2000)],
        "empties": [0, 5, 0] + [1] * (tK.LAMB_TABLE_TENSORS - 1) + [0, 0,
                                                                    70000,
                                                                    0]}


_LAMB_LAUNCHES = {"bert_large_O2": 1, "gpt350m": 1, "2000_tensors": 4,
                  "empties": 2}


@pytest.mark.parametrize("name", sorted(_LAMB_LAUNCHES))
def test_lamb_stage1_walk_covers_every_element_once(name):
    """Each block of each launch of ``lamb_stage1_plan`` finds its tensor
    by the kernel's search; the blocks' 64K-element ranges tile every
    non-empty tensor exactly once; block ``b`` of a launch writes partial
    ``b`` plus the chunks of the launches before it, which is the number
    ``chunk_counts`` gives that chunk (tensor after tensor), so stage 2 and
    the plain versions read the partials as before; one launch for
    BERT-large's and GPT-350M's lists, ceil(2000 / 605) for 2000."""
    numels = _lamb_lists()[name]
    plan = tK.lamb_stage1_plan(numels)
    assert len(plan) == tK.lamb_stage1_launches(numels) \
        == _LAMB_LAUNCHES[name]
    first_chunk = np.concatenate([[0], np.cumsum(tK.chunk_counts(numels))])
    ranges, slots, base = {}, [], 0
    for table in plan:
        assert 0 < len(table) <= tK.LAMB_TABLE_TENSORS
        starts = [first for _, first, _ in table]
        assert starts[0] == 0
        n_blocks = sum(chunks for _, _, chunks in table)
        for block in range(n_blocks):
            t = _sgd_block_owner(starts, block)
            i, first, _ = table[t]
            c = block - first
            s = c * tK.CHUNK
            e = min(numels[i], s + tK.CHUNK)
            assert s < e
            ranges.setdefault(i, []).append((s, e))
            assert base + block == first_chunk[i] + c
            slots.append(base + block)
        base += n_blocks
    assert slots == list(range(sum(tK.chunk_counts(numels))))
    assert sorted(ranges) == [i for i, n in enumerate(numels) if n > 0]
    for i, rs in ranges.items():
        ends = [0] + [e for _, e in sorted(rs)]
        assert [s for s, _ in sorted(rs)] == ends[:-1]
        assert ends[-1] == numels[i]


def test_lamb_table_is_the_kernels_and_fits_the_parameter_limit():
    """The Python walk's constants are the C source's; the five-list table
    at its cap, with the kernel's four pointers and two ints, fits CUDA
    12.1's 32,764 bytes of parameters, and one more tensor does not (the
    source's two static_asserts); the partials keep the 64K chunk."""
    src = (CSRC / "multi_tensor_lamb.cu").read_text()
    cap = int(re.search(r"kLambMaxTensors = (\d+);", src).group(1))
    assert cap == tK.LAMB_TABLE_TENSORS
    assert "using LambTable = ListTable<5, kLambMaxTensors>;" in src
    assert "kMTChunk" in src and tK.CHUNK == 65536
    assert _list_param_bytes(cap, 5, 4, 2) <= KERNEL_PARAM_LIMIT
    assert _list_param_bytes(cap + 1, 5, 4, 2) > KERNEL_PARAM_LIMIT


# ---------------------------------------------------------------------------
# the multi-tensor scale's whole-list table (csrc/multi_tensor_scale.cu on
# csrc/multi_tensor_list.cuh)
# ---------------------------------------------------------------------------

def _scale_lists():
    """Named lists of tensor sizes: BERT-large's O2 gradients and
    GPT-350M's parameters as the card script builds them (meta devices),
    2000 tensors of 1-70,000 elements, and a list with empty tensors around
    a table's worth."""
    lists = _lamb_lists()
    lists["empties"] = ([0, 5, 0] + [1] * (tK.SCALE_TABLE_TENSORS - 1)
                        + [0, 0, 70000, 0])
    return lists


_SCALE_LAUNCHES = {"bert_large_O2": 1, "gpt350m": 1, "2000_tensors": 2,
                   "empties": 2}


@pytest.mark.parametrize("name", sorted(_SCALE_LAUNCHES))
def test_scale_walk_covers_every_element_once(name):
    """Each block of each launch of ``scale_plan`` finds its tensor by the
    kernel's search, and the blocks' element ranges tile every non-empty
    tensor exactly once; empty tensors get no block; each launch holds at
    most a table's tensors, and the launches are those stated (one for
    BERT-large's and GPT-350M's lists, ceil(2000 / 1024) for 2000)."""
    numels = _scale_lists()[name]
    plan = tK.scale_plan(numels)
    assert len(plan) == tK.scale_launches(numels) == _SCALE_LAUNCHES[name]
    ranges = {}
    for table in plan:
        assert 0 < len(table) <= tK.SCALE_TABLE_TENSORS
        starts = [first for _, first, _ in table]
        assert starts[0] == 0
        n_blocks = sum(chunks for _, _, chunks in table)
        for block in range(n_blocks):
            t = _sgd_block_owner(starts, block)
            i, first, _ = table[t]
            s = (block - first) * tK.SCALE_CHUNK
            e = min(numels[i], s + tK.SCALE_CHUNK)
            assert s < e
            ranges.setdefault(i, []).append((s, e))
    assert sorted(ranges) == [i for i, n in enumerate(numels) if n > 0]
    for i, rs in ranges.items():
        ends = [0] + [e for _, e in sorted(rs)]
        assert [s for s, _ in sorted(rs)] == ends[:-1]
        assert ends[-1] == numels[i]


def test_scale_table_is_the_kernels_and_fits_the_parameter_limit():
    """The Python walk's constants are the C source's; the two-list table
    at its cap, with the kernel's two pointers and one int, fits CUDA
    12.1's 32,764 bytes of parameters (the source's static_assert); a
    chunk keeps a tensor's 16-byte phase (a multiple of 8 elements)."""
    src = ((CSRC / "multi_tensor_scale.cu").read_text()
           + (CSRC / "multi_tensor_list.cuh").read_text())

    def const(name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert const("kScaleMaxTensors") == tK.SCALE_TABLE_TENSORS
    assert const("kScaleChunk") == tK.SCALE_CHUNK
    assert const("kListNoVector") == SGD_NO_VECTOR
    assert const("kListParamLimit") == KERNEL_PARAM_LIMIT
    assert "using ScaleTable = ListTable<2, kScaleMaxTensors>;" in src
    assert "sizeof(ScaleTable) + 2 * 8 + 4 <= kListParamLimit" in src
    assert _list_param_bytes(tK.SCALE_TABLE_TENSORS, 2, 2, 1) \
        <= KERNEL_PARAM_LIMIT
    assert tK.SCALE_CHUNK % 8 == 0


@pytest.mark.parametrize("head", list(range(8)) + [SGD_NO_VECTOR])
@pytest.mark.parametrize("n", [1, 7, 9, 33, 65537, 2 * tK.SCALE_CHUNK + 5])
def test_scale_region_is_the_kernels_split(n, head):
    """The card script's ``scale_region``, which places the inf / NaN of
    its edge checks in a head, a 16-byte step or a tail, splits each
    chunk as ``scale_chunk`` does (the split of ``_sgd_chunk_split`` at
    ``SCALE_CHUNK``), and each element lands in one part."""
    cs = _chip_smoke()
    seen = np.zeros(n, np.int32)
    for s in range(0, n, tK.SCALE_CHUNK):
        parts = _sgd_chunk_split(s, min(n, s + tK.SCALE_CHUNK), head)
        for where, idx in zip(("head", "vector", "tail"), parts):
            assert all(cs.scale_region(i, n, head) == where for i in idx)
            seen[idx] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("offsets,dtypes,head", [
    ((0, 0), ("bfloat16", "bfloat16"), 0),
    ((3, 3), ("bfloat16", "bfloat16"), 5),
    ((3, 3), ("float32", "float16"), 5),
    ((1, 1), ("float32", "float32"), 3),
    ((7, 7), ("float16", "float32"), 1),
    ((1, 0), ("bfloat16", "bfloat16"), SGD_NO_VECTOR),
    ((1, 0), ("float32", "float16"), SGD_NO_VECTOR),
    ((0, 1), ("float32", "float32"), SGD_NO_VECTOR)])
def test_list_vector_head_is_the_kernels(offsets, dtypes, head):
    """The card script's ``list_vector_head`` on views at storage offsets
    (as its edge checks make them) is the kernel's rule
    (``_sgd_vector_head`` over the two lists' addresses)."""
    cs = _chip_smoke()
    views = []
    for off, dt in zip(offsets, dtypes):
        base = torch.empty(64 + off, dtype=getattr(torch, dt))
        assert base.data_ptr() % 16 == 0
        views.append(base[off:])
    assert cs.list_vector_head(views) == head == _sgd_vector_head(
        [v.data_ptr() for v in views], [v.element_size() for v in views])
