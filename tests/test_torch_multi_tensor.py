"""apex_tpu_torch multi-tensor scale, L2 norm and LAMB stages against
apex_tpu on the CPU.

The plain versions that CPU tensors take (the port's side of kernels #15,
#17, #20 and #21) are held against the JAX ``scale_packed``,
``l2norm_rowsq_packed``, ``lamb_stage1_packed`` and ``lamb_stage2_packed``
over the packed bucket of the same leaves (``bucketing.flatten_bucket``),
through the Pallas kernels in interpret mode and through the JAX default
path; the tensor-list functions (``multi_tensor_scale``,
``multi_tensor_l2norm``, ``clip_grad_norm_``) against their JAX namesakes.

The leaves have odd sizes (off the 128-lane multiple) and, in some cases,
one tensor of two 64K-element chunks, so the port's per-chunk partials are
summed across a chunk boundary.  Both sides run the same f32 math:
f32 results agree to 1e-6 relative; a result rounded to bf16 or f16 is
within one ulp of its dtype (the f32 value before rounding may differ in
its last bit, by the order of the partial sums).
"""

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


@pytest.mark.parametrize("special", [None, "inf", "nan"])
@pytest.mark.parametrize("in_dt,out_dt", [("f32", "f32"), ("bf16", "f32"),
                                          ("f32", "bf16"), ("f16", "f32"),
                                          ("bf16", "bf16")])
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
    with pytest.raises(NotImplementedError, match="#16"):
        multi_tensor_axpby(1.0, [torch.zeros(2)], 1.0, [torch.zeros(2)])


def test_multi_tensor_apply_takes_only_the_kernels_chunk():
    """The kernels' chunk is fixed at 64K elements (apex's usual 2048 *
    32): another ``chunk_size`` raises instead of being ignored."""
    assert MultiTensorApply(2048 * 32).chunk_size == tK.CHUNK
    with pytest.raises(ValueError, match="chunk"):
        MultiTensorApply(1024)
