"""apex_tpu_torch.contrib (layer_norm, multihead_attn, transducer, group_norm,
groupbn, cudnn_gbn, conv_bias_relu, focal_loss, index_mul_2d, fmha,
openfold_triton) against apex_tpu.contrib on the CPU.

Each case of ``tests/test_contrib_wave1.py``, ``test_contrib_wave2.py`` and
``test_contrib_attention.py`` for these modules has a counterpart here that
runs the same numpy inputs (made from a seed) through the JAX module and
the port and compares them.  Where the JAX module reaches a Pallas kernel
(flash attention, LayerNorm) it runs twice, in interpret mode
(``set_force_pallas(True)``) and on its default path (``jax_path``); the
port takes its plain versions.  JAX's parameters are carried over with
``convert.mha_params_from_jax`` or copied.

Tolerances, all f32 unless stated: outputs 2e-5 (attention, norms: the
same sums in another order), 1e-5 (lattice losses: 48 logaddexp steps),
1e-6 (element-wise chains and joints); gradients within 2e-5 of each
tensor's largest entry (1e-5 for the element-wise ops); bf16 outputs
compared in f32 at one bf16 ulp (2^-7 relative).  Dropout is compared
exactly where both packages draw the same mask (the kernels' counter hash
of one int seed); a Bernoulli mask from a generator is checked against its
own definition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.utils import set_force_pallas
from apex_tpu.utils.collectives import shard_map_compat as shard_map
from jax.sharding import PartitionSpec as P

import apex_tpu.contrib.conv_bias_relu as jcbr
import apex_tpu.contrib.cudnn_gbn as jgbn
import apex_tpu.contrib.fmha as jfmha
import apex_tpu.contrib.focal_loss as jfocal
import apex_tpu.contrib.group_norm as jgn
import apex_tpu.contrib.groupbn as jbn
import apex_tpu.contrib.index_mul_2d as jidx
import apex_tpu.contrib.layer_norm as jln
import apex_tpu.contrib.multihead_attn as jmha
import apex_tpu.contrib.openfold_triton as jof
import apex_tpu.contrib.transducer as jtr
import apex_tpu_torch.contrib.conv_bias_relu as tcbr
import apex_tpu_torch.contrib.cudnn_gbn as tgbn
import apex_tpu_torch.contrib.fmha as tfmha
import apex_tpu_torch.contrib.focal_loss as tfocal
import apex_tpu_torch.contrib.group_norm as tgn
import apex_tpu_torch.contrib.groupbn as tbn
import apex_tpu_torch.contrib.index_mul_2d as tidx
import apex_tpu_torch.contrib.layer_norm as tln
import apex_tpu_torch.contrib.multihead_attn as tmha
import apex_tpu_torch.contrib.openfold_triton as tof
import apex_tpu_torch.contrib.transducer as ttr
from apex_tpu_torch.convert import mha_params_from_jax
from apex_tpu_torch.ops import flash_attention as tfa

from _torch_dist import run as run_ranks

ATTN = dict(rtol=2e-5, atol=2e-5)
EXACTISH = dict(rtol=1e-6, atol=1e-6)

PAIRS = {"conv_bias_relu": (jcbr, tcbr), "cudnn_gbn": (jgbn, tgbn),
         "fmha": (jfmha, tfmha), "focal_loss": (jfocal, tfocal),
         "group_norm": (jgn, tgn), "groupbn": (jbn, tbn),
         "index_mul_2d": (jidx, tidx), "layer_norm": (jln, tln),
         "multihead_attn": (jmha, tmha), "openfold_triton": (jof, tof),
         "transducer": (jtr, ttr)}


@pytest.fixture(params=["pallas_interpret", "jax_default"])
def jax_path(request):
    set_force_pallas(True if request.param == "pallas_interpret" else None)
    yield request.param
    set_force_pallas(None)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.requires_grad_() if grad else t


def _np(t):
    return t.detach().float().numpy()


def _grad_close(got, want, rel=2e-5):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(_np(got) - want).max()) <= rel * scale


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_exports_every_name_of_the_reference(name):
    ref, port = PAIRS[name]
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, n) for n in ref.__all__)


def test_contrib_table_lists_the_ported_subpackages():
    import apex_tpu_torch.contrib as contrib
    for name in PAIRS:
        assert name in contrib._SUBMODULES and getattr(contrib, name) \
            is PAIRS[name][1]
    with pytest.raises(AttributeError):
        contrib.sparsity  # noqa: B018  (the next slice's)


# -- focal_loss ---------------------------------------------------------------

FOCAL_CASES = [
    dict(shape=(6, 5), targets=[0, 2, -1, 4, -1, 1], npos=4.0),
    dict(shape=(4, 8), targets=[1, -2, 3, -2], npos=2.0, num_real=6),
    dict(shape=(2, 3, 7), targets=[[0, -1, 6], [-2, 3, 5]], npos=0.0,
         smoothing=0.1, alpha=0.3, gamma=1.5),
]


@pytest.mark.parametrize("case", range(len(FOCAL_CASES)))
def test_focal_loss_and_grad_match_jax(case):
    c = FOCAL_CASES[case]
    logits = np.random.RandomState(case).randn(*c["shape"]).astype(
        np.float32)
    targets = np.asarray(c["targets"])
    kw = dict(num_real_classes=c.get("num_real"), alpha=c.get("alpha", 0.25),
              gamma=c.get("gamma", 2.0),
              label_smoothing=c.get("smoothing", 0.0))
    jv, jg = jax.value_and_grad(lambda x: jfocal.focal_loss(
        x, jnp.asarray(targets), c["npos"], **kw))(jnp.asarray(logits))
    x = _t(logits, grad=True)
    tv = tfocal.focal_loss(x, _t(targets), c["npos"], **kw)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    _grad_close(x.grad, jg, 1e-5)


def test_focal_loss_ignored_rows_contribute_nothing():
    rng = np.random.RandomState(1)
    logits = rng.randn(4, 8).astype(np.float32)
    targets = _t(np.asarray([1, -2, 3, -2]))
    full = tfocal.focal_loss(_t(logits), targets, 2.0, num_real_classes=6)
    logits[1], logits[3] = 100.0, -100.0
    again = tfocal.focal_loss(_t(logits), targets, 2.0, num_real_classes=6)
    np.testing.assert_allclose(float(full), float(again), rtol=1e-6)


def test_focal_loss_apply_wrapper_matches_jax():
    logits = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    targets = np.asarray([0, 1, 2, -1])
    jv = jfocal.FocalLoss.apply(jnp.asarray(logits), jnp.asarray(targets),
                                3.0, 5, 0.25, 2.0)
    tv = tfocal.FocalLoss.apply(_t(logits), _t(targets), 3.0, 5, 0.25, 2.0)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)


# -- index_mul_2d -------------------------------------------------------------

@pytest.mark.parametrize("idx", [[3, 0, 9, 3], [1, 1]])
def test_index_mul_2d_and_grad_match_jax(idx):
    rng = np.random.RandomState(len(idx))
    in1 = rng.randn(10, 7).astype(np.float32)
    in2 = rng.randn(len(idx), 7).astype(np.float32)
    idx = np.asarray(idx)
    jout, jvjp = jax.vjp(lambda a, b: jidx.index_mul_2d(a, b, jnp.asarray(
        idx)), jnp.asarray(in1), jnp.asarray(in2))
    dy = rng.randn(len(idx), 7).astype(np.float32)
    jg1, jg2 = jvjp(jnp.asarray(dy))
    a, b = _t(in1, True), _t(in2, True)
    out = tidx.index_mul_2d(a, b, _t(idx))
    out.backward(_t(dy))
    np.testing.assert_allclose(_np(out), np.asarray(jout), **EXACTISH)
    _grad_close(a.grad, jg1, 1e-6)       # duplicates scatter-add
    _grad_close(b.grad, jg2, 1e-6)
    with pytest.raises(ValueError):
        tidx.index_mul_2d(a[0], b, _t(idx))


# -- group_norm ---------------------------------------------------------------

@pytest.mark.parametrize("act", ["", "silu", "swish"])
@pytest.mark.parametrize("affine", [True, False])
def test_group_norm_matches_jax(act, affine):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 4, 8).astype(np.float32)
    w = rng.rand(8).astype(np.float32) + 0.5
    b = rng.randn(8).astype(np.float32)
    jm = jgn.GroupNorm(4, 8, affine=affine, act=act)
    params = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)} \
        if affine else {}
    jy, jvjp = jax.vjp(lambda x, p: jm(p, x), jnp.asarray(x), params)
    tm = tgn.GroupNorm(4, 8, affine=affine, act=act, device="cpu")
    if affine:
        with torch.no_grad():
            tm.weight.copy_(_t(w))
            tm.bias.copy_(_t(b))
    tx = _t(x, True)
    ty = tm(tx)
    dy = rng.randn(*x.shape).astype(np.float32)
    ty.backward(_t(dy))
    jdx, jdp = jvjp(jnp.asarray(dy))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    _grad_close(tx.grad, jdx)
    if affine:
        _grad_close(tm.weight.grad, jdp["weight"])
        _grad_close(tm.bias.grad, jdp["bias"])


def test_group_norm_bf16_io_matches_jax():
    x = np.random.RandomState(4).randn(1, 4, 4, 16).astype(np.float32)
    jy = jgn.group_norm_nhwc(jnp.asarray(x, jnp.bfloat16), 4)
    ty = tgn.group_norm_nhwc(_t(x).bfloat16(), 4)
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_group_norm_refusals_match_jax():
    x = np.zeros((1, 2, 2, 6), np.float32)
    for fn, arr in ((jgn.group_norm_nhwc, jnp.asarray(x)),
                    (tgn.group_norm_nhwc, _t(x))):
        with pytest.raises(ValueError, match="divisible"):
            fn(arr, 4)
        with pytest.raises(ValueError, match="unsupported act"):
            fn(arr, 3, act="gelu")


# -- transducer ---------------------------------------------------------------

def _numpy_rnnt_loss(x, label, t_len, u_len, blank=0):
    """The textbook O(T U) recursion in numpy (the JAX test's)."""
    alpha = np.full((t_len, u_len + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(t_len):
        for u in range(u_len + 1):
            if t == 0 and u == 0:
                continue
            cands = []
            if t > 0:
                cands.append(alpha[t - 1, u] + x[t - 1, u, blank])
            if u > 0:
                cands.append(alpha[t, u - 1] + x[t, u - 1, label[u - 1]])
            alpha[t, u] = np.logaddexp.reduce(cands)
    return -(alpha[t_len - 1, u_len] + x[t_len - 1, u_len, blank])


LATTICES = [
    # (B, T, U, V, f_len, y_len, blank): ragged, full, edges
    (3, 7, 4, 6, [7, 5, 6], [4, 2, 3], 0),
    (2, 5, 3, 4, [5, 4], [3, 2], 0),
    (4, 6, 5, 7, [1, 6, 3, 6], [0, 5, 5, 0], 2),
    (2, 12, 9, 5, [12, 7], [9, 4], 0),
]


@pytest.mark.parametrize("case", range(len(LATTICES)))
def test_transducer_loss_and_grad_match_jax(case):
    b, t, u, v, f_len, y_len, blank = LATTICES[case]
    rng = np.random.RandomState(10 + case)
    raw = rng.randn(b, t, u + 1, v).astype(np.float32)
    label = rng.randint(0, v, (b, u))
    label = np.where(label == blank, (blank + 1) % v, label)
    f_len, y_len = np.asarray(f_len), np.asarray(y_len)

    def jloss(r):
        x = jax.nn.log_softmax(r, axis=-1)
        return jtr.transducer_loss(x, jnp.asarray(label), jnp.asarray(f_len),
                                   jnp.asarray(y_len), blank_idx=blank)
    jl, jvjp = jax.vjp(jloss, jnp.asarray(raw))
    w = rng.rand(b).astype(np.float32)
    (jg,) = jvjp(jnp.asarray(w))
    r = _t(raw, True)
    tl = ttr.transducer_loss(torch.log_softmax(r, -1), _t(label), _t(f_len),
                             _t(y_len), blank_idx=blank)
    (tl * _t(w)).sum().backward()
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    x = np.asarray(jax.nn.log_softmax(raw, -1))
    for i in range(b):
        np.testing.assert_allclose(
            float(tl[i].detach()), _numpy_rnnt_loss(x[i], label[i], f_len[i],
                                           y_len[i], blank), rtol=1e-5)
    _grad_close(r.grad, jg, 1e-5)


def test_transducer_grads_past_f_len_are_zero():
    rng = np.random.RandomState(5)
    raw = _t(rng.randn(2, 5, 4, 4).astype(np.float32), True)
    f_len, y_len = _t(np.asarray([5, 4])), _t(np.asarray([3, 2]))
    ttr.transducer_loss(torch.log_softmax(raw, -1),
                        _t(rng.randint(1, 4, (2, 3))), f_len,
                        y_len).sum().backward()
    assert torch.isfinite(raw.grad).all()
    np.testing.assert_allclose(_np(raw.grad[1, 4]), 0.0, atol=1e-6)


def test_transducer_joint_dense_and_relu_match_jax():
    rng = np.random.RandomState(6)
    f = rng.randn(2, 5, 8).astype(np.float32)
    g = rng.randn(2, 3, 8).astype(np.float32)
    for relu in (False, True):
        jy = jtr.TransducerJoint(relu=relu)(jnp.asarray(f), jnp.asarray(g))
        ty = ttr.TransducerJoint(relu=relu)(_t(f), _t(g))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **EXACTISH)


@pytest.mark.parametrize("packed_batch", [18, 11])
def test_transducer_joint_packed_matches_jax(packed_batch):
    """The packed layout; at 11 rows the last sample's tail is out of range
    and dropped.  The gradient reaches f and g through the kept rows."""
    rng = np.random.RandomState(7)
    f = rng.randn(2, 4, 6).astype(np.float32)
    g = rng.randn(2, 3, 6).astype(np.float32)
    f_len, g_len, offsets = [3, 4], [2, 3], [0, 6]

    def jrun(f, g):
        return jtr.transducer_joint(
            f, g, jnp.asarray(f_len), jnp.asarray(g_len), pack_output=True,
            relu=True, batch_offsets=jnp.asarray(offsets),
            packed_batch=packed_batch)
    jy, jvjp = jax.vjp(jrun, jnp.asarray(f), jnp.asarray(g))
    tf, tg = _t(f, True), _t(g, True)
    ty = ttr.TransducerJoint(pack_output=True, relu=True)(
        tf, tg, _t(np.asarray(f_len)), _t(np.asarray(g_len)),
        _t(np.asarray(offsets)), packed_batch)
    dy = rng.randn(packed_batch, 6).astype(np.float32)
    ty.backward(_t(dy))
    jdf, jdg = jvjp(jnp.asarray(dy))
    assert ty.shape == (packed_batch, 6)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **EXACTISH)
    _grad_close(tf.grad, jdf, 1e-6)
    _grad_close(tg.grad, jdg, 1e-6)
    with pytest.raises(ValueError, match="pack_output needs"):
        ttr.transducer_joint(tf, tg, pack_output=True)


def test_transducer_joint_dropout_takes_a_generator():
    rng = np.random.RandomState(8)
    f, g = _t(rng.randn(2, 6, 16).astype(np.float32)), _t(
        rng.randn(2, 4, 16).astype(np.float32))
    joint = ttr.TransducerJoint(relu=True, dropout=True, dropout_prob=0.25)
    plain = ttr.transducer_joint(f, g, relu=True)
    y = joint(f, g, generator=torch.Generator().manual_seed(3))
    again = joint(f, g, generator=torch.Generator().manual_seed(3))
    kept = y != 0
    assert torch.equal(y, again)
    torch.testing.assert_close(y[kept], (plain / 0.75)[kept], rtol=1e-6,
                               atol=1e-6)
    assert 0.6 < float((kept | (plain == 0)).float().mean()) < 0.9
    with pytest.raises(ValueError, match="generator"):
        joint(f, g)


def test_transducer_loss_module_surface_matches_jax():
    x = np.asarray(jax.nn.log_softmax(np.random.RandomState(9).randn(
        1, 4, 3, 5).astype(np.float32), -1))
    args = (np.asarray([[1, 2]]), np.asarray([4]), np.asarray([2]))
    jl = jtr.TransducerLoss()(jnp.asarray(x), *map(jnp.asarray, args))
    tl = ttr.TransducerLoss()(_t(x), *map(_t, args))
    assert tl.shape == (1,)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-6)
    for cls in (jtr.TransducerLoss, ttr.TransducerLoss):
        with pytest.raises(ValueError, match="packed_input"):
            cls(packed_input=True)


# -- groupbn / cudnn_gbn --------------------------------------------------------

def _bn_pair(c, momentum, jcls=jbn.BatchNorm2d_NHWC,
             tcls=tbn.BatchNorm2d_NHWC, seed=11, **kw):
    rng = np.random.RandomState(seed)
    w = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    b = (0.2 * rng.randn(c)).astype(np.float32)
    jm = jcls(c, momentum=momentum, **kw)
    tm = tcls(c, momentum=momentum, device="cpu", **kw)
    with torch.no_grad():
        tm.weight.copy_(_t(w))
        tm.bias.copy_(_t(b))
    return jm, {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, tm


@pytest.mark.parametrize("fuse_relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_groupbn_train_matches_jax(fuse_relu, residual):
    rng = np.random.RandomState(12)
    x = rng.randn(4, 3, 3, 8).astype(np.float32)
    z = rng.randn(4, 3, 3, 8).astype(np.float32) if residual else None
    jm, params, tm = _bn_pair(8, 0.8, fuse_relu=fuse_relu)
    state = jm.init_state()

    def jrun(x, p):
        return jm(p, state, x, None if z is None else jnp.asarray(z),
                  training=True)
    (jy, jst), jvjp = jax.vjp(jrun, jnp.asarray(x), params)
    tx = _t(x, True)
    ty = tm(tx, None if z is None else _t(z))
    dy = rng.randn(*x.shape).astype(np.float32)
    ty.backward(_t(dy))
    jdx, jdp = jvjp((jnp.asarray(dy), jax.tree_util.tree_map(
        jnp.zeros_like, jst)))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tm.running_mean),
                               np.asarray(jst["running_mean"]), **EXACTISH)
    np.testing.assert_allclose(_np(tm.running_var),
                               np.asarray(jst["running_var"]), rtol=1e-6)
    _grad_close(tx.grad, jdx)
    _grad_close(tm.weight.grad, jdp["weight"])
    _grad_close(tm.bias.grad, jdp["bias"])


def test_groupbn_momentum_is_the_jax_convention():
    """running = m * running + (1 - m) * batch, the unbiased variance."""
    x = np.random.RandomState(13).randn(4, 3, 3, 8).astype(np.float32)
    _, _, tm = _bn_pair(8, 0.8)
    tm(_t(x))
    n = x.size // 8
    np.testing.assert_allclose(_np(tm.running_var),
                               0.8 + 0.2 * x.var(axis=(0, 1, 2)) * n / (n - 1),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(tm.running_mean),
                               0.2 * x.mean(axis=(0, 1, 2)), rtol=1e-5,
                               atol=1e-7)


def test_groupbn_eval_uses_running_stats_as_jax():
    x = np.random.RandomState(14).randn(2, 2, 2, 4).astype(np.float32)
    jm, params, tm = _bn_pair(4, 0.9)
    state = {"running_mean": jnp.asarray([1.0, 0, 0, 0]),
             "running_var": jnp.full((4,), 2.0)}
    jy, same = jm(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        tm.running_mean.copy_(_t(np.asarray([1.0, 0, 0, 0], np.float32)))
        tm.running_var.fill_(2.0)
    tm.eval()
    ty = tm(_t(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **EXACTISH)
    assert same is state and float(tm.running_var[0]) == 2.0


def test_groupbn_bf16_io_matches_jax():
    x = np.random.RandomState(15).randn(2, 3, 3, 8).astype(np.float32)
    jm, params, tm = _bn_pair(8, 0.9)
    jy, _ = jm(params, jm.init_state(), jnp.asarray(x, jnp.bfloat16))
    ty = tm(_t(x).bfloat16())
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_cudnn_gbn_matches_groupbn_and_jax():
    x = np.random.RandomState(16).randn(4, 4, 4, 8).astype(np.float32)
    jm, params, tm = _bn_pair(8, 0.9, jgbn.GroupBatchNorm2d,
                              tgbn.GroupBatchNorm2d)
    _, _, ref = _bn_pair(8, 0.9)
    jy, _ = jm(params, jm.init_state(), jnp.asarray(x), training=True)
    ty = tm(_t(x))
    np.testing.assert_allclose(_np(ty), _np(ref(_t(x))), rtol=0, atol=0)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_group_statistics_require_a_group_as_jax_requires_an_axis():
    with pytest.raises(ValueError, match="axis_name"):
        jgbn.GroupBatchNorm2d(8, group_size=4)
    with pytest.raises(ValueError, match="axis_name"):
        jbn.BatchNorm2d_NHWC(8, bn_group=2)
    with pytest.raises(ValueError, match="process_group"):
        tgbn.GroupBatchNorm2d(8, group_size=4, device="cpu")
    with pytest.raises(ValueError, match="process_group"):
        tbn.BatchNorm2d_NHWC(8, bn_group=2, device="cpu")
    tgbn.GroupBatchNorm2d(8, group_size=4, process_group="data",
                          device="cpu")


def test_group_statistics_on_two_gloo_ranks_match_jax(tmp_path):
    """groupbn and cudnn_gbn over 2 ranks (each half the batch) against
    JAX's ``shard_map`` over a 2-device ``data`` axis (its
    ``test_sync_over_mesh_axis`` / ``test_cross_device_stats``) and
    against JAX's BN of the whole batch (outputs, running statistics, and
    the gradients of sum(y * dy), which the group's backward sums)."""
    world, c = 2, 8
    rng = np.random.RandomState(17)
    x = rng.randn(world, 3, 4, 4, c).astype(np.float32)
    dy = rng.randn(world, 3, 4, 4, c).astype(np.float32)
    w = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    b = (0.2 * rng.randn(c)).astype(np.float32)
    ranks = run_ranks(tmp_path, world, "contrib_bn",
                      dict(x=x, dy=dy, w=w, b=b, momentum=0.8))
    params = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    full = jnp.asarray(x.reshape(-1, 4, 4, c))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:world]), ("data",))
    for name, jcls, kw in (
            ("groupbn", jbn.BatchNorm2d_NHWC, dict(bn_group=world)),
            ("cudnn_gbn", jgbn.GroupBatchNorm2d, dict(group_size=world))):
        jm = jcls(c, momentum=0.8, axis_name="data", **kw)
        state = jm.init_state()

        def f(x, jm=jm, state=state):
            y, st = jm(params, state, x, training=True)
            return y, st["running_mean"], st["running_var"]
        ys, rmean, rvar = jax.jit(shard_map(
            f, mesh=mesh, in_specs=(P("data"),),
            out_specs=(P("data"), P(), P())))(full)
        serial = jbn.BatchNorm2d_NHWC(c, momentum=0.8)
        (y_ref, st), vjp = jax.vjp(
            lambda x, p: serial(p, state, x, training=True), full, params)
        dx, dp = vjp((jnp.asarray(dy.reshape(full.shape)),
                      jax.tree_util.tree_map(jnp.zeros_like, st)))
        got_y = np.concatenate([r[name]["y"] for r in ranks])
        np.testing.assert_allclose(got_y, np.asarray(ys), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got_y, np.asarray(y_ref), rtol=2e-4,
                                   atol=2e-4)
        for r in ranks:
            np.testing.assert_allclose(r[name]["running"][0],
                                       np.asarray(rmean), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(r[name]["running"][1],
                                       np.asarray(rvar), rtol=1e-5)
            _grad_close(_t(r[name]["dw"]), dp["weight"])
            _grad_close(_t(r[name]["db"]), dp["bias"])
        _grad_close(_t(np.concatenate([r[name]["dx"] for r in ranks])), dx)


# -- conv_bias_relu -----------------------------------------------------------

CONV_CASES = [  # (x shape, w shape, padding, stride)
    ((2, 8, 8, 3), (3, 3, 3, 16), 1, 2),
    ((2, 8, 8, 3), (3, 3, 3, 16), 1, 1),
    ((1, 6, 6, 2), (1, 1, 2, 4), 0, 1),
]


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
@pytest.mark.parametrize("fn", ["ConvBias", "ConvBiasReLU",
                                "ConvBiasMaskReLU", "ConvFrozenScaleBiasReLU"])
def test_conv_bias_relu_and_grads_match_jax(fn, case):
    xs, ws, padding, stride = CONV_CASES[case]
    rng = np.random.RandomState(20 + case)
    x = rng.randn(*xs).astype(np.float32)
    w = (0.3 * rng.randn(*ws)).astype(np.float32)
    c = ws[-1]
    b = (0.1 * rng.randn(c)).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    out_hw = (xs[1] + 2 * padding - ws[0]) // stride + 1
    mask = (rng.rand(xs[0], out_hw, out_hw, c) > 0.5).astype(np.float32)
    extra = {"ConvBiasMaskReLU": [mask],
             "ConvFrozenScaleBiasReLU": [scale]}.get(fn, [])

    def args(x, w, b, lib):
        conv = [x, w] + ([lib(extra[0])] if fn == "ConvFrozenScaleBiasReLU"
                         else []) + [b]
        if fn == "ConvBiasMaskReLU":
            conv.append(lib(extra[0]))
        return conv
    jy, jvjp = jax.vjp(lambda x, w, b: getattr(jcbr, fn)(
        *args(x, w, b, jnp.asarray), padding=padding, stride=stride),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = _t(x, True), _t(w, True), _t(b, True)
    ty = getattr(tcbr, fn)(*args(tx, tw, tb, _t), padding=padding,
                           stride=stride)
    dy = rng.randn(*ty.shape).astype(np.float32)
    ty.backward(_t(dy))
    jg = jvjp(jnp.asarray(dy))
    assert ty.shape == jy.shape
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for got, want in zip((tx, tw, tb), jg):
        _grad_close(got.grad, want)


# -- layer_norm ---------------------------------------------------------------

def test_fast_layer_norm_matches_jax(jax_path):
    rng = np.random.RandomState(30)
    x = rng.randn(8, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    b = (0.1 * rng.randn(64)).astype(np.float32)
    jm = jln.FastLayerNorm(64)
    params = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    jy, jvjp = jax.vjp(lambda x, p: jm(p, x), jnp.asarray(x), params)
    tm = tln.FastLayerNorm(64, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(_t(w))
        tm.bias.copy_(_t(b))
    tx = _t(x, True)
    ty = tm(tx)
    dy = rng.randn(8, 64).astype(np.float32)
    ty.backward(_t(dy))
    jdx, jdp = jvjp(jnp.asarray(dy))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    _grad_close(tx.grad, jdx)
    _grad_close(tm.weight.grad, jdp["weight"])
    _grad_close(tm.bias.grad, jdp["bias"])
    np.testing.assert_allclose(
        _np(tln.fast_layer_norm(_t(x), _t(w), _t(b), 1e-3)),
        np.asarray(jln.fast_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), 1e-3)), **ATTN)


# -- multihead_attn -----------------------------------------------------------

def _mha(cls, jcls, embed, heads, seed, **kw):
    jm = jcls(embed, heads, **kw)
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm = cls(embed, heads, device="cpu", **kw)
    tm.load_state_dict(mha_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return jm, params, tm


def _jax_seed(key):
    """The int seed the JAX modules draw from their dropout key."""
    return int(jax.random.randint(key, (), 0, 2 ** 31 - 1, jnp.int32))


@pytest.mark.parametrize("kw", [dict(bias=True), dict(include_norm_add=True),
                                dict(bias=True, include_norm_add=True)],
                         ids=["bias", "norm_add", "bias_norm_add"])
def test_self_mha_and_grads_match_jax(jax_path, kw):
    jm, params, tm = _mha(tmha.SelfMultiheadAttn, jmha.SelfMultiheadAttn,
                          64, 4, 0, **kw)
    rng = np.random.RandomState(31)
    x = rng.randn(16, 2, 64).astype(np.float32)
    jy, jvjp = jax.vjp(lambda p, x: jm(p, x), params, jnp.asarray(x))
    tx = _t(x, True)
    ty = tm(tx)
    dy = rng.randn(*x.shape).astype(np.float32)
    ty.backward(_t(dy))
    jdp, jdx = jvjp(jnp.asarray(dy))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    _grad_close(tx.grad, jdx)
    want = mha_params_from_jax(jax.tree_util.tree_map(np.asarray, jdp), tm)
    for n, p in tm.named_parameters():
        _grad_close(p.grad, want[n].numpy())


def test_self_mha_kv_seqlens_match_jax(jax_path):
    jm, params, tm = _mha(tmha.SelfMultiheadAttn, jmha.SelfMultiheadAttn,
                          64, 4, 1)
    x = np.random.RandomState(32).randn(12, 3, 64).astype(np.float32)
    lens = np.asarray([12, 5, 9], np.int32)
    jy = jm(params, jnp.asarray(x), kv_seqlens=jnp.asarray(lens))
    ty = tm(_t(x), kv_seqlens=_t(lens))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)


def test_self_mha_key_padding_mask_matches_jax(jax_path):
    jm, params, tm = _mha(tmha.SelfMultiheadAttn, jmha.SelfMultiheadAttn,
                          32, 2, 2)
    rng = np.random.RandomState(33)
    x = rng.randn(8, 3, 32).astype(np.float32)
    mask = rng.rand(3, 8) > 0.7
    jy = jm(params, jnp.asarray(x), key_padding_mask=jnp.asarray(mask))
    ty = tm(_t(x), key_padding_mask=_t(mask))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)


def test_mha_dropout_with_the_jax_seed_matches_jax(jax_path):
    """Flash-path dropout: the port given the int JAX draws from its key
    drops the same probabilities (the kernels' counter hash)."""
    jm, params, tm = _mha(tmha.SelfMultiheadAttn, jmha.SelfMultiheadAttn,
                          64, 4, 3, dropout=0.3, bias=True)
    rng = np.random.RandomState(34)
    x = rng.randn(16, 2, 64).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jy, jvjp = jax.vjp(lambda x: jm(params, x, dropout_rng=key),
                       jnp.asarray(x))
    tx = _t(x, True)
    ty = tm(tx, dropout_seed=_jax_seed(key))
    dy = rng.randn(*x.shape).astype(np.float32)
    ty.backward(_t(dy))
    (jdx,) = jvjp(jnp.asarray(dy))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    _grad_close(tx.grad, jdx)
    plain = tm(_t(x), is_training=False)
    assert float((ty - plain).detach().abs().max()) > 1e-3   # dropped


def test_mha_dropout_needs_a_seed_and_eval_is_deterministic():
    jm, params, tm = _mha(tmha.SelfMultiheadAttn, jmha.SelfMultiheadAttn,
                          32, 2, 4, dropout=0.5)
    x = np.random.RandomState(35).randn(4, 1, 32).astype(np.float32)
    with pytest.raises(ValueError, match="dropout_seed"):
        tm(_t(x))
    with pytest.raises(ValueError, match="dropout_rng"):
        jm(params, jnp.asarray(x))
    assert tm(_t(x), dropout_seed=7).shape == (4, 1, 32)
    o1, o2 = tm(_t(x), is_training=False), tm(_t(x), is_training=False)
    assert torch.equal(o1, o2)
    np.testing.assert_allclose(
        _np(o1), np.asarray(jm(params, jnp.asarray(x), is_training=False)),
        **ATTN)


def test_materialized_path_draws_dropout_from_the_seed():
    """With a padding mask, dropout is the reference's generator draw
    seeded by the int (JAX's materialized path draws from its key, so
    there is no shared mask to hold): one seed repeats its output, another
    seed or the flash path's hash mask drops other probabilities, and the
    output is the reference's with that generator."""
    _, _, tm = _mha(tmha.SelfMultiheadAttn, jmha.SelfMultiheadAttn, 32, 2, 5,
                    dropout=0.2)
    x = _t(np.random.RandomState(36).randn(8, 2, 32).astype(np.float32))
    nothing = torch.zeros(2, 8, dtype=torch.bool)
    y = tm(x, key_padding_mask=nothing, dropout_seed=11)
    assert torch.equal(y, tm(x, key_padding_mask=nothing, dropout_seed=11))
    for other in (tm(x, key_padding_mask=nothing, dropout_seed=12),
                  tm(x, dropout_seed=11),
                  tm(x, key_padding_mask=nothing, is_training=False)):
        assert float((y - other).detach().abs().max()) > 1e-3
    qkv = torch.nn.functional.linear(x, tm.in_proj.weight)
    q, k, v = (t.reshape(8, 2, 2, 16).permute(1, 2, 0, 3)
               for t in qkv.chunk(3, dim=-1))
    ctx = tfa.flash_attention_reference(
        q, k, v, key_padding_mask=nothing, dropout=0.2,
        generator=torch.Generator().manual_seed(11))
    want = torch.nn.functional.linear(
        ctx.permute(2, 0, 1, 3).reshape(8, 2, 32), tm.out_proj.weight)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


def test_materialized_path_takes_kv_seqlens_and_the_mask(jax_path):
    jm, params, tm = _mha(tmha.SelfMultiheadAttn, jmha.SelfMultiheadAttn,
                          32, 2, 6)
    x = np.random.RandomState(37).randn(8, 2, 32).astype(np.float32)
    lens = np.asarray([5, 8], np.int32)
    mask = np.zeros((2, 8), bool)
    mask[0, 1] = True
    jy = jm(params, jnp.asarray(x), key_padding_mask=jnp.asarray(mask),
            kv_seqlens=jnp.asarray(lens))
    ty = tm(_t(x), key_padding_mask=_t(mask), kv_seqlens=_t(lens))
    combined = mask | (np.arange(8)[None, :] >= lens[:, None])
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    torch.testing.assert_close(ty, tm(_t(x), key_padding_mask=_t(combined)),
                               rtol=1e-6, atol=1e-6)


def test_fully_masked_row_outputs_zero_as_jax(jax_path):
    jm, params, tm = _mha(tmha.SelfMultiheadAttn, jmha.SelfMultiheadAttn,
                          32, 2, 7)
    x = np.random.RandomState(38).randn(4, 2, 32).astype(np.float32)
    mask = np.zeros((2, 4), bool)
    mask[1] = True
    ty = tm(_t(x), key_padding_mask=_t(mask))
    jy = jm(params, jnp.asarray(x), key_padding_mask=jnp.asarray(mask))
    np.testing.assert_allclose(_np(ty[:, 1]), 0.0, atol=1e-6)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)


@pytest.mark.parametrize("kw", [dict(bias=True), dict(include_norm_add=True)],
                         ids=["bias", "norm_add"])
def test_encdec_mha_and_grads_match_jax(jax_path, kw):
    jm, params, tm = _mha(tmha.EncdecMultiheadAttn,
                          jmha.EncdecMultiheadAttn, 64, 4, 8, **kw)
    rng = np.random.RandomState(39)
    q = rng.randn(8, 2, 64).astype(np.float32)
    mem = rng.randn(16, 2, 64).astype(np.float32)
    lens = np.asarray([16, 11], np.int32)
    jy, jvjp = jax.vjp(lambda p, q, m: jm(p, q, m,
                                          kv_seqlens=jnp.asarray(lens)),
                       params, jnp.asarray(q), jnp.asarray(mem))
    tq, tmem = _t(q, True), _t(mem, True)
    ty = tm(tq, tmem, kv_seqlens=_t(lens))
    dy = rng.randn(*q.shape).astype(np.float32)
    ty.backward(_t(dy))
    jdp, jdq, jdm = jvjp(jnp.asarray(dy))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    _grad_close(tq.grad, jdq)
    _grad_close(tmem.grad, jdm)
    want = mha_params_from_jax(jax.tree_util.tree_map(np.asarray, jdp), tm)
    for n, p in tm.named_parameters():
        _grad_close(p.grad, want[n].numpy())


def test_mha_refuses_indivisible_heads():
    for cls in (jmha.SelfMultiheadAttn, jmha.EncdecMultiheadAttn):
        with pytest.raises(ValueError, match="divisible"):
            cls(30, 4)
    for cls in (tmha.SelfMultiheadAttn, tmha.EncdecMultiheadAttn):
        with pytest.raises(ValueError, match="divisible"):
            cls(30, 4, device="cpu")


def test_flash_reference_padding_mask_and_generator_dropout():
    """``flash_attention_reference``'s new arguments: a padding mask equals
    the same keys cut by ``kv_seqlens``; the generator's Bernoulli mask
    keeps about 1 - p of the probabilities, scaled by 1 / (1 - p), and one
    seed repeats it."""
    rng = np.random.RandomState(40)
    q, k, v = (_t(rng.randn(2, 2, 6, 16).astype(np.float32))
               for _ in range(3))
    lens = torch.tensor([4, 6])
    mask = torch.arange(6)[None, :] >= lens[:, None]
    torch.testing.assert_close(
        tfa.flash_attention_reference(q, k, v, key_padding_mask=mask),
        tfa.flash_attention_reference(q, k, v, kv_seqlens=lens))
    one = torch.ones_like(v)
    dropped = tfa.flash_attention_reference(
        q, k, one, dropout=0.25, generator=torch.Generator().manual_seed(1))
    again = tfa.flash_attention_reference(
        q, k, one, dropout=0.25, generator=torch.Generator().manual_seed(1))
    assert torch.equal(dropped, again)
    assert 0.9 < float(dropped.mean()) < 1.1     # E[row sum] = 1
    with pytest.raises(ValueError, match="generator"):
        tfa.flash_attention_reference(q, k, v, dropout=0.1)


# -- fmha ---------------------------------------------------------------------

def _packed(lens, h, d, seed):
    qkv = np.random.RandomState(seed).randn(sum(lens), 3, h, d).astype(
        np.float32)
    return qkv, np.cumsum([0] + lens).astype(np.int32)


@pytest.mark.parametrize("causal", [False, True])
def test_fmha_and_grads_match_jax(jax_path, causal):
    qkv, cu = _packed([5, 12, 8], 2, 32, 41)
    jy, jvjp = jax.vjp(lambda x: jfmha.fmha(x, jnp.asarray(cu), max_s=16,
                                            causal=causal), jnp.asarray(qkv))
    tx = _t(qkv, True)
    ty = tfmha.fmha(tx, _t(cu), max_s=16, causal=causal)
    dy = np.random.RandomState(42).randn(*ty.shape).astype(np.float32)
    ty.backward(_t(dy))
    (jdx,) = jvjp(jnp.asarray(dy))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    _grad_close(tx.grad, jdx)


def test_fmha_matches_each_sequence_alone():
    """The JAX test's reference: each sequence attended at full density."""
    lens = [5, 12, 8]
    qkv, cu = _packed(lens, 2, 32, 43)
    out = _np(tfmha.fmha(_t(qkv), _t(cu), max_s=16))
    for i in range(len(lens)):
        seg = qkv[cu[i]:cu[i + 1]]
        q, k, v = (seg[:, j].transpose(1, 0, 2) for j in range(3))
        s = np.einsum("hqd,hkd->hqk", q, k) * 32 ** -0.5
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        np.testing.assert_allclose(out[cu[i]:cu[i + 1]],
                                   np.einsum("hqk,hkd->hqd", p, v)
                                   .transpose(1, 0, 2), **ATTN)


def test_fmha_apply_and_dropout_with_the_jax_seed_match_jax(jax_path):
    qkv, cu = _packed([7, 9], 2, 32, 44)
    key = jax.random.PRNGKey(6)
    jy = jfmha.FMHAFun.apply(jnp.asarray(qkv), jnp.asarray(cu), None, 0.25,
                             16, True, dropout_rng=key)
    ty = tfmha.FMHAFun.apply(_t(qkv), _t(cu), None, 0.25, 16, True,
                             dropout_seed=_jax_seed(key))
    assert ty.shape == (16, 2, 32)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    # is_training=False turns dropout off
    np.testing.assert_allclose(
        _np(tfmha.FMHAFun.apply(_t(qkv), _t(cu), None, 0.25, 16, False)),
        np.asarray(jfmha.fmha(jnp.asarray(qkv), jnp.asarray(cu), 16, 0.25,
                              is_training=False)), **ATTN)
    with pytest.raises(ValueError, match="dropout_seed"):
        tfmha.fmha(_t(qkv), _t(cu), 16, p_dropout=0.1)


# -- openfold_triton ----------------------------------------------------------

def test_attention_core_without_bias_matches_jax(jax_path):
    """The flash path (head dim 16: one the kernels take on the card)."""
    rng = np.random.RandomState(50)
    q, k, v = (rng.randn(2, 3, 2, 16, 16).astype(np.float32)
               for _ in range(3))
    jy, jvjp = jax.vjp(jof.attention_core, *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    ty = tof.attention_core(tq, tk, tv)
    dy = rng.randn(*q.shape).astype(np.float32)
    ty.backward(_t(dy))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    for got, want in zip((tq, tk, tv), jvjp(jnp.asarray(dy))):
        _grad_close(got.grad, want)


@pytest.mark.parametrize("which", ["bias_mask", "bias", "mask"])
def test_attention_core_with_bias_and_mask_matches_jax(which):
    rng = np.random.RandomState(51)
    q, k, v = (rng.randn(2, 3, 2, 8, 4).astype(np.float32) for _ in range(3))
    bias = rng.randn(2, 1, 2, 8, 8).astype(np.float32) \
        if "bias" in which else None
    mask = None
    if "mask" in which:
        mask = np.ones((2, 3, 1, 1, 8), np.float32)
        mask[..., 6:] = 0
    jarg = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    targ = lambda a: None if a is None else _t(a)  # noqa: E731
    jy, jvjp = jax.vjp(lambda q, k, v: jof.attention_core(
        q, k, v, mask=jarg(mask), bias=jarg(bias)),
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    ty = tof.attention_core(tq, tk, tv, mask=targ(mask), bias=targ(bias))
    dy = rng.randn(*q.shape).astype(np.float32)
    ty.backward(_t(dy))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)
    for got, want in zip((tq, tk, tv), jvjp(jnp.asarray(dy))):
        _grad_close(got.grad, want)


def test_layer_norm_small_shape_impl_matches_jax(jax_path):
    rng = np.random.RandomState(52)
    x = rng.randn(4, 7, 64).astype(np.float32)
    w = (rng.rand(64) + 0.5).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    jy = jof.LayerNormSmallShapeOptImpl.apply(*map(jnp.asarray, (x, w, b)))
    ty = tof.LayerNormSmallShapeOptImpl.apply(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **ATTN)


@pytest.mark.parametrize("start,freq", [(2, 1), (0, 2), (1, 3)])
def test_fused_adam_swa_matches_jax(start, freq):
    """Five steps of Adam + SWA on the same gradients: parameters, the
    average and the sample count (f32, 1e-6: one Adam update's rounding)."""
    rng = np.random.RandomState(53)
    w0 = rng.randn(16, 16).astype(np.float32)
    grads = [(rng.randn(16, 16) * 0.1).astype(np.float32) for _ in range(5)]
    jopt = jof.FusedAdamSWA(lr=1e-2, swa_start=start, swa_freq=freq)
    params = {"w": jnp.asarray(w0)}
    state = jopt.init(params)
    for g in grads:
        params, state = jopt.step({"w": jnp.asarray(g)}, params, state)
    w = torch.nn.Parameter(_t(w0))
    topt = tof.FusedAdamSWA([w], lr=1e-2, swa_start=start, swa_freq=freq)
    for g in grads:
        w.grad = _t(g)
        topt.step()
    np.testing.assert_allclose(_np(w), np.asarray(params["w"]), rtol=1e-6,
                               atol=1e-6)
    assert int(topt.n_avg) == int(state["n_avg"])
    (swa,) = topt.swa_params()
    np.testing.assert_allclose(_np(swa), np.asarray(
        jopt.swa_params(state, like=params)["w"]), rtol=1e-6, atol=1e-6)
