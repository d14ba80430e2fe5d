"""The ResNet slice of apex_tpu_torch against apex_tpu on the CPU.

A tiny bottleneck ResNet (``resnet26``, width 8, 10 classes, batch 4) is
initialised by the JAX package and carried into the port with
``convert.resnet_params_from_jax``; the same numpy images go through both,
at an even image size (32) and an odd one (33), so that a convolution or
pool window shifted by torch's symmetric padding (JAX's "SAME" pads (0, 1)
at stride 2 on an even size) would show.

Batch norm: the JAX package takes the variance as ``E[x^2] - mean^2`` in
f32, which loses digits where a channel's mean is large against its
spread (a 2 x 2 stage-4 map over 4 images here: JAX's f32 gradients lie
up to 26% of their largest entry from exact at 33 x 33).  The yardstick
is therefore the JAX model run in float64 (x64 on, and the ``_f32`` its
batch norm and head cast to made f64 for the call).  The port run in
float64 the same way is held to it within 1e-9 of the largest entry
(measured: 3e-12), which holds the network's structure (strides, pads,
residuals, BN momentum, the head's layout) against JAX's; the port in f32
is held to it within 1e-4 of the largest entry for logits and running
statistics (measured 4.6e-5) and 1e-3 for gradients, which carry f32
rounding back through 26 normalised layers (measured 3.0e-4).

O1: the output dtype of every convolution, batch norm, ReLU and residual
add of a bottleneck block under the port's autocast equals the JAX
jaxpr's under ``autocast``.  Logits and gradients are compared on a
one-block ResNet (stem, pool, one bottleneck with its downsample, head),
where bf16 leaves the gradients meaningful: on the 26-layer one, JAX's O1
gradient is 121% (global norm) away from its own f32 gradient, bf16
rounding amplified by batch norms over 4 to 16 values per channel.  There
JAX's O1 gradients lie 4-10% (global norm) from JAX's f32 ones, and up to
40% for single batch-norm tensors, whose gradients are sums that cancel;
the port's O1 is held to logits within 2e-2 of their largest entry, its
global gradient within JAX's own O1-to-f32 distance (measured: half of
it), and each tensor within twice JAX's distance plus 1e-2 of the f32
gradient's norm (measured: 1.12x at most).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from apex_tpu import amp as jamp
from apex_tpu.models import resnet as jR
from apex_tpu.optimizers import FusedSGD as JFusedSGD
from apex_tpu.parallel import sync_batchnorm as jS

from apex_tpu_torch import amp
from apex_tpu_torch.convert import (_flatten, fused_sgd_state_from_jax,
                                    resnet_layout, resnet_params_from_jax)
from apex_tpu_torch.models import resnet as tR
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import (BatchNormState, SyncBatchNorm,
                                     convert_syncbn_model, sync_batch_norm)

TINY = dict(width=8, num_classes=10)
BATCH = 4
F64_TOL, F32_TOL, GRAD_TOL = 1e-9, 1e-4, 1e-3
O1_LOGIT_TOL = 2e-2
O1_ONE_BLOCK = dict(depths=(1,), width=8, num_classes=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_model():
    jm = jR.resnet26(**TINY)
    return jm, jm.init_params(jax.random.PRNGKey(0)), jm.init_state()


def _port(jparams, jstate, dtype=torch.float32, **kw):
    cfg = tR.ResNetConfig(depths=(2, 2, 2, 2), **TINY, **kw)
    m = tR.ResNet(cfg, device="cpu")
    m.load_state_dict(resnet_params_from_jax(_np(jparams), _np(jstate), cfg))
    if dtype == torch.float64:
        m = m.double()
        m.cfg = dataclasses.replace(m.cfg, dtype=torch.float64)
    return m


def _images(size, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(BATCH, size, size, 3).astype(np.float32),
            rng.randint(0, TINY["num_classes"], BATCH))


def _state_dict_of(m):
    return {k: v.detach().double() for k, v in m.state_dict().items()
            if "running" in k}


@contextlib.contextmanager
def _f64_run(monkeypatch):
    """Both ResNets in float64: JAX's x64 on, and the f32 that the JAX
    batch norm and both heads cast to (each module's ``_f32``) made f64
    for the call.  Yields the JAX model."""
    with monkeypatch.context() as mp, jax.enable_x64(True):
        for module in (jS, jR, tR):
            mp.setattr(module, "_f32",
                       torch.float64 if module is tR else jnp.float64)
        yield jR.resnet26(**TINY, dtype=jnp.float64,
                          param_dtype=jnp.float64)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)
                              if np.issubdtype(np.asarray(a).dtype,
                                               np.floating) else a), tree)


def _in_port_layout(tree):
    """JAX leaves under the port's names and in its layout, their dtype
    kept (``resnet_params_from_jax`` casts to the model's): parameters
    through the converter's own layout map, each ``BatchNormState``
    under its buffers' names."""
    out = {}
    for name, leaf in _flatten(tree):
        prefix, last = name.rsplit(".", 1)
        if isinstance(_leaf_parent(tree, prefix), jS.BatchNormState):
            name = f"{prefix}.{jS.BatchNormState._fields[int(last)]}"
        out[name] = resnet_layout(name, np.asarray(leaf))
    return out


def _leaf_parent(tree, path):
    for key in path.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else \
            tree[key]
    return tree


def _held(name, got, got64, want64, tol):
    """The port in f64 equals JAX in f64 within ``F64_TOL`` of the largest
    entry (the same model, summed in another order), and the port in f32
    lies within ``tol`` of JAX in f64."""
    got, got64, want = (np.asarray(a, np.float64) for a in (got, got64,
                                                            want64))
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got64 - want).max() <= F64_TOL * scale, (
        name, np.abs(got64 - want).max() / scale)
    assert np.abs(got - want).max() <= tol * scale, (
        name, np.abs(got - want).max() / scale)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_logits_and_bn_state_match_jax(jax_model, size, training,
                                              monkeypatch):
    jm, jp, js = jax_model
    x, _ = _images(size)
    m, m64 = _port(jp, js), _port(jp, js, torch.float64)
    m.train(training)
    m64.train(training)
    with _f64_run(monkeypatch) as jm64:
        jlogits, jnew = jm64.apply(_f64(jp), _f64(js), _f64(x),
                                   training=training)
        jlogits, jnew = np.asarray(jlogits), _np(jnew)
        ref = m64(torch.from_numpy(x).double())
    assert jlogits.dtype == np.float64 and ref.dtype == torch.float64
    logits = m(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, 10)
    _held("logits", logits.detach(), ref.detach(), jlogits, F32_TOL)
    want = _in_port_layout(jnew)
    ref_state = _state_dict_of(m64)
    for name, got in _state_dict_of(m).items():
        assert want[name].dtype == np.float64
        _held(name, got, ref_state[name], want[name], F32_TOL)
    tracked = [int(u.num_batches_tracked) for u in m.conv_units()]
    assert tracked == [int(training)] * len(tracked) == [
        int(want[k]) for k in want if k.endswith("num_batches_tracked")]


@pytest.mark.parametrize("size", [32, 33])
def test_resnet_gradients_match_jax(jax_model, size, monkeypatch):
    jm, jp, js = jax_model
    x, y = _images(size, seed=1)
    jloss32 = jm.loss(jp, js, jnp.asarray(x), jnp.asarray(y))[0]
    m, m64 = _port(jp, js), _port(jp, js, torch.float64)
    with _f64_run(monkeypatch) as jm64:
        jloss, jgrads = jax.value_and_grad(
            lambda p: jm64.loss(p, _f64(js), _f64(x), jnp.asarray(y))[0])(
                _f64(jp))
        jloss, jgrads = float(jloss), _np(jgrads)
        loss64 = m64.loss(torch.from_numpy(x).double(), torch.from_numpy(y))
        loss64.backward()
    assert loss64.dtype == torch.float64
    loss = m.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss64.detach()), jloss,
                               rtol=F64_TOL)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss32),
                               rtol=1e-4)
    want = _in_port_layout(jgrads)
    ref = dict(m64.named_parameters())
    for name, p in m.named_parameters():
        assert want[name].dtype == np.float64
        _held(name, p.grad, ref[name].grad, want[name], GRAD_TOL)


def _o1_block():
    cfg_j = jR.ResNetConfig(width=8)
    jblk = jR._BottleneckBlock(cfg_j, 16, 8, 2)
    tblk = tR._BottleneckBlock(tR.ResNetConfig(width=8), 16, 8, 2,
                               device="cpu")
    return jblk, tblk


def test_o1_dtypes_of_a_bottleneck_block_match_jax():
    """Under O1 only the convolutions run in bf16: every batch-norm output,
    ReLU and the residual add are f32, as in the JAX jaxpr (``reduce_sum``
    and ``rsqrt`` are blacklisted and ``sub``/``mul``/``add`` promote);
    ``torch.autocast`` would keep ``batch_norm`` in bf16."""
    jblk, tblk = _o1_block()
    jp, js = jblk.init_params(jax.random.PRNGKey(0)), jblk.init_state()
    x = np.random.RandomState(2).randn(2, 8, 8, 16).astype(np.float32)
    jaxpr = jax.make_jaxpr(jamp.autocast(
        lambda p, s, x: jblk(p, s, x, training=True)))(jp, js, x).jaxpr
    made_by = {v: e for e in jaxpr.eqns for v in e.outvars}
    convs = [str(e.outvars[0].aval.dtype) for e in jaxpr.eqns
             if e.primitive.name == "conv_general_dilated"]
    relus = [e for e in jaxpr.eqns if e.primitive.name == "custom_jvp_call"]
    residual = made_by[relus[-1].invars[0]]
    bns = [made_by[r.invars[0]] for r in relus[:-1]] + [
        made_by[v] for v in residual.invars]
    want = dict(conv2d=convs,
                batch_norm=[str(e.outvars[0].aval.dtype) for e in bns],
                relu=[str(e.outvars[0].aval.dtype) for e in relus],
                add=[str(residual.outvars[0].aval.dtype)])
    for u in tblk.units():
        u.reset_parameters(torch.Generator().manual_seed(0))
    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__ in want:
                seen.append((func.__name__, str(out.dtype).split(".")[1]))
            return out

    def block(x):
        with Record():
            return tblk(x)

    amp.autocast(block)(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = {k: [d for n, d in seen if n == k] for k in want}
    assert want == dict(conv2d=["bfloat16"] * 4,
                        batch_norm=["float32"] * 4, relu=["float32"] * 3,
                        add=["float32"])
    assert got == want


@pytest.mark.parametrize("size", [32, 33])
def test_o1_logits_and_gradients_match_jax_o1(size):
    """``amp.initialize(..., opt_level="O1")`` wraps ``forward`` in the
    autocast; JAX O1 is ``autocast(model.apply)``.  The bounds are in the
    module docstring."""
    jm = jR.ResNet(jR.ResNetConfig(**O1_ONE_BLOCK))
    jp, js = jm.init_params(jax.random.PRNGKey(0)), jm.init_state()
    x, y = _images(size, seed=3)

    def jloss(p, o1):
        apply = jamp.autocast(jm.apply) if o1 else jm.apply
        logits, _ = apply(p, js, jnp.asarray(x), training=True)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             axis=-1)), logits

    cfg = tR.ResNetConfig(**O1_ONE_BLOCK)
    jgrads, jlogits, jl = {}, {}, {}
    for o1 in (True, False):
        (jl[o1], jlogits[o1]), g = jax.value_and_grad(
            lambda p: jloss(p, o1), has_aux=True)(jp)
        jgrads[o1] = {n: v.numpy() for n, v in resnet_params_from_jax(
            _np(g), _np(js), cfg).items() if "running" not in n
            and "num_batches" not in n}
    m = tR.ResNet(cfg, device="cpu")
    m.load_state_dict(resnet_params_from_jax(_np(jp), _np(js), cfg))
    state = amp.initialize(m, None, opt_level="O1")
    assert state.properties.patch_torch_functions
    logits = m(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    assert jlogits[True].dtype == jnp.float32
    jo1 = np.asarray(jlogits[True])
    assert np.abs(logits.detach().numpy() - jo1).max() <= \
        O1_LOGIT_TOL * np.abs(jo1).max()
    loss = -F.log_softmax(logits, -1)[torch.arange(BATCH),
                                      torch.from_numpy(y)].mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl[True]),
                               rtol=O1_LOGIT_TOL)
    got = {n: p.grad.numpy() for n, p in m.named_parameters()}
    assert all(p.grad.dtype == torch.float32 for p in m.parameters())
    norm = np.linalg.norm
    own = {n: norm(jgrads[True][n] - jgrads[False][n]) for n in got}
    for n in got:
        assert norm(got[n] - jgrads[True][n]) <= 2 * own[n] + 1e-2 * norm(
            jgrads[False][n]), n

    def cat(d):
        return np.concatenate([d[n].ravel() for n in sorted(got)])
    assert norm(cat(got) - cat(jgrads[True])) <= norm(
        cat(jgrads[True]) - cat(jgrads[False]))


def test_o2_keeps_batch_norm_f32_and_fused_sgd_keeps_masters(jax_model):
    """O2 casts by name as JAX does: every ``bn_weight`` / ``bn_bias``
    stays f32, every convolution and the head become bf16; FusedSGD then
    holds f32 masters of exactly the bf16 parameters."""
    jm, jp, js = jax_model
    jcast = jamp.initialize(jm.apply, None, opt_level="O2").cast_params(jp)
    want = {n: str(jnp.dtype(a.dtype)) for n, a in _np_names(jcast)}
    m = tR.resnet26(device="cpu", dtype=torch.bfloat16, **TINY).init_params(
        torch.Generator().manual_seed(0))
    opt = FusedSGD(m.parameters(), lr=0.1, momentum=0.9)
    amp.initialize(m, opt, opt_level="O2")
    got = {n: str(p.dtype).split(".")[1] for n, p in m.named_parameters()}
    assert got == want
    bn = {n for n, d in got.items() if d == "float32"}
    assert bn and all("bn_" in n for n in bn)
    assert opt.master_weights
    x, y = _images(32)
    m.loss(torch.from_numpy(x), torch.from_numpy(y)).backward()
    opt.step()
    for p in m.parameters():
        st = opt.state[p]
        assert ("master" in st) == (p.dtype == torch.bfloat16)
        if "master" in st:
            assert torch.equal(p.detach(), st["master"].to(torch.bfloat16))


def _np_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _np_names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _np_names(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_resnet_params_from_jax_layouts(jax_model):
    """HWIO -> OIHW, the head (features, classes) -> (classes, features),
    and each BatchNormState in its unit's buffers; a wrong tree raises."""
    jm, jp, js = jax_model
    cfg = tR.ResNetConfig(depths=(2, 2, 2, 2), **TINY)
    sd = resnet_params_from_jax(_np(jp), _np(js), cfg)
    np.testing.assert_array_equal(
        sd["stem.weight"].numpy(),
        np.asarray(jp["stem"]["weight"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  np.asarray(jp["head"]["weight"]).T)
    assert sd["blocks.0.downsample.running_var"].shape == (32,)
    assert sd["blocks.0.conv1.num_batches_tracked"].dtype == torch.int32
    assert len(sd) == len(tR.ResNet(cfg, device="meta").state_dict())
    bad = _np(jp)
    del bad["head"]
    with pytest.raises(KeyError):
        resnet_params_from_jax(bad, _np(js), cfg)


def test_optimizer_state_from_jax_takes_the_resnet_layout(jax_model):
    """The JAX FusedSGD state of a ResNet carried over with
    ``layout=resnet_layout``: each momentum buffer in its parameter's
    layout; without it the convolution buffers' shapes refuse."""
    jm, jp, js = jax_model
    jopt = JFusedSGD(lr=0.1, momentum=0.9, bucketed=False)
    jstate = jopt.init(jp)
    _, jstate = jopt.step(jp, jp, jstate)
    m = _port(jp, js)
    carried = fused_sgd_state_from_jax(_np(jstate), m, layout=resnet_layout)
    assert carried["step"] == 1
    want = _in_port_layout(_np(jp))
    for name, p in m.named_parameters():
        buf = carried["state"][name]["momentum_buffer"]
        assert buf.shape == p.shape
        np.testing.assert_array_equal(buf.numpy(), want[name])
    with pytest.raises(ValueError, match="shape"):
        fused_sgd_state_from_jax(_np(jstate), m)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (33, 3, 2, (1, 1)), (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1))])
def test_same_padding_matches_jax(size, k, stride, pads):
    """JAX's "SAME": more at the end at stride 2 on an even size."""
    assert tR._same_pads(size, k, stride) == pads
    jpads = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
    assert tuple(jpads[0]) == pads


def test_resnet50_shapes():
    """ResNet-50 at ImageNet's widths: 161 parameter tensors, 25,557,032
    elements (the JAX tree's count), 2048 features."""
    m = tR.resnet50(device="meta")
    jm = jR.resnet50()
    jshapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    jn = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jshapes))
    params = list(m.parameters())
    assert len(params) == len(jax.tree_util.tree_leaves(jshapes)) == 161
    assert sum(p.numel() for p in params) == jn == 25_557_032
    assert m.feat_dim == 2048 and m.head.weight.shape == (1000, 2048)


# ---------------------------------------------------------------------------
# sync batch norm (the local path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "train_no_update", "eval"])
@pytest.mark.parametrize("channel_last", [False, True])
def test_sync_batch_norm_matches_jax(channel_last, mode):
    """Training statistics (biased variance to normalise, unbiased into the
    running variance, ``(1 - m) running + m batch``) and eval mode with
    the running statistics; a well-conditioned input, so f32 agrees."""
    rng = np.random.RandomState(4)
    shape = (3, 5, 4, 6) if channel_last else (3, 6, 5, 4)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    w, b = (rng.randn(6).astype(np.float32) for _ in range(2))
    rm, rv = rng.randn(6).astype(np.float32), rng.rand(6).astype(
        np.float32) + 0.5
    training = mode != "eval"
    update = mode != "train_no_update"
    jstate = jS.BatchNormState(jnp.asarray(rm), jnp.asarray(rv),
                               jnp.zeros((), jnp.int32))
    jy, jnew = jS.sync_batch_norm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jstate,
        training=training, momentum=0.2, eps=1e-3,
        channel_last=channel_last, update_running_stats=update)
    state = BatchNormState(torch.from_numpy(rm.copy()),
                           torch.from_numpy(rv.copy()),
                           torch.zeros((), dtype=torch.int32))
    y, new = sync_batch_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), state, training=training,
                             momentum=0.2, eps=1e-3,
                             channel_last=channel_last,
                             update_running_stats=update)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for got, w_ in zip(new, jnew):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(state.running_mean.numpy(), rm)


def test_sync_batch_norm_bf16_input_keeps_its_dtype():
    """bf16 in, bf16 out, normalised in f32 with f32 weights (JAX's
    ``astype(x.dtype)``)."""
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 6, 6).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    jstate = jS.BatchNormState(jnp.zeros(3), jnp.ones(3),
                               jnp.zeros((), jnp.int32))
    jy, _ = jS.sync_batch_norm(jnp.asarray(xb, jnp.bfloat16), jnp.ones(3),
                               jnp.zeros(3), jstate, training=True)
    state = BatchNormState(torch.zeros(3), torch.ones(3),
                           torch.zeros((), dtype=torch.int32))
    y, _ = sync_batch_norm(torch.from_numpy(xb).bfloat16(), torch.ones(3),
                           torch.zeros(3), state, training=True)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), rtol=2 ** -7,
                               atol=1e-2)


def test_sync_batchnorm_module_and_convert():
    """The module updates its buffers in training mode only, fuses the
    ReLU where asked, and ``convert_syncbn_model`` replaces torch's
    BatchNorm2d with it, carrying parameters and running statistics; a
    process group of one rank (no ``torch.distributed``: the ``data``
    axis is this rank alone) normalises as the local path does
    (``tests/test_torch_ddp.py`` holds the statistics across ranks)."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(4, 3, 5, 5).astype(np.float32))
    net = nn.Sequential(nn.Conv2d(3, 3, 1), nn.BatchNorm2d(3))
    with torch.no_grad():
        net[1].weight.uniform_(0.5, 1.5)
        net[1].running_var.fill_(2.0)
    ref = net(x)                     # training mode: updates torch's stats
    ref_stats = (net[1].running_mean.clone(), net[1].running_var.clone())
    with torch.no_grad():
        net[1].running_mean.zero_()
        net[1].running_var.fill_(2.0)
    net = convert_syncbn_model(net)
    assert isinstance(net[1], SyncBatchNorm)
    np.testing.assert_allclose(net[1].running_var.numpy(), 2.0)
    out = net(x)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip((net[1].running_mean, net[1].running_var),
                         ref_stats):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert int(net[1].num_batches_tracked) == 2   # torch's 1, carried, + 1
    net.eval()
    before = net[1].running_mean.clone()
    net(x)
    assert torch.equal(net[1].running_mean, before)
    relu = SyncBatchNorm(3, fuse_relu=True)
    assert (relu(x) >= 0).all()
    local = SyncBatchNorm(3)
    synced = SyncBatchNorm(3, process_group="data")
    assert torch.equal(synced(x), local(x))
    state = BatchNormState(torch.zeros(3), torch.ones(3),
                           torch.zeros((), dtype=torch.int32))
    ya, sa = sync_batch_norm(x, None, None, state, training=True,
                             axis_name="data")
    yb, sb = sync_batch_norm(x, None, None, state, training=True)
    assert torch.equal(ya, yb) and all(map(torch.equal, sa, sb))
    assert tR.ResNetConfig(axis_name="data").axis_name == "data"
