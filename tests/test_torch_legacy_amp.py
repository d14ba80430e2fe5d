"""apex_tpu_torch's legacy amp surface, ``fp16_utils`` and
``LossScaler.stats`` against apex_tpu on the CPU.

Followed: JAX ``tests/test_amp.py::TestLegacyAmpSurface`` (the casting
decorators, ``register_*`` patch and restore, the disabled ``init``, the
handle's scaled loss and ``OptimWrapper``, the RNN shim) and
``tests/test_fp16_utils.py`` (the half cast that keeps norms f32, the
master copies, ``FP16_Optimizer``'s step and overflow skip, the dynamic
scaler alias).  The same numpy inputs go to both sides; the port's
optimizers run their plain versions on the CPU.  A FusedAdam step from the
same values agrees within 1e-6 of each tensor's largest entry (the JAX and
port Adam round at other places in f32); 16-bit parameters within one ulp
of their type; skipped steps and the scaler's numbers exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu import amp as jamp
from apex_tpu import fp16_utils as jfp16
from apex_tpu.amp import legacy as jlegacy
from apex_tpu.optimizers import FusedAdam as JFusedAdam

from apex_tpu_torch import amp
from apex_tpu_torch import fp16_utils
from apex_tpu_torch.amp import legacy
from apex_tpu_torch.optimizers import FusedAdam

_JDT = {jnp.dtype(jnp.float32): torch.float32,
        jnp.dtype(jnp.bfloat16): torch.bfloat16,
        jnp.dtype(jnp.float16): torch.float16,
        jnp.dtype(jnp.int32): torch.int32}


def _torch_dtype(a):
    return _JDT[jnp.dtype(a.dtype)]


# -- the casting decorators and the registry -----------------------------------

@pytest.mark.parametrize("mode", ["half", "float", "promote"])
def test_casting_decorators_match_jax(mode):
    """The same dtypes out of each decorator, for floating tensors in
    positional, nested and keyword arguments; integers pass as they are."""
    jdec = getattr(jamp, f"{mode}_function")
    tdec = getattr(amp, f"{mode}_function")

    def fn(a, pair, scale=None, ids=None):
        return a, pair[0], pair[1], scale, ids

    rng = np.random.RandomState(0)
    a = rng.randn(4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    cases = [(np.float32, np.float32), ("bf16", np.float32),
             ("bf16", "bf16"), (np.float16, "bf16")]
    for da, db in cases:
        def j(x, d):
            return jnp.asarray(x, jnp.bfloat16 if d == "bf16" else d)

        def t(x, d):
            return torch.from_numpy(x).to(torch.bfloat16 if d == "bf16"
                                          else _JDT[jnp.dtype(d)])
        ids = np.arange(3, dtype=np.int32)
        jout = jdec(fn)(j(a, da), (j(b, db), j(a, da)), scale=j(b, db),
                        ids=jnp.asarray(ids))
        tout = tdec(fn)(t(a, da), (t(b, db), t(a, da)), scale=t(b, db),
                        ids=torch.from_numpy(ids))
        assert [o.dtype for o in tout] == [_torch_dtype(o) for o in jout]
        for got, want in zip(tout, jout):
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want, np.float32))
    assert amp.half_function(fn)._amp_original is fn


def test_register_patches_and_deactivate_restores():
    for mod, dev in ((jamp, {}), (amp, {"device": "cpu"})):
        def f(x):
            return x
        fake = types.SimpleNamespace(f=f, g=f)
        mod.register_half_function(fake, "f")
        mod.register_float_function(fake, "g")
        one = (jnp.ones((2,), jnp.float32) if mod is jamp
               else torch.ones(2))
        assert fake.f(one).dtype == one.dtype        # staged, not applied
        handle = mod.init(loss_scale=128.0, **dev)
        try:
            assert fake.f(one).dtype in (jnp.bfloat16, torch.bfloat16)
            assert fake.g(one.astype(jnp.bfloat16) if mod is jamp
                          else one.bfloat16()).dtype in (jnp.float32,
                                                         torch.float32)
        finally:
            handle._deactivate()
        assert fake.f is f and fake.g is f
        assert not (jlegacy._PENDING if mod is jamp else legacy._PENDING)


def test_disabled_init_clears_staged_registrations():
    """``init(enabled=False)`` returns the no-op handle and drops what was
    staged: a later ``init`` patches nothing."""
    for mod, dev in ((jamp, {}), (amp, {"device": "cpu"})):
        def f(x):
            return x
        fake = types.SimpleNamespace(f=f)
        mod.register_half_function(fake, "f")
        noop = mod.init(enabled=False)
        assert not noop.is_active and noop.loss_scale() == 1.0
        with noop.scale_loss(2.0) as scaled:
            assert scaled == 2.0
        handle = mod.init(loss_scale=4.0, **dev)
        try:
            assert fake.f is f
        finally:
            handle._deactivate()


def _adam_case():
    rng = np.random.RandomState(1)
    w = (rng.randn(8, 8) * 0.1).astype(np.float32)
    g = (rng.randn(8, 8) * 0.01).astype(np.float32)
    return w, g


def _port_param(w, dtype=torch.float32):
    return nn.Parameter(torch.from_numpy(w.copy()).to(dtype))


@pytest.mark.parametrize("loss_scale", [64.0, "dynamic"])
def test_handle_scale_loss_and_optim_wrapper_match_jax(loss_scale):
    """The handle yields the scaled loss; ``OptimWrapper.step`` unscales
    inside the fused step: the update of scaled gradients equals JAX's
    wrapper's, and the unscaled plain step's."""
    w, g = _adam_case()
    jh = jamp.init(loss_scale=loss_scale)
    th = amp.init(loss_scale=loss_scale, device="cpu")
    try:
        scale = th.loss_scale()
        assert scale == jh.loss_scale()
        with jh.scale_loss(jnp.float32(3.0)) as js, \
                th.scale_loss(torch.tensor(3.0)) as ts:
            assert float(ts) == float(js) == 3.0 * scale
        jopt = JFusedAdam(lr=1e-2, bucketed=False)
        jp = {"w": jnp.asarray(w)}
        jnew, _ = jh.wrap_optimizer(jopt).step(
            {"w": jnp.asarray(g * scale)}, jp, jopt.init(jp))
        p = _port_param(w)
        wrapper = th.wrap_optimizer(FusedAdam([p], lr=1e-2))
        p.grad = torch.from_numpy(g * scale)
        found_inf = wrapper.step()
        assert float(found_inf) == 0.0
        assert wrapper.param_groups is wrapper.optimizer.param_groups
        ref = _port_param(w)
        ref.grad = torch.from_numpy(g.copy())
        FusedAdam([ref], lr=1e-2).step()
    finally:
        jh._deactivate()
        th._deactivate()
    want = np.asarray(jnew["w"])
    assert np.abs(p.detach().numpy() - want).max() <= 1e-6 * np.abs(
        want).max()
    np.testing.assert_allclose(p.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-6, atol=1e-7)


def test_optim_wrapper_skips_an_overflow_step_as_jax_does():
    w, g = _adam_case()
    g = g.copy()
    g[2, 3] = np.inf
    jh = jamp.init(loss_scale="dynamic")
    th = amp.init(loss_scale="dynamic", device="cpu")
    jopt = JFusedAdam(lr=1e-2, bucketed=False)
    jp = {"w": jnp.asarray(w)}
    jnew, _ = jh.wrap_optimizer(jopt).step({"w": jnp.asarray(g)}, jp,
                                           jopt.init(jp))
    p = _port_param(w)
    opt = FusedAdam([p], lr=1e-2)
    p.grad = torch.from_numpy(g)
    assert float(th.wrap_optimizer(opt).step()) == 1.0
    np.testing.assert_array_equal(np.asarray(jnew["w"]), w)
    np.testing.assert_array_equal(p.detach().numpy(), w)
    assert int(opt.param_groups[0]["step"]) == 0
    assert th.loss_scale() == float(jh.scaler_state.loss_scale) == 2.0 ** 15


def test_disabled_handle_wrapper_steps_the_optimizer_as_it_is():
    w, g = _adam_case()
    p, ref = _port_param(w), _port_param(w)
    p.grad, ref.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
    amp.init(enabled=False).wrap_optimizer(FusedAdam([p], lr=1e-2)).step()
    FusedAdam([ref], lr=1e-2).step()
    assert torch.equal(p, ref)


def test_rnn_compat_surface():
    assert legacy.has_old_rnns is jlegacy.has_old_rnns is False
    assert legacy.whitelist_rnn_cells() is None
    assert legacy.whitelist_rnn_cells(amp.init(enabled=False), True) is None
    with pytest.raises(TypeError, match="handle"):
        legacy.whitelist_rnn_cells(object())
    with pytest.raises(TypeError, match="verbose"):
        legacy.whitelist_rnn_cells(None, "yes")


def test_amp_exports_the_jax_names():
    """Every JAX name but ``LossScaleState`` (the port's scaler keeps its
    state on itself)."""
    assert set(amp.__all__) == set(jamp.__all__) - {"LossScaleState"}
    assert set(legacy.__all__) == set(jlegacy.__all__)
    for name in amp.__all__:
        assert hasattr(amp, name), name


# -- LossScaler.stats ------------------------------------------------------------

# a run with overflows: growth every 3 clean steps, backoff on each overflow
_FLAGS = [0, 0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0]


@pytest.mark.parametrize("kind", ["dynamic", "static", "min_max"])
def test_scale_schedule_and_stats_match_jax(kind):
    kw = dict(scale_window=3, init_scale=2.0 ** 4)
    if kind == "static":
        kw = {}
        loss_scale = 8.0
    else:
        loss_scale = "dynamic"
    if kind == "min_max":
        kw.update(min_loss_scale=4.0, max_loss_scale=2.0 ** 5)
    js = jamp.LossScaler(loss_scale, **kw)
    ts = amp.LossScaler(loss_scale, device="cpu", **kw)
    state = js.init()
    assert ts.stats() == js.stats(state)
    for flag in _FLAGS:
        state = js.update(state, jnp.float32(flag))
        ts.update(torch.tensor(float(flag)))
        assert ts.stats() == js.stats(state), flag
    stats = ts.stats()
    assert stats["skipped_steps"] == sum(_FLAGS)
    assert stats["dynamic"] == (kind != "static")
    assert isinstance(stats["loss_scale"], float)
    assert isinstance(stats["overflows"], int)


# -- fp16_utils --------------------------------------------------------------------

class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = nn.Linear(8, 8)
        self.bn = nn.BatchNorm1d(8)
        self.layer_norm = nn.LayerNorm(8)
        self.register_buffer("step", torch.zeros((), dtype=torch.int32))


def _jax_tree(net):
    """The JAX-side params of ``net``: the same names and values as a
    nested dict."""
    tree = {}
    for name, t in net.state_dict().items():
        if name.startswith("bn.") and name not in ("bn.weight", "bn.bias"):
            continue
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(t.numpy())
    return tree


def _dtypes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dtypes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: _torch_dtype(tree)}


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_network_to_half_keeps_norms_f32_as_jax_does(half):
    net = _Net()
    jhalf = jnp.bfloat16 if half == torch.bfloat16 else jnp.float16
    want = _dtypes(jfp16.network_to_half(_jax_tree(net), jhalf))
    params = dict(net.named_parameters())
    assert fp16_utils.network_to_half(net, half) is net
    got = {n: p.dtype for n, p in net.named_parameters()}
    assert got == {n: d for n, d in want.items() if n in got}
    assert got["linear.weight"] == half and got["bn.weight"] == torch.float32
    assert all(p is params[n] for n, p in net.named_parameters())
    assert net.step.dtype == torch.int32


def test_bn_convert_float_matches_jax():
    net = _Net()
    jtree = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, _jax_tree(net))
    for p in net.parameters():
        p.data = p.data.bfloat16()
    want = _dtypes(jfp16.BN_convert_float(jtree))
    fp16_utils.BN_convert_float(net)
    got = {n: p.dtype for n, p in net.named_parameters()}
    assert got == {n: d for n, d in want.items() if n in got}
    assert got["linear.weight"] == torch.bfloat16


def test_master_copies_round_trip():
    net = fp16_utils.network_to_half(_Net())
    model_params, masters = fp16_utils.prep_param_lists(net)
    assert [p.shape for p in model_params] == [m.shape for m in masters]
    assert all(m.dtype == torch.float32 and m.requires_grad and m.is_leaf
               for m in masters)
    jmodel, jmaster = jfp16.prep_param_lists(
        jfp16.network_to_half(_jax_tree(_Net())))
    assert jnp.dtype(jmaster["linear"]["weight"].dtype) == jnp.float32
    with torch.no_grad():
        for m in masters:
            m.add_(1.0)
    fp16_utils.master_params_to_model_params(model_params, masters)
    for p, m in zip(model_params, masters):
        assert torch.equal(p, m.to(p.dtype))
    for p in model_params:
        p.grad = torch.full_like(p, 0.5)
    model_params[-1].grad = None
    fp16_utils.model_grads_to_master_grads(model_params, masters)
    assert masters[-1].grad is None
    assert all(m.grad.dtype == torch.float32 and torch.equal(
        m.grad, p.grad.float()) for p, m in zip(model_params[:-1],
                                                 masters[:-1]))


def _fp16_case():
    rng = np.random.RandomState(1)
    return ((rng.randn(16, 16) * 0.1).astype(np.float32),
            (rng.randn(16, 16) * 0.01).astype(np.float32))


def test_fp16_optimizer_steps_match_jax():
    """Three static-scale steps on bf16 parameters with f32 masters: the
    masters within 1e-6 of their largest entry of JAX's, the bf16
    parameters within one bf16 ulp, and both near f32 Adam (2e-2)."""
    w, g = _fp16_case()
    jopt = jfp16.FP16_Optimizer(JFusedAdam(lr=1e-2, bucketed=False))
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    jg = {"w": jnp.asarray(g, jnp.bfloat16)}
    jstate = jopt.init(jp)
    for _ in range(3):
        jp, jstate = jopt.step(jg, jp, jstate)
    p = _port_param(w, torch.bfloat16)
    opt = fp16_utils.FP16_Optimizer(FusedAdam([p], lr=1e-2))
    for _ in range(3):
        opt.zero_grad()
        p.grad = torch.from_numpy(g).bfloat16()
        assert float(opt.step()) == 0.0
    assert p.dtype == torch.bfloat16
    master = opt.optimizer.state[p]["master"].numpy()
    jmaster = np.asarray(jax.tree_util.tree_leaves(
        jopt.optimizer.master_params(jp, jstate["optimizer"]))[0])
    assert np.abs(master - jmaster).max() <= 1e-6 * np.abs(jmaster).max()
    got = p.detach().float().numpy()
    want = np.asarray(jp["w"], np.float32)
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-30)
    ref = _port_param(w)
    ref_opt = FusedAdam([ref], lr=1e-2)
    for _ in range(3):
        ref.grad = torch.from_numpy(g).bfloat16().float()
        ref_opt.step()
    np.testing.assert_allclose(got, ref.detach().numpy(), rtol=2e-2,
                               atol=2e-2)


def test_fp16_optimizer_scaled_loss_and_overflow_skip_match_jax():
    w, g = _fp16_case()
    args = {"init_scale": 2.0 ** 8}
    jopt = jfp16.FP16_Optimizer(JFusedAdam(lr=1e-2, bucketed=False),
                                dynamic_loss_scale=True,
                                dynamic_loss_args=args)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    jstate = jopt.init(jp)
    p = _port_param(w, torch.bfloat16)
    opt = fp16_utils.FP16_Optimizer(FusedAdam([p], lr=1e-2),
                                    dynamic_loss_scale=True,
                                    dynamic_loss_args=args)
    assert float(opt.scale_loss(torch.tensor(2.0))) == float(
        jopt.scale_loss(jnp.float32(2.0), jstate)) == 2.0 * 2.0 ** 8
    # a clean step, then one with an inf: skipped bit for bit
    for grad in (g, np.full_like(g, np.inf)):
        jp, jstate = jopt.step({"w": jnp.asarray(grad, jnp.bfloat16)}, jp,
                               jstate)
        before = (p.detach().clone(),
                  {k: v.clone() for k, v in opt.optimizer.state[p].items()})
        opt.zero_grad()
        p.grad = torch.from_numpy(grad).bfloat16()
        found_inf = float(opt.step())
    assert found_inf == 1.0
    assert torch.equal(p, before[0])
    assert all(torch.equal(opt.optimizer.state[p][k], v)
               for k, v in before[1].items())
    assert int(opt.param_groups[0]["step"]) == 1
    assert opt.loss_scaler.stats() == jopt.loss_scaler.stats(
        jstate["loss_scaler"])
    assert opt.loss_scale == 2.0 ** 7


def test_fp16_optimizer_backward_scales_the_loss():
    p = _port_param(np.ones((4,), np.float32))
    opt = fp16_utils.FP16_Optimizer(FusedAdam([p], lr=1e-2),
                                    static_loss_scale=8.0)
    opt.backward((p * 3.0).sum())
    assert torch.equal(p.grad, torch.full((4,), 24.0))


def test_dynamic_loss_scaler_alias_matches_jax():
    js = jfp16.DynamicLossScaler()
    ts = fp16_utils.DynamicLossScaler(device="cpu")
    state = js.init()
    assert ts.stats() == js.stats(state)
    assert ts.stats()["loss_scale"] == 2.0 ** 32 and ts.scale_window == 1000
    state = js.update(state, jnp.float32(1.0))
    ts.update(torch.tensor(1.0))
    assert ts.stats() == js.stats(state)
    assert fp16_utils.LossScaler is amp.LossScaler
    assert set(fp16_utils.__all__) == set(jfp16.__all__)
