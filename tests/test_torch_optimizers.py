"""apex_tpu_torch multi-tensor Adam and the fused optimizers against
apex_tpu on the CPU.

``multi_tensor_adam`` (the plain version a CPU tensor takes) is held against
the JAX ``adam_packed`` over the packed bucket of the same leaves, through
its Pallas kernel in interpret mode and its default path; ``FusedAdam`` is
held against the JAX ``FusedAdam(bucketed=False)`` over three steps, one of
them skipped by the noop flag.  Both sides run the same f32 ``_adam_math``:
parameters and moments agree to 1e-6 relative (only the order of f32
operations in pow/sqrt may differ).

``FusedSGD``, ``FusedAdagrad`` and ``FusedNovoGrad`` are held against their
JAX namesakes over three steps (the second skipped by a device noop flag)
in the JAX optimizers' per-leaf layout (they refuse ``bucketed=True``; the
packed kernels are held in ``test_torch_multi_tensor.py``), with and
without Pallas forced; their state is carried over with
``convert.fused_*_state_from_jax`` and compared too (1e-6 relative, or an
f32 ulp of a 0.1-sized entry).  Where the parameters are bf16 with f32
masters, the masters agree likewise and each parameter is its master
rounded to bf16.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu.multi_tensor_apply import bucketing as jB
from apex_tpu.ops import multi_tensor as jK
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.utils import set_force_pallas

from apex_tpu.optimizers import FusedAdagrad as JFusedAdagrad
from apex_tpu.optimizers import FusedNovoGrad as JFusedNovoGrad
from apex_tpu.optimizers import FusedSGD as JFusedSGD

from apex_tpu_torch.convert import (fused_adagrad_state_from_jax,
                                    fused_adam_state_from_jax,
                                    fused_novograd_state_from_jax,
                                    fused_sgd_state_from_jax)
from apex_tpu_torch.ops import multi_tensor as tK
from apex_tpu_torch.optimizers import (FusedAdagrad, FusedAdam,
                                       FusedLAMB, FusedNovoGrad, FusedSGD)

SHAPES = [(3, 5), (7,), (130,), (2, 3, 4)]   # off the 128-lane multiple
TOL = 1e-6


@pytest.fixture(params=["pallas_interpret", "jax_default"])
def jax_path(request):
    set_force_pallas(True if request.param == "pallas_interpret" else None)
    yield request.param
    set_force_pallas(None)


def _leaves(seed, shapes=SHAPES, positive=False):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*s).astype(np.float32) for s in shapes]
    return [np.abs(a) for a in out] if positive else out


@pytest.mark.parametrize("noop", [0, 1])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_multi_tensor_adam_matches_adam_packed(jax_path, adam_w_mode, noop):
    g, p, m = _leaves(0), _leaves(1), _leaves(2)
    v = _leaves(3, positive=True)
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.1,
                 bias_correction1=0.271, bias_correction2=0.0394,
                 grad_scale=0.5)
    meta = jB.bucket_meta(SHAPES, jnp.float32, block_rows=8)
    packed = [jB.flatten_bucket([jnp.asarray(a) for a in leaves], meta)
              for leaves in (g, p, m, v)]
    outs = jK.adam_packed(*packed, adam_w_mode=adam_w_mode,
                          noop_flag=jnp.int32(noop), block_rows=8, **hyper)
    ref = [jB.unflatten_bucket(o, meta) for o in outs]

    tg, tp, tm, tv = ([torch.from_numpy(a.copy()) for a in leaves]
                      for leaves in (g, p, m, v))
    scal = torch.tensor([hyper[k] for k in (
        "lr", "beta1", "beta2", "eps", "weight_decay", "bias_correction1",
        "bias_correction2", "grad_scale")], dtype=torch.float32)
    tK.multi_tensor_adam(tg, tp, tm, tv, scal,
                         torch.tensor(noop, dtype=torch.int32), adam_w_mode)
    for got, want in zip((tp, tm, tv), ref):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=TOL)
    if noop:
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(tp, p))


def test_adam_math_bf16_params_round_like_jax():
    """bf16 parameters: the update runs in f32 and rounds once to bf16."""
    g, p, m = _leaves(4), _leaves(5), _leaves(6)
    v = _leaves(7, positive=True)
    scal = np.array([1e-2, 0.9, 0.99, 1e-8, 0.0, 1.0, 1.0, 1.0], np.float32)
    for gi, pi, mi, vi in zip(g, p, m, v):
        jp = jnp.asarray(pi, jnp.bfloat16)
        rp, rm, rv = jK._adam_math(True, jnp.asarray(scal), False,
                                   jnp.asarray(gi), jp.astype(jnp.float32),
                                   jnp.asarray(mi), jnp.asarray(vi))
        tp = torch.from_numpy(pi).bfloat16()
        tm, tv = torch.from_numpy(mi.copy()), torch.from_numpy(vi.copy())
        tK.multi_tensor_adam([torch.from_numpy(gi)], [tp], [tm], [tv],
                             torch.from_numpy(scal))
        np.testing.assert_array_equal(
            tp.float().numpy(), np.asarray(rp.astype(jnp.bfloat16),
                                           np.float32))
        np.testing.assert_allclose(tm.numpy(), np.asarray(rm), rtol=TOL)


class _Tiny(nn.Module):
    """Parameters named like the JAX tree {"a": ..., "b": [..., ...]}."""

    def __init__(self, a, b):
        super().__init__()
        self.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.b = nn.ParameterList(nn.Parameter(torch.from_numpy(x.copy()))
                                  for x in b)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_three_steps_match_jax(adam_w_mode):
    """Three steps with fresh gradients each; the second is skipped by a
    device noop flag (no update, no step advance)."""
    init = _leaves(10, [(4, 3), (5,), (2, 2)])
    jparams = {"a": jnp.asarray(init[0]),
               "b": [jnp.asarray(init[1]), jnp.asarray(init[2])]}
    kw = dict(lr=1e-2, betas=(0.9, 0.98), eps=1e-6, weight_decay=0.05,
              adam_w_mode=adam_w_mode)
    jopt = JFusedAdam(bucketed=False, **kw)
    jstate = jopt.init(jparams)
    model = _Tiny(init[0], init[1:])
    opt = FusedAdam(model.parameters(), **kw)
    for step in range(3):
        grads = _leaves(20 + step, [(4, 3), (5,), (2, 2)])
        noop = int(step == 1)
        jgrads = {"a": jnp.asarray(grads[0]),
                  "b": [jnp.asarray(grads[1]), jnp.asarray(grads[2])]}
        jparams, jstate = jopt.step(jgrads, jparams, jstate,
                                    noop_flag=jnp.int32(noop))
        for p, g in zip(model.parameters(), grads):
            p.grad = torch.from_numpy(g)
        opt.step(noop_flag=torch.tensor(noop, dtype=torch.int32))
        want = [jparams["a"]] + jparams["b"]
        for p, w in zip(model.parameters(), want):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=TOL, atol=TOL)
    assert int(opt.param_groups[0]["step"]) == int(jstate["step"]) == 2
    np_state = {"step": np.asarray(jstate["step"]),
                "buckets": {k: {"m": [np.asarray(x) for x in b["m"]],
                                "v": [np.asarray(x) for x in b["v"]]}
                            for k, b in jstate["buckets"].items()}}
    carried = fused_adam_state_from_jax(np_state, model)
    assert carried["step"] == 2
    for name, p in model.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(opt.state[p][key].numpy(),
                                       carried["state"][name][key].numpy(),
                                       rtol=TOL, atol=1e-12)


def test_fused_adam_refuses_what_is_not_ported():
    params = [nn.Parameter(torch.zeros(3))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(params, amsgrad=True)
    with pytest.raises(NotImplementedError, match="ZeRO"):
        FusedAdam(params, bucketed=True)
    assert FusedAdam(params, master_weights=True).master_weights


def test_fused_adam_grad_scale_and_zero_grad():
    """``grad_scale`` multiplies the gradient inside the update (Adam is
    scale-invariant but for eps and weight decay); ``zero_grad`` drops
    the gradients when ``set_grad_none``."""
    p1 = nn.Parameter(torch.ones(4))
    p2 = nn.Parameter(torch.ones(4))
    o1 = FusedAdam([p1], lr=0.1, eps=1.0)
    o2 = FusedAdam([p2], lr=0.1, eps=1.0)
    p1.grad = torch.full((4,), 2.0)
    p2.grad = torch.full((4,), 4.0)
    o1.step()
    o2.step(grad_scale=0.5)
    assert torch.equal(p1, p2)
    o1.zero_grad()
    assert p1.grad is None


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_unreached_parameter_steps_with_a_zero_gradient_as_in_jax(kind):
    """A parameter the loss did not reach (``.grad`` None) is stepped with
    a zero gradient, as the JAX optimizers step every leaf: with weight
    decay a nonzero one moves (by lr * wd * p under AdamW).  Skipping it
    instead left it lr * wd * max|b| = 1.5e-3 away from JAX here."""
    from apex_tpu.optimizers import FusedLAMB as JFusedLAMB
    from apex_tpu_torch.optimizers import FusedLAMB
    rng = np.random.RandomState(30)
    a = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    ga = rng.randn(4, 3).astype(np.float32)
    kw = dict(lr=1e-2, weight_decay=0.1)
    jcls, tcls = ((JFusedAdam, FusedAdam) if kind == "adam"
                  else (JFusedLAMB, FusedLAMB))
    jopt = jcls(bucketed=False, **kw)
    jparams = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    jstate = jopt.init(jparams)
    model = _Tiny(a, [b])
    opt = tcls(model.parameters(), **kw)
    for _ in range(2):
        jparams, jstate = jopt.step({"a": jnp.asarray(ga),
                                     "b": jnp.zeros(5)}, jparams, jstate)
        model.a.grad = torch.from_numpy(ga)
        opt.step()
    assert model.b[0].grad is None
    moved = np.abs(model.b[0].detach().numpy() - b).max()
    assert moved > 1e-3
    for p, w in ((model.a, jparams["a"]), (model.b[0], jparams["b"])):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL)


def test_fused_adam_master_weights_match_jax():
    """bf16 parameters with f32 masters (amp O2's layout): the update runs
    on the masters, and each parameter takes its master rounded to
    nearest even, as JAX's ``astype`` rounds: the parameters equal JAX's
    bit for bit after two steps."""
    init = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
            for a in _leaves(40, [(4, 3), (5,), (2, 2)])]
    kw = dict(lr=1e-2, weight_decay=0.05)
    jopt = JFusedAdam(bucketed=False, master_weights=True, **kw)
    jparams = {"a": jnp.asarray(init[0], jnp.bfloat16),
               "b": [jnp.asarray(x, jnp.bfloat16) for x in init[1:]]}
    jstate = jopt.init(jparams)
    model = _Tiny(init[0], init[1:]).to(torch.bfloat16)
    opt = FusedAdam(model.parameters(), master_weights=True, **kw)
    for step in range(2):
        grads = _leaves(50 + step, [(4, 3), (5,), (2, 2)])
        jparams, jstate = jopt.step(
            {"a": jnp.asarray(grads[0], jnp.bfloat16),
             "b": [jnp.asarray(g, jnp.bfloat16) for g in grads[1:]]},
            jparams, jstate)
        for p, g in zip(model.parameters(), grads):
            p.grad = torch.from_numpy(g).bfloat16()
        opt.step()
    want = [jparams["a"]] + jparams["b"]
    for p, master, w in zip(model.parameters(), opt.master_params(), want):
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(w, np.float32))
        assert torch.equal(p.detach(), master.to(torch.bfloat16))
        assert not torch.equal(master, p.detach().float())


# ---------------------------------------------------------------------------
# FusedSGD, FusedAdagrad, FusedNovoGrad against JAX
# ---------------------------------------------------------------------------

STEP_SHAPES = [(4, 3), (5,), (2, 2), (130,)]


@pytest.fixture(params=["per_leaf", "per_leaf_pallas_forced"])
def jax_layout(request):
    """The JAX optimizer's per-leaf layout, with the Pallas switch as the
    platform sets it or forced on."""
    if request.param == "per_leaf_pallas_forced":
        set_force_pallas(True)
    yield request.param
    set_force_pallas(None)


def _run_three_steps(jcls, tcls, kw, layout, masters=False, state_keys=(),
                     convert=None):
    """Three steps on both sides with fresh gradients (the second skipped
    by a noop flag); parameters compared after every step, the per-leaf
    state at the end.  Returns the port's optimizer and model."""
    dt = jnp.bfloat16 if masters else jnp.float32
    init = _leaves(60, STEP_SHAPES)
    if masters:
        init = [np.asarray(jnp.asarray(a, dt), np.float32) for a in init]
    jparams = {"a": jnp.asarray(init[0], dt),
               "b": [jnp.asarray(x, dt) for x in init[1:]]}
    jopt = jcls(bucketed=False, master_weights=masters, **kw)
    jstate = jopt.init(jparams)
    model = _Tiny(init[0], init[1:])
    if masters:
        model = model.to(torch.bfloat16)
    opt = tcls(model.parameters(), master_weights=masters, **kw)
    for step in range(3):
        grads = _leaves(70 + step, STEP_SHAPES)
        if masters:
            grads = [np.asarray(jnp.asarray(g, dt), np.float32)
                     for g in grads]
        noop = int(step == 1)
        jparams, jstate = jopt.step(
            {"a": jnp.asarray(grads[0], dt),
             "b": [jnp.asarray(g, dt) for g in grads[1:]]},
            jparams, jstate, noop_flag=jnp.int32(noop))
        for p, g in zip(model.parameters(), grads):
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.step(noop_flag=torch.tensor(noop, dtype=torch.int32))
        want = [jparams["a"]] + jparams["b"]
        for p, w in zip(model.parameters(), want):
            if masters:   # bf16 on both sides: one ulp (the masters below)
                np.testing.assert_allclose(
                    p.detach().float().numpy(), np.asarray(w, np.float32),
                    rtol=2.0 ** -7, atol=1e-30)
            else:
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(w), rtol=TOL, atol=TOL)
    assert int(opt.param_groups[0]["step"]) == int(jstate["step"]) == 2
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    carried = convert(np_state, model)
    assert carried["step"] == 2
    for name, p in model.named_parameters():
        for key in state_keys + (("master",) if masters else ()):
            np.testing.assert_allclose(
                opt.state[p][key].numpy(),
                carried["state"][name][key].numpy(), rtol=TOL, atol=1e-8)
        if masters:
            assert torch.equal(p.detach(), opt.state[p]["master"].to(
                torch.bfloat16))
    return opt, model


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("variant", ["momentum", "nesterov",
                                     "wd_after_momentum", "no_momentum"])
def test_fused_sgd_three_steps_match_jax(jax_layout, variant, masters):
    """Momentum with dampening (zero on step 1, from the device step
    count), Nesterov, decay after the momentum, and the momentum == 0
    shortcut."""
    kw = {"momentum": dict(lr=0.05, momentum=0.9, dampening=0.1,
                           weight_decay=0.01),
          "nesterov": dict(lr=0.05, momentum=0.9, nesterov=True,
                           weight_decay=0.01),
          "wd_after_momentum": dict(lr=0.05, momentum=0.8, dampening=0.2,
                                    weight_decay=0.05,
                                    wd_after_momentum=True),
          "no_momentum": dict(lr=0.05, weight_decay=0.01)}[variant]
    _run_three_steps(JFusedSGD, FusedSGD, kw, jax_layout, masters,
                     ("momentum_buffer",), fused_sgd_state_from_jax)


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("adagrad_w_mode", [False, True])
def test_fused_adagrad_three_steps_match_jax(jax_layout, adagrad_w_mode,
                                             masters):
    kw = dict(lr=0.05, eps=1e-8, weight_decay=0.02,
              adagrad_w_mode=adagrad_w_mode)
    _run_three_steps(JFusedAdagrad, FusedAdagrad, kw, jax_layout, masters,
                     ("sum",), fused_adagrad_state_from_jax)


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("variant", ["default", "init_zero",
                                     "no_bias_correction",
                                     "no_grad_averaging",
                                     "reg_inside_moment"])
def test_fused_novograd_three_steps_match_jax(jax_layout, variant, masters):
    """v per tensor from the per-tensor sums (kernel #17's plain version),
    set to the first ||g||^2 unless ``init_zero`` and kept by the noop
    step; the bias corrections folded into the learning rate."""
    kw = dict(lr=0.05, betas=(0.9, 0.98), weight_decay=0.01)
    kw.update({"default": {}, "init_zero": dict(init_zero=True),
               "no_bias_correction": dict(bias_correction=False),
               "no_grad_averaging": dict(grad_averaging=False),
               "reg_inside_moment": dict(reg_inside_moment=True)}[variant])
    opt, model = _run_three_steps(JFusedNovoGrad, FusedNovoGrad, kw,
                                  jax_layout, masters,
                                  ("exp_avg", "exp_avg_sq"),
                                  fused_novograd_state_from_jax)
    v = [opt.state[p]["exp_avg_sq"] for p in model.parameters()]
    assert all(t.dim() == 0 and t.dtype == torch.float32 for t in v)


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("cls,kw", [
    (FusedSGD, dict(lr=0.05, momentum=0.9, dampening=0.1,
                    weight_decay=0.01)),
    (FusedAdagrad, dict(lr=0.05, weight_decay=0.02)),
    (FusedNovoGrad, dict(lr=0.05, betas=(0.9, 0.98), weight_decay=0.01)),
    (FusedNovoGrad, dict(lr=0.05, betas=(0.9, 0.98), init_zero=True)),
    (FusedAdam, dict(lr=0.05, weight_decay=0.01)),
    (FusedLAMB, dict(lr=0.05, weight_decay=0.01)),
], ids=["sgd", "adagrad", "novograd", "novograd_init_zero", "adam", "lamb"])
def test_a_restored_state_resumes_the_run(cls, kw, masters):
    """Two steps, ``state_dict()``, ``load_state_dict`` into a fresh
    optimizer over a copy of the model, two more steps: parameters and
    state equal bit for bit those of four uninterrupted steps, the f32
    state of bf16 parameters (masters, moments, NovoGrad's per-tensor v)
    kept f32."""
    init = _leaves(80, STEP_SHAPES)
    grads = [_leaves(90 + s, STEP_SHAPES) for s in range(4)]

    def model():
        m = _Tiny(init[0], init[1:])
        return m.to(torch.bfloat16) if masters else m

    def steps(m, opt, gs):
        for g in gs:
            for p, a in zip(m.parameters(), g):
                p.grad = torch.from_numpy(a).to(p.dtype)
            opt.step()

    whole = model()
    whole_opt = cls(whole.parameters(), master_weights=masters, **kw)
    steps(whole, whole_opt, grads)
    first = model()
    opt = cls(first.parameters(), master_weights=masters, **kw)
    steps(first, opt, grads[:2])
    saved = copy.deepcopy(opt.state_dict())
    resumed = model()
    resumed.load_state_dict(first.state_dict())
    resumed_opt = cls(resumed.parameters(), master_weights=masters, **kw)
    resumed_opt.load_state_dict(saved)
    steps(resumed, resumed_opt, grads[2:])
    assert int(resumed_opt.param_groups[0]["step"]) == 4
    for p, q in zip(resumed.parameters(), whole.parameters()):
        assert torch.equal(p, q)
        got, want = resumed_opt.state[p], whole_opt.state[q]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key


def test_fused_sgd_adagrad_novograd_refuse_what_apex_refuses():
    params = [nn.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(params, momentum=0.0, nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        FusedSGD(params, momentum=0.9, dampening=0.1, nesterov=True)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(params, amsgrad=True)
    with pytest.raises(RuntimeError, match="l2 norm"):
        FusedNovoGrad(params, norm_type=1)
    for cls in (FusedSGD, FusedAdagrad, FusedNovoGrad):
        with pytest.raises(NotImplementedError, match="ZeRO"):
            cls(params, bucketed=True)


def test_fused_sgd_grad_scale_and_zero_grad():
    """``grad_scale`` multiplies the gradient inside the update; apex's
    FusedSGD keeps zeroed gradients (``set_grad_none=False``)."""
    p1, p2 = nn.Parameter(torch.ones(4)), nn.Parameter(torch.ones(4))
    o1 = FusedSGD([p1], lr=0.1, momentum=0.9)
    o2 = FusedSGD([p2], lr=0.1, momentum=0.9)
    p1.grad = torch.full((4,), 2.0)
    p2.grad = torch.full((4,), 4.0)
    o1.step()
    o2.step(grad_scale=0.5)
    assert torch.equal(p1, p2)
    o1.zero_grad()
    assert p1.grad is not None and not p1.grad.any()
