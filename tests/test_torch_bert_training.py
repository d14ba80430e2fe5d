"""The BERT + amp O2 + FusedLAMB slice of apex_tpu_torch against apex_tpu on
the CPU.

``FusedLAMB.step`` is held against the JAX ``FusedLAMB(bucketed=False)``
on the same gradients, parameters and state: f32 parameters, O2 masters
(bf16 parameters with f32 masters beside f32 LayerNorm leaves),
``use_nvlamb``, an active global-norm clip, a noop-skipped step and
``grad_scale != 1``.  Both sides run the same f32 math, so parameters,
masters and moments agree to 1e-6 relative, and a bf16 parameter (its
master rounded to nearest even) within one bf16 ulp.

Then three steps of a tiny BERT (vocab 512, hidden 64, 2 layers, seq 32,
micro-batch 2 x accumulation 2; the f32-logits head, and the JAX default
fused LM head in the ``fused_head`` tests; one step with ``fused_ffn=True``
and the fused head in ``test_fused_ffn_o2_lamb_step_matches_jax``) under
O2 with FusedLAMB, through
``forward_backward_no_pipelining``: each port step starts from the JAX
step's own parameters and state (``convert.bert_params_from_jax``,
``convert.fused_lamb_state_from_jax``), and its loss, gradients, masters
and moments are held against the JAX step.  The gradients differ at bf16
level (``test_torch_bert.py`` states that bound), and the tolerances of
what the optimizer makes of them follow from its update rule:

* m' = b1 m + (1 - b1) c g (c the clip factor, which the two sides take
  from their own global norms: within 1% here), so |dm| <= (1 - b1)
  c (E + 0.01 max|g|), where E bounds the leaf's gradient difference;
* v' = b2 v + (1 - b2) (c g)^2, so |dv| <= 1.02 (1 - b2) c^2
  (2 max|g| + E) (E + 0.01 max|g|);
* a master moves by lr r u with r = ||p|| / ||u|| the leaf's trust ratio
  and |u| <= C_t + wd |p|, where C_t bounds |m^ / sqrt(v^)| at step t by
  Cauchy-Schwarz over the gradient history (1 at step 1, 1.0014 at step 2,
  1.0036 at step 3).  An entry whose gradient is noise may move the other
  way on one side, so the masters may differ by 2 lr r (C_t + wd |p|);
  r is the JAX step's own ratio, and 5% covers the port's ratio (a norm
  over the whole leaf).

That entry bound cannot tell an update of the wrong size from noise (a
master that did not move at all is within it), so each leaf's step as a
whole is held too: ||p_port - p_jax|| <= MOVE_RTOL ||p_jax - p0||, with p0
the master before the step.  The largest share seen is 0.199 (a bias whose
gradient is noise, at step 1); a master left unmoved gives 1, one moved at
half the learning rate 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu import amp as jamp
from apex_tpu.models.bert import BertConfig as JConfig
from apex_tpu.models.bert import BertModel as JModel
from apex_tpu.ops.multi_tensor import _lamb_stage1_math as j_stage1
from apex_tpu.optimizers import FusedLAMB as JFusedLAMB
from apex_tpu.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining as j_fwd_bwd)

from apex_tpu_torch import amp
from apex_tpu_torch.convert import (bert_params_from_jax,
                                    fused_lamb_state_from_jax)
from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.optimizers import FusedLAMB, FusedMixedPrecisionLamb
from apex_tpu_torch.transformer.pipeline_parallel import (
    forward_backward_no_pipelining)

TOL = 1e-6
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_seq_len=32, fused_lm_head=False)
MB, ACCUM, SEQ = 2, 2, 32
LR, BETAS, WD = 1e-3, (0.9, 0.999), 0.01
MOVE_RTOL = 0.35


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _names(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# one FusedLAMB step against JAX
# ---------------------------------------------------------------------------

class _Tiny(nn.Module):
    """Parameters named like the JAX tree {"a": ..., "layernorm": ...,
    "z": ...}: ``a`` low precision under O2, ``layernorm`` kept f32, ``z``
    all zeros (||p|| = 0: the two trust-ratio rules differ)."""

    def __init__(self, a, ln, z):
        super().__init__()
        self.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.layernorm = nn.Parameter(torch.from_numpy(ln.copy()))
        self.z = nn.Parameter(torch.from_numpy(z.copy()))


_CASES = {
    "f32": dict(),
    "o2_masters": dict(o2=True),
    "use_nvlamb": dict(kw=dict(use_nvlamb=True)),
    "clip": dict(gmul=50.0),                       # global norm > 1
    "noop": dict(noop=True),
    "grad_scale": dict(grad_scale=0.25, gmul=8.0),
    "adam_mode_l2": dict(o2=True, kw=dict(adam_w_mode=False)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_fused_lamb_step_matches_jax(case):
    c = _CASES[case]
    rng = np.random.RandomState(0)
    a = rng.randn(40, 30).astype(np.float32) * 0.1
    if c.get("o2"):
        a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    ln = 1 + 0.1 * rng.randn(30).astype(np.float32)
    z = np.zeros(7, np.float32)
    kw = dict(lr=1e-2, weight_decay=WD, **c.get("kw", {}))
    jdt = jnp.bfloat16 if c.get("o2") else jnp.float32
    jparams = {"a": jnp.asarray(a, jdt), "layernorm": jnp.asarray(ln),
               "z": jnp.asarray(z, jdt)}
    jopt = JFusedLAMB(bucketed=False, master_weights=bool(c.get("o2")), **kw)
    jstate = jopt.init(jparams)
    model = _Tiny(a, ln, z)
    opt = FusedLAMB(model.parameters(), **kw)
    if c.get("o2"):
        amp.initialize(model, opt, opt_level="O2")
        assert model.a.dtype == torch.bfloat16 and model.z.dtype == \
            torch.bfloat16 and model.layernorm.dtype == torch.float32
    gscale = c.get("grad_scale", 1.0)
    for step in range(2):
        grads = [c.get("gmul", 1.0) * rng.randn(*s).astype(np.float32)
                 for s in ((40, 30), (30,), (7,))]
        if c.get("o2"):
            grads[0] = np.asarray(jnp.asarray(grads[0], jnp.bfloat16),
                                  np.float32)
            grads[2] = np.asarray(jnp.asarray(grads[2], jnp.bfloat16),
                                  np.float32)
        noop = int(c.get("noop", False) and step == 1)
        jg = {"a": jnp.asarray(grads[0], jdt),
              "layernorm": jnp.asarray(grads[1]),
              "z": jnp.asarray(grads[2], jdt)}
        jparams, jstate = jopt.step(jg, jparams, jstate, grad_scale=gscale,
                                    noop_flag=jnp.int32(noop))
        for p, g in zip((model.a, model.layernorm, model.z), grads):
            p.grad = torch.from_numpy(g.copy()).to(p.dtype)
        opt.step(grad_scale=gscale,
                 noop_flag=torch.tensor(noop, dtype=torch.int32))
        for name, p in model.named_parameters():
            want = np.asarray(jparams[name], np.float32)
            got = p.detach().float().numpy()
            tol = (2.0 ** -7 if p.dtype == torch.bfloat16 else TOL)
            assert np.all(np.abs(got - want) <= tol * np.abs(want) + 1e-7), \
                (case, name, np.abs(got - want).max())
        carried = fused_lamb_state_from_jax(_np(jstate), model)
        assert int(opt.param_groups[0]["step"]) == carried["step"]
        for name, p in model.named_parameters():
            assert set(carried["state"][name]) == set(opt.state[p])
            for key, want in carried["state"][name].items():
                # the clip factors come from global norms summed in
                # other orders: 1e-6 of the leaf's scale
                np.testing.assert_allclose(
                    opt.state[p][key].numpy(), want.numpy(), rtol=TOL,
                    atol=TOL * float(want.abs().max()))
    assert carried["step"] == (1 if c.get("noop") else 2)
    if case == "use_nvlamb":      # ||p|| = 0 gives ratio 0: z stays 0
        assert not model.z.detach().any()
    elif case == "f32":           # ratio 1 where ||p|| = 0: z moves
        assert model.z.detach().abs().max() > 0


def test_fused_lamb_refusals_and_mixed_precision_variant():
    params = [nn.Parameter(torch.zeros(3))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(params, amsgrad=True)
    with pytest.raises(NotImplementedError, match="ZeRO"):
        FusedLAMB(params, bucketed=True)
    assert FusedMixedPrecisionLamb(params).master_weights
    assert not FusedMixedPrecisionLamb(params,
                                       master_weights=False).master_weights


def test_mixed_precision_lamb_refuses_a_reduced_dtype_it_would_ignore():
    """Each parameter keeps its own dtype: ``reduced_precision_dtype``
    is taken only where every non-f32 parameter already has it."""
    params = [nn.Parameter(torch.zeros(3, dtype=torch.bfloat16)),
              nn.Parameter(torch.zeros(3))]
    opt = FusedMixedPrecisionLamb(params,
                                  reduced_precision_dtype=torch.bfloat16)
    assert opt.reduced_precision_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="reduced_precision_dtype"):
        FusedMixedPrecisionLamb(params, reduced_precision_dtype=torch.float16)


# ---------------------------------------------------------------------------
# three steps of tiny BERT + O2 + FusedLAMB
# ---------------------------------------------------------------------------

def _batch(seed):
    rng = np.random.RandomState(seed)
    shape = (ACCUM, MB, SEQ)
    tokens = rng.randint(0, TINY["vocab_size"], shape)
    labels = np.where(rng.rand(*shape) < 0.15,
                      rng.randint(0, TINY["vocab_size"], shape), -1)
    return tokens, labels


def _cs_bound(t, b1=BETAS[0], b2=BETAS[1]):
    """max |m^ / sqrt(v^)| over gradient histories of length t."""
    k = np.arange(1, t + 1)
    a = (1 - b1) * b1 ** (t - k) / (1 - b1 ** t)
    b = (1 - b2) * b2 ** (t - k) / (1 - b2 ** t)
    return float(np.sqrt(np.sum(a * a / b)))


def _jax_ratio(p, g, m, v, clip, t):
    """The JAX step's trust ratio of one leaf (its stage-1 math)."""
    b1, b2 = BETAS
    scal = jnp.asarray([b1, b2, 1e-6, WD, 1 - b1 ** t, 1 - b2 ** t, 1.0,
                        clip, 1 - b1], jnp.float32)
    u, *_ = j_stage1(True, scal, False, jnp.asarray(g, jnp.float32).reshape(
        1, -1), jnp.asarray(p).reshape(1, -1), jnp.asarray(m).reshape(1, -1),
        jnp.asarray(v).reshape(1, -1))
    pn, un = np.linalg.norm(p), float(jnp.linalg.norm(u))
    return pn / un if pn > 0 and un > 0 else 1.0


def _run_jax(steps=3, fused=False, ffn=False):
    """Per step: (start params, start state, loss, grads, f32 grads of the
    same parameters), then the state and parameters after the last
    step."""
    tiny = dict(TINY, fused_lm_head=fused, fused_ffn=ffn)
    jm = JModel(JConfig(**tiny, dtype=jnp.bfloat16))
    jm32 = JModel(JConfig(**tiny))
    opt = JFusedLAMB(lr=LR, bucketed=False)
    jstate_amp = jamp.initialize(jm.loss, opt, opt_level="O2")
    assert opt.master_weights
    params = jstate_amp.cast_params(jm.init_params(jax.random.PRNGKey(0)))
    state = opt.init(params)
    tokens, labels = (jnp.asarray(a) for a in _batch(1))
    out = []
    for _ in range(steps):
        loss, grads = j_fwd_bwd(
            lambda p, x: (p, x),
            lambda px, t: jm.loss(px[0], px[1], t), params, tokens, labels)
        _, g32 = j_fwd_bwd(
            lambda p, x: (p, x),
            lambda px, t: jm32.loss(px[0], px[1], t),
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params),
            tokens, labels)
        out.append((_np(params), _np(state), float(loss),
                    dict(_names(_np(grads))), dict(_names(_np(g32)))))
        params, state = opt.step(grads, params, state)
    return out, (_np(state), dict(_names(_np(params))))


def _port_step(jparams, jstate, fused=False, ffn=False):
    """One port step from a JAX start: returns (loss, grads, state,
    parameters after the step)."""
    cfg = BertConfig(**dict(TINY, fused_lm_head=fused, fused_ffn=ffn),
                     dtype=torch.bfloat16)
    model = BertModel(cfg, device="cpu")
    opt = FusedLAMB(model.parameters(), lr=LR)
    amp.initialize(model, opt, opt_level="O2")
    model.load_state_dict(bert_params_from_jax(jparams, cfg))
    carried = fused_lamb_state_from_jax(jstate, model)
    for name, p in model.named_parameters():
        opt.state[p].update(carried["state"][name])
    opt.param_groups[0]["step"] = torch.tensor(carried["step"],
                                               dtype=torch.int32)
    tokens, labels = (torch.from_numpy(a) for a in _batch(1))
    opt.zero_grad()
    loss = forward_backward_no_pipelining(
        lambda m, x: x, lambda x, t: model.loss(x, t), model, tokens, labels)
    grads = {n: np.zeros(p.shape, np.float32) if p.grad is None
             else p.grad.float().numpy().copy()
             for n, p in model.named_parameters()}
    opt.step()
    return float(loss), grads, {n: {k: v.numpy().copy() for k, v in
                                    opt.state[p].items()}
                                for n, p in model.named_parameters()}, {
        n: p.detach().float().numpy().copy()
        for n, p in model.named_parameters()}


_CACHE = {}


def _three_steps(fused=False, ffn=False, steps=3):
    key = (fused, ffn, steps)
    if key not in _CACHE:
        jout, jfinal = _run_jax(steps, fused, ffn)
        _CACHE[key] = ((jout, jfinal),
                       [_port_step(p, s, fused, ffn) for p, s, *_ in jout])
    return _CACHE[key]


def _grad_bound(want, ref):
    """The gradient bound of test_torch_bert.py: 5e-2 of the largest entry
    plus the JAX bf16 gradient's own distance from the f32 one."""
    return 5e-2 * np.abs(want).max() + np.abs(want - ref).max()


# (step, fused LM head): the f32-logits head, then the JAX default fused
# head on both sides, held to the same bounds
_STEPS = [pytest.param(step, fused, id=("fused_head-" if fused else "")
                       + str(step)) for fused in (False, True)
          for step in (0, 1, 2)]


@pytest.mark.parametrize("step,fused", _STEPS)
def test_three_o2_lamb_steps_loss_and_grads_match_jax(step, fused):
    _check_loss_and_grads(step, fused)


@pytest.mark.parametrize("step,fused", _STEPS)
def test_three_o2_lamb_steps_state_matches_jax(step, fused):
    """Masters, m and v after each step within the update-rule bounds of
    the module docstring; the step count advances on both sides."""
    _check_state(step, fused)


def test_fused_ffn_o2_lamb_step_matches_jax():
    """One O2 + FusedLAMB step with ``fused_ffn=True`` (and the fused
    head): loss, gradients, masters, m and v by the same bounds.  JAX's
    default path on the CPU is its unfused FFN reference; the port's the
    three FFN kernels' plain versions."""
    _check_loss_and_grads(0, True, ffn=True, steps=1)
    _check_state(0, True, ffn=True, steps=1)


def _check_loss_and_grads(step, fused, ffn=False, steps=3):
    (jout, _), port = _three_steps(fused, ffn, steps)
    _, _, jloss, jgrads, jg32 = jout[step]
    loss, grads = port[step][:2]
    assert abs(loss - jloss) <= 2e-3 * abs(jloss), (loss, jloss)
    assert set(grads) == set(jgrads)
    for name, want in jgrads.items():
        want = np.asarray(want, np.float32)
        err = np.abs(grads[name] - want).max()
        assert err <= _grad_bound(want, jg32[name]), (name, err)


def _check_state(step, fused, ffn=False, steps=3):
    (jout, (jfinal, jfinal_params)), port = _three_steps(fused, ffn, steps)
    t = step + 1
    jparams, jstate, _, jgrads, jg32 = jout[step]
    after, after_params = ((jout[step + 1][1], dict(_names(jout[step + 1][0])))
                           if step + 1 < len(jout)
                           else (jfinal, jfinal_params))
    model = BertModel(BertConfig(**TINY, dtype=torch.bfloat16), device="cpu")
    amp.initialize(model, None, opt_level="O2")
    start = fused_lamb_state_from_jax(jstate, model)["state"]
    want = fused_lamb_state_from_jax(after, model)
    assert want["step"] == t
    # the clip factors of the JAX step (its global norm) and of the port's
    gnorm = np.sqrt(sum(np.sum(np.square(g.astype(np.float32)))
                        for g in jgrads.values()))
    clip = min(1.0, 1.0 / gnorm)
    pgrads = port[step][1]
    pnorm = np.sqrt(sum(np.sum(np.square(g)) for g in pgrads.values()))
    assert abs(min(1.0, 1.0 / pnorm) - clip) <= 1e-2 * clip
    b1, b2 = BETAS
    cs = _cs_bound(t)
    for name, st in port[step][2].items():
        g = np.asarray(jgrads[name], np.float32)
        e = _grad_bound(g, jg32[name])
        gmax = np.abs(g).max()
        w = {k: v.numpy() for k, v in want["state"][name].items()}
        m_tol = (1 - b1) * clip * (e + 1e-2 * gmax) + 1e-9
        v_tol = 1.02 * (1 - b2) * clip ** 2 * (2 * gmax + e) * (
            e + 1e-2 * gmax) + 1e-12
        assert np.abs(st["exp_avg"] - w["exp_avg"]).max() <= m_tol, name
        assert np.abs(st["exp_avg_sq"] - w["exp_avg_sq"]).max() <= v_tol, \
            name
        if "master" in w:
            p0, got, ref = (start[name]["master"].numpy(), st["master"],
                            w["master"])
        else:                               # the f32 LayerNorm leaves
            assert "master" not in st and "layernorm" in name
            p0 = np.asarray(dict(_names(jparams))[name])
            got, ref = port[step][3][name], np.asarray(after_params[name])
        ratio = _jax_ratio(p0, g, start[name]["exp_avg"].numpy(),
                           start[name]["exp_avg_sq"].numpy(), clip, t)
        tol = 2 * 1.05 * LR * ratio * (cs + WD * np.abs(p0)) + 1e-7
        assert np.all(np.abs(got - ref) <= tol), name
        moved = np.linalg.norm(ref - p0)   # 0 only for the unreached NSP head
        assert np.linalg.norm(got - ref) <= MOVE_RTOL * moved + 1e-9, (
            name, np.linalg.norm(got - ref), moved)


def test_cs_bound_values():
    assert _cs_bound(1) == pytest.approx(1.0)
    assert _cs_bound(2) == pytest.approx(1.0014, abs=1e-4)
    assert _cs_bound(3) == pytest.approx(1.0036, abs=1e-4)
