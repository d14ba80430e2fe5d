"""The training slice of apex_tpu_torch against apex_tpu on the CPU.

A tiny GPT (vocab 256, hidden 64, 2 layers, 4 heads, seq 64, micro-batch 2
x accumulation 2; ``fused_lm_head=False``, and in the ``fused_head`` cases
the JAX default ``fused_lm_head=True``; ``fused_ffn=True`` in the
``fused_ffn`` cases) is initialised by the JAX package
and carried into the port.  ``forward_backward_no_pipelining`` over the
port's ``GPTModel`` (its loss and ``backward``) is held against the JAX
schedule of the same name over ``GPTModel.loss`` (``jax.vjp`` seeded at 1/M,
summed ascending), then two ``FusedAdam`` steps against the JAX per-leaf
``FusedAdam``; f32 and bf16 activations, with and without attention dropout
(the per-layer counter-hash streams of both models draw the same masks).

Each step's loss and gradients are compared from the same start: the port
loads the JAX step's params and Adam moments (``convert``).  Tolerances:
f32 loss 1e-5 relative and every gradient within 1e-5 of its largest entry
(sums in another order through 2 layers); bf16 loss 1e-3 relative and
gradients within 5e-2 of their largest entry (bf16 keeps 8 bits, and its
rounding places differ in the elementwise chains XLA fuses; a bias sums
128 tokens of them).  The port's own two-step trajectory is compared as
``test_params_after_two_fused_adam_steps_match_jax`` states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.ops import rope as jrope
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining as j_fwd_bwd)
from apex_tpu.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy as j_xent)
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch.convert import (fused_adam_state_from_jax,
                                     gpt_params_from_jax)
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.ops import rope as trope
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.pipeline_parallel import (
    forward_backward_no_pipelining)
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy)

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_seq_len=64, fused_lm_head=False)
MB, ACCUM, SEQ = 2, 2, 64
LR = 1e-3
SEED = 17
_JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _batch(seed):
    rng = np.random.RandomState(seed)
    shape = (ACCUM, MB, SEQ)
    return (rng.randint(0, TINY["vocab_size"], shape),
            rng.randint(0, TINY["vocab_size"], shape))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _names(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _np_state(state):
    return jax.tree_util.tree_map(np.asarray, state)


def _run_jax(dtype, dropout, steps=2, fused=False, ffn=False):
    """Per step: the params and optimizer state it starts from (numpy),
    its mean loss and {name: grad}; then the params after the last."""
    cfg = JConfig(**dict(TINY, fused_lm_head=fused, fused_ffn=ffn),
                  attention_dropout=0.1 if dropout else 0.0,
                  dtype=_JAX_DT[dtype])
    model = JModel(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    seed = SEED if dropout else None
    opt = JFusedAdam(lr=LR, bucketed=False)
    state = opt.init(params)
    tokens, targets = _batch(1)
    out = []
    for _ in range(steps):
        start = (_np_state(params), _np_state(state))
        loss, grads = j_fwd_bwd(
            lambda p, x: (p, x),
            lambda px, t: model.loss(px[0], px[1], t, dropout_seed=seed),
            params, jnp.asarray(tokens), jnp.asarray(targets))
        out.append((start, float(loss), dict(_names(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), grads)))))
        params, state = opt.step(grads, params, state)
    return out, dict(_names(_np_state(params)))


def _port(dtype, dropout, init, fused=False, ffn=False):
    cfg = GPTConfig(**dict(TINY, fused_lm_head=fused, fused_ffn=ffn),
                    attention_dropout=0.1 if dropout else 0.0,
                    dtype=_T_DT[dtype])
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(init, cfg))
    return model, FusedAdam(model.parameters(), lr=LR)


def _port_step(model, opt, dropout):
    """One step of the slice: zero_grad, the schedule over the model's
    loss and backward, FusedAdam.  Returns (mean loss, {name: grad})."""
    seed = SEED if dropout else None
    tokens, targets = (torch.from_numpy(a) for a in _batch(1))
    opt.zero_grad()
    loss = forward_backward_no_pipelining(
        lambda m, x: m.backbone(m.embed(x), dropout_seed=seed),
        lambda x, t: model.head_loss(x, t).mean(), model, tokens, targets)
    grads = {n: p.grad.float().numpy().copy()
             for n, p in model.named_parameters()}
    opt.step()
    return float(loss), grads


def _run_port_from_jax_states(jout, dtype, dropout, fused=False,
                              ffn=False):
    """Each step from the JAX step's own start (params and Adam moments
    carried over with the convert functions)."""
    out = []
    for (params, state), _, _ in jout:
        model, opt = _port(dtype, dropout, params, fused, ffn)
        carried = fused_adam_state_from_jax(state, model)
        for name, p in model.named_parameters():
            if carried["step"]:
                opt.state[p].update(carried["state"][name])
        opt.param_groups[0]["step"] = torch.tensor(carried["step"],
                                                   dtype=torch.int32)
        out.append(_port_step(model, opt, dropout))
    return out


def _run_port(init, dtype, dropout, steps=2, fused=False, ffn=False):
    """The port's own trajectory from the same initial params."""
    model, opt = _port(dtype, dropout, init, fused, ffn)
    for _ in range(steps):
        _port_step(model, opt, dropout)
    return {n: p.detach().float().numpy() for n, p in model.named_parameters()}


_CACHE = {}


def _both(dtype, dropout, fused=False, ffn=False):
    key = (dtype, dropout, fused, ffn)
    if key not in _CACHE:
        jout, jfinal = _run_jax(dtype, dropout, fused=fused, ffn=ffn)
        _CACHE[key] = (jout, jfinal,
                       _run_port_from_jax_states(jout, dtype, dropout, fused,
                                                 ffn),
                       _run_port(jout[0][0][0], dtype, dropout, fused=fused,
                                 ffn=ffn))
    return _CACHE[key]


# (dtype, dropout, fused LM head); with the fused head (the JAX default)
# JAX's default path on the CPU is its materialized f32 reference, the
# port's the kernels' plain versions
_CASES = [("f32", False, False), ("f32", True, False), ("bf16", False, False),
          ("bf16", True, False), ("f32", False, True), ("bf16", True, True)]
_IDS = [("fused_head-" if f else "") + f"{d}-{'dropout' if p else 'no_dropout'}"
        for d, p, f in _CASES]


def _assert_step_matches(jout, tout, dtype):
    loss_tol = 1e-5 if dtype == "f32" else 1e-3
    grad_tol = 1e-5 if dtype == "f32" else 5e-2
    for (_, jl, jg), (tl, tg) in zip(jout, tout):
        assert abs(jl - tl) <= loss_tol * abs(jl), (jl, tl)
        assert set(jg) == set(tg)
        for name, want in jg.items():
            err = np.abs(tg[name] - want).max()
            assert err <= grad_tol * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("dtype,dropout,fused", _CASES, ids=_IDS)
def test_loss_and_every_grad_match_jax(dtype, dropout, fused):
    jout, _, tout, _ = _both(dtype, dropout, fused)
    _assert_step_matches(jout, tout, dtype)


@pytest.mark.parametrize("dtype,dropout,fused", _CASES, ids=_IDS)
def test_params_after_two_fused_adam_steps_match_jax(dtype, dropout, fused):
    """The port's own two-step trajectory.  Adam moves an entry by about lr
    per step whatever the gradient's size, so an entry whose gradient is
    at noise level (the key bias: softmax ignores it) may move the other
    way on one side.  |m^ / sqrt(v^)| is 1 at step 1 and at most 1.0014 at
    step 2 (Cauchy-Schwarz), so such entries differ by at most 4.003 lr
    after two steps (checked at 4.5 lr); 99% of entries agree to 1e-6
    (f32) / 5e-4 (bf16)."""
    _, jfinal, _, tfinal = _both(dtype, dropout, fused)
    _assert_params_match(jfinal, tfinal, dtype)


# fused_ffn=True (with the fused LM head): JAX's default path on the CPU is
# its unfused reference, the port's the FFN kernels' plain versions, which
# keep the pre-activation in f32 until GELU; the bounds are the same
_FFN_CASES = [("f32", False), ("bf16", True)]
_FFN_IDS = [f"fused_ffn-{d}-{'dropout' if p else 'no_dropout'}"
            for d, p in _FFN_CASES]


@pytest.mark.parametrize("dtype,dropout", _FFN_CASES, ids=_FFN_IDS)
def test_fused_ffn_loss_and_every_grad_match_jax(dtype, dropout):
    jout, _, tout, _ = _both(dtype, dropout, True, ffn=True)
    _assert_step_matches(jout, tout, dtype)


@pytest.mark.parametrize("dtype,dropout", _FFN_CASES, ids=_FFN_IDS)
def test_fused_ffn_params_after_two_fused_adam_steps_match_jax(dtype,
                                                               dropout):
    """Two FusedAdam steps with ``fused_ffn=True``, by the bounds of
    ``test_params_after_two_fused_adam_steps_match_jax``."""
    _, jfinal, _, tfinal = _both(dtype, dropout, True, ffn=True)
    _assert_params_match(jfinal, tfinal, dtype)


def _assert_params_match(jfinal, tfinal, dtype):
    diffs = np.concatenate([np.abs(tfinal[n] - want).ravel()
                            for n, want in jfinal.items()])
    assert diffs.max() <= 4.5 * LR, diffs.max()
    assert np.quantile(diffs, 0.99) <= (1e-6 if dtype == "f32" else 5e-4)


def test_dropout_needs_a_seed_and_changes_the_loss():
    """No seed means no dropout (the JAX rule); a seed gives a different,
    repeatable loss; the port's loss equals the schedule's mean."""
    cfg = GPTConfig(**TINY, attention_dropout=0.3)
    model = GPTModel(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    plain = GPTModel(GPTConfig(**TINY), device="cpu")
    plain.load_state_dict(model.state_dict())
    tokens, targets = (torch.from_numpy(a[0]) for a in _batch(2))
    with torch.no_grad():
        base = float(plain.loss(tokens, targets))
        assert float(model.loss(tokens, targets)) == base
        a = float(model.loss(tokens, targets, dropout_seed=5))
        assert a != base and a == float(model.loss(tokens, targets, 5))
        assert a != float(model.loss(tokens, targets, 6))
        mean = forward_backward_no_pipelining(
            lambda m, x: m, lambda m, t: m.loss(tokens, t, 5), model,
            [tokens, tokens], [targets, targets], forward_only=True)
    assert float(mean) == pytest.approx(a, rel=1e-6)
    assert all(p.grad is None for p in model.parameters())


def test_fused_lm_head_raises_in_head_loss_only():
    """``fused_lm_head=True`` (the JAX default) now runs in ``head_loss``:
    in f32 its loss equals the f32-logits head's within 1e-6 relative and
    every gradient within 1e-5 of its largest entry (the same math, sums
    in other orders); serving's prefill logits are the same f32 head GEMM
    on both configs; remat still raises."""
    fused = GPTModel(GPTConfig(**dict(TINY, fused_lm_head=True)),
                     device="cpu").init_params(
        torch.Generator().manual_seed(3))
    plain = GPTModel(GPTConfig(**TINY), device="cpu")
    plain.load_state_dict(fused.state_dict())
    tokens, targets = (torch.from_numpy(a[0]) for a in _batch(4))
    a, _ = fused.prefill(tokens)
    b, _ = plain.prefill(tokens)
    assert a.shape == (MB, SEQ, TINY["vocab_size"]) and torch.equal(a, b)
    losses = []
    for model in (fused, plain):
        loss = model.loss(tokens, targets)
        loss.backward()
        losses.append(loss.item())
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    grads = dict(plain.named_parameters())
    for name, p in fused.named_parameters():
        want = grads[name].grad
        assert float((p.grad - want).abs().max()) <= 1e-5 * float(
            want.abs().max()), name
    with pytest.raises(NotImplementedError, match="slice"):
        GPTConfig(**TINY, remat=True)


def test_grad_enabled_forward_matches_jax_logits():
    jm = JModel(JConfig(**TINY))
    jp = jm.init_params(jax.random.PRNGKey(1))
    cfg = GPTConfig(**TINY)
    tm = GPTModel(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    tokens = _batch(3)[0][0]
    out = tm(torch.from_numpy(tokens))
    assert out.requires_grad
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jm(jp, jnp.asarray(tokens))),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_vocab_parallel_cross_entropy_matches_jax(dtype, smoothing):
    """Loss and the logits' gradient (f32 at 1e-6; bf16 logits: the loss
    at 1e-5 — both sides upcast the same bf16 values — and the bf16
    gradient at one bf16 ulp of its magnitude, 1e-2)."""
    rng = np.random.RandomState(4)
    logits = (3 * rng.randn(12, 50)).astype(np.float32)
    target = rng.randint(0, 50, 12)
    dloss = rng.rand(12).astype(np.float32)
    jl = jnp.asarray(logits, _JAX_DT[dtype])
    ref, pull = jax.vjp(lambda x: j_xent(x, jnp.asarray(target), smoothing,
                                         None), jl)
    (rgrad,) = pull(jnp.asarray(dloss))
    tl = torch.from_numpy(logits).to(_T_DT[dtype]).requires_grad_()
    out = vocab_parallel_cross_entropy(tl, torch.from_numpy(target),
                                       smoothing)
    out.backward(torch.from_numpy(dloss))
    assert out.dtype == torch.float32 and tl.grad.dtype == tl.dtype
    tol = 1e-6 if dtype == "f32" else 1e-5
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)
    gtol = 1e-6 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(tl.grad.float().numpy(),
                               np.asarray(rgrad, np.float32), rtol=gtol,
                               atol=gtol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_gradient_matches_jax_custom_vjp(dtype):
    """Autograd through the port's plain RoPE gives the JAX custom VJP's
    analytic backward (rotation by -theta), bit for bit in f32."""
    rng = np.random.RandomState(5)
    t = rng.randn(16, 2, 3, 8).astype(np.float32)
    dy = rng.randn(16, 2, 3, 8).astype(np.float32)
    f = np.asarray(jrope.rope_freqs(16, 8))
    cos, sin = np.cos(f), np.sin(f)
    _, pull = jax.vjp(lambda x: jrope.fused_apply_rotary_pos_emb_cached(
        x, jnp.asarray(cos), jnp.asarray(sin)),
        jnp.asarray(t, _JAX_DT[dtype]))
    (ref,) = pull(jnp.asarray(dy, _JAX_DT[dtype]))
    tt = torch.from_numpy(t).to(_T_DT[dtype]).requires_grad_()
    trope.fused_apply_rotary_pos_emb_cached(
        tt, torch.from_numpy(cos), torch.from_numpy(sin)).backward(
        torch.from_numpy(dy).to(_T_DT[dtype]))
    tol = 1e-6 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(tt.grad.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _pallas_interpret_step_matches(fused, ffn=False):
    set_force_pallas(True)
    try:
        jout, _ = _run_jax("bf16", True, fused=fused, ffn=ffn)
    finally:
        set_force_pallas(None)
    _assert_step_matches(
        jout, _run_port_from_jax_states(jout, "bf16", True, fused, ffn),
        "bf16")


def test_pallas_interpret_grads_match_the_port():
    """One config (bf16, dropout) with the JAX side forced through its
    Pallas kernels in interpret mode (LayerNorm and flash fwd/bwd)."""
    _pallas_interpret_step_matches(fused=False)


def test_pallas_interpret_fused_head_grads_match_the_port():
    """The same with the fused LM head: the JAX side runs its three LM-head
    kernels in interpret mode too (dS rounded to bf16, as the port's plain
    versions round it)."""
    _pallas_interpret_step_matches(fused=True)


def test_pallas_interpret_fused_ffn_grads_match_the_port():
    """The same with ``fused_ffn=True`` and the fused head: the JAX side
    runs its three FFN kernels in interpret mode too (the port's plain
    versions take their casts)."""
    _pallas_interpret_step_matches(fused=True, ffn=True)
