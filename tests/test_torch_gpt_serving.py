"""The serving slice of apex_tpu_torch against apex_tpu on the CPU.

A tiny f32 GPT (vocab 64, hidden 64, 2 layers, 4 heads, max_seq 32) is
initialised by the JAX package and carried into the port with
``apex_tpu_torch.convert.gpt_params_from_jax``.  Prefill logits and K/V,
and four decode steps of logits and cache, agree within 1e-4; the
continuous-batching engines give the same greedy tokens, token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import (InferenceEngine as JEngine, KVCache as JKV,
                                Request as JRequest)
from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.utils.profiling import ServingMetrics as JMetrics

from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.inference import (InferenceEngine, KVCache, QueueFull,
                                      Request, SamplingParams, sample)
from apex_tpu_torch.inference.sampling import stream_generator
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.utils.profiling import ServingMetrics

TINY = dict(vocab_size=64, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_seq_len=32)
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JModel(JConfig(**TINY))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = GPTConfig(**TINY)
    tm = GPTModel(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return jm, jp, tm


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, TINY["vocab_size"], shape)


def test_prefill_logits_and_kv_match_jax(models):
    jm, jp, tm = models
    toks = _tokens(0, (2, 11))
    jl, jkv = jm.prefill(jp, jnp.asarray(toks))
    tl, tkv = tm.prefill(torch.from_numpy(toks))
    assert tl.shape == (2, 11, TINY["vocab_size"]) and tl.dtype == torch.float32
    assert tkv.shape == jkv.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=TOL,
                               rtol=TOL)


def test_forward_matches_jax(models):
    jm, jp, tm = models
    toks = _tokens(1, (1, 9))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(jm(jp, toks)),
                               atol=TOL, rtol=TOL)


def test_decode_steps_match_jax(models):
    """Prefill 6 tokens into a 3-slot ring, then 4 decode steps at ragged
    positions: logits and the whole cache agree after every step."""
    jm, jp, tm = models
    cfg = tm.cfg
    b, n = 3, 6
    toks = _tokens(2, (b, n + 4))
    _, kv = jm.prefill(jp, jnp.asarray(toks[:, :n]))
    shape = (b, cfg.num_layers, 2, cfg.max_seq_len, cfg.local_heads,
             cfg.head_dim)
    jcache = jnp.zeros(shape, jnp.float32).at[:, :, :, :n].set(
        kv.transpose(2, 0, 1, 3, 4, 5))
    tcache = torch.from_numpy(np.asarray(jcache).copy())
    start = np.array([n, n - 2, n - 5], np.int32)   # ragged lengths
    step = jax.jit(jm.decode_step)
    for i in range(4):
        pos = start + i
        jl, jcache = step(jp, jnp.asarray(toks[:, n + i]), jcache,
                          jnp.asarray(pos))
        tl, tcache = tm.decode_step(torch.from_numpy(toks[:, n + i]), tcache,
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache),
                                   atol=TOL, rtol=TOL)


def test_engine_greedy_streams_match_jax(models):
    """3 mixed-length requests over 2 slots (one waits for a free slot):
    the port's engine emits the JAX engine's tokens, token for token."""
    jm, jp, tm = models
    rng = np.random.RandomState(3)
    specs = [(5, 6), (13, 4), (3, 9)]       # (prompt length, new tokens)
    prompts = [rng.randint(0, TINY["vocab_size"], n).tolist()
               for n, _ in specs]
    je = JEngine(jm, jp, max_slots=2)
    te = InferenceEngine(tm, max_slots=2, device="cpu")
    for i, (p, (_, new)) in enumerate(zip(prompts, specs)):
        je.submit(JRequest(request_id=i, prompt=p, max_new_tokens=new))
        te.submit(Request(request_id=i, prompt=p, max_new_tokens=new))
    jr = {r.request_id: (r.tokens, r.finish_reason) for r in je.run()}
    tr = {r.request_id: (r.tokens, r.finish_reason) for r in te.run()}
    assert tr == jr
    assert all(len(tr[i][0]) == specs[i][1] for i in range(3))
    assert te.metrics.summary()["requests"] == 3
    assert te.metrics.pending_requests == 0


def test_engine_eos_and_cache_exhaustion(models):
    _, _, tm = models
    te = InferenceEngine(tm, max_slots=2, device="cpu", max_seq=12)
    prompt = _tokens(4, 10).tolist()
    te.submit(Request(request_id=0, prompt=prompt, max_new_tokens=50))
    first = te.run()[0].tokens[0]
    te.submit(Request(request_id=1, prompt=prompt, max_new_tokens=50,
                      eos_id=first))
    done = {r.request_id: r for r in te.run()}
    # prompt 10 + 2 decoded positions fill the 12-entry row
    assert done[0].finish_reason == "length" and len(done[0].tokens) == 3
    assert done[1].finish_reason == "eos" and done[1].tokens == [first]


def test_engine_validation_backpressure_and_cancel(models):
    _, _, tm = models
    te = InferenceEngine(tm, max_slots=1, device="cpu", max_queue=1)
    with pytest.raises(ValueError, match="prompt length"):
        te.submit(Request(request_id=0, prompt=[]))
    with pytest.raises(ValueError, match="prompt token"):
        te.submit(Request(request_id=0, prompt=[TINY["vocab_size"]]))
    with pytest.raises(ValueError, match="max_new_tokens"):
        te.submit(Request(request_id=0, prompt=[1], max_new_tokens=0))
    te.submit(Request(request_id=1, prompt=[1, 2]))
    with pytest.raises(QueueFull):
        te.submit(Request(request_id=2, prompt=[1, 2]))
    assert te.cancel(1) and not te.cancel(1)
    assert te.queue_depth == 0 and te.metrics.summary()["cancelled"] == 1


def test_engine_quarantines_poison_request(models):
    """A sampling config that only fails when sampled finishes its own
    request with reason="error"; the other request completes."""
    _, _, tm = models
    te = InferenceEngine(tm, max_slots=2, device="cpu")
    te.submit(Request(request_id=0, prompt=[1, 2, 3], max_new_tokens=3,
                      sampling=SamplingParams(temperature=1.0), seed="x"))
    te.submit(Request(request_id=1, prompt=[4, 5], max_new_tokens=3))
    done = {r.request_id: r for r in te.run()}
    assert done[0].finish_reason == "error" and "ValueError" in done[0].error
    assert done[1].finish_reason == "length"
    assert te.cache.free_slots == 2


def test_kv_cache_bookkeeping_matches_jax():
    args = (3, 2, 16, 4, 8)
    jc, tc = JKV(*args), KVCache(*args, device="cpu")
    assert tuple(tc.data.shape) == jc.data.shape
    assert tc.data.dtype == torch.bfloat16
    kv = np.random.RandomState(5).randn(2, 2, 5, 4, 8).astype(np.float32)
    for c, arr in ((jc, jnp.asarray(kv)), (tc, torch.from_numpy(kv))):
        s0, s1 = c.allocate(), c.allocate()
        c.write_prompt(s1, arr, 4)
        c.advance(s1)
        c.free(s0)
    assert (tc.lengths == jc.lengths).all()
    assert (tc.slot_bytes, tc.free_bytes(), tc.used_bytes(),
            tc.occupancy()) == (jc.slot_bytes, jc.free_bytes(),
                                jc.used_bytes(), jc.occupancy())
    np.testing.assert_array_equal(tc.data.float().numpy(),
                                  np.asarray(jc.data, np.float32))
    with pytest.raises(ValueError, match="already free"):
        tc.free(0)


def test_serving_metrics_summary_keys_match_jax():
    assert ServingMetrics().summary().keys() == JMetrics().summary().keys()


def test_sampling_streams_are_deterministic_with_top_k_and_top_p():
    logits = torch.from_numpy(
        np.random.RandomState(6).randn(64).astype(np.float32))
    top4 = set(torch.topk(logits, 4).indices.tolist())
    params = SamplingParams(temperature=1.5, top_k=4)
    draws = [int(sample(logits, params, stream_generator(7, i)))
             for i in range(40)]
    assert draws == [int(sample(logits, params, stream_generator(7, i)))
                     for i in range(40)]
    assert set(draws) <= top4 and len(set(draws)) > 1
    nucleus = SamplingParams(temperature=1.0, top_p=1e-6)
    assert int(sample(logits, nucleus, stream_generator(1, 0))) \
        == int(torch.argmax(logits))
    assert int(sample(logits)) == int(torch.argmax(logits))
    with pytest.raises(ValueError, match="Generator"):
        sample(logits, params)


@pytest.mark.parametrize("knob", [
    dict(fused_ffn=True, remat=True), dict(weight_quant="int8"),
    dict(n_experts=2),
    dict(context_axis="ctx"), dict(sequence_parallel=True),
    dict(tensor_parallel_size=2), dict(remat=True)])
def test_unported_config_knobs_raise(knob):
    """Knobs of later slices raise, naming their slice (``fused_ffn`` runs
    now; with remat it still raises for remat)."""
    with pytest.raises(NotImplementedError, match="slice"):
        GPTConfig(**TINY, **knob)


def test_fused_ffn_config_raises_jax_value_errors():
    """JAX's refusals come before the not-ported ones."""
    with pytest.raises(ValueError, match="n_experts > 0"):
        GPTConfig(**TINY, fused_ffn=True, n_experts=2)
    with pytest.raises(ValueError, match="weight_quant"):
        GPTConfig(**TINY, fused_ffn=True, weight_quant="int8")
    for knob in (dict(n_experts=2), dict(weight_quant="int8")):
        with pytest.raises(ValueError):
            JConfig(**TINY, fused_ffn=True, **knob)


def test_fused_ffn_prefill_and_decode_match_jax():
    """``fused_ffn=True`` on the serving path (the FFN kernel's plain
    version on the CPU, JAX's unfused reference): prefill logits and K/V,
    then 3 decode steps, within the same 1e-4 (f32)."""
    cfg = dict(TINY, fused_ffn=True)
    jm = JModel(JConfig(**cfg))
    jp = jm.init_params(jax.random.PRNGKey(5))
    tm = GPTModel(GPTConfig(**cfg), device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), GPTConfig(**cfg)))
    toks = _tokens(7, (2, 12))
    n = 9
    jl, jkv = jm.prefill(jp, jnp.asarray(toks[:, :n]))
    tl, tkv = tm.prefill(torch.from_numpy(toks[:, :n]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=TOL,
                               rtol=TOL)
    shape = (2, TINY["num_layers"], 2, TINY["max_seq_len"],
             tm.cfg.local_heads, tm.cfg.head_dim)
    jcache = jnp.zeros(shape, jnp.float32).at[:, :, :, :n].set(
        jkv.transpose(2, 0, 1, 3, 4, 5))
    tcache = torch.from_numpy(np.asarray(jcache).copy())
    for i in range(3):
        pos = np.full(2, n + i, np.int32)
        jl, jcache = jm.decode_step(jp, jnp.asarray(toks[:, n + i]), jcache,
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(torch.from_numpy(toks[:, n + i]), tcache,
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)


def test_convert_rejects_mismatched_trees(models):
    jm, jp, tm = models
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="shape"):
        gpt_params_from_jax(tree, GPTConfig(**dict(TINY, vocab_size=32)))
    with pytest.raises(KeyError, match="lacks"):
        gpt_params_from_jax(dict(tree, layers=tree["layers"][:1]), tm.cfg)


def test_init_params_is_seeded_and_shaped_like_jax():
    cfg = GPTConfig(**TINY)
    a = GPTModel(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    b = GPTModel(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.layers[0].attention.qkv.weight.detach()
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert not a.layers[0].attention.qkv.bias.any()
    assert torch.equal(a.final_layernorm.weight, torch.ones(64))
    jp = JModel(JConfig(**TINY)).init_params(jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in a.state_dict().items()}
    assert shapes == {k: v.shape for k, v in gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg).items()}


def _jax_field_default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()


@pytest.mark.parametrize("name", [f.name for f in dataclasses.fields(
    JConfig)])
def test_gpt_config_takes_every_jax_field_at_its_default(name):
    """Every field of the JAX ``GPTConfig`` exists in the port's with the
    same default, and the port's config builds with it.  Ten of the 28
    (``axis_name``, ``overlap_chunks``, ``context_mechanism``, the three
    ``moe_*``, ``expert_axis``, ``expert_parallel_size``, ``remat_policy``,
    ``plan``) were missing and raised ``TypeError``."""
    jf = {f.name: f for f in dataclasses.fields(JConfig)}[name]
    tf = {f.name: f for f in dataclasses.fields(GPTConfig)}
    assert name in tf
    jdefault = _jax_field_default(jf)
    tdefault = _jax_field_default(tf[name])
    if name in ("dtype", "param_dtype"):
        assert jnp.dtype(jdefault) == jnp.float32
        assert tdefault == torch.float32
        return
    assert tdefault == jdefault
    if name in TINY:
        return
    cfg = GPTConfig(**TINY, **{name: jdefault})
    assert getattr(cfg, name) == jdefault or name == "ffn_hidden_size"


@pytest.mark.parametrize("knob", [
    dict(axis_name="model"), dict(sequence_parallel=True, overlap_chunks=2),
    dict(context_mechanism="ulysses"), dict(moe_top_k=2),
    dict(moe_capacity_factor=2.0), dict(moe_aux_weight=0.1),
    dict(n_experts=4, expert_axis="expert"), dict(expert_parallel_size=2),
    dict(remat_policy="dots"), dict(plan=object())],
    ids=lambda k: list(k)[-1])
def test_gpt_config_new_fields_raise_naming_their_slice(knob):
    """A value other than the default of the ten added fields needs a part
    not ported yet: it raises ``NotImplementedError`` naming the slice
    (the JAX config accepts each of these)."""
    if "plan" not in knob:
        JConfig(**TINY, **knob)
    with pytest.raises(NotImplementedError, match="slice"):
        GPTConfig(**TINY, **knob)


def test_gpt_config_keeps_jax_value_errors_for_the_new_fields():
    for knob, match in ((dict(context_mechanism="all2all"),
                         "context_mechanism"),
                        (dict(remat_policy="some"), "remat_policy"),
                        (dict(overlap_chunks=2), "sequence_parallel"),
                        (dict(expert_axis="expert"), "n_experts")):
        with pytest.raises(ValueError):
            JConfig(**TINY, **knob)
        with pytest.raises(ValueError, match=match):
            GPTConfig(**TINY, **knob)
