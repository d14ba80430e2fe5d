"""The int8 decode path of apex_tpu_torch against apex_tpu on the CPU.

* ``quantize_weight`` is bitwise JAX's (int8 and scales), all-zero rows
  included, and so is ``quantize_decode_params`` over a whole GPT;
* ``quant_gemm``'s plain version against the JAX Pallas ``_qgemm_kernel``
  in interpret mode and against the JAX default path at (5, 130, 200) and
  (16, 512, 512): f32 within 2e-5, bf16 within 2e-2 (the JAX test's
  tolerances);
* ``GPTConfig(weight_quant="int8")`` on a small GPT: prefill and decode
  logits within 1e-4 of the JAX quantized model on the same int8 weights
  (carried bit for bit by ``gpt_quant_params_from_jax``), within
  ``WEIGHT_QUANT_LOGITS_TOL`` of the f32 model, greedy streams of both
  engines equal to JAX's, and ``weight_bytes`` under 0.30x f32;
* the config and training refusals of the JAX package;
* the f32 path of the TMA kernel in plain PyTorch: the split of f32 x
  into three bf16 parts (``split_bf16x3_reference``) gives x back to
  2^-24 relative, and the split-and-factored-scale sum
  (``quant_gemm_split_reference``) is within 1e-4 of the JAX reference
  and of the Pallas kernel in interpret mode;
* ``qgemm_plan`` routes GPT-350M's decode and prefill shapes to the TMA
  kernel and the shapes off its grid to the ``mma.sync`` / FMA kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import (InferenceEngine as JEngine,
                                Request as JRequest)
from apex_tpu.models.gpt import (GPTConfig as JConfig, GPTModel as JModel,
                                 quantize_decode_params as jquantize)
from apex_tpu.ops import quant_gemm as jq
from apex_tpu.serving import PagedInferenceEngine as JPaged
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch.convert import (gpt_params_from_jax,
                                    gpt_quant_params_from_jax)
from apex_tpu_torch.inference import InferenceEngine, Request
from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                       quantize_decode_params)
from apex_tpu_torch.ops import quant_gemm as tq
from apex_tpu_torch.serving import PagedInferenceEngine

# int8 weights keep decode logits this close to f32 (the JAX test's bound)
WEIGHT_QUANT_LOGITS_TOL = 5e-2
# the JAX test's CI config: greedy argmax is stable under the quantization
# error, and LN / bias / scales stay under 30% of the int8 bytes
CI_KW = dict(vocab_size=256, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_seq_len=64)


@pytest.fixture(scope="module")
def ci():
    jm = JModel(JConfig(**CI_KW))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    f32 = GPTModel(GPTConfig(**CI_KW), device="cpu")
    f32.load_state_dict(gpt_params_from_jax(tree, GPTConfig(**CI_KW)))
    qcfg = GPTConfig(**CI_KW, weight_quant="int8")
    q = GPTModel(qcfg, device="cpu").load_quantized_(
        gpt_quant_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jquantize(jp)), qcfg))
    return jm, jp, f32, q


def _weights(seed, n, k, zero_rows=()):
    w = (np.random.RandomState(seed).randn(n, k) * 0.1).astype(np.float32)
    w[list(zero_rows)] = 0.0
    return w


@pytest.mark.parametrize("zero_rows", [(), (0, 5)],
                         ids=["random", "zero_rows"])
def test_quantize_weight_bitwise_matches_jax(zero_rows):
    w = _weights(0, 64, 48, zero_rows)
    j8, jsc = jq.quantize_weight(jnp.asarray(w))
    t8, tsc = tq.quantize_weight(torch.from_numpy(w))
    assert t8.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        tq.dequantize_weight(t8, tsc).numpy(),
        np.asarray(jq.dequantize_weight(j8, jsc)))
    for r in zero_rows:
        assert tsc[r] == 1.0 and not t8[r].any()
    # the per-element error bound: half a scale step
    err = np.abs(tq.dequantize_weight(t8, tsc).numpy() - w)
    assert (err <= tsc.numpy()[:, None] / 2 + 1e-9).all()


def test_quantize_weight_rejects_non_2d():
    with pytest.raises(ValueError, match="2D"):
        tq.quantize_weight(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("m,n,k", [(5, 130, 200), (16, 512, 512)])
@pytest.mark.parametrize("pallas", [True, False],
                         ids=["jax_interpret_kernel", "jax_default_path"])
def test_quant_gemm_plain_version_matches_jax(pallas, m, n, k, dtype, tol):
    rng = np.random.RandomState(1)
    x = rng.randn(m, k).astype(np.float32)
    w8, scale = (np.array(a) for a in jq.quantize_weight(
        jnp.asarray(_weights(2, n, k))))
    set_force_pallas(True if pallas else None)
    try:
        want = jq.quant_gemm(jnp.asarray(x).astype(dtype), jnp.asarray(w8),
                             jnp.asarray(scale), block_n=128, block_k=128)
    finally:
        set_force_pallas(None)
    got = tq.quant_gemm(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(w8), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_quant_gemm_leading_dims_flatten():
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 32).astype(
        np.float32))
    w8, scale = tq.quantize_weight(torch.from_numpy(_weights(4, 48, 32)))
    out = tq.quant_gemm(x, w8, scale)
    assert tuple(out.shape) == (2, 3, 48)
    assert torch.equal(out.reshape(6, 48),
                       tq.quant_gemm(x.reshape(6, 32), w8, scale))


@pytest.mark.parametrize("case", ["float_weight", "in_features", "scale"])
def test_quant_gemm_rejects_bad_operands_as_jax(case):
    x = np.zeros((2, 8), np.float32)
    w8, scale = np.zeros((4, 8), np.int8), np.ones(4, np.float32)
    if case == "float_weight":
        w8, match = w8.astype(np.float32), "int8"
    elif case == "in_features":
        x, match = np.zeros((2, 6), np.float32), "features"
    else:
        scale, match = np.ones(3, np.float32), "scale"
    with pytest.raises(ValueError, match=match):
        jq.quant_gemm(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(scale))
    with pytest.raises(ValueError, match=match):
        tq.quant_gemm(*(torch.from_numpy(a) for a in (x, w8, scale)))


def test_quantize_decode_params_bitwise_matches_jax(ci):
    """The port quantizing its own f32 state dict gives bit for bit what
    JAX's ``quantize_decode_params`` gives on the same weights."""
    _, jp, f32, q = ci
    ours = quantize_decode_params(f32.state_dict())
    theirs = q.state_dict()
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert ours[name].dtype == theirs[name].dtype, name
        assert torch.equal(ours[name], theirs[name]), name
    assert sum(name.endswith("weight_scale") for name in ours) == 1 + 4 * 2
    with pytest.raises(ValueError, match="already quantized"):
        quantize_decode_params(ours)


def test_gpt_quant_params_from_jax_rejects_mismatches(ci):
    _, jp, _, _ = ci
    tree = jax.tree_util.tree_map(np.asarray, jquantize(jp))
    qcfg = GPTConfig(**CI_KW, weight_quant="int8")
    with pytest.raises(ValueError, match="weight_quant"):
        gpt_quant_params_from_jax(tree, GPTConfig(**CI_KW))
    bad = dict(tree, embedding=dict(tree["embedding"],
                                    weight=tree["embedding"]["weight"]
                                    .astype(np.float32)))
    with pytest.raises(ValueError, match="dtype"):
        gpt_quant_params_from_jax(bad, qcfg)
    with pytest.raises(KeyError, match="lacks"):
        gpt_quant_params_from_jax(dict(tree, layers=tree["layers"][:1]),
                                  qcfg)


def test_quantized_model_matches_jax_and_f32(ci):
    """Prefill logits and K/V, then 3 decode steps, on the same int8
    weights: within 1e-4 of the JAX quantized model and within
    WEIGHT_QUANT_LOGITS_TOL of the port's f32 model."""
    jm, jp, f32, q = ci
    jqm = JModel(JConfig(**CI_KW, weight_quant="int8"))
    jqp = jquantize(jp)
    toks = np.random.RandomState(5).randint(1, 256, (2, 9))
    jl, jkv = jqm.prefill(jqp, jnp.asarray(toks))
    tl, tkv = q.prefill(torch.from_numpy(toks))
    fl, _ = f32.prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=1e-4,
                               rtol=1e-4)
    assert float((tl - fl).abs().max()) < WEIGHT_QUANT_LOGITS_TOL
    cfg = q.cfg
    shape = (2, cfg.num_layers, 2, cfg.max_seq_len, cfg.local_heads,
             cfg.head_dim)
    jcache = jnp.zeros(shape, jnp.float32).at[:, :, :, :9].set(
        jkv.transpose(2, 0, 1, 3, 4, 5))
    tcache = torch.from_numpy(np.asarray(jcache).copy())
    fcache = tcache.clone()
    tok = toks[:, -1]
    for i in range(3):
        pos = np.full(2, 9 + i, np.int32)
        jl, jcache = jqm.decode_step(jqp, jnp.asarray(tok), jcache,
                                     jnp.asarray(pos))
        tl, tcache = q.decode_step(torch.from_numpy(tok), tcache,
                                   torch.from_numpy(pos))
        fl, fcache = f32.decode_step(torch.from_numpy(tok), fcache,
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        assert float((tl - fl).abs().max()) < WEIGHT_QUANT_LOGITS_TOL
        tok = tl.argmax(-1).numpy()


def _greedy(engine, reqs):
    for r in reqs:
        engine.submit(dataclasses.replace(r))
    return {r.request_id: r.tokens for r in engine.run()}


@pytest.mark.parametrize("paged", [False, True])
def test_int8_engines_greedy_match_jax_and_f32(ci, paged):
    """Both engines quantize at init: their greedy streams equal the JAX
    int8 engine's and the f32 engine's, and their weights take under 0.30x
    the f32 bytes."""
    jm, jp, f32, _ = ci
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 256, 6 + i).tolist() for i in range(4)]
    qcfg = GPTConfig(**CI_KW, weight_quant="int8")
    model = GPTModel(qcfg, device="cpu")
    model.load_state_dict(f32.state_dict())
    jqm = JModel(JConfig(**CI_KW, weight_quant="int8"))
    if paged:
        kw = dict(max_slots=4, block_size=8, chunked_prefill=True)
        engine = PagedInferenceEngine(model, device="cpu", **kw)
        jeng = JPaged(jqm, jp, **kw)
        base = PagedInferenceEngine(f32, device="cpu", **kw)
    else:
        engine = InferenceEngine(model, max_slots=4, device="cpu")
        jeng = JEngine(jqm, jp, max_slots=4)
        base = InferenceEngine(f32, max_slots=4, device="cpu")
    assert model.quantized
    assert model.embedding.weight.dtype == torch.int8
    got = _greedy(engine, [Request(i, p, max_new_tokens=8)
                           for i, p in enumerate(prompts)])
    assert got == _greedy(jeng, [JRequest(i, p, max_new_tokens=8)
                                 for i, p in enumerate(prompts)])
    assert got == _greedy(base, [Request(i, p, max_new_tokens=8)
                                 for i, p in enumerate(prompts)])
    assert engine.weight_bytes < 0.30 * base.weight_bytes
    assert engine.weight_bytes == jeng.weight_bytes


def test_quantized_model_refuses_training(ci):
    """The JAX package refuses gradients through int8 weights
    (``pipeline_step``): train with ``weight_quant=None``."""
    q = ci[3]
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="weight_quant=None"):
        q.loss(toks, toks)
    with pytest.raises(ValueError, match="weight_quant=None"):
        q.head_loss(torch.zeros((1, 4, 64)), toks)


@pytest.mark.parametrize("knob,match", [
    (dict(weight_quant="int4"), "weight_quant"),
    (dict(weight_quant="int8", n_experts=2), "n_experts"),
    (dict(weight_quant="int8", fused_ffn=True), "fused_ffn")],
    ids=["mode", "moe", "fused_ffn"])
def test_weight_quant_config_refusals_match_jax(knob, match):
    with pytest.raises(ValueError):
        JConfig(**CI_KW, **knob)
    with pytest.raises(ValueError, match=match):
        GPTConfig(**CI_KW, **knob)


def test_load_quantized_needs_the_int8_config(ci):
    f32 = ci[2]
    with pytest.raises(ValueError, match="weight_quant"):
        GPTModel(GPTConfig(**CI_KW), device="cpu").load_quantized_(
            quantize_decode_params(f32.state_dict()))


# bf16 keeps 8 significant bits, so three parts carry f32's 24: the split
# gives x back to 2^-24 relative; below bf16's normal range its subnormal
# step 2^-133 rounds the parts (half a step)
SPLIT_REL = 2.0 ** -24
SPLIT_ABS = 2.0 ** -134


def _split_case(case):
    rng = np.random.RandomState(11)
    if case == "zeros":
        return np.zeros(64, np.float32)
    if case == "spread":    # 1e-3 .. 1e3, both signs
        return (np.sign(rng.randn(256)) * 10.0 ** rng.uniform(-3, 3, 256)
                ).astype(np.float32)
    if case == "subnormal":  # f32 subnormals and bf16's smallest normals
        return np.concatenate([
            rng.uniform(-1, 1, 64) * np.float32(1.1754944e-38),
            rng.uniform(-4, 4, 64) * np.float32(1e-37)]).astype(np.float32)
    if case == "large":      # up to f32's largest, past bf16's largest
        return np.concatenate([
            np.array([3.4028235e38, -3.4028235e38, 3.39e38, 1e38],
                     np.float32),
            (rng.randn(60) * 1e30).astype(np.float32)])
    return np.array([np.inf, -np.inf, np.nan, 1.5, -2.25], np.float32)


@pytest.mark.parametrize("case", ["zeros", "spread", "subnormal", "large",
                                  "non_finite"])
def test_split_bf16x3_reconstructs_x(case):
    x = _split_case(case)
    parts = tq.split_bf16x3_reference(torch.from_numpy(x))
    assert parts.dtype == torch.bfloat16 and tuple(parts.shape) == (
        3,) + x.shape
    hi, mid, lo = (p.to(torch.float64).numpy() for p in parts)
    fin = np.isfinite(x)
    assert np.isfinite(hi[fin]).all()
    np.testing.assert_array_equal(mid[~fin], 0.0)
    np.testing.assert_array_equal(lo[~fin], 0.0)
    np.testing.assert_array_equal(hi[~fin], x[~fin].astype(np.float64))
    err = np.abs((hi + mid + lo)[fin] - x[fin].astype(np.float64))
    lim = SPLIT_REL * np.abs(x[fin].astype(np.float64)) + SPLIT_ABS
    assert (err <= lim).all(), float((err / lim).max())


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("pallas", [True, False],
                         ids=["jax_interpret_kernel", "jax_reference"])
def test_split_sum_matches_jax(pallas, m):
    """s * (lo q^T + mid q^T + hi q^T) in f32, the f32 head's arithmetic on
    the TMA kernel, against the JAX f32 dequant-GEMM, within 1e-4."""
    n, k = 512, 1024
    rng = np.random.RandomState(13)
    x = rng.randn(m, k).astype(np.float32)
    w8, scale = (np.array(a) for a in jq.quantize_weight(
        jnp.asarray(_weights(14, n, k))))
    set_force_pallas(True if pallas else None)
    try:
        want = jq.quant_gemm(jnp.asarray(x), jnp.asarray(w8),
                             jnp.asarray(scale), block_n=128, block_k=512)
    finally:
        set_force_pallas(None)
    got = tq.quant_gemm_split_reference(
        torch.from_numpy(x), torch.from_numpy(w8), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jq.quant_gemm_reference(
            jnp.asarray(x), jnp.asarray(w8), jnp.asarray(scale))),
        rtol=1e-4, atol=1e-4)


_BF, _F32, _F16 = torch.bfloat16, torch.float32, torch.float16
_PLANS = [
    # GPT-350M decode, 8 slots: qkv, proj, fc1 (the register-fed kernel),
    # fc2 (bf16), the f32 head
    ((8, 3072, 1024, _BF, True), ("qgemm_bf16_rows16", 0, 1, 1)),
    ((8, 1024, 1024, _BF, True), ("qgemm_bf16_rows16", 0, 1, 1)),
    ((8, 4096, 1024, _BF, True), ("qgemm_bf16_rows16", 0, 1, 1)),
    ((8, 1024, 4096, _BF, True), ("qgemm_tma", 8, 8, 1)),
    ((8, 50304, 1024, _F32, True), ("qgemm_tma", 8, 1, 3)),
    # the 512-token prefill
    ((512, 3072, 1024, _BF, True), ("qgemm_tma", 128, 1, 1)),
    ((512, 1024, 1024, _BF, True), ("qgemm_tma", 128, 4, 1)),
    ((512, 4096, 1024, _BF, True), ("qgemm_tma", 128, 1, 1)),
    ((512, 1024, 4096, _BF, True), ("qgemm_tma", 128, 4, 1)),
    ((512, 50304, 1024, _F32, True), ("qgemm_tma", 128, 1, 3)),
    # off the TMA grid: the mma.sync / FMA kernels
    ((5, 130, 200, _BF, True), ("qgemm_bf16_rows16", 0, 1, 1)),
    ((33, 130, 200, _BF, True), ("qgemm_bf16_tiles", 0, 1, 1)),
    ((5, 130, 200, _F32, True), ("qgemm_fma", 0, 1, 1)),
    ((17, 64, 48, _F16, True), ("qgemm_fma", 0, 1, 1)),
    ((8, 1024, 4096, _BF, False), ("qgemm_bf16_rows16", 0, 1, 1)),
    ((64, 1024, 1024, _F32, False), ("qgemm_fma", 0, 1, 1)),
    ((8, 1024, 4004, _BF, True), ("qgemm_bf16_rows16", 0, 1, 1)),
    ((32, 1024, 1000, _BF, True), ("qgemm_bf16_tiles", 0, 1, 1)),
]


@pytest.mark.parametrize("shape,want", _PLANS,
                         ids=[f"{m}x{n}x{k}-{str(dt)[6:]}-"
                              f"{'al' if a else 'mis'}"
                              for (m, n, k, dt, a), _ in _PLANS])
def test_qgemm_plan_routes_by_shape(shape, want):
    m, n, k, dtype, aligned = shape
    plan = tq.qgemm_plan(m, n, k, dtype, aligned, sms=132)
    assert tuple(plan) == want
    assert plan.kernel in tq.QGEMM_KERNELS
    if plan.kernel == "qgemm_tma":
        # the blocks fit one wave; each rank of a split keeps two k steps
        tiles = -(-m // plan.bn) * -(-n // tq.QGEMM_TMA_ROWS)
        assert plan.bn >= min(m, 128) and plan.ks <= tq.QGEMM_MAX_SPLIT
        assert plan.ks == 1 or (tiles * plan.ks <= 132
                                and -(-k // 64) >= 2 * plan.ks)


@pytest.mark.parametrize("held,short_from,want_ks",
                         [(132, 2, 4), (120, 4, 2), (63, 2, 1)],
                         ids=["all_sms", "clusters_of_4_short", "none"])
def test_qgemm_plan_keeps_a_split_within_the_cards_clusters(
        held, short_from, want_ks):
    """32 weight tiles of 8 tokens: clusters of ks that the card cannot
    hold all at once would run a second wave, so the split stops below
    them."""
    asked = []

    def slots(bn, parts, ks):
        asked.append((bn, parts, ks))
        return held if ks >= short_from else 132

    plan = tq.qgemm_plan(8, 4096, 2048, _BF, True, sms=132, slots=slots)
    assert (plan.kernel, plan.bn, plan.ks) == ("qgemm_tma", 8, want_ks)
    assert all(a[:2] == (8, 1) for a in asked)


@pytest.mark.parametrize("m,n,k,want", [
    (512, 1024, 1024, (64, 2)), (512, 1024, 4096, (64, 2)),
    (512, 3072, 1024, (128, 1)), (512, 4096, 1024, (128, 1))],
    ids=["proj", "fc2", "qkv", "fc1"])
def test_qgemm_plan_halves_the_tile_where_the_card_sits_half_idle(
        m, n, k, want):
    """A prefill's proj and fc2 (8 weight tiles x 4 token tiles): clusters
    of 4 that do not all fit leave 64 blocks; tiles of 64 tokens give 128.
    qkv and fc1 fill the card with 128-token tiles and keep them."""
    def slots(bn, parts, ks):
        return 120 if ks >= 4 else 132

    plan = tq.qgemm_plan(m, n, k, _BF, True, sms=132, slots=slots)
    assert (plan.kernel, (plan.bn, plan.ks)) == ("qgemm_tma", want)
