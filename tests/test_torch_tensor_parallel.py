"""Tensor and sequence parallelism of the port against the JAX package at
two ``gloo`` ranks: the mappings and rings, GPT's tensor-parallel
configurations, attention dropout, bf16, BERT, the dropout streams and
the int8 linears; the refusals.  The set-up, the references and the
tolerances are ``tests/_torch_tp.py``'s (4 ranks:
``tests/test_torch_tensor_parallel_4.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from apex_tpu_torch.models.bert import BertConfig
from apex_tpu_torch.models.gpt import (GPTConfig, quantize_decode_params,
                                       shard_params_for_tp)
from apex_tpu_torch.transformer.tensor_parallel import layers as tL

from _torch_tp import (F32_GPT, MAPPINGS, STEPS_2, TINY,
                       WEIGHT_QUANT_LOGITS_TOL, _check_step, _rel, _run,
                       check_gpt_step, check_mapping, check_sliced_serial,
                       check_surface)


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return (2,) + _run(2, tmp_path_factory)


@pytest.mark.parametrize("name", MAPPINGS)
def test_mappings_and_rings_match_jax_exactly(tp2, name):
    """The seven mappings and both overlap rings (chunks 1 and 2), forward
    and backward (the gradients of sum(y * c) for each rank's c), equal
    JAX's under shard_map bit for bit."""
    check_mapping(tp2, name)


@pytest.mark.parametrize("name", F32_GPT)
def test_gpt_step_matches_jax_shard_map(tp2, name):
    """GPT at 2 ranks (TP; TP + SP; TP + SP + ``overlap_chunks=2``; each
    also with ``fused_ffn=True``): the loss, every rank's gradients and
    parameters after one FusedAdam step against the JAX package's
    shard_map step.  A dropped ``copy_to`` wrapper leaves a replicated
    leaf's gradient a rank-local partial, an extra one multiplies it by
    the ranks."""
    check_gpt_step(tp2, name)


@pytest.mark.parametrize("name", F32_GPT)
def test_gpt_grads_match_sliced_serial_grads(tp2, name):
    """The same ranks' losses and gradients against the JAX serial model's,
    sliced by JAX's ``shard_params_for_tp``: a replicated leaf's gradient
    is the serial one on every rank, a sharded leaf's its slice."""
    check_sliced_serial(tp2, name)


@pytest.mark.parametrize("name", [n for n in STEPS_2
                                  if not STEPS_2[n].get("nsp")])
def test_two_rank_steps_match_jax_shard_map(tp2, name):
    """At two ranks: attention dropout (each rank's seed offset by its
    rank times ``_SEED_TP_RANK_STRIDE``, as in JAX), bf16 activations, and
    BERT with SP (and with the overlap rings and the fused FFN)."""
    t, inp, ref, out = tp2
    c = STEPS_2[name]
    _check_step(name, t, ref["steps"][name], out, c["dtype"],
                c.get("bert", False))


@pytest.mark.parametrize("name", [n for n in STEPS_2 if n.startswith("bert")])
def test_bert_grads_match_sliced_serial_grads(tp2, name):
    check_sliced_serial(tp2, name)


def test_bert_nsp_under_sp_matches_serial_step(tp2):
    """BERT with SP and the NSP loss: every rank's loss, gradients and
    FusedAdam step against the JAX serial model's.  Every rank computes
    the same NSP loss, so its cotangent must reach the backbone once (the
    pooler's input is gathered with a split backward), not summed over
    the ranks by the sequence gather's reduce-scatter, as the JAX
    package's shard_map run sums it (its largest gradient error is
    printed)."""
    t, inp, ref, out = tp2
    want = ref["steps"]["bert-tp_sp-nsp"]
    jax_sm = want["shard_map"]["grads"]
    worst = max(_rel(jax_sm[n], g) for n, g in want["grads"].items()
                if "nsp_head" not in n)
    print(f"JAX shard_map with NSP under SP: largest gradient error "
          f"{worst:.3e} of the tensor's largest entry")
    _check_step("bert-tp_sp-nsp", t, want, out, "float32", bert=True)


def test_tp_ranks_draw_independent_masks(tp2):
    """Both ranks hold the same local attention shard and input: with
    attention dropout their attention contexts (proj's input) differ,
    without it they are equal (``tests/test_gpt.py::
    test_tp_ranks_draw_independent_masks``'s twin)."""
    t, inp, ref, out = tp2
    (drop0, plain0), (drop1, plain1) = out[0]["masks"], out[1]["masks"]
    np.testing.assert_array_equal(plain0, plain1)
    assert not np.allclose(drop0, drop1), "identical masks across ranks"


def test_int8_tp_linears_match_jax(tp2):
    """An int8 GPT at two ranks (every linear and the tied head through
    the dequant-GEMM on the rank's shards): prefill logits and K/V of
    shard-then-quantize against JAX's shard_map prefill of the same
    weights (1e-5 of the largest entry: the plain dequant-GEMMs sum in
    other orders), and quantize-then-shard (the row layers' scales those
    of the whole weight) within the weight-quantization tolerance."""
    t, inp, ref, out = tp2
    jlogits, jkv = ref["int8"]
    got = {key: (np.concatenate([o["int8"][key][0] for o in out], -1),
                 np.concatenate([o["int8"][key][1] for o in out], -2))
           for key in ("shard_then_quantize", "quantize_then_shard")}
    logits, kv = got["shard_then_quantize"]
    assert logits.shape == jlogits.shape and kv.shape == jkv.shape
    assert _rel(logits, jlogits) <= 1e-5
    assert _rel(kv, jkv) <= 1e-5
    other, _ = got["quantize_then_shard"]
    np.testing.assert_allclose(other, logits, atol=WEIGHT_QUANT_LOGITS_TOL)


def test_int8_column_shards_commute_with_quantization():
    """Quantize-then-shard equals shard-then-quantize bit for bit on the
    column layers and the embedding (per-output-row scales ride the row
    slice); a row shard's own scales only tighten (JAX's
    ``TestTensorParallel``)."""
    cfg = GPTConfig(**TINY)
    from apex_tpu_torch.models.gpt import GPTModel
    sd = GPTModel(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)).state_dict()
    full = quantize_decode_params(sd)
    tcfg = dataclasses.replace(cfg, tensor_parallel_size=2, axis_name="model")
    for r in range(2):
        a = shard_params_for_tp(tcfg, full, r)
        b = quantize_decode_params(shard_params_for_tp(tcfg, sd, r))
        assert set(a) == set(b)
        for n in a:
            if ".proj." in n or ".fc2." in n:
                if n.endswith("weight_scale"):
                    assert bool(((b[n] <= a[n] + 1e-12) | (b[n] == 1.0))
                                .all()), n
                continue
            assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("knob", [dict(plan=object()), dict(n_experts=2),
                                  dict(context_axis="ctx")],
                         ids=["plan", "n_experts", "context_axis"])
def test_plan_moe_and_context_parallelism_still_raise(knob):
    """These raised ``NotImplementedError`` until ROADMAP item 14 was
    ported: MoE and context parallelism now build, and a ``plan`` that is
    not a ``ParallelPlan`` fails as the JAX configs fail
    (``AttributeError``); a real plan builds both configs."""
    from apex_tpu_torch.parallel import ParallelPlan
    if "plan" in knob:
        for cls in (GPTConfig, BertConfig):
            with pytest.raises(AttributeError):
                cls(**TINY, **knob)
            assert cls(**TINY, plan=ParallelPlan(tp=2)).axis_name == "model"
        return
    cfg = GPTConfig(**TINY, **knob)
    assert all(getattr(cfg, k) == v for k, v in knob.items())


def test_tp_configs_and_layers_refuse_what_cannot_run():
    """``tensor_parallel_size > 1`` needs ``axis_name`` (no GSPMD form),
    the heads must divide, a layer's group must have its ``world_size``
    ranks, and SP refuses KV-cache decode, as in JAX."""
    for cls in (GPTConfig, BertConfig):
        with pytest.raises(ValueError, match="axis_name"):
            cls(**TINY, tensor_parallel_size=2)
        with pytest.raises(ValueError, match="divisible"):
            cls(**TINY, tensor_parallel_size=3, axis_name="model")
    layer = tL.ColumnParallelLinear(8, 8, world_size=2, gather_output=False,
                                    device="cpu")
    with pytest.raises(ValueError, match="world_size=2"):
        layer(torch.zeros(2, 8))
    from apex_tpu_torch.models.gpt import GPTModel
    model = GPTModel(GPTConfig(**TINY, sequence_parallel=True),
                     device="cpu")
    with pytest.raises(ValueError, match="sequence_parallel=False"):
        model.prefill(torch.zeros((1, 4), dtype=torch.int64))


def test_layers_broadcast_and_rng_across_ranks(tp2):
    """``ColumnParallelLinear(gather_output=True)`` into
    ``RowParallelLinear(input_is_parallel=False)`` on two ranks' shards,
    ``broadcast_data`` and the per-rank random streams."""
    check_surface(tp2)


def test_utils_random_and_exports_match_jax():
    """``tensor_parallel.utils`` against JAX's, the RNG tracker and
    ``checkpoint``, and the JAX package's ``__all__``."""
    import jax.numpy as jnp
    import apex_tpu.transformer.tensor_parallel as jtp
    import apex_tpu_torch.transformer.tensor_parallel as ttp
    assert sorted(ttp.__all__) == sorted(jtp.__all__)
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    for a, b in zip(ttp.split_tensor_along_last_dim(torch.from_numpy(x), 3),
                    jtp.split_tensor_along_last_dim(jnp.asarray(x), 3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    chunks = [ttp.split_tensor_into_1d_equal_chunks(torch.from_numpy(x), r, 4)
              for r in range(4)]
    for r, ch in enumerate(chunks):
        np.testing.assert_array_equal(ch.numpy(), np.asarray(
            jtp.split_tensor_into_1d_equal_chunks(jnp.asarray(x), r, 4)))
    np.testing.assert_array_equal(ttp.gather_split_1d_tensor(chunks).numpy(),
                                  x.reshape(-1))
    assert ttp.VocabUtility.vocab_range_from_global_vocab_size(128, 3, 4) \
        == jtp.VocabUtility.vocab_range_from_global_vocab_size(128, 3, 4)
    with pytest.raises(ValueError, match="divisible"):
        ttp.divide(10, 4)
    tracker = ttp.CudaRNGStatesTracker()
    tracker.add("model-parallel-rng", 7)
    with pytest.raises(Exception, match="already exists"):
        tracker.add("model-parallel-rng", 8)
    saved = tracker.get_states()
    with tracker.fork() as gen:
        a = torch.rand(3, generator=gen)
    tracker.set_states(saved)
    with tracker.fork() as gen:
        assert torch.equal(torch.rand(3, generator=gen), a)
    data_gen, tp_gen = ttp.model_parallel_cuda_manual_seed(5)
    assert data_gen.initial_seed() == 5
    assert tp_gen().initial_seed() == 5 + 2718
    w = torch.randn(4, 4, requires_grad=True)
    y = ttp.checkpoint(lambda a: torch.tanh(a @ a), False, w)
    y.sum().backward()
    g, w.grad = w.grad.clone(), None
    torch.tanh(w @ w).sum().backward()
    assert torch.equal(g, w.grad)
