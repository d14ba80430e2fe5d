"""The ring pipeline of apex_tpu_torch against apex_tpu: the schedule
arithmetic and the micro-batch calculators (equal to JAX's over a grid),
``pipeline_step`` over two ``gloo`` ranks with 1F1B and the interleaved
schedule against JAX's ``pipeline_step`` at the same S and v and against
the port's own one-stage run, a MoE model in the pipeline, the dropout
seeds (from the logical stage and micro-batch, never the rank), the
stage-to-stage hops, and the refusals.  The set-up and tolerances are
``tests/_torch_pp.py``'s (4 ranks: ``tests/test_torch_pipeline_4.py``)."""

import jax
import numpy as np
import pytest
import torch

from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer.pipeline_parallel import ring as jring

from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel, pipeline_step,
                                       stack_layers_for_pipeline)
from apex_tpu_torch.transformer import microbatches as tmb
from apex_tpu_torch.transformer import pipeline_parallel as tpp
from apex_tpu_torch.transformer.pipeline_parallel import ring as tring

from _torch_dist import start
from _torch_pp import (PP_GPT, batch, check_against, jax_golden,
                       jax_pipeline, port_one_stage, spawn, _close,
                       _names, _np_tree)

_RUN = {}
DENSE = dict(PP_GPT, num_layers=4)
MOE = dict(DENSE, n_experts=4)
DROP = dict(DENSE, attention_dropout=0.3)


# -- the arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_schedule_ticks_and_bubble_match_jax(S):
    for M in range(1, 9):
        for v in (1, 2, 3):
            assert tring.schedule_ticks(M, S, v) == \
                jring.schedule_ticks(M, S, v)
            assert tring.bubble_fraction(M, S, v) == \
                jring.bubble_fraction(M, S, v)


_CALCS = [(None, 64, 4, 2), (None, 63, 4, 2), (None, 8, 4, 4),
          ([16, 8, 96], 64, 4, 2), ([16, 8, 96], 64, 4, 4),
          ([16, 12, 96], 64, 4, 2), ([16, 0, 96], 64, 4, 2),
          ([80, 8, 96], 64, 4, 2), ([16, 8], 64, 4, 2)]


@pytest.mark.parametrize("ramp,gbs,mbs,dp", _CALCS)
def test_microbatch_calculators_match_jax(ramp, gbs, mbs, dp):
    """The same calculator (or the same error) from the same arguments,
    and the same micro-batch counts along the ramp."""
    def build(mod):
        try:
            return mod.build_num_microbatches_calculator(0, ramp, gbs, mbs,
                                                         dp), None
        except ValueError as e:
            return None, str(e)
    (jc, je), (tc, te) = build(jmb), build(tmb)
    assert te == je
    if jc is None:
        return
    assert type(tc).__name__ == type(jc).__name__
    for consumed in range(0, 200, 7):
        got = want = None
        try:
            jc.update(consumed, True)
            want = (jc.get(), jc.get_current_global_batch_size())
        except ValueError as e:
            want = str(e)
        try:
            tc.update(consumed, True)
            got = (tc.get(), tc.get_current_global_batch_size())
        except ValueError as e:
            got = str(e)
        assert got == want, consumed


def test_stack_layers_for_pipeline_assigns_chunks_as_jax():
    """Device s chunk c holds logical stage c * S + s; the count must
    divide."""
    assert stack_layers_for_pipeline(list(range(8)), 2, 2) == [
        [[0, 1], [4, 5]], [[2, 3], [6, 7]]]
    assert stack_layers_for_pipeline(list(range(4)), 2) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="logical pipeline stages"):
        stack_layers_for_pipeline(list(range(6)), 2, 2)


# -- two ranks -------------------------------------------------------------------

def _pp2(tmp_path_factory):
    if "out" in _RUN:
        return _RUN["out"]
    tokens, targets = batch(0)
    params = {name: _jax_params(cfg, seed) for name, (cfg, seed) in
              {"dense": (DENSE, 0), "moe": (MOE, 1), "drop": (DROP, 2)}
              .items()}
    runs = {"v1": dict(cfg=DENSE, v=1, params="dense"),
            "v2": dict(cfg=DENSE, v=2, params="dense"),
            "moe": dict(cfg=MOE, v=1, params="moe"),
            "dropout": dict(cfg=DROP, v=1, params="drop",
                            seeds=[5, 5, 6, None])}
    sp = spawn(tmp_path_factory, 2, runs,
               {k: _np_tree(v) for k, v in params.items()}, tokens, targets)
    ref = {}
    for v in (1, 2):
        ref[f"v{v}"] = jax_pipeline(DENSE, params["dense"], tokens, targets,
                                    2, v)
        ref[f"one_v{v}"] = port_one_stage(DENSE, _np_tree(params["dense"]),
                                          tokens, targets, v)
    loss, g = jax_golden(MOE, params["moe"], tokens, targets)
    ref["moe"] = (loss, dict(_names(g)))
    ref["dropout"] = [jax_pipeline(DROP, params["drop"], tokens, targets, 2,
                                   1, seed=s, grads=False)[0]
                      for s in (5, 6)]
    _RUN["out"] = (ref, sp.result())
    return _RUN["out"]


def _jax_params(cfg, seed):
    from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
    return JModel(JConfig(**cfg)).init_params(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("v", [1, 2], ids=["1f1b", "interleaved"])
def test_pipeline_step_matches_jax_pipeline_step(tmp_path_factory, v):
    """Two stages, each rank's loss and its stage's gradients against
    JAX's pipeline_step (unpacked to the serial layout)."""
    ref, out = _pp2(tmp_path_factory)
    loss, grads = ref[f"v{v}"]
    for rank in out:
        check_against(rank["pipeline"][f"v{v}"], loss, grads, 4, 2, v)


@pytest.mark.parametrize("v", [1, 2], ids=["1f1b", "interleaved"])
def test_pipeline_step_is_its_one_stage_run_bit_for_bit(tmp_path_factory,
                                                        v):
    ref, out = _pp2(tmp_path_factory)
    loss, grads = ref[f"one_v{v}"]
    for rank in out:
        check_against(rank["pipeline"][f"v{v}"], loss, grads, 4, 2, v,
                      exact=True)


def test_moe_model_in_the_pipeline_matches_jax_golden(tmp_path_factory):
    """A MoE GPT over two stages (the aux rides with the activation):
    the loss and gradients of JAX's per-micro-batch serial golden."""
    ref, out = _pp2(tmp_path_factory)
    loss, grads = ref["moe"]
    for rank in out:
        check_against(rank["pipeline"]["moe"], loss, grads, 4, 2, 1)


def test_dropout_seeds_come_from_the_job(tmp_path_factory):
    """Attention dropout in the pipeline: each layer's stream derives from
    the base seed, the micro-batch and the logical stage (as JAX's
    ``make_stage_fn`` derives it), so both ranks' losses equal JAX's
    pipeline_step at the same seed, a seed repeats, another differs, and
    no seed is no dropout."""
    ref, out = _pp2(tmp_path_factory)
    for rank in out:
        a, b, c, none = rank["pipeline"]["dropout"]["losses"]
        assert a == b and a != c and a != none
        _close(a, ref["dropout"][0])
        _close(c, ref["dropout"][1])


# -- in one process ----------------------------------------------------------------

def test_tensor_parallel_without_sp_is_refused():
    cfg = GPTConfig(**DENSE, tensor_parallel_size=2, axis_name="model")
    model = GPTModel(cfg, device="meta")
    tk = torch.zeros((2, 2, 32), dtype=torch.long)
    with pytest.raises(ValueError, match="sequence_parallel"):
        pipeline_step(model, tk, tk)


def test_int8_weights_are_refused():
    cfg = GPTConfig(**DENSE, weight_quant="int8")
    model = GPTModel(cfg, device="meta")
    tk = torch.zeros((2, 2, 32), dtype=torch.long)
    with pytest.raises(ValueError, match="weight_quant"):
        pipeline_step(model, tk, tk)


def test_get_forward_backward_func_dispatches_as_apex():
    assert tpp.get_forward_backward_func() is \
        tpp.forward_backward_no_pipelining
    assert tpp.get_forward_backward_func(None, 2) is \
        tpp.forward_backward_pipelining_without_interleaving
    f = tpp.get_forward_backward_func(2, 2)
    assert f.func is tpp.forward_backward_pipelining_with_interleaving
    assert f.keywords == {"n_virtual": 2}


@pytest.mark.parametrize("v", [1, 2])
def test_pipelined_schedules_equal_no_pipelining_at_one_stage(v):
    """The apex schedules over plain ``stage_fn(params, x)`` chunks (two
    linear + tanh chunks): at one stage the 1F1B / interleaved engine
    gives ``forward_backward_no_pipelining``'s loss and gradients bit for
    bit, and ``forward_only`` the same loss."""
    torch.manual_seed(0)
    chunks = [torch.nn.Linear(8, 8) for _ in range(2)]
    x, t = torch.randn(4, 3, 8), torch.randn(4, 3, 8)

    def loss_fn(y, tt):
        return torch.mean((y - tt) ** 2)
    whole = tpp.forward_backward_no_pipelining(
        lambda ps, xx: torch.tanh(ps[1](torch.tanh(ps[0](xx)))), loss_fn,
        chunks, x, t)
    want = [p.grad.clone() for c in chunks for p in c.parameters()]
    for c in chunks:
        c.zero_grad(set_to_none=True)
    if v == 1:
        fn = tpp.forward_backward_pipelining_without_interleaving
        params = torch.nn.ModuleList(chunks)
        stage = lambda m, xx: torch.tanh(m[1](torch.tanh(m[0](xx))))  # noqa
    else:
        fn = tpp.forward_backward_pipelining_with_interleaving
        params = chunks
        stage = lambda m, xx: torch.tanh(m(xx))  # noqa: E731
    loss = fn(stage, loss_fn, params, x, t)
    assert float(loss) == float(whole)
    got = [p.grad for c in chunks for p in c.parameters()]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert float(fn(stage, loss_fn, params, x, t, forward_only=True)) == \
        float(whole)


def test_p2p_hops_at_two_ranks(tmp_path_factory):
    """Forward and backward hops with and without the wrap (the boundary
    stage receives zeros without it), and their gradients (the opposite
    hop), against the JAX module's ring semantics in numpy."""
    rng = np.random.RandomState(3)
    x, w = rng.randn(2, 5).astype(np.float32), rng.randn(2, 5).astype(
        np.float32)
    out = start(tmp_path_factory.mktemp("p2p"), 2, "mp", {
        "parts": {"p2p": dict(x=x, w=w)}}).result()
    for wrap in (False, True):
        fwd = np.stack([x[1], x[0]])     # rank s receives rank s - 1's
        back = np.stack([x[1], x[0]])    # rank s receives rank s + 1's
        fmask = np.array([wrap, True])[:, None]
        bmask = np.array([True, wrap])[:, None]
        for r in range(2):
            y, g = out[r]["p2p"][("fwd", wrap)]
            np.testing.assert_array_equal(y, (fwd * fmask)[r])
            # d/dx_r of sum_s y_s w_s: rank r's x lands on rank r + 1
            np.testing.assert_array_equal(
                g, (np.stack([w[1], w[0]]) * np.array(
                    [True, wrap])[:, None])[r])
            y, g = out[r]["p2p"][("bwd", wrap)]
            np.testing.assert_array_equal(y, (back * bmask)[r])
            np.testing.assert_array_equal(
                g, (np.stack([w[1], w[0]]) * np.array(
                    [wrap, True])[:, None])[r])


def _chip_smoke():
    """The card script (it imports torch and numpy only)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_phase16_gates_every_gap_and_refuses_unread_ones():
    """Phase 16 of ``chip_smoke.py`` holds every loss gap to a gate taken
    from readings: at 1, 2 and 4 ranks each path the default parts run has
    a number, a rank count without readings raises before anything runs,
    a gap without a gate raises, and a gap over its gate fails."""
    cs = _chip_smoke()
    paths = {1: {"pipeline_v2", "ulysses", "ring"},
             2: {"ep", "pipeline_v1", "pipeline_v2", "ulysses", "ring"}}
    paths[4] = paths[2] | {"pp_tp"}
    assert sorted(cs.MP_LOSS_RTOL) == [1, 2, 4]
    for world, keys in paths.items():
        limits = cs.mp_loss_limits(world)
        assert set(limits) == keys
        assert all(isinstance(v, float) and v >= 0 for v in limits.values())
        cs.gate_mp(dict.fromkeys(keys, 0.0), world)
    with pytest.raises(ValueError, match="no loss-gate readings at 3"):
        cs.mp_loss_limits(3)
    with pytest.raises(ValueError, match="pipeline_v1"):
        cs.gate_mp({"pipeline_v1": 0.0}, 1)
    with pytest.raises(AssertionError, match="ring"):
        cs.gate_mp({"ring": 1e-9}, 1)
    assert cs.MP_FAULTS == ("drop_microbatch", "ring_dkv", "a2a_bwd_local")
    with pytest.raises(ValueError, match="unknown fault"):
        cs._plant_mp(("drop_everything",))
