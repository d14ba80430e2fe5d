"""The ring pipeline over four ``gloo`` ranks against apex_tpu: four
stages with 1F1B and the interleaved schedule (8 layers) against JAX's
``pipeline_step`` at S = 4 and against the port's own one-stage run, and
pipe 2 x model 2 with sequence parallelism against the JAX serial model's
gradients cut by JAX's ``shard_params_for_tp`` and by stage.  The set-up
and tolerances are ``tests/_torch_pp.py``'s."""

import jax
import pytest

from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel

from _torch_pp import (PP_GPT, batch, check_against, jax_golden,
                       jax_pipeline, jshard, port_one_stage, spawn, _names,
                       _np_tree)

_RUN = {}
DEEP = dict(PP_GPT, num_layers=8)
SHALLOW = dict(PP_GPT, num_layers=4)


def _pp4(tmp_path_factory):
    if "out" in _RUN:
        return _RUN["out"]
    tokens, targets = batch(4)
    params = {"deep": JModel(JConfig(**DEEP)).init_params(
                  jax.random.PRNGKey(4)),
              "shallow": JModel(JConfig(**SHALLOW)).init_params(
                  jax.random.PRNGKey(5))}
    runs = {"v1": dict(cfg=DEEP, v=1, params="deep"),
            "v2": dict(cfg=DEEP, v=2, params="deep"),
            "pp_tp": dict(cfg=SHALLOW, v=1, params="shallow", tp=2)}
    sp = spawn(tmp_path_factory, 4, runs,
               {k: _np_tree(v) for k, v in params.items()}, tokens, targets)
    ref = {}
    for v in (1, 2):
        ref[f"v{v}"] = jax_pipeline(DEEP, params["deep"], tokens, targets, 4,
                                    v)
        ref[f"one_v{v}"] = port_one_stage(DEEP, _np_tree(params["deep"]),
                                          tokens, targets, v)
    loss, g = jax_golden(SHALLOW, params["shallow"], tokens, targets)
    tp_cfg = JConfig(**SHALLOW, tensor_parallel_size=2, axis_name="model")
    ref["pp_tp"] = (loss, [dict(_names(jshard(tp_cfg, g, r)))
                           for r in range(2)])
    _RUN["out"] = (ref, sp.result())
    return _RUN["out"]


@pytest.mark.parametrize("v", [1, 2], ids=["1f1b", "interleaved"])
def test_four_stages_match_jax_pipeline_step(tmp_path_factory, v):
    ref, out = _pp4(tmp_path_factory)
    loss, grads = ref[f"v{v}"]
    for rank in out:
        check_against(rank["pipeline"][f"v{v}"], loss, grads, 8, 4, v)


@pytest.mark.parametrize("v", [1, 2], ids=["1f1b", "interleaved"])
def test_four_stages_are_the_one_stage_run_bit_for_bit(tmp_path_factory, v):
    ref, out = _pp4(tmp_path_factory)
    loss, grads = ref[f"one_v{v}"]
    for rank in out:
        check_against(rank["pipeline"][f"v{v}"], loss, grads, 8, 4, v,
                      exact=True)


def test_pp_x_tp_with_sp_matches_sliced_jax_golden(tmp_path_factory):
    """Pipe 2 x model 2, sequence parallel: every rank's loss and its
    stage's gradients, each tensor-parallel shard the serial gradient's
    slice (the SP wrappers sum the replicated leaves inside the engine's
    backward jobs)."""
    ref, out = _pp4(tmp_path_factory)
    loss, sliced = ref["pp_tp"]
    for rank in out:
        run = rank["pipeline"]["pp_tp"]
        check_against(run, loss, sliced[run["tp_rank"]], 4, 2, 1)
