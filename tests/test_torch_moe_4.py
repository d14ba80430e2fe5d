"""Expert parallelism with tensor parallelism inside each expert (EP 2 x
TP 2) on four ``gloo`` ranks against the JAX package: the GPT MoE loss
and gradients after ``reduce_moe_grads``, held against the JAX serial
per-shard golden sliced by JAX's ``shard_params_for_tp`` and by expert
rank (what JAX's ``TestMoEComposition`` holds its shard_map run to).  The
set-up and tolerances are ``tests/test_torch_moe.py``'s."""

import jax
import jax.numpy as jnp

from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.models.gpt import shard_params_for_tp as jshard

from apex_tpu_torch.transformer.expert_parallel import is_gpt_expert_leaf

from _torch_dist import start
from test_torch_moe import GPT, _batch, _close, _close_grad, _names, _np_tree

_RUN = {}


def _ep_tp(tmp_path_factory):
    if "out" in _RUN:
        return _RUN["out"]
    ep, tp = 2, 2
    jcfg = dict(GPT, num_layers=2)
    jmodel = JModel(JConfig(**jcfg))
    jparams = jmodel.init_params(jax.random.PRNGKey(44))
    tokens, targets = _batch(45, (ep * 2, 32))
    spawn = start(tmp_path_factory.mktemp("eptp4"), ep * tp, "mp", {
        "parts": {"gpt_ep": dict(cfg=jcfg, tp=tp, params=_np_tree(jparams),
                                 tokens=tokens, targets=targets)}})

    def golden(p):
        return jnp.mean(jnp.stack([jmodel.loss(
            p, jnp.asarray(tokens[s * 2:(s + 1) * 2]),
            jnp.asarray(targets[s * 2:(s + 1) * 2])) for s in range(ep)]))
    loss, grads = jax.value_and_grad(golden)(jparams)
    tp_cfg = JConfig(**jcfg, tensor_parallel_size=tp, axis_name="model")
    sliced = [dict(_names(jshard(tp_cfg, grads, r))) for r in range(tp)]
    _RUN["out"] = (float(loss), sliced, spawn.result())
    return _RUN["out"]


def test_ep_tp_gpt_loss_matches_jax_golden(tmp_path_factory):
    loss, _, out = _ep_tp(tmp_path_factory)
    for rank in out:
        _close(rank["gpt_ep"]["loss"], loss)


def test_ep_tp_gpt_grads_match_sliced_jax_golden(tmp_path_factory):
    """Every rank's gradients: the golden's sliced along the FFN dim of its
    tensor rank (its vocab rows, column / row shards; a MoE slot's ``w1``
    columns and ``w2`` rows) and its expert rank's experts."""
    _, sliced, out = _ep_tp(tmp_path_factory)
    for rank in out:
        got = rank["gpt_ep"]
        want_all = sliced[got["tp_rank"]]
        assert set(got["grads"]) == set(want_all)
        for n, want in want_all.items():
            if is_gpt_expert_leaf(n):
                nl = want.shape[0] // 2
                er = got["expert_rank"]
                want = want[er * nl:(er + 1) * nl]
            _close_grad(got["grads"][n], want, msg=n)
