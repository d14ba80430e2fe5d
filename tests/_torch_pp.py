"""Shared parts of ``tests/test_torch_pipeline.py`` (2 ranks) and
``tests/test_torch_pipeline_4.py`` (4 ranks); pytest does not collect
this file.

The port's ``pipeline_step`` runs on ``gloo`` ranks (``tests/_torch_dist.py``
case ``mp``, one spawn a file, started before the JAX references are
computed, so both run at once); the JAX package's ``pipeline_step`` runs
under ``jax.shard_map`` over a ``pipe`` mesh axis of the first S CPU
devices with the parameters of ``pack_for_shard_map``, and its gradients
come back to the serial layout through ``unpack_from_shard_map``.  A tiny
f32 GPT (vocab 256, hidden 64, 4 heads, seq 32, the f32 vocab-parallel
head), M = 4 micro-batches of 2 rows.

Tolerances: the loss rtol 1e-5 / atol 1e-6 and each gradient within 1e-5
of its largest entry (``tests/test_torch_moe.py``'s); against the port's
own one-stage run of the same engine, bit for bit (the same operations in
the same order: per chunk the micro-batches' gradients in ascending
order, and the sums over the pipe group add zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.models.gpt import (pack_for_shard_map, pipeline_step as
                                 j_pipeline_step, unpack_from_shard_map)
from apex_tpu.models.gpt import shard_params_for_tp as jshard
from apex_tpu.utils.collectives import shard_map_compat

from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel, pipeline_step,
                                       stage_state_dict)

from _torch_dist import start
from test_torch_moe import _close, _close_grad, _names, _np_tree

PP_GPT = dict(vocab_size=256, hidden_size=64, num_attention_heads=4,
              max_seq_len=32, fused_lm_head=False)
M, MB, SEQ = 4, 2, 32


def batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, PP_GPT["vocab_size"], (M, MB, SEQ)),
            rng.randint(0, PP_GPT["vocab_size"], (M, MB, SEQ)))


def jax_pipeline(cfg_kw, params, tokens, targets, S, v, seed=None,
                 grads=True):
    """JAX's ``pipeline_step`` at S stages and v chunks: the loss and (for
    dense models) the gradients in the serial layout."""
    model = JModel(JConfig(**cfg_kw))
    packed, in_specs, local_fn, repack_fn = pack_for_shard_map(
        model, params, n_stages=S, tensor_axis=None, n_virtual=v)
    mesh = jax.make_mesh((S,), ("pipe",), devices=jax.devices()[:S])

    def step(sp, tk, tg):
        loss, g = j_pipeline_step(model, local_fn(sp), tk, tg,
                                  pipe_axis="pipe", n_virtual=v,
                                  dropout_seed=seed)
        return loss, repack_fn(g)
    loss, g = jax.jit(shard_map_compat(
        step, mesh=mesh, in_specs=(in_specs, P(), P()),
        out_specs=(P(), in_specs)))(packed, jnp.asarray(tokens),
                                    jnp.asarray(targets))
    if not grads:
        return float(loss), None
    return float(loss), dict(_names(unpack_from_shard_map(
        model, _np_tree(g), n_stages=S, n_virtual=v)))


def jax_golden(cfg_kw, params, tokens, targets):
    """The JAX serial model's mean over the micro-batches (the per-
    micro-batch golden: each micro-batch routes its own tokens)."""
    model = JModel(JConfig(**cfg_kw))

    def loss(p):
        return jnp.mean(jnp.stack([model.loss(p, jnp.asarray(tokens[m]),
                                              jnp.asarray(targets[m]))
                                   for m in range(tokens.shape[0])]))
    val, g = jax.value_and_grad(loss)(params)
    return float(val), g


def port_one_stage(cfg_kw, tree, tokens, targets, v):
    """The port's engine at one stage (no process group)."""
    cfg = GPTConfig(**cfg_kw)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(tree, cfg))
    loss = pipeline_step(model, torch.from_numpy(tokens),
                         torch.from_numpy(targets), n_virtual=v)
    return float(loss), {n: p.grad.numpy().copy()
                         for n, p in model.named_parameters()}


def spawn(tmp_path_factory, world, runs, params, tokens, targets):
    return start(tmp_path_factory.mktemp(f"pp{world}"), world, "mp", {
        "parts": {"pipeline": dict(runs=runs, params=params, tokens=tokens,
                                   targets=targets)}})


def check_against(rank_out, loss, grads, num_layers, S, v, exact=False):
    """A rank's loss and stage gradients against a whole model's
    (``grads`` in the serial layout), cut to the rank's stage."""
    assert len(set(rank_out["losses"])) == 1
    want = stage_state_dict(grads, num_layers, S, v, rank_out["stage"])
    assert set(rank_out["grads"]) == set(want)
    if exact:
        assert rank_out["losses"][0] == loss
        for n, w in want.items():
            np.testing.assert_array_equal(rank_out["grads"][n], w, err_msg=n)
        return
    _close(rank_out["losses"][0], loss)
    for n, w in want.items():
        _close_grad(rank_out["grads"][n], w, msg=n)


__all__ = ["PP_GPT", "M", "MB", "SEQ", "batch", "jax_pipeline",
           "jax_golden", "port_one_stage", "spawn", "check_against",
           "jshard", "_names", "_np_tree", "_close", "_close_grad"]
