"""Context parallelism of apex_tpu_torch against apex_tpu at two ``gloo``
ranks (``tests/_torch_dist.py`` case ``mp``, started once for the file, so
the JAX references run while the ranks do): ring and Ulysses attention,
causal and not, forward and the gradients of ``sum(out**2)`` (ring also
with ``remat=False``), against JAX's under ``jax.shard_map`` over a
``context`` mesh axis of the first two CPU devices (with the replication
check on: with it off JAX transposes the loss's ``psum`` as a ``psum``,
doubling its gradients at two devices); GPT's loss and gradients with
``context_axis`` (both mechanisms, rotary and learned positions), each
rank's partial gradients summed over the group, against the JAX serial
model on the whole sequence (what JAX's own test holds its shard_map run
to; see ``_jax_gpt``);
Ulysses refusing heads not divisible by the group.

Tolerances: the outputs rtol 1e-5 / atol 1e-6; a gradient within 1e-5 of
its largest entry (its entries are sums over positions with cancellation;
``tests/test_torch_moe.py``).  The ring's streaming softmax and its
explicit backward (the flash form, from the saved log-sum-exp) sum in
other orders than JAX's autodiff through its scan; Ulysses at two ranks
runs the flash kernels' plain versions on the whole sequence of a head
shard, as JAX runs its kernel's reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax.sharding import PartitionSpec as P

from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.transformer.context_parallel import (
    ring_attention as j_ring, ulysses_attention as j_ulysses)
from apex_tpu.utils.collectives import shard_map_compat

from _torch_dist import start
from test_torch_moe import _close, _close_grad, _names, _np_tree

N = 2
GPT_CP = dict(vocab_size=32, hidden_size=16, num_layers=2,
              num_attention_heads=4, max_seq_len=32, fused_lm_head=False)
_RUN = {}


def _mesh():
    return jax.make_mesh((N,), ("context",), devices=jax.devices()[:N])


def _jax_attention(fn, q, k, v, causal, **kw):
    spec = P(None, None, "context", None)

    def loss(q, k, v):
        out = fn(q, k, v, "context", causal=causal, **kw)
        return jax.lax.psum(jnp.sum(out.astype(jnp.float32) ** 2),
                            "context"), out

    def body(q, k, v):
        (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
        return out, g
    out, g = jax.jit(shard_map_compat(
        body, mesh=_mesh(), in_specs=(spec,) * 3,
        out_specs=(spec, (spec,) * 3), check_vma=True))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in g]


def _jax_gpt(params, tokens, targets, rotary):
    """JAX's serial model on the whole sequence: what JAX's own
    context-parallel test holds its shard_map run to.  (Its shard_map run
    itself needs the replication check off for the Pallas LayerNorm's
    custom VJP, and with the check off JAX transposes the loss's ``pmean``
    as a ``pmean``, which leaves the replicated leaves' summed gradients
    off the serial ones: the embedding's by 77% of its largest entry.)"""
    serial = JModel(JConfig(**GPT_CP, rotary=rotary))
    loss, grads = jax.value_and_grad(serial.loss)(params, tokens, targets)
    return float(loss), dict(_names(grads))


def _cp(tmp_path_factory):
    if "out" in _RUN:
        return _RUN["out"]
    rng = np.random.RandomState(0)
    qkv = {k: (0.3 * rng.randn(1, 4, 32, 16)).astype(np.float32)
           for k in "qkv"}
    params = {rot: JModel(JConfig(**GPT_CP, rotary=rot)).init_params(
        jax.random.PRNGKey(int(rot))) for rot in (True, False)}
    tokens = rng.randint(0, 32, (2, 32))
    targets = rng.randint(0, 32, (2, 32))
    spawn = start(tmp_path_factory.mktemp("cp2"), N, "mp", {"parts": {
        "attention": qkv,
        "gpt_cp": dict(tokens=tokens, targets=targets,
                       params={r: _np_tree(p) for r, p in params.items()},
                       cfgs=[dict(GPT_CP, rotary=r) for r in (True, False)])}})
    q, k, v = (jnp.asarray(qkv[c]) for c in "qkv")
    ref = {}
    for causal in (False, True):
        ref[("ring", causal)] = _jax_attention(j_ring, q, k, v, causal)
        ref[("ulysses", causal)] = _jax_attention(j_ulysses, q, k, v, causal)
    for rot in (True, False):
        ref[("gpt", rot)] = _jax_gpt(params[rot], tokens, targets, rot)
    _RUN["out"] = (ref, spawn.result())
    return _RUN["out"]


@pytest.mark.parametrize("mech,causal,remat", [
    ("ring", False, True), ("ring", True, True), ("ring", False, False),
    ("ring", True, False), ("ulysses", False, True), ("ulysses", True, True)])
def test_attention_forward_and_grads_match_jax(tmp_path_factory, mech,
                                               causal, remat):
    ref, out = _cp(tmp_path_factory)
    want_out, want_g = ref[(mech, causal)]
    sl = want_out.shape[2] // N
    for r, rank in enumerate(out):
        got_out, got_g = rank["attention"][(mech, causal, remat)]
        _close(got_out, want_out[:, :, r * sl:(r + 1) * sl])
        for name, g, w in zip("qkv", got_g, want_g):
            _close_grad(g, w[:, :, r * sl:(r + 1) * sl], msg=name)


@pytest.mark.parametrize("mech", ["ring", "ulysses"])
@pytest.mark.parametrize("rotary", [True, False], ids=["rope", "learned"])
def test_gpt_context_loss_and_grads_match_jax(tmp_path_factory, mech,
                                              rotary):
    """The loss (the mean over the context group) and every parameter's
    gradient summed over the group: RoPE rows and learned positions at the
    shard's global offset."""
    ref, out = _cp(tmp_path_factory)
    loss, grads = ref[("gpt", rotary)]
    for rank in out:
        got_loss, got = rank["gpt_cp"][(mech, rotary)]
        _close(got_loss, loss)
        assert set(got) == set(grads)
        for n, want in grads.items():
            _close_grad(got[n], want, msg=n)


def test_ulysses_refuses_heads_not_divisible_by_the_group(tmp_path_factory):
    _, out = _cp(tmp_path_factory)
    for rank in out:
        assert "divisible by the context axis size (2)" in \
            rank["attention"]["heads"]


def test_decode_refuses_context_parallelism():
    import torch
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    model = GPTModel(GPTConfig(**GPT_CP, context_axis="context"),
                     device="cpu")
    with pytest.raises(ValueError, match="context"):
        model.prefill(torch.zeros((1, 4), dtype=torch.long))
