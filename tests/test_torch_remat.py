"""Activation recompute (``remat=True``) of apex_tpu_torch's GPT and BERT
against apex_tpu on the CPU.

Tiny models (GPT: vocab 256, hidden 64, 2 layers, 4 heads, seq 64; BERT:
vocab 512, hidden 64, 2 layers, 4 heads, seq 32; both with the f32-logits
head) are initialised by the JAX package and carried into the port.  Under
each ``remat_policy`` ("full", "dots"), with and without GPT's attention
dropout and with and without BERT's token types, ``seqlens`` and NSP
labels, the loss and every gradient are held against the JAX model with
``remat=True`` and the same policy (``jax.value_and_grad``), at the
bounds of ``test_torch_gpt_training.py`` / ``test_torch_bert.py`` in f32:
the loss 1e-5 relative, every gradient within 1e-5 of its largest entry.
Against the port without remat they agree within 1e-6 (the JAX
``test_gpt.py`` ``TestSelectiveRemat`` bound), and the recompute draws the
forward's dropout masks.

What each policy recomputes is counted with a dispatch mode over
``backward()``: the 2-D products (``aten.mm`` / ``aten.addmm``) beyond
those of the run without remat.  "dots" saves every one of them (0 more,
the counterpart of JAX's ``test_dots_policy_saves_more``).  "full"
recomputes each layer up to its last saved tensor: BERT's post-LN layer
ends in a LayerNorm, so all four products (qkv, proj, fc1, fc2) run again;
GPT's pre-LN layer's last saved tensors are fc2's inputs, which autograd
saves before the product runs, so the early stop of non-reentrant
checkpointing ends the recompute there: three products a layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu.models.bert import BertConfig as JBertConfig
from apex_tpu.models.bert import BertModel as JBertModel
from apex_tpu.models.gpt import GPTConfig as JGPTConfig
from apex_tpu.models.gpt import GPTModel as JGPTModel

from apex_tpu_torch.convert import bert_params_from_jax, gpt_params_from_jax
from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.ops import flash_attention as tflash
from apex_tpu_torch.transformer.pipeline_parallel import (
    forward_backward_no_pipelining)

GPT_TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
                num_attention_heads=4, max_seq_len=64, fused_lm_head=False)
BERT_TINY = dict(vocab_size=512, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_seq_len=32, fused_lm_head=False)
B = 2
SEED = 17
POLICIES = ("full", "dots")


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _names(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _gpt_batch(seed=1):
    rng = np.random.RandomState(seed)
    shape = (B, GPT_TINY["max_seq_len"])
    return (rng.randint(0, GPT_TINY["vocab_size"], shape),
            rng.randint(0, GPT_TINY["vocab_size"], shape))


def _bert_inputs(seed=1):
    rng = np.random.RandomState(seed)
    s, v = BERT_TINY["max_seq_len"], BERT_TINY["vocab_size"]
    tokens = rng.randint(0, v, (B, s))
    labels = np.where(rng.rand(B, s) < 0.15, rng.randint(0, v, (B, s)), -1)
    labels[0, 3] = 7
    return dict(tokens=tokens, labels=labels,
                token_type_ids=rng.randint(0, 2, (B, s)),
                seqlens=np.array([s, 20], np.int32),
                nsp_labels=rng.randint(0, 2, (B,)))


_BERT_EXTRAS = {"mlm": (), "all": ("token_type_ids", "seqlens",
                                   "nsp_labels")}


def _gpt(policy, dropout, jparams=None):
    """(port model, JAX params as numpy) with ``remat_policy`` (None: no
    remat)."""
    remat = dict(remat=policy is not None, remat_policy=policy or "full")
    rate = 0.1 if dropout else 0.0
    if jparams is None:
        jm = JGPTModel(JGPTConfig(**GPT_TINY))
        jparams = jax.tree_util.tree_map(
            np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    cfg = GPTConfig(**GPT_TINY, attention_dropout=rate, **remat)
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(jparams, cfg))
    return model, jparams


def _port_loss_and_grads(model, call):
    loss = call(model)
    loss.backward()
    return loss.item(), {n: p.grad.detach().numpy().copy()
                         for n, p in model.named_parameters()
                         if p.grad is not None}


def _gpt_loss(model, dropout):
    tokens, targets = (torch.from_numpy(a) for a in _gpt_batch())
    return model.loss(tokens, targets, SEED if dropout else None)


def _bert(policy, jparams=None):
    remat = dict(remat=policy is not None, remat_policy=policy or "full")
    if jparams is None:
        jm = JBertModel(JBertConfig(**BERT_TINY))
        jparams = jax.tree_util.tree_map(
            np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    cfg = BertConfig(**BERT_TINY, **remat)
    model = BertModel(cfg, device="cpu")
    model.load_state_dict(bert_params_from_jax(jparams, cfg))
    return model, jparams


def _bert_loss(model, extras):
    inp = _bert_inputs()
    kw = {k: torch.from_numpy(inp[k]) for k in _BERT_EXTRAS[extras]}
    return model.loss(torch.from_numpy(inp["tokens"]),
                      torch.from_numpy(inp["labels"]), **kw)


def _assert_matches(got, want, loss_tol, grad_tol):
    (tl, tg), (jl, jg) = got, want
    assert abs(tl - jl) <= loss_tol * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for name, ref in jg.items():
        err = np.abs(tg[name] - ref).max()
        assert err <= grad_tol * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("policy", POLICIES)
def test_gpt_remat_loss_and_every_grad_match_jax(policy, dropout):
    model, jparams = _gpt(policy, dropout)
    got = _port_loss_and_grads(model, lambda m: _gpt_loss(m, dropout))
    jm = JGPTModel(JGPTConfig(**GPT_TINY, remat=True, remat_policy=policy,
                              attention_dropout=0.1 if dropout else 0.0))
    tokens, targets = (jnp.asarray(a) for a in _gpt_batch())
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, tokens, targets,
                          dropout_seed=SEED if dropout else None))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    want = (float(jloss), {n: np.asarray(g, np.float32)
                           for n, g in _names(jgrads)})
    _assert_matches(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("policy", POLICIES)
def test_gpt_remat_equals_no_remat(policy, dropout):
    model, jparams = _gpt(policy, dropout)
    got = _port_loss_and_grads(model, lambda m: _gpt_loss(m, dropout))
    plain, _ = _gpt(None, dropout, jparams)
    want = _port_loss_and_grads(plain, lambda m: _gpt_loss(m, dropout))
    _assert_matches(got, want, 1e-6, 1e-6)


@pytest.mark.parametrize("extras", ["mlm", "all"])
@pytest.mark.parametrize("policy", POLICIES)
def test_bert_remat_loss_and_every_grad_match_jax(policy, extras):
    model, jparams = _bert(policy)
    got = _port_loss_and_grads(model, lambda m: _bert_loss(m, extras))
    jm = JBertModel(JBertConfig(**BERT_TINY, remat=True,
                                remat_policy=policy))
    inp = _bert_inputs()
    kw = {k: jnp.asarray(inp[k]) for k in _BERT_EXTRAS[extras]}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(inp["tokens"]),
                          jnp.asarray(inp["labels"]), **kw))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    # the NSP head without NSP labels: JAX's zero gradient, no .grad
    want = (float(jloss), {n: np.asarray(g, np.float32)
                           for n, g in _names(jgrads) if n in got[1]})
    _assert_matches(got, want, 1e-5, 1e-5)
    assert ("nsp_head.weight" in got[1]) == (extras == "all")


@pytest.mark.parametrize("extras", ["mlm", "all"])
@pytest.mark.parametrize("policy", POLICIES)
def test_bert_remat_equals_no_remat(policy, extras):
    model, jparams = _bert(policy)
    got = _port_loss_and_grads(model, lambda m: _bert_loss(m, extras))
    plain, _ = _bert(None, jparams)
    want = _port_loss_and_grads(plain, lambda m: _bert_loss(m, extras))
    _assert_matches(got, want, 1e-6, 1e-6)


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in ("mm", "addmm"):
            self.n += 1
        return func(*args, **(kwargs or {}))


MICRO = 2


def _products_in_backward(kind, policy):
    """2-D products run by ``backward()`` over ``MICRO`` micro-batches of
    the schedule (the head's included)."""
    if kind == "gpt":
        model, _ = _gpt(policy, True)
        tokens, targets = (torch.from_numpy(np.stack([a] * MICRO))
                           for a in _gpt_batch())
        step = (lambda m, x: m.backbone(m.embed(x), SEED),
                lambda x, t: model.head_loss(x, t).mean())
    else:
        model, _ = _bert(policy)
        inp = _bert_inputs()
        tokens, targets = (torch.from_numpy(np.stack([inp[k]] * MICRO))
                           for k in ("tokens", "labels"))
        step = (lambda m, x: x, lambda x, t: model.loss(x, t))
    counted = _CountProducts()
    real = torch.Tensor.backward

    def backward(self, *args, **kwargs):
        with counted:
            return real(self, *args, **kwargs)
    try:
        torch.Tensor.backward = backward
        forward_backward_no_pipelining(*step, model, tokens, targets)
    finally:
        torch.Tensor.backward = real
    return counted.n


@pytest.mark.parametrize("kind,recomputed_per_layer", [("gpt", 3),
                                                        ("bert", 4)])
def test_full_recomputes_the_products_and_dots_saves_them(
        kind, recomputed_per_layer):
    layers = (GPT_TINY if kind == "gpt" else BERT_TINY)["num_layers"]
    base = _products_in_backward(kind, None)
    assert base > 0
    assert (_products_in_backward(kind, "full") - base
            == recomputed_per_layer * layers * MICRO)
    assert _products_in_backward(kind, "dots") == base


@pytest.mark.parametrize("policy", POLICIES)
def test_the_recompute_draws_the_forwards_dropout_masks(policy,
                                                        monkeypatch):
    """Every dropout mask drawn during forward, recompute and backward of
    a layer's stream is the same tensor, and the recompute draws one per
    layer more than the run without remat."""
    drawn = {}
    real = tflash._dropout_mask

    def recording(rate, seed, *args):
        mask = real(rate, seed, *args)
        if mask is not None:
            drawn.setdefault(seed, []).append(mask.clone())
        return mask
    monkeypatch.setattr(tflash, "_dropout_mask", recording)
    counts = {}
    for run in (None, policy):
        drawn.clear()
        model, _ = _gpt(run, True)
        _gpt_loss(model, True).backward()
        counts[run] = {s: len(m) for s, m in drawn.items()}
        for masks in drawn.values():
            assert all(torch.equal(m, masks[0]) for m in masks)
    assert len(counts[policy]) == GPT_TINY["num_layers"]
    assert counts[policy] == {s: n + 1 for s, n in counts[None].items()}


@pytest.mark.parametrize("make", [
    lambda **kw: GPTConfig(**GPT_TINY, **kw),
    lambda **kw: BertConfig(**BERT_TINY, **kw),
    lambda **kw: JGPTConfig(**GPT_TINY, **kw),
    lambda **kw: JBertConfig(**BERT_TINY, **kw)],
    ids=["gpt", "bert", "jax_gpt", "jax_bert"])
def test_an_unknown_policy_is_refused_as_jax_refuses_it(make):
    with pytest.raises(ValueError, match="remat_policy"):
        make(remat=True, remat_policy="everything")
    assert make(remat=True, remat_policy="dots").remat


def test_dots_without_selective_checkpointing_raises_naming_it(monkeypatch):
    """A PyTorch without selective checkpointing refuses "dots" by name,
    never quietly recomputing everything."""
    monkeypatch.delattr(torch.utils.checkpoint,
                        "create_selective_checkpoint_contexts")
    model, _ = _gpt("dots", False)
    with pytest.raises(RuntimeError,
                       match="create_selective_checkpoint_contexts"):
        _gpt_loss(model, False)


def test_remat_leaves_no_grad_forwards_alone():
    """Serving's entry points do not recompute: without autograd the
    layers run as they are, and prefill's logits equal no-remat's."""
    model, jparams = _gpt("dots", False)
    plain, _ = _gpt(None, False, jparams)
    tokens = torch.from_numpy(_gpt_batch()[0])
    with torch.no_grad():
        assert torch.equal(model(tokens), plain(tokens))
    assert torch.equal(model.prefill(tokens)[0], plain.prefill(tokens)[0])
