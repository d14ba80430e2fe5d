"""The mixture-of-experts FFN of apex_tpu_torch against apex_tpu on the
CPU: ``MoEMLP`` (Switch top-1 and GShard top-2) serially, the GPT model
with MoE FFN slots in training (loss, gradients, one FusedAdam step) and
in serving (prefill, decode, the engines' greedy tokens), and expert
parallelism over two ``gloo`` ranks (``tests/_torch_dist.py`` case ``mp``,
started once for the file, so the JAX references run while the ranks do;
four ranks, EP x TP: ``tests/test_torch_moe_4.py``).

Inputs come from numpy seeds, parameters from the JAX init (carried over
by ``convert.gpt_params_from_jax``).  Tolerances: f32 rtol 1e-5 / atol
1e-6 (the same routing; sums in other orders), and one FusedAdam step as
``tests/_torch_tp.py`` holds it (Adam turns a rounding-level difference
of a gradient at noise level into a visible move: the parameters agree to
rtol 1e-5 / atol 1e-6 where the gradient is at least 1e-4 of its
tensor's largest entry, and all within 2.2 lr).  A gradient is held
within 1e-5 of its largest entry (``tests/test_torch_gpt_training.py``'s
bound): its entries are sums over tokens with cancellation, whose relative
error in another summation order is unbounded where they nearly cancel
(the gate's reached 4.6e-5 relative, 3.8e-6 absolute, on an entry of
0.08).  The expert-parallel runs are held against the JAX serial model on
each rank's rows (the per-shard golden that JAX's own expert-parallel tests
hold its shard_map runs to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import (InferenceEngine as JEngine,
                                Request as JRequest)
from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.transformer.expert_parallel import (MoEConfig as JMoEConfig,
                                                  MoEMLP as JMoEMLP)

from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.inference import InferenceEngine, Request
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving import PagedInferenceEngine
from apex_tpu_torch.transformer.expert_parallel import (
    MoEConfig, MoEMLP, is_gpt_expert_leaf, localize_expert_params,
    top_k_by_index)

from _torch_dist import start

RTOL, ATOL = 1e-5, 1e-6
H, F, E = 16, 32, 8
GPT = dict(vocab_size=256, hidden_size=64, num_layers=2,
           num_attention_heads=4, max_seq_len=32, n_experts=4,
           fused_lm_head=False)
LR = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _names(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def _close_grad(got, want, msg=""):
    """A gradient within 1e-5 of its largest entry (a gradient entry is a
    sum over tokens with cancellation: in another order its relative
    error is unbounded where it nearly cancels;
    ``tests/test_torch_gpt_training.py``'s bound)."""
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= 1e-5 * np.abs(want).max(), (msg, err, np.abs(want).max())


def _mlp_pair(seed, **kw):
    """The JAX MoEMLP, its params, and the port's with the same ones."""
    kw = dict(dict(hidden_size=H, ffn_hidden_size=F, n_experts=E), **kw)
    jm = JMoEMLP(JMoEConfig(**kw))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = MoEMLP(MoEConfig(**kw), device="cpu")
    with torch.no_grad():
        for k in ("gate", "w1", "w2"):
            getattr(tm, k).copy_(torch.tensor(np.asarray(jp[k])))
    return jm, jp, tm


def _x(seed, n=64):
    return np.random.RandomState(seed).randn(n, H).astype(np.float32)


# -- MoEMLP ------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_output_and_aux_match_jax(top_k):
    jm, jp, tm = _mlp_pair(top_k, top_k=top_k)
    x = _x(top_k)
    jout, jaux = jax.jit(jm)(jp, jnp.asarray(x))
    tout, taux = tm(torch.from_numpy(x))
    assert tout.shape == x.shape and tout.dtype == torch.float32
    assert float(taux.detach()) > 0.0
    _close(tout.detach().numpy(), np.asarray(jout))
    _close(float(taux.detach()), float(jaux))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_gradients_match_jax(top_k):
    """The gradients of ``sum(out**2) + 0.01 * aux`` in the gate, both
    expert stacks and the input (the gate's through the combine weights,
    the top-k values and the aux)."""
    jm, jp, tm = _mlp_pair(10 + top_k, top_k=top_k)
    x = _x(10 + top_k)

    def loss(p, xx):
        out, aux = jm(p, xx)
        return jnp.sum(out ** 2) + 0.01 * aux
    jg, jdx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.tensor(x).requires_grad_()
    out, aux = tm(xt)
    (torch.sum(out ** 2) + 0.01 * aux).backward()
    for k in ("gate", "w1", "w2"):
        _close_grad(getattr(tm, k).grad.numpy(), np.asarray(jg[k]), msg=k)
    _close_grad(xt.grad.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_drops_the_tokens_jax_drops(top_k):
    """Capacity 1 an expert: at most 8 tokens survive, the same ones as in
    JAX (first choices claim slots in token order)."""
    jm, jp, tm = _mlp_pair(20 + top_k, top_k=top_k,
                           capacity_factor=8.0 / (top_k * 64.0))
    x = _x(20 + top_k)
    jout = np.asarray(jm(jp, jnp.asarray(x))[0])
    tout = tm(torch.from_numpy(x))[0].detach().numpy()
    kept = set(np.where(np.any(tout != 0.0, axis=-1))[0])
    assert kept == set(np.where(np.any(jout != 0.0, axis=-1))[0])
    assert 0 < len(kept) <= 8
    _close(tout, jout)


def test_second_choices_claim_slots_after_first_choices():
    """GShard at capacity 1: an expert serves the first token whose FIRST
    choice it is, and a second choice only where no first choice claimed
    it (JAX's test's slot reference)."""
    jm, jp, tm = _mlp_pair(7, top_k=2, capacity_factor=8.0 / (2 * 64.0))
    x = _x(7)
    out = tm(torch.from_numpy(x))[0].detach().numpy()
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ np.asarray(
        jp["gate"])), -1))
    order = np.argsort(-probs, axis=-1, kind="stable")
    served = {}
    for c in (0, 1):
        for t in range(64):
            served.setdefault(order[t, c], t)
    assert set(np.where(np.any(out != 0.0, axis=-1))[0]) \
        == set(served.values())
    _close(out, np.asarray(jm(jp, jnp.asarray(x))[0]))


@pytest.mark.parametrize("top_k", [1, 2])
def test_an_all_ties_gate_routes_to_the_lowest_experts(top_k):
    """A gate of zeros gives every expert 1/E: ties go to the lower index
    as ``jax.lax.top_k`` sends them (``torch.topk`` promises no order), so
    every token reaches expert 0 (and 1), uncapped here."""
    jm, jp, tm = _mlp_pair(30, top_k=top_k, capacity_factor=float(E))
    jp = dict(jp, gate=jnp.zeros_like(jp["gate"]))
    with torch.no_grad():
        tm.gate.zero_()
    x = _x(31, n=16)
    tout = tm(torch.from_numpy(x))[0].detach().numpy()
    _close(tout, np.asarray(jm(jp, jnp.asarray(x))[0]))
    w1, w2 = np.asarray(jp["w1"]), np.asarray(jp["w2"])
    ffn = [np.maximum(x @ w1[e], 0.0) @ w2[e] for e in range(top_k)]
    want = ffn[0] / E if top_k == 1 else 0.5 * (ffn[0] + ffn[1])
    _close(tout, want, rtol=2e-5, atol=2e-6)
    vals, idx = top_k_by_index(torch.full((3, E), 1.0 / E), top_k)
    assert idx.tolist() == [list(range(top_k))] * 3


@pytest.mark.parametrize("top_k", [1, 2])
def test_drop_counts_cover_the_marked_rows_only(top_k):
    """``count_drops`` at capacity 1 an expert: ``dropped`` / ``routed``
    count the token-choices of every row (``count_rows`` None) or of the
    marked rows only, ``chosen`` their first choices per expert; the kept
    first choices are the rows whose output is not zero (top-1), and the
    counts add up over calls."""
    _, _, tm = _mlp_pair(40 + top_k, top_k=top_k,
                         capacity_factor=8.0 / (top_k * 64.0))
    x = torch.from_numpy(_x(40 + top_k))
    first = torch.argmax(x @ tm.gate.detach(), dim=-1)
    marked = torch.arange(64) % 3 == 0
    tm.count_drops = True
    with torch.no_grad():
        out = tm(x)[0]
        counts = [(int(tm.dropped), int(tm.routed), tm.chosen.tolist())]
        tm.dropped = tm.routed = tm.chosen = None
        tm.count_rows = marked
        tm(x)
        counts.append((int(tm.dropped), int(tm.routed), tm.chosen.tolist()))
        tm(x)
    kept = torch.any(out != 0.0, dim=-1)
    for rows, (dropped, routed, chosen) in zip((torch.ones(64, dtype=bool),
                                                marked), counts):
        assert routed == top_k * int(rows.sum())
        assert chosen == torch.bincount(first[rows], minlength=E).tolist()
        assert 0 < dropped < routed
        if top_k == 1:
            assert dropped == int((rows & ~kept).sum())
    assert (int(tm.dropped), int(tm.routed)) == (2 * counts[1][0],
                                                 2 * counts[1][1])


def test_reset_parameters_keeps_each_ranks_shard():
    """Every expert-parallel rank's experts and tensor-parallel rank's FFN
    columns are the one-rank module's from the same seed (the whole stacks
    are drawn on every rank), at the JAX init's scales."""
    serial = MoEMLP(MoEConfig(hidden_size=H, ffn_hidden_size=F,
                              n_experts=E), device="cpu")
    serial.reset_parameters(torch.Generator().manual_seed(0))
    for name, std in (("gate", 0.02), ("w1", H ** -0.5), ("w2", F ** -0.5)):
        got = float(getattr(serial, name).detach().std())
        assert abs(got / std - 1) < 0.1, (name, got, std)
    for ep, tp in ((2, 1), (4, 2), (8, 4)):
        nl, fl = E // ep, F // tp
        for er in range(ep):
            for tr in range(tp):
                shard = MoEMLP(MoEConfig(
                    hidden_size=H, ffn_hidden_size=F, n_experts=E,
                    expert_parallel_size=ep, axis_name="expert",
                    tensor_parallel_size=tp, tensor_axis="model"),
                    device="cpu")
                shard.reset_parameters(torch.Generator().manual_seed(0),
                                       er, tr)
                experts = slice(er * nl, (er + 1) * nl)
                cols = slice(tr * fl, (tr + 1) * fl)
                assert torch.equal(shard.gate, serial.gate)
                assert torch.equal(shard.w1, serial.w1[experts, :, cols])
                assert torch.equal(shard.w2, serial.w2[experts, cols])


@pytest.mark.parametrize("kw", [
    dict(n_experts=6, expert_parallel_size=4, axis_name="expert"),
    dict(top_k=0), dict(top_k=9),
    dict(expert_parallel_size=2),
    dict(ffn_hidden_size=30, tensor_parallel_size=4, tensor_axis="model"),
    dict(tensor_parallel_size=2)],
    ids=["ep-divides", "top_k-0", "top_k-9", "ep-axis", "tp-divides",
         "tp-axis"])
def test_moe_config_refusals_match_jax(kw):
    kw = dict(dict(hidden_size=H, ffn_hidden_size=F, n_experts=E), **kw)
    with pytest.raises(ValueError) as want:
        JMoEConfig(**kw)
    with pytest.raises(ValueError) as got:
        MoEConfig(**kw)
    assert str(got.value) == str(want.value)


def test_expert_leaves_and_localize():
    names = ["layers.0.mlp.w1", "layers.3.mlp.w2", "layers.0.mlp.gate",
             "layers.0.mlp.fc1.weight", "embedding.weight"]
    assert [is_gpt_expert_leaf(n) for n in names] == [True, True, False,
                                                      False, False]
    sd = {"layers.0.mlp.w1": torch.arange(8.0).reshape(4, 2),
          "layers.0.mlp.gate": torch.ones(2)}
    got = localize_expert_params(sd, 1, 2)
    assert got["layers.0.mlp.w1"].tolist() == [[4.0, 5.0], [6.0, 7.0]]
    assert got["layers.0.mlp.gate"] is sd["layers.0.mlp.gate"]


# -- GPT with MoE FFNs ---------------------------------------------------------

def _gpt(top_k, seed=0):
    jcfg = JConfig(**GPT, moe_top_k=top_k)
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    cfg = GPTConfig(**GPT, moe_top_k=top_k)
    tm = GPTModel(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(_np_tree(jp), cfg))
    return jm, jp, tm


def _batch(seed, shape=(2, 32)):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, GPT["vocab_size"], shape),
            rng.randint(0, GPT["vocab_size"], shape))


@pytest.mark.parametrize("top_k", [1, 2])
def test_gpt_moe_loss_grads_and_fused_adam_step_match_jax(top_k):
    """The loss (with the aux term ``moe_aux_weight * aux / num_layers``),
    every gradient, and the parameters after one FusedAdam step."""
    jm, jp, tm = _gpt(top_k, seed=top_k)
    tokens, targets = _batch(top_k)
    jl, jg = jax.value_and_grad(jm.loss)(jp, jnp.asarray(tokens),
                                         jnp.asarray(targets))
    opt = JFusedAdam(lr=LR, bucketed=False)
    jnew, _ = opt.step(jg, jp, opt.init(jp))
    tl = tm.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
    tl.backward()
    _close(float(tl), float(jl))
    jgrads = dict(_names(jg))
    grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    assert set(grads) == set(jgrads)
    for n, want in jgrads.items():
        _close_grad(grads[n], want, msg=n)
    aux0 = GPTModel(GPTConfig(**GPT, moe_top_k=top_k, moe_aux_weight=0.0),
                    device="cpu")
    aux0.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert float(aux0.loss(torch.from_numpy(tokens),
                               torch.from_numpy(targets))) < float(tl)
    FusedAdam(tm.parameters(), lr=LR).step()
    for n, want in _names(jnew):
        got = dict(tm.named_parameters())[n].detach().numpy()
        g = np.abs(jgrads[n])
        big = g >= 1e-4 * g.max()
        _close(got[big], want[big], msg=n)
        assert np.abs(got - want).max() <= 2.2 * LR, n


@pytest.mark.parametrize("top_k", [1, 2])
def test_gpt_moe_prefill_and_decode_match_jax(top_k):
    """Prefill logits and K/V, then 4 decode steps over a 3-slot ring at
    ragged positions (a decode step routes 3 tokens: capacity 1 drops)."""
    jm, jp, tm = _gpt(top_k, seed=5)
    cfg = tm.cfg
    b, n = 3, 6
    toks = np.random.RandomState(6).randint(0, GPT["vocab_size"], (b, n + 4))
    jl, kv = jm.prefill(jp, jnp.asarray(toks[:, :n]))
    tl, tkv = tm.prefill(torch.from_numpy(toks[:, :n]))
    _close(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    _close(tkv.numpy(), np.asarray(kv), rtol=1e-4, atol=1e-4)
    shape = (b, cfg.num_layers, 2, cfg.max_seq_len, cfg.local_heads,
             cfg.head_dim)
    jcache = jnp.zeros(shape, jnp.float32).at[:, :, :, :n].set(
        kv.transpose(2, 0, 1, 3, 4, 5))
    tcache = torch.from_numpy(np.asarray(jcache).copy())
    start_pos = np.array([n, n - 2, n - 5], np.int32)
    for i in range(4):
        pos = start_pos + i
        jl, jcache = jm.decode_step(jp, jnp.asarray(toks[:, n + i]), jcache,
                                    jnp.asarray(pos))
        tl, tcache = tm.decode_step(torch.from_numpy(toks[:, n + i]),
                                    tcache, torch.from_numpy(pos))
        _close(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_gpt_moe_engines_emit_jax_greedy_tokens():
    """Three requests over 2 slots through ``InferenceEngine`` and the
    paged engine: the JAX engine's greedy tokens, token for token (a
    decode step routes the ring's 2 slots, inactive ones included, as in
    JAX)."""
    jm, jp, tm = _gpt(1, seed=7)
    rng = np.random.RandomState(8)
    specs = [(5, 6), (13, 4), (3, 9)]
    prompts = [rng.randint(0, GPT["vocab_size"], n).tolist()
               for n, _ in specs]
    je = JEngine(jm, jp, max_slots=2)
    engines = [InferenceEngine(tm, max_slots=2, device="cpu"),
               PagedInferenceEngine(tm, max_slots=2, device="cpu")]
    for i, (p, (_, new)) in enumerate(zip(prompts, specs)):
        je.submit(JRequest(request_id=i, prompt=p, max_new_tokens=new))
        for e in engines:
            e.submit(Request(request_id=i, prompt=p, max_new_tokens=new))
    want = {r.request_id: r.tokens for r in je.run()}
    for e in engines:
        assert {r.request_id: r.tokens for r in e.run()} == want, type(e)


def test_gpt_moe_refuses_int8_weights_and_sp():
    from apex_tpu_torch.models.gpt import quantize_decode_params
    with pytest.raises(ValueError, match="3D weight layout"):
        GPTConfig(**GPT, weight_quant="int8")
    _, _, tm = _gpt(1)
    with pytest.raises(ValueError, match="mlp.gate"):
        quantize_decode_params(tm.state_dict())


# -- expert parallelism on two ranks ---------------------------------------------

_RUN = {}


def _ep2(tmp_path_factory):
    """The ranks (started first) and the JAX per-shard references."""
    if "out" in _RUN:
        return _RUN["out"]
    ep = 2
    mlp = {}
    for top_k in (1, 2):
        jm, jp, _ = _mlp_pair(40 + top_k, top_k=top_k)
        x = np.random.RandomState(40 + top_k).randn(ep, 16, H).astype(
            np.float32)
        mlp[top_k] = (jm, jp, x)
    jcfg = dict(GPT, n_experts=4, num_layers=1)
    jmodel = JModel(JConfig(**jcfg))
    jparams = jmodel.init_params(jax.random.PRNGKey(42))
    tokens, targets = _batch(43, (ep * 2, 32))
    inp = {"parts": {
        "moe_mlp_ep": dict(h=H, f=F, e=E, top_k=1, gate=np.asarray(
            mlp[1][1]["gate"]), w1=np.asarray(mlp[1][1]["w1"]),
            w2=np.asarray(mlp[1][1]["w2"]), x=mlp[1][2]),
        "gpt_ep": dict(cfg=jcfg, tp=1, params=_np_tree(jparams),
                       tokens=tokens, targets=targets)}}
    spawn = start(tmp_path_factory.mktemp("ep2"), ep, "mp", inp)
    ref = {}
    jm, jp, x = mlp[1]

    def mlp_loss(p, xs):
        tot = 0.0
        outs, auxes = [], []
        for s in range(ep):
            out, aux = jm(p, xs[s])
            outs.append(out)
            auxes.append(aux)
            tot = tot + jnp.sum(out ** 2) + 0.01 * aux / ep
        return tot, (outs, auxes)
    (_, (outs, auxes)), (g, dx) = jax.value_and_grad(
        mlp_loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    ref["mlp"] = dict(out=[np.asarray(o) for o in outs],
                      aux=[float(a) for a in auxes],
                      grads={k: np.asarray(v) for k, v in g.items()},
                      dx=np.asarray(dx))

    def golden(p):
        return jnp.mean(jnp.stack([jmodel.loss(
            p, jnp.asarray(tokens[s * 2:(s + 1) * 2]),
            jnp.asarray(targets[s * 2:(s + 1) * 2])) for s in range(ep)]))
    gl, gg = jax.value_and_grad(golden)(jparams)
    ref["gpt"] = (float(gl), dict(_names(gg)))
    _RUN["out"] = (ref, spawn.result())
    return _RUN["out"]


def test_ep2_moe_mlp_matches_jax_per_shard(tmp_path_factory):
    """``MoEMLP`` with 4 experts a rank: each rank's output and aux are
    the serial MoE's on its tokens; the gate's gradient (summed over the
    ranks) and each rank's expert gradients (the all_to_all backward
    routes them home) are the serial sum's."""
    ref, out = _ep2(tmp_path_factory)
    nl = E // 2
    for r, rank in enumerate(out):
        got = rank["moe_mlp_ep"]
        _close(got["out"], ref["mlp"]["out"][r])
        _close(got["aux"], ref["mlp"]["aux"][r])
        _close_grad(got["dgate"], ref["mlp"]["grads"]["gate"])
        for k in ("w1", "w2"):
            _close_grad(got["d" + k],
                        ref["mlp"]["grads"][k][r * nl:(r + 1) * nl])
        _close_grad(got["dx"], ref["mlp"]["dx"][r])


def test_ep2_gpt_with_reduce_moe_grads_matches_jax_golden(tmp_path_factory):
    """GPT MoE with its experts over two ranks, each on its rows, through
    ``reduce_moe_grads``: the mean loss and every gradient equal the JAX
    per-shard golden's (dense ones whole, expert stacks each rank's
    experts' rows)."""
    ref, out = _ep2(tmp_path_factory)
    loss, grads = ref["gpt"]
    for rank in out:
        got = rank["gpt_ep"]
        _close(got["loss"], loss)
        er = got["expert_rank"]
        assert set(got["grads"]) == set(grads)
        for n, want in grads.items():
            if is_gpt_expert_leaf(n):
                nl = want.shape[0] // 2
                want = want[er * nl:(er + 1) * nl]
            _close_grad(got["grads"][n], want, msg=n)


def test_switch_example_trains_on_the_cpu():
    """The ported example's ``main()`` (one process: every expert here) at
    a tiny size, top-1 and top-2: finite losses, the aux loss logged (one
    per step, > 0: the sum over the layers of the Switch statistic), and
    every step's gradients reached the experts."""
    from apex_tpu_torch.examples.moe import train_switch_gpt as ex
    for top_k in (1, 2):
        res = ex.main(["--device", "cpu", "--hidden", "32", "--layers", "2",
                       "--heads", "4", "--vocab", "128", "--seq-len", "16",
                       "--batch-per-device", "2", "--accum", "2",
                       "--steps", "2", "--n-experts", "4", "--top-k",
                       str(top_k), "--print-freq", "1"])
        assert res["devices"] == 1 and len(res["losses"]) == 2
        assert np.all(np.isfinite(res["losses"] + [res["warmup_loss"]]))
        assert all(a > 0 for a in res["aux_losses"])
        w1 = dict(res["model"].named_parameters())["layers.0.mlp.w1"]
        assert w1.grad is not None and float(w1.grad.abs().max()) > 0
