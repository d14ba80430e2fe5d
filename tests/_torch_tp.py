"""Shared parts of ``tests/test_torch_tensor_parallel.py`` (2 ranks) and
``tests/test_torch_tensor_parallel_4.py`` (4 ranks); pytest does not
collect this file.

Tensor and sequence parallelism of the port (``apex_tpu_torch.transformer.
tensor_parallel``: the region mappings and the overlap rings, the
vocab-parallel cross entropy and embedding, the column / row linears;
``fused_ffn_tp``; GPT and BERT at ``tensor_parallel_size`` t) against the
JAX package.

The port runs on 2 and 4 ``gloo`` ranks on the CPU, one spawn a world size
(``tests/_torch_dist.py`` case ``tp``, all ranks one ``model`` group of
``parallel_state``); while the ranks run, the JAX package computes the
same things under ``jax.shard_map`` on the first t of the 8 CPU devices
(check_vma on for tensor parallelism alone, where JAX sums a replicated
leaf's cotangents by itself; off under sequence parallelism, whose
``copy_to`` wrappers do, as ``tests/test_sequence_parallel.py`` runs it),
and serially.  A tiny GPT / BERT (2 layers, hidden 64, 4 heads, FFN 128,
vocab 128, seq 16, batch 2; the f32 vocab-parallel head) starts from the
JAX init carried over by ``convert.gpt_params_from_jax(tree, cfg,
rank)``; one step is ``forward_backward_no_pipelining`` over the model's
loss, then ``FusedAdam``.

Tolerances:

* the mappings and rings: exact.  Their inputs are multiples of 1/4 in
  [-1, 1], so every product and sum is exact in f32 whatever the order
  (gloo's and XLA's sums run in other orders);
* f32 training: the loss and every rank's gradients within rtol 1e-5 /
  atol 1e-6 (``tree_allclose`` of ``tests/test_sequence_parallel.py``) of
  the JAX shard_map run's, and of the JAX serial gradients sliced by JAX's
  ``shard_params_for_tp``;
* bf16 activations: the loss 1e-3 relative and each gradient within 5e-2
  of its largest entry, the bounds of ``tests/test_torch_gpt_training.py``
  (bf16 keeps 8 bits and rounds at other places than XLA's fusions; gloo
  also rounds each addition of a bf16 reduction, XLA once); the reading
  is logged by the test;
* one FusedAdam step: Adam moves an entry by lr g / (|g| + eps), whose
  derivative lr eps / (|g| + eps)^2 turns a rounding-level difference of
  a small gradient into a visible one (an entry at noise level, such as
  the key bias, which softmax ignores, may even move the other way); the
  parameters agree to rtol 1e-5 / atol 1e-6 where the gradient is at
  least 1e-4 of its tensor's largest entry (bf16: 5e-2, the gradients'
  own bound, above which the signs agree), and all within 2.2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.models.bert import BertConfig as JBertConfig
from apex_tpu.models.bert import BertModel as JBertModel
from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.models.gpt import quantize_decode_params as jquantize
from apex_tpu.models.gpt import shard_params_for_tp as jshard
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.transformer.tensor_parallel import mappings as JM

from apex_tpu_torch.models import bert as tbert
from apex_tpu_torch.models.bert import BertConfig
from apex_tpu_torch.models.gpt import GPTConfig, shard_params_for_tp

from _torch_dist import start

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2,
            num_attention_heads=4, ffn_hidden_size=128, max_seq_len=16,
            fused_lm_head=False)
BATCH, SEQ = 2, 16
LR = 1e-3
SEED = 17
RTOL, ATOL = 1e-5, 1e-6
BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-3, 5e-2
ADAM_NOISE = 1e-4
WEIGHT_QUANT_LOGITS_TOL = 5e-2     # tests/test_quant_gemm.py's
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# GPT at every world size: (config keywords, activation dtype)
STEPS = {}
for _ffn in (False, True):
    for _name, _kw in (("tp", {}), ("tp_sp", dict(sequence_parallel=True)),
                       ("tp_sp_overlap", dict(sequence_parallel=True,
                                              overlap_chunks=2))):
        STEPS[_name + ("-fused_ffn" if _ffn else "")] = dict(
            kw=dict(_kw, fused_ffn=_ffn), dtype="float32")
# at two ranks also attention dropout, bf16 activations and BERT
STEPS_2 = {
    "tp_sp-dropout": dict(kw=dict(sequence_parallel=True,
                                  attention_dropout=0.1), dtype="float32",
                          seed=SEED),
    "tp_sp-bf16": dict(kw=dict(sequence_parallel=True), dtype="bfloat16"),
    "bert-tp_sp": dict(kw=dict(sequence_parallel=True), dtype="float32",
                       bert=True),
    "bert-tp_sp_overlap-fused_ffn": dict(
        kw=dict(sequence_parallel=True, overlap_chunks=2, fused_ffn=True),
        dtype="float32", bert=True),
    # with the NSP loss: held against JAX's serial step, since JAX's
    # shard_map run sums the ranks' identical NSP cotangents
    "bert-tp_sp-nsp": dict(kw=dict(sequence_parallel=True), dtype="float32",
                           bert=True, nsp=True),
}
F32_GPT = [n for n in STEPS]

# the mappings and rings at world t: (function name, JAX positional
# arguments after x [and w], port keywords, the local shapes of x, w (None
# without) and the output)
_Q = 4.0


def _mapping_specs(t):
    seq = dict(seq_dim=1)
    specs = {
        "copy": ("copy_to_tensor_model_parallel_region", (), {}, (3, 8),
                 None, (3, 8)),
        "reduce": ("reduce_from_tensor_model_parallel_region", (), {},
                   (3, 8), None, (3, 8)),
        "scatter": ("scatter_to_tensor_model_parallel_region", (), {},
                    (3, 4 * t), None, (3, 4)),
        "gather": ("gather_from_tensor_model_parallel_region", (), {},
                   (3, 4), None, (3, 4 * t)),
        "seq_scatter": ("scatter_to_sequence_parallel_region", (1,), seq,
                        (2, 4 * t, 3), None, (2, 4, 3)),
        "seq_gather": ("gather_from_sequence_parallel_region", (1,), seq,
                       (2, 4, 3), None, (2, 4 * t, 3)),
        "seq_reduce_scatter": ("reduce_scatter_to_sequence_parallel_region",
                               (1,), seq, (2, 4 * t, 3), None, (2, 4, 3)),
    }
    for chunks in (1, 2):
        kw = dict(seq_dim=1, chunks=chunks)
        specs[f"column_ring-chunks{chunks}"] = (
            "column_parallel_linear_overlap", (1, chunks), kw, (2, 4, 6),
            (5, 6), (2, 4 * t, 5))
        specs[f"row_ring-chunks{chunks}"] = (
            "row_parallel_linear_overlap", (1, chunks), kw, (2, 4 * t, 6),
            (5, 6), (2, 4, 5))
    return specs


MAPPINGS = list(_mapping_specs(2))


def _dyadic(rng, shape):
    return (rng.randint(-4, 5, shape) / _Q).astype(np.float32)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _names(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh(t):
    return Mesh(np.asarray(jax.devices()[:t]), ("model",))


# -- the JAX side ----------------------------------------------------------------

def _jax_mappings(t, inp):
    out = {}
    for name, (fn, args, _, _, wshape, _) in _mapping_specs(t).items():
        c = inp["mappings"][name]
        f = getattr(JM, fn)

        def body(x, *rest, _f=f, _args=args, _w=wshape is not None):
            if _w:
                w, cot = rest
                y, pull = jax.vjp(lambda a, b: _f(a, b, "model", *_args),
                                  x[0], w[0])
            else:
                (cot,) = rest
                y, pull = jax.vjp(lambda a: _f(a, "model", *_args), x[0])
            return (y[None],) + tuple(g[None] for g in pull(cot[0]))

        arrays = [c["x"]] + ([c["w"]] if wshape is not None else []) \
            + [c["c"]]
        n_out = 1 + (2 if wshape is not None else 1)
        # check_vma off: each rank's input is its own, the rules apply as
        # the table writes them
        res = jax.jit(jax.shard_map(
            body, mesh=_mesh(t), in_specs=(P("model"),) * len(arrays),
            out_specs=(P("model"),) * n_out, check_vma=False))(
            *map(jnp.asarray, arrays))
        out[name] = [np.asarray(a) for a in res]
    return out


def _shard_dim(spec):
    return next((d for d, a in enumerate(spec) if a is not None), None)


def _is_spec(x):
    return isinstance(x, P)


def _shard_map_step(model, params, t, loss_fn):
    """Loss and gradients of ``loss_fn(local_params)`` under shard_map
    over t devices, the model's partition specs splitting the sharded
    leaves; the gradients unpacked to the serial layout.  The JAX models
    need check_vma on for tensor parallelism alone (it sums a replicated
    leaf's cotangents) and off under sequence parallelism (their
    ``copy_to`` wrappers sum them; ``tests/test_sequence_parallel.py``
    runs so)."""
    check = not model.cfg.sequence_parallel
    specs = model.partition_specs()
    tmap = jax.tree_util.tree_map

    def pack(s, x):
        d = _shard_dim(s)
        return x if d is None else jnp.stack(jnp.split(x, t, axis=d))

    packed = tmap(pack, specs, params, is_leaf=_is_spec)
    in_specs = tmap(lambda s: P() if _shard_dim(s) is None else P("model"),
                    specs, is_leaf=_is_spec)

    def step(sp):
        local = tmap(lambda s, x: x if _shard_dim(s) is None else x[0],
                     specs, sp, is_leaf=_is_spec)
        loss, g = jax.value_and_grad(loss_fn)(local)
        return loss, tmap(lambda s, x: x if _shard_dim(s) is None
                          else x[None], specs, g, is_leaf=_is_spec)

    loss, g = jax.jit(jax.shard_map(
        step, mesh=_mesh(t), in_specs=(in_specs,),
        out_specs=(P(), in_specs), check_vma=check))(packed)
    grads = tmap(lambda s, x: x if _shard_dim(s) is None else
                 jnp.concatenate(list(x), axis=_shard_dim(s)), specs, g,
                 is_leaf=_is_spec)
    return float(loss), grads


def _adam_step(loss, grads, params):
    """The loss, the gradients and one per-leaf FusedAdam step of the
    serial parameters with them, by name."""
    opt = JFusedAdam(lr=LR, bucketed=False)
    new, _ = opt.step(grads, params, opt.init(params))
    return dict(loss=float(loss), grads=dict(_names(grads)),
                params=dict(_names(new)))


def _jax_step(t, inp, c):
    """The JAX package's tensor-parallel step for config ``c``: the
    shard_map loss and gradients (serial layout), and one per-leaf
    FusedAdam step of the serial parameters with them.  With the NSP loss
    (``nsp``) the JAX serial model's step, the shard_map run's kept as
    ``shard_map``: under sequence parallelism its pooler input is the
    sequence gather whose backward reduce-scatters, which sums the ranks'
    identical NSP cotangents into t times the gradient."""
    bert = c.get("bert", False)
    tokens = jnp.asarray(inp["tokens"])
    if bert:
        model = JBertModel(JBertConfig(**TINY, **c["kw"],
                                       dtype=_JDT[c["dtype"]],
                                       tensor_parallel_size=t,
                                       axis_name="model"))
        params = inp["jax_bert_params"]
        labels = jnp.asarray(inp["labels"])
        kw = (dict(nsp_labels=jnp.asarray(inp["nsp_labels"]))
              if c.get("nsp") else {})
        loss, grads = _shard_map_step(
            model, params, t, lambda p: model.loss(p, tokens, labels, **kw))
        if c.get("nsp"):
            serial = JBertModel(JBertConfig(**TINY))
            sl, sg = jax.jit(jax.value_and_grad(
                lambda p: serial.loss(p, tokens, labels, **kw)))(params)
            return dict(_adam_step(sl, sg, params),
                        shard_map=_adam_step(loss, grads, params))
    else:
        model = JModel(JConfig(**TINY, **c["kw"], dtype=_JDT[c["dtype"]],
                               tensor_parallel_size=t, axis_name="model"))
        params = inp["jax_params"]
        targets = jnp.asarray(inp["targets"])
        seed = c.get("seed")
        loss, grads = _shard_map_step(
            model, params, t,
            lambda p: model.loss(p, tokens, targets, dropout_seed=seed))
    return _adam_step(loss, grads, params)


def _serial_key(c):
    return ("bert-nsp" if c.get("nsp") else "bert" if c.get("bert")
            else "gpt")


def _jax_serial_grads(inp, t, key):
    """The JAX serial model's loss and gradients (``key``: "gpt", "bert"
    or "bert-nsp", BERT with the NSP loss), each rank's slice (JAX's
    ``shard_params_for_tp``; BERT by its partition specs)."""
    tokens = jnp.asarray(inp["tokens"])
    if key != "gpt":
        model = JBertModel(JBertConfig(**TINY))
        params = inp["jax_bert_params"]
        kw = (dict(nsp_labels=jnp.asarray(inp["nsp_labels"]))
              if key == "bert-nsp" else {})
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, tokens, jnp.asarray(inp["labels"]),
                                 **kw)))(params)
        cfg = BertConfig(**TINY, tensor_parallel_size=t, axis_name="model")
        full = {n: torch.tensor(v) for n, v in _names(g)}
        return float(loss), [{n: v.numpy() for n, v in tbert.
                              shard_params_for_tp(cfg, full, r).items()}
                             for r in range(t)]
    model = JModel(JConfig(**TINY))
    params = inp["jax_params"]
    loss, g = jax.jit(jax.value_and_grad(model.loss))(
        params, tokens, jnp.asarray(inp["targets"]))
    cfg = JConfig(**TINY, tensor_parallel_size=t, axis_name="model")
    return float(loss), [dict(_names(jshard(cfg, g, r))) for r in range(t)]


def _slice(named, t, r, bert=False):
    """Rank r's slice of a serial-layout {name: array} (the port's
    shard function)."""
    cfg = (BertConfig if bert else GPTConfig)(
        **TINY, tensor_parallel_size=t, axis_name="model")
    fn = tbert.shard_params_for_tp if bert else shard_params_for_tp
    out = fn(cfg, {n: torch.from_numpy(v) for n, v in named.items()}, r)
    return {n: v.numpy() for n, v in out.items()}


def _jax_int8_prefill(inp):
    """JAX's tensor-parallel int8 prefill at two ranks, each rank's
    weights sharded then quantized (``tests/test_quant_gemm.py``)."""
    cfg_tp = JConfig(**TINY, tensor_parallel_size=2, axis_name="model")
    par = JModel(JConfig(**TINY, weight_quant="int8",
                         tensor_parallel_size=2, axis_name="model"))
    shards = [jquantize(jshard(cfg_tp, inp["jax_params"], r))
              for r in range(2)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *shards)
    specs = jax.tree_util.tree_map(lambda _: P("model"), stacked)

    def local_prefill(sp, toks):
        return par.prefill(jax.tree_util.tree_map(lambda a: a[0], sp), toks)

    logits, kv = jax.jit(jax.shard_map(
        local_prefill, mesh=_mesh(2), in_specs=(specs, P()),
        out_specs=(P(None, None, "model"),
                   P(None, None, None, None, "model"))))(
        stacked, jnp.asarray(inp["tokens"]))
    return np.asarray(logits), np.asarray(kv)


# -- the runs ----------------------------------------------------------------------

def _inputs(t):
    rng = np.random.RandomState(20 + t)
    mappings = {}
    for name, (fn, _, kw, shape, wshape, yshape) in _mapping_specs(
            t).items():
        c = {"fn": fn, "kw": kw, "x": _dyadic(rng, (t,) + shape),
             "c": _dyadic(rng, (t,) + yshape)}
        if wshape is not None:
            c["w"] = _dyadic(rng, (t,) + wshape)
        mappings[name] = c
    jparams = JModel(JConfig(**TINY)).init_params(jax.random.PRNGKey(t))
    bparams = JBertModel(JBertConfig(**TINY)).init_params(
        jax.random.PRNGKey(10 + t))
    tokens = rng.randint(0, TINY["vocab_size"], (BATCH, SEQ))
    surface = dict(x=_dyadic(rng, (3, 8)), c=_dyadic(rng, (3, 8)),
                   b1=_dyadic(rng, (12,)), b2=_dyadic(rng, (8,)),
                   data=dict(tokens=rng.randint(0, 9, (2, 5)),
                             mask=rng.randint(0, 2, (7,))))
    inp = dict(tiny=TINY, lr=LR, mappings=mappings, surface=surface,
               params=_np_tree(jparams), bert_params=_np_tree(bparams),
               jax_params=jparams, jax_bert_params=bparams, tokens=tokens,
               targets=rng.randint(0, TINY["vocab_size"], (BATCH, SEQ)),
               labels=np.where(rng.rand(BATCH, SEQ) < 0.3,
                               rng.randint(0, TINY["vocab_size"],
                                           (BATCH, SEQ)), -1),
               steps=dict(STEPS, **(STEPS_2 if t == 2 else {})))
    if t == 2:
        inp["masks"] = _masks_inputs(rng)
        inp["int8"] = True
        # the NSP head is zero at init, which would hide its gradient into
        # the backbone: draw it as the MLM transform is drawn
        bparams["nsp_head"]["weight"] = jnp.asarray(
            0.02 * rng.randn(*bparams["nsp_head"]["weight"].shape),
            jnp.float32)
        inp.update(nsp_labels=rng.randint(0, 2, (BATCH,)),
                   jax_bert_params=bparams, bert_params=_np_tree(bparams))
    return inp


def _masks_inputs(rng):
    """One attention's rank-0 shards (hidden 32, 4 heads: 2 a rank) for
    both ranks, and one input."""
    tiny = dict(vocab_size=32, hidden_size=32, num_layers=1,
                num_attention_heads=4, max_seq_len=16)
    w = (0.2 * rng.randn(96, 32)).astype(np.float32)
    proj = (0.2 * rng.randn(32, 32)).astype(np.float32)
    shard = {"qkv.weight": w[:48], "qkv.bias": np.zeros(48, np.float32),
             "proj.weight": proj[:, :16].copy(),
             "proj.bias": np.zeros(32, np.float32)}
    return dict(tiny=tiny, shard=shard,
                x=rng.randn(2, 16, 32).astype(np.float32))


_RUNS = {}


def _run(t, tmp_path_factory):
    """The port's ranks (started first) and the JAX references computed
    while they run."""
    if t not in _RUNS:
        inp = _inputs(t)
        rank_inp = {k: v for k, v in inp.items()
                    if k not in ("jax_params", "jax_bert_params")}
        spawn = start(tmp_path_factory.mktemp(f"tp{t}"), t, "tp", rank_inp)
        ref = dict(mappings=_jax_mappings(t, inp),
                   steps={name: _jax_step(t, inp, c)
                          for name, c in inp["steps"].items()},
                   serial={key: _jax_serial_grads(inp, t, key)
                           for key in {_serial_key(c)
                                       for c in inp["steps"].values()}})
        if t == 2:
            ref["int8"] = _jax_int8_prefill(inp)
        _RUNS[t] = (inp, ref, spawn.result())
    return _RUNS[t]


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def _check_step(name, t, want, outs, dtype, bert=False):
    """Every rank's loss, gradients and parameters after one FusedAdam
    step against the JAX shard_map run's (its gradients and parameters
    cut into the rank's slices)."""
    for r in range(t):
        got = outs[r]["steps"][name]
        grads = _slice(want["grads"], t, r, bert)
        params = _slice(want["params"], t, r, bert)
        assert set(got["grads"]) == set(grads)
        if dtype == "float32":
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
            for n, g in grads.items():
                np.testing.assert_allclose(got["grads"][n], g, rtol=RTOL,
                                           atol=ATOL, err_msg=f"{n} rank {r}")
        else:
            assert abs(got["loss"] - want["loss"]) <= BF16_LOSS_RTOL * abs(
                want["loss"]), (got["loss"], want["loss"])
            worst = max(_rel(got["grads"][n], g) for n, g in grads.items())
            print(f"{name} rank {r}: largest gradient error {worst:.3e} of "
                  f"the tensor's largest entry")
            assert worst <= BF16_GRAD_TOL
        # above the gradients' noise (f32: ADAM_NOISE; bf16: the bound
        # just asserted on each entry's error, so the gradients' signs
        # agree) Adam's first step moves both by lr g / (|g| + eps)
        noise = ADAM_NOISE if dtype == "float32" else BF16_GRAD_TOL
        for n, p in params.items():
            diff = np.abs(got["params"][n] - p)
            assert diff.max() <= 2.2 * LR, (n, r, diff.max())
            g = np.abs(grads[n])
            sure = g >= noise * g.max()
            np.testing.assert_allclose(got["params"][n][sure], p[sure],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{n} rank {r}")


def check_mapping(run, name):
    """The mapping or ring ``name`` on every rank equals JAX's bit for
    bit: its output and the gradients of sum(y * c)."""
    t, inp, ref, out = run
    want = ref["mappings"][name]
    for r in range(t):
        y, grads = out[r]["mappings"][name]
        np.testing.assert_array_equal(y, want[0][r], err_msg=f"y rank {r}")
        assert len(grads) == len(want) - 1
        for i, g in enumerate(grads):
            np.testing.assert_array_equal(g, want[1 + i][r],
                                          err_msg=f"grad {i} rank {r}")


def check_gpt_step(run, name):
    t, inp, ref, out = run
    _check_step(name, t, ref["steps"][name], out, "float32")


def check_sliced_serial(run, name):
    """Every rank's loss and gradients against the JAX serial model's, a
    replicated leaf's whole and a sharded leaf's sliced."""
    t, inp, ref, out = run
    loss, per_rank = ref["serial"][_serial_key(inp["steps"][name])]
    for r in range(t):
        got = out[r]["steps"][name]
        np.testing.assert_allclose(got["loss"], loss, rtol=RTOL)
        assert set(got["grads"]) == set(per_rank[r])
        for n, g in per_rank[r].items():
            np.testing.assert_allclose(got["grads"][n], g, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{n} rank {r}")


def check_surface(run):
    """The column (``gather_output``) and row (``input_is_parallel=False``)
    layers on the shards of one serial pair against that pair in f64
    (weights drawn from one seed, sliced per rank), ``broadcast_data``
    from rank 0 and the ranks' ``model_parallel_rng_key`` seeds (base +
    2718 + rank)."""
    t, inp, ref, out = run
    c = inp["surface"]
    w1 = np.concatenate([o["surface"]["col"][0] for o in out], 0)
    w2 = np.concatenate([o["surface"]["row"][0] for o in out], 1)
    x, ct = c["x"].astype(np.float64), c["c"].astype(np.float64)
    h = x @ w1.T + c["b1"]
    y = h @ w2.T + c["b2"]
    dh = ct @ w2
    for r, o in enumerate(out):
        s = o["surface"]
        np.testing.assert_allclose(s["y"], y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(s["dx"], dh @ w1, rtol=1e-6, atol=1e-6)
        rows = slice(r * 12 // t, (r + 1) * 12 // t)
        np.testing.assert_allclose(s["col"][1], (dh.T @ x)[rows], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(s["col"][2], dh.sum(0)[rows], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(s["row"][1], (ct.T @ h)[:, rows],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(s["row"][2], ct.sum(0), rtol=1e-6,
                                   atol=1e-6)
        for k, v in c["data"].items():
            np.testing.assert_array_equal(s["data"][k], v)
        assert s["rng_seed"] == 5 + 2718 + r
