"""apex_tpu_torch's softmax, cross-entropy, RoPE and transformer surfaces
against apex_tpu on the CPU.

The same numpy inputs (seeded) go through each JAX function and its port:
``ops.softmax`` and ``transformer.functional.FusedScaleMaskSoftmax``
(forward and the gradient of a random cotangent), ``transformer.enums``,
``ops.xentropy`` / ``contrib.xentropy`` (loss and gradient, smoothing,
padding rows, ``half_to_float``), the two RoPE forms added to
``ops.rope`` (the freqs form and the packed ``thd`` form), the functional
norms that ``normalization`` now exports, ``transformer.layers`` and
``transformer.log_util``.  The JAX tests followed are ``test_ops.py``'s
``TestFusedSoftmax``, ``TestRoPE`` and ``TestXentropy``.

Tolerances: f32 1e-5 (sums in another order); bf16 results one bf16 ulp
of the largest entry (2**-8 relative: both sides compute in f32 and round
once, and the f32 sums may round to neighbouring bf16 values).  Where
JAX runs the softmax in bf16 arithmetic (``softmax_in_fp32=False``) the
bound also allows JAX's own distance from its f32 result on the same
inputs, and the port is held to 2**-7 of that f32 result.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import normalization as jnorm
from apex_tpu.contrib import xentropy as jcxent
from apex_tpu.ops import rope as jrope
from apex_tpu.ops import softmax as jsoftmax
from apex_tpu.ops import xentropy as jxent
from apex_tpu.transformer import enums as jenums
from apex_tpu.transformer import functional as jfunctional
from apex_tpu.transformer import layers as jlayers
from apex_tpu.transformer import log_util as jlog

from apex_tpu_torch import normalization as tnorm
from apex_tpu_torch import transformer as ttransformer
from apex_tpu_torch.contrib import xentropy as tcxent
from apex_tpu_torch.ops import layer_norm as tln
from apex_tpu_torch.ops import rope as trope
from apex_tpu_torch.ops import softmax as tsoftmax
from apex_tpu_torch.ops import xentropy as txent
from apex_tpu_torch.transformer import enums as tenums
from apex_tpu_torch.transformer import functional as tfunctional
from apex_tpu_torch.transformer import layers as tlayers
from apex_tpu_torch.transformer import log_util as tlog

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype):
    """``got`` (torch) against ``want`` (JAX) at the module's bounds."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    tol = 1e-5 if dtype == "f32" else 2.0 ** -8
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _value_and_vjp(jfn, tfn, arrays, dtype, grad_args=(0,), seed=9):
    """Both sides' outputs and the gradient of ``sum(out * c)`` for a
    random cotangent ``c`` in the arguments ``grad_args``; ``arrays`` are
    numpy (floating ones cast to ``dtype``)."""
    jdt, tdt = _DT[dtype]
    jargs = [jnp.asarray(a, jdt) if a.dtype.kind == "f" else jnp.asarray(a)
             for a in arrays]
    targs = [torch.tensor(a, dtype=tdt) if a.dtype.kind == "f"
             else torch.from_numpy(a) for a in arrays]
    for i in grad_args:
        targs[i].requires_grad_(True)
    jout, vjp = jax.vjp(lambda *g: jfn(*[
        g[grad_args.index(i)] if i in grad_args else a
        for i, a in enumerate(jargs)]), *[jargs[i] for i in grad_args])
    cot = np.random.RandomState(seed).randn(*jout.shape)
    jgrads = vjp(jnp.asarray(cot, jout.dtype))
    tout = tfn(*targs)
    tout.backward(torch.tensor(cot, dtype=tout.dtype))
    return (tout, jout), [(targs[i].grad, g) for i, g in
                          zip(grad_args, jgrads)]


def _check(jfn, tfn, arrays, dtype, grad_args=(0,), jax_own_error=False):
    """Outputs and gradients within the module's bounds.  With
    ``jax_own_error`` (a softmax the JAX side runs in bf16 arithmetic)
    the bf16 bound also allows JAX's own distance from its result on the
    same bf16 inputs in f32, and the port is held to 2**-7 of that f32
    result."""
    (tout, jout), grads = _value_and_vjp(jfn, tfn, arrays, dtype, grad_args)
    assert tout.dtype == _DT[dtype][1]
    if not (jax_own_error and dtype == "bf16"):
        _close(tout, jout, dtype)
        for tg, jg in grads:
            _close(tg, jg, dtype)
        return
    rounded = [a.astype(jnp.bfloat16).astype(np.float32)
               if a.dtype.kind == "f" else a for a in arrays]
    (_, ref), ref_grads = _value_and_vjp(jfn, lambda *a: tfn(*a), rounded,
                                         "f32", grad_args)
    for got, want, f32 in [(tout, jout, ref)] + [
            (tg, jg, rg) for (tg, jg), (_, rg) in zip(grads, ref_grads)]:
        got = got.detach().float().numpy()
        want, f32 = (np.asarray(a, np.float32) for a in (want, f32))
        own = np.abs(want - f32).max()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2.0 ** -8 * scale + own
        assert np.abs(got - f32).max() <= 2.0 ** -7 * np.abs(f32).max()


# -- ops.softmax ---------------------------------------------------------------

def _scores(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["masked", "broadcast_mask", "no_mask",
                                  "generic"])
def test_scaled_masked_softmax_matches_jax(form, dtype):
    x = _scores((2, 4, 8, 16))
    mshape = (2, 1, 8, 16) if form == "broadcast_mask" else (2, 4, 8, 16)
    mask = np.random.RandomState(1).rand(*mshape) > 0.7
    if form == "no_mask":
        _check(lambda x: jsoftmax.scaled_softmax(x, 0.5),
               lambda x: tsoftmax.scaled_softmax(x, 0.5), [x], dtype)
        return
    jfn = (jsoftmax.generic_scaled_masked_softmax if form == "generic"
           else jsoftmax.scaled_masked_softmax)
    tfn = (tsoftmax.generic_scaled_masked_softmax if form == "generic"
           else tsoftmax.scaled_masked_softmax)
    _check(lambda x, m: jfn(x, m, 0.5), lambda x, m: tfn(x, m, 0.5),
           [x, mask], dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 8, 8), (2, 6, 10)],
                         ids=["square", "sk_longer"])
def test_scaled_upper_triang_masked_softmax_matches_jax(shape, dtype):
    x = _scores(shape, 2)
    _check(lambda x: jsoftmax.scaled_upper_triang_masked_softmax(x, 0.7),
           lambda x: tsoftmax.scaled_upper_triang_masked_softmax(x, 0.7),
           [x], dtype)
    y = tsoftmax.scaled_upper_triang_masked_softmax(torch.from_numpy(x), 1.0)
    sq, sk = shape[1:]
    for q in range(sq - 1):
        assert float(y[:, q, q + 1 + sk - sq:].abs().max()) < 1e-4
    torch.testing.assert_close(y.sum(-1), torch.ones(shape[:2]))


@pytest.mark.parametrize("fn", [
    lambda x: tsoftmax.scaled_softmax(x, 2.0),
    lambda x: tsoftmax.scaled_masked_softmax(x, x > 1.0, 2.0),
    lambda x: tsoftmax.scaled_upper_triang_masked_softmax(x[0], 2.0)],
    ids=["no_mask", "masked", "causal"])
def test_softmax_backward_reads_only_the_saved_output(fn):
    """One tensor is saved, the output (never the scores or the mask)."""
    x = torch.from_numpy(_scores((2, 8, 8))).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = fn(x)
    assert len(saved) == 1 and torch.equal(saved[0], y.detach())
    y.sum().backward()
    assert float(x.grad.abs().max()) < 1e-5      # softmax rows sum to 1


# -- transformer.functional.FusedScaleMaskSoftmax ------------------------------

def _mask_func(x, mask):
    return x.masked_fill(mask, -5000.0) if torch.is_tensor(x) \
        else jnp.where(mask, -5000.0, x)


_FSMS_CASES = {
    "padding": dict(mask=True),
    "padding_scaled": dict(mask=True, scale=0.125),
    "no_mask": dict(mask=False, scale=0.5),
    "causal": dict(causal=True, scale=0.3),
    "mask_func": dict(mask=True, mask_func=_mask_func, scale=2.0),
    "fp16_path_padding": dict(mask=True, softmax_in_fp32=False),
    "fp16_path_causal": dict(causal=True, softmax_in_fp32=False),
    "fp16_path_mask_func": dict(mask=True, mask_func=_mask_func,
                                softmax_in_fp32=False),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_FSMS_CASES))
def test_fused_scale_mask_softmax_matches_jax(case, dtype):
    kw = dict(_FSMS_CASES[case])
    use_mask = kw.pop("mask", False)
    causal = kw.pop("causal", False)
    kw["attn_mask_type"] = "causal" if causal else "padding"
    jkw = dict(kw, attn_mask_type=getattr(jenums.AttnMaskType,
                                          kw["attn_mask_type"]))
    tkw = dict(kw, attn_mask_type=getattr(tenums.AttnMaskType,
                                          kw["attn_mask_type"]))
    jm = jfunctional.FusedScaleMaskSoftmax(**jkw)
    tm = tfunctional.FusedScaleMaskSoftmax(**tkw)
    x = _scores((2, 3, 8, 8), 4)
    own = not kw.get("softmax_in_fp32", True)
    if use_mask:
        mask = np.random.RandomState(5).rand(2, 1, 8, 8) > 0.6
        _check(lambda x, m: jm(x, m), lambda x, m: tm(x, m), [x, mask],
               dtype, jax_own_error=own)
    else:
        _check(lambda x: jm(x), lambda x: tm(x), [x], dtype,
               jax_own_error=own)


def test_fused_scale_mask_softmax_keeps_apex_refusals():
    for cls in (jfunctional.FusedScaleMaskSoftmax,
                tfunctional.FusedScaleMaskSoftmax):
        with pytest.raises(RuntimeError, match="fp16 and bf16"):
            cls(input_in_fp16=True, input_in_bf16=True)
        with pytest.raises(RuntimeError, match="fp32 when scaled"):
            cls(scale=2.0, softmax_in_fp32=False)
    assert isinstance(tfunctional.FusedScaleMaskSoftmax(), torch.nn.Module)


def test_functional_exports_the_jax_names():
    assert sorted(tfunctional.__all__) == sorted(jfunctional.__all__)
    assert tfunctional.fused_apply_rotary_pos_emb_thd is \
        trope.fused_apply_rotary_pos_emb_thd


# -- transformer.enums ---------------------------------------------------------

@pytest.mark.parametrize("name", ["LayerType", "AttnType", "AttnMaskType",
                                  "ModelType"])
def test_enums_match_jax(name):
    want = {m.name: m.value for m in getattr(jenums, name)}
    assert {m.name: m.value for m in getattr(tenums, name)} == want
    assert getattr(ttransformer, name) is getattr(tenums, name)


# -- ops.xentropy ----------------------------------------------------------------

def _xent_inputs(n=32, c=50, seed=0, pad=None):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, c) * 3).astype(np.float32)
    labels = rng.randint(0, c, n)
    if pad is not None:
        labels[::5] = pad
    return logits, labels


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("padding_idx", [-100, 0], ids=["pad-100", "pad0"])
@pytest.mark.parametrize("half_to_float", [False, True],
                         ids=["logits_dtype", "half_to_float"])
def test_softmax_cross_entropy_matches_jax(half_to_float, padding_idx,
                                           smoothing, dtype):
    logits, labels = _xent_inputs(pad=padding_idx)
    args = (smoothing, padding_idx, half_to_float)
    (tout, jout), grads = _value_and_vjp(
        lambda l, t: jxent.SoftmaxCrossEntropyLoss.apply(l, t, *args),
        lambda l, t: txent.SoftmaxCrossEntropyLoss.apply(l, t, *args),
        [logits, labels], dtype)
    want_dtype = torch.float32 if half_to_float else _DT[dtype][1]
    assert tout.dtype == want_dtype
    assert str(jout.dtype) == str(want_dtype).split(".")[-1]
    _close(tout, jout, "f32" if half_to_float else dtype)
    pad = labels == padding_idx
    assert pad.any() and float(tout.detach()[torch.from_numpy(pad)]
                               .abs().max()) == 0.0
    (tg, jg), = grads
    _close(tg, jg, dtype)
    assert float(tg[torch.from_numpy(pad)].abs().max()) == 0.0


def test_softmax_cross_entropy_saves_what_jax_saves():
    """The logits, the labels (ignored rows set to 0), the valid rows and
    the (N,) log-sum-exp; never an (N, C) softmax."""
    logits, labels = _xent_inputs(8, 10, pad=-100)
    x = torch.from_numpy(logits).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        txent.softmax_cross_entropy_loss(x, torch.from_numpy(labels), 0.1)
    shapes = sorted(tuple(t.shape) for t in saved)
    assert shapes == [(8,), (8,), (8,), (8, 10)]
    assert any(t is x or torch.equal(t, x.detach()) for t in saved)


def test_contrib_xentropy_is_the_op():
    assert sorted(tcxent.__all__) == sorted(jcxent.__all__)
    assert tcxent.SoftmaxCrossEntropyLoss is txent.SoftmaxCrossEntropyLoss
    assert tcxent.softmax_cross_entropy_loss is \
        txent.softmax_cross_entropy_loss


# -- ops.rope ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rot_dim", [32, 16], ids=["full", "partial"])
def test_fused_apply_rotary_pos_emb_matches_jax(rot_dim, dtype):
    s, b, h, d = 12, 2, 4, 32
    t = np.random.RandomState(0).randn(s, b, h, d).astype(np.float32)
    freqs = np.asarray(jrope.rope_freqs(s, rot_dim))
    _check(lambda t, f: jrope.fused_apply_rotary_pos_emb(t, f),
           lambda t, f: trope.fused_apply_rotary_pos_emb(t, f.float()),
           [t, freqs], dtype)
    tf = trope.rope_freqs(s, rot_dim)
    np.testing.assert_allclose(tf.numpy(), freqs, rtol=1e-6)
    out = trope.fused_apply_rotary_pos_emb(torch.from_numpy(t), tf)
    torch.testing.assert_close(out[..., rot_dim:],
                               torch.from_numpy(t)[..., rot_dim:],
                               rtol=0, atol=0)


def test_transpose_output_memory_lays_out_batch_major():
    t = torch.from_numpy(np.random.RandomState(1).randn(6, 3, 2, 8)
                         .astype(np.float32))
    f = trope.rope_freqs(6, 8)
    a = trope.fused_apply_rotary_pos_emb(t, f)
    b = trope.fused_apply_rotary_pos_emb(t, f, transpose_output_memory=True)
    assert torch.equal(a, b) and b.shape == t.shape
    assert b.transpose(0, 1).is_contiguous() and not b.is_contiguous()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_apply_rotary_pos_emb_thd_matches_jax(dtype):
    d = 16
    t = np.random.RandomState(2).randn(12, 2, d).astype(np.float32)
    cu = np.array([0, 3, 7, 12], np.int32)
    freqs = np.asarray(jrope.rope_freqs(10, d)).reshape(10, 1, d)
    _check(lambda t, c, f: jrope.fused_apply_rotary_pos_emb_thd(t, c, f),
           lambda t, c, f: trope.fused_apply_rotary_pos_emb_thd(
               t, c, f.float()), [t, cu, freqs], dtype)


def test_thd_restarts_positions():
    """Each sequence's first token sits at position 0 (the identity), and
    its later tokens take the sbhd form's positions."""
    d = 16
    t = torch.from_numpy(np.random.RandomState(3).randn(7, 2, d)
                         .astype(np.float32))
    freqs = trope.rope_freqs(10, d)
    out = trope.fused_apply_rotary_pos_emb_thd(
        t, torch.tensor([0, 3, 7], dtype=torch.int32), freqs.reshape(10, 1,
                                                                     d))
    for start, end in ((0, 3), (3, 7)):
        torch.testing.assert_close(out[start], t[start])
        sbhd = trope.fused_apply_rotary_pos_emb(t[start:end, None],
                                                freqs[:end - start])
        torch.testing.assert_close(out[start:end], sbhd[:, 0])


# -- normalization / transformer.layers / log_util -----------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["fused_layer_norm_affine",
                                  "fused_rms_norm_affine", "fused_layer_norm",
                                  "fused_rms_norm"])
def test_normalization_exports_the_functional_norms(name, dtype):
    rng = np.random.RandomState(4)
    x = rng.randn(6, 4, 32).astype(np.float32)
    w = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    b = (0.1 * rng.randn(32)).astype(np.float32)
    assert getattr(tnorm, name) is getattr(tln, name)
    assert name in tnorm.__all__ and name in jnorm.__all__
    jfn, tfn = getattr(jnorm, name), getattr(tnorm, name)
    if name == "fused_layer_norm_affine":
        _check(lambda x, w, b: jfn(x, w, b, (32,)),
               lambda x, w, b: tfn(x, w.float(), b.float(), (32,)),
               [x, w, b], dtype)
    elif name == "fused_rms_norm_affine":
        _check(lambda x, w: jfn(x, w, (32,)),
               lambda x, w: tfn(x, w.float(), (32,)), [x, w], dtype)
    else:
        _check(lambda x: jfn(x, (32,)), lambda x: tfn(x, (32,)), [x], dtype)


@pytest.mark.parametrize("cls", ["FusedLayerNorm", "FastLayerNorm"])
def test_transformer_layers_layer_norm_matches_jax(cls):
    jm = getattr(jlayers, cls)(32, eps=1e-5, sequence_parallel_enabled=True)
    tm = getattr(tlayers, cls)(32, eps=1e-5, sequence_parallel_enabled=True,
                               device="cpu")
    assert isinstance(tm, tnorm.MixedFusedLayerNorm)
    assert tm.sequence_parallel_enabled and jm.sequence_parallel_enabled
    rng = np.random.RandomState(6)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(1 + 0.1 * rng.randn(32)))
        tm.bias.copy_(torch.from_numpy(0.1 * rng.randn(32)))
    params = {"weight": jnp.asarray(tm.weight.detach().numpy()),
              "bias": jnp.asarray(tm.bias.detach().numpy())}
    x = rng.randn(5, 32).astype(np.float32)
    _check(lambda x: jm(params, x), lambda x: tm(x), [x], "bf16")
    assert not tlayers.FusedLayerNorm(8, device="cpu") \
        .sequence_parallel_enabled


def test_log_util_matches_jax_under_the_ports_root():
    assert jlog.get_transformer_logger("pipeline.schedules").name == \
        "apex_tpu.transformer.pipeline"
    logger = tlog.get_transformer_logger("pipeline.schedules")
    assert logger.name == "apex_tpu_torch.transformer.pipeline"
    root = logging.getLogger("apex_tpu_torch")
    level = root.level
    try:
        tlog.set_logging_level(logging.WARNING)
        assert root.level == logging.WARNING
        assert logger.getEffectiveLevel() == logging.WARNING
    finally:
        root.setLevel(level)
