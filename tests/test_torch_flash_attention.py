"""apex_tpu_torch flash attention (forward, backward, dropout) and decode
attention against apex_tpu on the CPU.

The JAX side runs twice — its Pallas kernels in interpret mode
(``set_force_pallas(True)``) and its default path — against the port's
plain versions (what a CPU tensor takes).  f32 tolerance 2e-5 (the JAX
kernel's own parity bound); a bf16 cache compared in f32 at 2e-2.
Gradients: f32 at 1e-4 (sums over 40 keys of products recomputed from the
saved logsumexp here, autodiff of the softmax or the Pallas kernels there);
bf16 at 5e-2 of each gradient's largest entry (dS and P*D round to bf16 at
the same places on both sides, the products sum in other orders).  The
dropout keep mask is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flash_attention as jfa
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch.ops import flash_attention as tfa

B, H, S, D = 2, 2, 40, 16     # seq off every block multiple


@pytest.fixture(params=["pallas_interpret", "jax_default"])
def jax_path(request):
    set_force_pallas(True if request.param == "pallas_interpret" else None)
    yield request.param
    set_force_pallas(None)


def _qkv(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("case", ["causal", "non_causal", "kv_seqlens"])
def test_flash_attention_matches_jax(jax_path, case):
    q, k, v = _qkv(0)
    lens = np.array([S, 13], np.int32) if case == "kv_seqlens" else None
    causal = case == "causal"
    ref = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_seqlens=None if lens is None else jnp.asarray(lens))
    out = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_seqlens=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_fully_masked_row_is_zero():
    """kv_seqlens 0 masks every key: the l == 0 guard gives 0, no NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    out = tfa.flash_attention(q, k, v, kv_seqlens=torch.tensor([S, 0]))
    assert torch.isfinite(out).all()
    assert not out[1].any()


def test_dropout_and_grad_are_refused():
    """What is still refused: dropout without a seed, a rate outside
    [0, 1), a causal call with sq != sk.  Dropout with a seed runs, and
    gradients flow to q, k and v."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2))
    with pytest.raises(ValueError, match="needs dropout_seed"):
        tfa.flash_attention(q, k, v, dropout=0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        tfa.flash_attention(q, k, v, dropout=1.0, dropout_seed=0)
    with pytest.raises(ValueError, match="sq == sk"):
        tfa.flash_attention(q[:, :, :5], k, v, causal=True)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(qg, kg, vg, causal=True, dropout=0.1,
                              dropout_seed=3)
    assert not torch.allclose(out, tfa.flash_attention(q, k, v, causal=True))
    out.sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (qg, kg, vg))


@pytest.mark.parametrize("seed", [0, 7, -123456789, 2 ** 31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_scale_is_bitwise_jax(seed, rate):
    ref = np.asarray(jfa.dropout_keep_scale(jnp.int32(seed), 6, S, 37, rate))
    out = tfa.dropout_keep_scale(seed, 6, S, 37, rate).numpy()
    assert out.dtype == ref.dtype == np.float32
    assert np.array_equal(out.view(np.uint32), ref.view(np.uint32))
    # the port wraps seeds modulo 2**32, as int32 arithmetic does in JAX
    wrapped = tfa.dropout_keep_scale(seed + 2 ** 32, 6, S, 37, rate).numpy()
    assert np.array_equal(wrapped, out)


def test_keep_scale_tile_is_bitwise_jax():
    ref = np.asarray(jfa._keep_scale_tile(jnp.int32(5), 3, 2, 1, 16, 8, 0.2))
    out = tfa._keep_scale_tile(5, 3, 2, 1, 16, 8, 0.2).numpy()
    assert np.array_equal(out.view(np.uint32), ref.view(np.uint32))
    dense = tfa.dropout_keep_scale(5, 4, 48, 16, 0.2).numpy()
    assert np.array_equal(out, dense[3, 32:48, 8:16])


_GRAD_CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(causal=False),
    "kv_seqlens": dict(causal=False, lens=[S, 13]),
    "non_multiple_seq": dict(causal=True, seq=37),
    "dropout": dict(causal=True, dropout=0.1, seed=11),
}


@pytest.mark.parametrize("case", list(_GRAD_CASES))
def test_flash_grads_match_jax(jax_path, case):
    """Forward output and dq, dk, dv of ``flash_attention``: the port's
    autograd Function (plain forward + plain dq/dkv) against ``jax.vjp``."""
    c = _GRAD_CASES[case]
    n = c.get("seq", S)
    q, k, v = (a[:, :, :n] for a in _qkv(5))
    g = np.random.RandomState(6).randn(*q.shape).astype(np.float32)
    lens = c.get("lens")
    kw = dict(causal=c["causal"], dropout=c.get("dropout", 0.0),
              dropout_seed=c.get("seed"))
    jlens = None if lens is None else jnp.asarray(np.array(lens, np.int32))
    ref, pull = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, kv_seqlens=jlens, **kw), *map(jnp.asarray, (q, k, v)))
    rq, rk, rv = pull(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v))
    out = tfa.flash_attention(
        tq, tk, tv, kv_seqlens=None if lens is None else torch.tensor(lens),
        **kw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    for got, want in ((tq, rq), (tk, rk), (tv, rv)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_flash_grads_bf16_match_jax(jax_path, dropout):
    q, k, v = _qkv(7)
    g = np.random.RandomState(8).randn(*q.shape).astype(np.float32)
    kw = dict(causal=True, dropout=dropout,
              dropout_seed=21 if dropout else None)
    ref, pull = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, **kw),
                        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    refs = pull(jnp.asarray(g, jnp.bfloat16))
    ts = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, **kw)
    out.backward(torch.from_numpy(g).bfloat16())
    pairs = [(out.detach(), ref)] + [(t.grad, r) for t, r in zip(ts, refs)]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 5e-2 * np.abs(want).max(), err


def test_dq_dkv_plain_versions_take_the_saved_stats():
    """The wrappers' plain versions, called the way the autograd Function
    calls them (lse from the forward, delta = rowsum(dO * O)), give the
    gradients of the materialized reference."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(9))
    do = torch.from_numpy(
        np.random.RandomState(10).randn(B, H, S, D).astype(np.float32))
    scale = D ** -0.5
    lens = torch.tensor([S, 17])
    ref = tfa.flash_attention_reference(q, k, v, True, scale, lens)
    ref.backward(do)
    with torch.no_grad():
        o, lse = tfa.flash_fwd(q, k, v, True, scale, lens)
        delta = (do * o).sum(-1).reshape(B * H, S)
        dq = tfa.flash_attention_dq(q, k, v, do, lse, delta, True, scale,
                                    lens)
        dk, dv = tfa.flash_attention_dkv(q, k, v, do, lse, delta, True,
                                         scale, lens)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_decode_matches_jax_on_strided_cache(jax_path, cache_dtype):
    """Ragged lengths (1 token, mid-block, block edge, full cache) over a
    strided ``cache[:, layer, 0]`` view of a slot ring, as the model
    passes it."""
    b, S_, h, d, layers = 4, 160, 3, 16, 2
    rng = np.random.RandomState(3)
    q = rng.randn(b, h, d).astype(np.float32)
    ring = rng.randn(b, layers, 2, S_, h, d).astype(np.float32)
    lens = np.array([1, 97, 128, S_], np.int32)
    jdt = jnp.bfloat16 if cache_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if cache_dtype == "bf16" else torch.float32
    ref = jfa.flash_attention_decode(
        jnp.asarray(q), jnp.asarray(ring[:, 1, 0], jdt),
        jnp.asarray(ring[:, 1, 1], jdt), jnp.asarray(lens))
    tring = torch.from_numpy(ring).to(tdt)
    k_view, v_view = tring[:, 1, 0], tring[:, 1, 1]
    assert not k_view.is_contiguous()
    out = tfa.flash_attention_decode(torch.from_numpy(q), k_view, v_view,
                                     torch.from_numpy(lens))
    tol = 2e-5 if cache_dtype == "f32" else 2e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_decode_equals_last_row_of_causal_flash():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4))
    full = tfa.flash_attention(q, k, v, causal=True)
    dec = tfa.flash_attention_decode(q[:, :, -1], k.transpose(1, 2),
                                     v.transpose(1, 2),
                                     torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(dec.numpy(), full[:, :, -1].numpy(),
                               rtol=2e-5, atol=2e-5)
