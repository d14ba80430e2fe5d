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


def _qkv(seed, seq=S, dim=D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, seq, dim).astype(np.float32) for _ in range(3)]


# s = 72 is one whole 64-row tile of the card's tensor-core kernels and a
# partial one: the ragged edges chip_smoke.py holds the kernels to, against
# these plain versions, at head_dim 16 and 32
_FWD_CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(causal=False),
    "kv_seqlens": dict(causal=False, lens=[S, 13]),
    "causal_s72_d16": dict(causal=True, seq=72, dim=16),
    "causal_s72_d32": dict(causal=True, seq=72, dim=32),
    "non_causal_s72_d32": dict(causal=False, seq=72, dim=32),
    "kv_seqlens_s72_d32": dict(causal=False, seq=72, dim=32, lens=[50, 0]),
}


@pytest.mark.parametrize("case", list(_FWD_CASES))
def test_flash_attention_matches_jax(jax_path, case):
    c = _FWD_CASES[case]
    q, k, v = _qkv(0, c.get("seq", S), c.get("dim", D))
    lens = None if "lens" not in c else np.array(c["lens"], np.int32)
    causal = c["causal"]
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


@pytest.mark.parametrize(
    "dropout,seq,dim",
    [(0.0, S, D), (0.1, S, D), (0.0, 72, 16), (0.1, 72, 16), (0.0, 72, 32),
     (0.1, 72, 32)],
    ids=["0.0", "0.1", "s72_d16", "s72_d16-0.1", "s72_d32", "s72_d32-0.1"])
def test_flash_grads_bf16_match_jax(jax_path, dropout, seq, dim):
    q, k, v = _qkv(7, seq, dim)
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


# The card's tensor-core dq kernel works on 64-row query tiles and 64-key
# tiles: one row, one short of and one past a tile, and a ragged 200; head
# dims 16 / 32 / 64; kv_seqlens holding 0 and a length past one key tile;
# dropout 0.1.  JAX's ``_dq_kernel`` runs in interpret mode with 64-row
# blocks (its tiles then fall where the card's do) and its forward's own lse
# and output; the port's plain dq version takes the same lse and delta.
# (seq, head_dim, causal, kv_seqlens, dropout, dtype)
_DQ_EDGE_CASES = {
    **{f"causal_s{s}_d{d}": (s, d, True, None, 0.0, "f32")
       for s in (1, 63, 65, 200) for d in (16, 32, 64)},
    "non_causal_s1_d64": (1, 64, False, None, 0.0, "f32"),
    "non_causal_s63_d16": (63, 16, False, None, 0.0, "f32"),
    "non_causal_s65_d32": (65, 32, False, None, 0.0, "f32"),
    "non_causal_s200_d64": (200, 64, False, None, 0.0, "f32"),
    "kv_seqlens_s65_d32": (65, 32, False, [0, 65], 0.0, "f32"),
    "kv_seqlens_causal_s200_d16": (200, 16, True, [130, 0], 0.0, "f32"),
    "dropout_causal_s63_d64": (63, 64, True, None, 0.1, "f32"),
    "dropout_causal_s200_d32": (200, 32, True, None, 0.1, "f32"),
    "dropout_kv_seqlens_s65_d16": (65, 16, False, [70, 0], 0.1, "f32"),
    "bf16_causal_s200_d64": (200, 64, True, None, 0.0, "bf16"),
    "bf16_dropout_causal_s65_d64": (65, 64, True, None, 0.1, "bf16"),
    "bf16_kv_seqlens_s200_d32": (200, 32, False, [0, 77], 0.0, "bf16"),
}


@pytest.mark.parametrize("case", list(_DQ_EDGE_CASES))
def test_dq_plain_version_matches_the_jax_kernel_at_tile_edges(case):
    """f32: 1e-5 of the largest |dq| (the same f32 products summed in
    another order, head_dim zero-padded to 128 on the JAX side), or 1e-5
    where dq is below 1 (one key under the causal mask: dS = p (dP - delta)
    cancels to rounding noise, ~5e-7).  bf16: 1e-2 of it (both round dS to
    bf16 at the same place and dq to bf16 at the end; an entry near a
    rounding midpoint may round the other way after its f32 sum moved by
    the order of summation, and one bf16 ulp is 2**-8 relative)."""
    seq, dim, causal, lens, rate, dt = _DQ_EDGE_CASES[case]
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.RandomState(31)
    q, k, v, do = (rng.randn(B, H, seq, dim).astype(np.float32)
                   for _ in range(4))
    scale = dim ** -0.5
    seed = 5 if rate else None
    jlens = jnp.asarray(np.array(lens if lens else [seq] * B, np.int32))
    masked = bool(causal or lens or seq % 64)
    set_force_pallas(True)
    try:
        out, res = jfa._flash_vjp_fwd(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), jlens,
            jnp.full((1,), 0 if seed is None else seed, jnp.int32), causal,
            scale, 64, 64, rate, masked)
        ref = jfa._flash_vjp_bwd(causal, scale, 64, 64, rate, masked, res,
                                 jnp.asarray(do, jdt))[0]
    finally:
        set_force_pallas(None)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    o = torch.from_numpy(np.array(out, np.float32))
    lse = torch.from_numpy(np.array(res[6][:, :seq, 0]))
    delta = (tdo.float() * o).sum(-1).reshape(B * H, seq)
    got = tfa.flash_attention_dq(
        tq, tk, tv, tdo, lse, delta, causal, scale,
        None if lens is None else torch.tensor(lens), rate, seed)
    assert got.dtype == tdt
    want = np.asarray(ref, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    tol = 1e-5 if dt == "f32" else 1e-2
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def _split_views(hd, last=None):
    """q, k, v as the models pass them: (b, h, s, hd) views of one
    (b, s, h, 3*hd) projection (``last`` widens its last axis), and a dO
    laid out as autograd returns it."""
    qkv = torch.zeros(2, 9, 3, last or 3 * hd, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * hd:(i + 1) * hd].transpose(1, 2)
               for i in range(3))
    do = torch.zeros(2, 9, 3, hd, dtype=torch.bfloat16).transpose(1, 2)
    return qkv, dict(q=q, k=k, v=v, do=do)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_alignment_check_takes_the_models_split_views(hd):
    """The bf16 kernels stage q, k, v and dO with 16-byte cp.async copies;
    the model's split projection meets their alignment rule."""
    _, ops = _split_views(hd)
    assert not ops["q"].is_contiguous()
    tfa._check_aligned("flash_fwd", **ops)
    tfa._check_aligned("flash_attention_dkv", **ops)


@pytest.mark.parametrize("name", ["q", "k", "v", "do"])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_alignment_check_refuses_a_one_element_offset(hd, name):
    qkv, ops = _split_views(hd)
    ops[name] = qkv[..., 1:1 + hd].transpose(1, 2)
    with pytest.raises(ValueError,
                       match=rf"^flash_attention_dq: {name} must start on a "
                             "16-byte boundary"):
        tfa._check_aligned("flash_attention_dq", **ops)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_alignment_check_refuses_strides_off_8_elements(hd):
    """A projection one element wider keeps the base aligned but puts the
    seq and head strides off a multiple of 8 elements."""
    _, ops = _split_views(hd, last=3 * hd + 1)
    with pytest.raises(ValueError, match=r"^flash_fwd: q's batch, head and "
                                         r"seq strides must be multiples"):
        tfa._check_aligned("flash_fwd", **ops)
    # an axis of length one takes any stride: it is never stepped
    one = torch.zeros(8 * hd, dtype=torch.bfloat16).as_strided(
        (1, 1, 8, hd), (5, 3, hd, 1))
    tfa._check_aligned("flash_fwd", q=one)


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


# The card's decode kernels cut a row at 0, DECODE_SPLIT, 2 DECODE_SPLIT,
# ...: lengths on each side of a chunk edge, a row with no key, the whole
# cache and a length past it.  S is a multiple of 128, where the JAX
# kernel pads no position (a padded one would count as a key below len).
_EDGE_S = 3 * tfa.DECODE_SPLIT
_EDGE_LENS = [0, 1, tfa.DECODE_SPLIT - 1, tfa.DECODE_SPLIT,
              tfa.DECODE_SPLIT + 1, _EDGE_S, _EDGE_S + 100]


@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_decode_matches_jax_at_the_chunk_edges(jax_path, cache_dtype):
    """The lengths of ``_EDGE_LENS`` over a strided ring view: f32 within
    2e-5, a bf16 cache within 2e-2 (as above); a row of length 0 is 0."""
    b, h, d, layers = len(_EDGE_LENS), 2, 32, 2
    rng = np.random.RandomState(5)
    q = rng.randn(b, h, d).astype(np.float32)
    ring = rng.randn(b, layers, 2, _EDGE_S, h, d).astype(np.float32)
    lens = np.array(_EDGE_LENS, np.int32)
    jdt = jnp.bfloat16 if cache_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if cache_dtype == "bf16" else torch.float32
    ref = jfa.flash_attention_decode(
        jnp.asarray(q), jnp.asarray(ring[:, 0, 0], jdt),
        jnp.asarray(ring[:, 0, 1], jdt), jnp.asarray(lens))
    tring = torch.from_numpy(ring).to(tdt)
    out = tfa.flash_attention_decode(torch.from_numpy(q), tring[:, 0, 0],
                                     tring[:, 0, 1], torch.from_numpy(lens))
    tol = 2e-5 if cache_dtype == "f32" else 2e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    assert not out[0].any()


def test_decode_equals_last_row_of_causal_flash():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4))
    full = tfa.flash_attention(q, k, v, causal=True)
    dec = tfa.flash_attention_decode(q[:, :, -1], k.transpose(1, 2),
                                     v.transpose(1, 2),
                                     torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(dec.numpy(), full[:, :, -1].numpy(),
                               rtol=2e-5, atol=2e-5)
