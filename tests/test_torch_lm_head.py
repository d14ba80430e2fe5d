"""apex_tpu_torch's fused LM head against apex_tpu's on the CPU.

The same numpy inputs (N 200, H 96, V 1000: off the JAX blocks of 64 tokens
and 128 vocab rows; one row with target -1 and rows whose cotangent is 0)
go through the JAX kernels in Pallas interpret mode (``set_force_pallas``)
and through the port's plain versions of the three CUDA kernels, for each
operand pair: f32/f32, bf16/bf16, bf16 x with f32 W (computed in f32) and
f16/f16 (which JAX routes to its materialized reference, and the port to
its f32 instantiation).  Then the autograd op against ``jax.grad`` of the
JAX op, on its default path and forced through its kernels.  Last, the
rule by which ``chip_smoke.py`` holds the card's dX and dW kernels to
their plain versions is checked against an emulation of the kernels,
exact and with a broken softmax term.

Tolerances: loss and lse 1e-5 (both sides take f32 scores of the same
operands, summed in other orders); an f32 gradient within 1e-5 of its
largest entry, an f16 one within 1e-3 (one f16 ulp of the result); a bf16
gradient within 1e-2 of its largest entry (both round
dS to bf16 and the result once; a dS entry near a rounding boundary may
round the other way after its f32 score moved by a sum order).  Against
the JAX default path (its materialized f32 reference, no rounding of dS)
bf16 gradients are held to 2e-2 of their largest entry.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import lm_head as jlm
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch.ops import fused_linear_cross_entropy as exported
from apex_tpu_torch.ops import lm_head as tlm

ROOT = Path(__file__).resolve().parent.parent
N, H, V = 200, 96, 1000
BLOCKS = dict(block_t=64, block_v=128)
PAIRS = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
         "bf16_x_f32_w": ("bfloat16", "float32"), "f16": ("float16",
                                                          "float16")}


def _kernel_route(pair, force):
    return force and pair != "f16"


def _inputs(pair, force, seed=0):
    """numpy f32 values already rounded to each operand's dtype, targets
    (row 5 at -1 where JAX runs its kernels; its materialized reference
    indexes -1 as the last column) and a cotangent with zero rows."""
    xd, wd = PAIRS[pair]
    rng = np.random.RandomState(seed)
    x = np.asarray(jnp.asarray(rng.randn(N, H), xd).astype(jnp.float32))
    w = np.asarray(jnp.asarray(0.1 * rng.randn(V, H), wd).astype(
        jnp.float32))
    t = rng.randint(0, V, N)
    if _kernel_route(pair, force):
        t[5] = -1
    g = rng.rand(N).astype(np.float32)
    g[7:20] = 0.0
    return x, w, t, g


def _jax(pair, force):
    """JAX loss, lse (None on the reference route) and the vjp's dx, dw."""
    xd, wd = PAIRS[pair]
    x, w, t, g = _inputs(pair, force)
    jx, jw, jt = jnp.asarray(x, xd), jnp.asarray(w, wd), jnp.asarray(t)
    set_force_pallas(True if force else None)
    try:
        lse = None
        if _kernel_route(pair, force):
            _, lse = jlm._fwd_impl(jx, jw, jt, BLOCKS["block_t"],
                                   BLOCKS["block_v"])
            lse = np.asarray(lse)[:N, 0]
        loss, pull = jax.vjp(
            lambda a, b: jlm.fused_linear_cross_entropy(a, b, jt, **BLOCKS),
            jx, jw)
        dx, dw = pull(jnp.asarray(g))
    finally:
        set_force_pallas(None)
    return dict(loss=np.asarray(loss), lse=lse, dx=dx, dw=dw)


def _torch(pair, force=True):
    xd, wd = PAIRS[pair]
    x, w, t, g = _inputs(pair, force)
    return (torch.from_numpy(x).to(getattr(torch, xd)),
            torch.from_numpy(w).to(getattr(torch, wd)), torch.from_numpy(t),
            torch.from_numpy(g))


_CACHE = {}


def _jax_cached(pair, force=True):
    if (pair, force) not in _CACHE:
        _CACHE[pair, force] = _jax(pair, force)
    return _CACHE[pair, force]


def _assert_grad(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _grad_tol(dtype):
    return {torch.bfloat16: 1e-2, torch.float16: 1e-3}.get(dtype, 1e-5)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_fwd_reference_matches_jax_kernel(pair):
    j = _jax_cached(pair)
    x, w, t, _ = _torch(pair)
    loss, lse = tlm.lm_head_fwd_reference(x, w, t)
    assert loss.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), j["loss"], rtol=1e-5,
                               atol=1e-5)
    if j["lse"] is not None:
        np.testing.assert_allclose(lse.numpy(), j["lse"], rtol=1e-5,
                                   atol=1e-5)
    if _kernel_route(pair, True):   # target -1: no column, loss = lse
        assert float(loss[5]) == float(lse[5])


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("part", ["dx", "dw"])
def test_bwd_references_match_jax_kernels(pair, part):
    """lm_head_dx_reference / lm_head_dw_reference against the JAX
    ``_bwd_impl`` (through ``jax.vjp``) with a random cotangent."""
    j = _jax_cached(pair)
    x, w, t, g = _torch(pair)
    _, lse = tlm.lm_head_fwd_reference(x, w, t)
    fn = tlm.lm_head_dx_reference if part == "dx" else \
        tlm.lm_head_dw_reference
    got = fn(x, w, t, lse, g)
    want_dtype = x.dtype if part == "dx" else w.dtype
    assert got.dtype == want_dtype
    _assert_grad(got, j[part], _grad_tol(want_dtype))


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("force", [True, False], ids=["pallas", "default"])
def test_public_op_and_its_grads_match_jax(pair, force):
    """The autograd op (forward, then the dX and dW plain versions) against
    the JAX op's value and ``jax.vjp``, with its kernels forced and on its
    default path (the materialized reference)."""
    j = _jax_cached(pair, force)
    x, w, t, g = _torch(pair, force)
    x.requires_grad_()
    w.requires_grad_()
    loss = exported(x, w, t)
    loss.backward(g)
    assert loss.dtype == torch.float32
    assert x.grad.dtype == x.dtype and w.grad.dtype == w.dtype
    np.testing.assert_allclose(loss.detach().numpy(), j["loss"], rtol=1e-5,
                               atol=1e-5)
    for got, part in ((x.grad, "dx"), (w.grad, "dw")):
        tol = _grad_tol(got.dtype)
        if not force and got.dtype == torch.bfloat16:
            tol = 2e-2          # JAX's reference does not round dS
        _assert_grad(got, j[part], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_materialized_reference_matches_jax(dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(40, 32).astype(np.float32)
    w = rng.randn(50, 32).astype(np.float32)
    t = rng.randint(0, 50, 40)
    want = jlm.fused_linear_cross_entropy_reference(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(t))
    got = tlm.fused_linear_cross_entropy_reference(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(w).to(getattr(torch, dtype)), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_zero_cotangent_rows_add_nothing_to_dw():
    """BERT's unmasked positions: rows with g = 0 leave dW as the rows
    with g != 0 alone make it (f32, bit for bit up to sum order)."""
    x, w, t, g = _torch("f32")
    _, lse = tlm.lm_head_fwd_reference(x, w, t)
    keep = g != 0
    full = tlm.lm_head_dw_reference(x, w, t, lse, g)
    part = tlm.lm_head_dw_reference(x[keep], w, t[keep], lse[keep], g[keep])
    torch.testing.assert_close(full, part, rtol=1e-5, atol=1e-6)


def test_dot_dtype_is_bf16_only_for_a_bf16_pair():
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    assert tlm._dot_dtype(bf, bf) == bf
    for pair in ((bf, f32), (f32, bf), (f32, f32), (f16, f16), (bf, f16)):
        assert tlm._dot_dtype(*pair) == f32
    for xd, wd in PAIRS.values():
        want = jnp.dtype(jlm._dot_dtype(jnp.dtype(xd), jnp.dtype(wd))).name
        got = tlm._dot_dtype(getattr(torch, xd), getattr(torch, wd))
        assert str(got) == "torch." + want


def test_the_port_takes_no_tile_sizes():
    """block_t / block_v select TPU tiles; the port drops them rather than
    accept keywords it would ignore."""
    x, w, t, _ = _torch("f32")
    with pytest.raises(TypeError):
        tlm.fused_linear_cross_entropy(x, w, t, block_t=64)


def test_wrappers_refuse_tensors_their_kernels_do_not_take():
    meta = torch.empty((4, 16), device="meta")
    wm = torch.empty((10, 16), device="meta")
    tm = torch.zeros(4, dtype=torch.long, device="meta")
    rows = torch.empty(4, device="meta")
    for call in (lambda: tlm.lm_head_fwd(meta, wm, tm),
                 lambda: tlm.lm_head_dx(meta, wm, tm, rows, rows),
                 lambda: tlm.lm_head_dw(meta, wm, tm, rows, rows),
                 lambda: tlm.lm_head_bwd(meta, wm, tm, rows, rows)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    with pytest.raises(ValueError, match=r"\(N, H\) and \(V, H\)"):
        tlm.fused_linear_cross_entropy(torch.zeros(4, 16), torch.zeros(10, 8),
                                       torch.zeros(4, dtype=torch.long))


# -- the backward's vocab chunks ---------------------------------------------

@pytest.mark.parametrize("v", [50304, 30528, 30522, 1000])
@pytest.mark.parametrize("n", [8192, 1000, 1])
def test_chunk_plan_covers_the_vocab_on_the_grid(n, v):
    """The chunks cover [0, V) exactly, in order; each dS chunk is on the
    64-column grid (the last padded by less than 64) and within 128 MiB,
    for bf16 and f32 dS."""
    for itemsize in (2, 4):
        plan = tlm.bwd_chunk_plan(n, v, itemsize)
        assert plan.width % tlm.CHUNK_GRID == 0
        assert n * plan.width * itemsize <= tlm.DS_CHUNK_BYTES
        v0s = [c[0] for c in plan.chunks]
        assert v0s == list(range(0, v, plan.width))
        assert sum(c[1] for c in plan.chunks) == v
        for v0, valid, padded in plan.chunks:
            assert 0 < valid <= plan.width and padded <= plan.width
            assert padded % tlm.CHUNK_GRID == 0
            assert 0 <= padded - valid < tlm.CHUNK_GRID
        assert all(c[1] == plan.width for c in plan.chunks[:-1])


def test_chunk_plan_at_the_model_heads():
    """8192 bf16 tokens: at most 8192 columns (128 MiB), 7 chunks of
    GPT-350M's vocab and 4 of BERT-large's; f32 dS halves the width."""
    gpt, bert = tlm.bwd_chunk_plan(8192, 50304, 2), \
        tlm.bwd_chunk_plan(8192, 30528, 2)
    assert (len(gpt.chunks), len(bert.chunks)) == (7, 4)
    assert gpt.width <= 8192 and bert.width <= 8192
    assert tlm.bwd_chunk_plan(8192, 50304, 4).width <= 4096
    assert len(tlm.bwd_chunk_plan(1, 50304, 2).chunks) == 1
    assert gpt.launches("dx") == (14, 0)
    assert gpt.launches("dw") == (0, 14)
    assert gpt.launches("bwd") == (14, 7)


class _FakeLib:
    """Stands in for the kernel library: records apex_lm_head_bwd's
    arguments and launches nothing."""

    def __init__(self):
        self.calls = []

    def apex_lm_head_bwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("call", ["dx", "dw", "bwd"])
@pytest.mark.parametrize("shape", [(8192, 64, 50304), (200, 96, 1000)],
                         ids=["gpt_vocab", "small"])
def test_wrappers_count_the_plans_launches(monkeypatch, call, shape):
    """What a wrapper adds to the counters is its chunk plan's launch
    count, and the C entry gets the plan's width and the outputs asked
    for (meta tensors past the device check; the library a stand-in)."""
    n, h, v = shape
    fake = _FakeLib()
    monkeypatch.setattr(tlm._kernels, "lib", lambda: fake)
    monkeypatch.setattr(tlm._kernels, "stream", lambda: 0)
    monkeypatch.setattr(tlm, "_check_operands",
                        lambda kernel, x, w, t: (t.to(torch.int32), (1, 1)))
    x = torch.empty((n, h), dtype=torch.bfloat16, device="meta")
    w = torch.empty((v, h), dtype=torch.bfloat16, device="meta")
    t = torch.zeros(n, dtype=torch.long, device="meta")
    rows = torch.empty(n, device="meta")
    before = (tlm.lm_head_dx.launches, tlm.lm_head_dw.launches)
    fn = dict(dx=tlm.lm_head_dx, dw=tlm.lm_head_dw, bwd=tlm.lm_head_bwd)
    out = fn[call](x, w, t, rows, rows)
    got = (tlm.lm_head_dx.launches - before[0],
           tlm.lm_head_dw.launches - before[1])
    plan = tlm.bwd_chunk_plan(n, v, 2)
    assert got == plan.launches(call)
    (args,) = fake.calls
    assert args[9:13] == (n, v, h, plan.width)
    want_dx, want_dw = call != "dw", call != "dx"
    assert (args[5] is not None, args[6] is not None) == (want_dx, want_dw)
    assert (args[8] is not None) == (want_dx and len(plan.chunks) > 1)
    shapes = [tuple(o.shape) for o in (out if call == "bwd" else (out,))]
    assert shapes == [(n, h)] * want_dx + [(v, h)] * want_dw


@pytest.mark.parametrize("pair", list(PAIRS))
def test_bwd_reference_is_the_dx_and_dw_pair(pair):
    x, w, t, g = _torch(pair)
    _, lse = tlm.lm_head_fwd_reference(x, w, t)
    dx, dw = tlm.lm_head_bwd_reference(x, w, t, lse, g)
    assert torch.equal(dx, tlm.lm_head_dx_reference(x, w, t, lse, g))
    assert torch.equal(dw, tlm.lm_head_dw_reference(x, w, t, lse, g))


@pytest.mark.parametrize("pair", ["bf16", "f32", "bf16_x_f32_w"])
def test_bwd_reference_matches_jax_bwd_impl(pair):
    """lm_head_bwd_reference against the JAX ``_bwd_impl`` run through its
    Pallas kernels in interpret mode (V = 1000, off the 64-column grid,
    row 5 targeting -1), with the tolerances above."""
    j = _jax_cached(pair)
    x, w, t, g = _torch(pair)
    assert int(t[5]) == -1 and V % 64
    _, lse = tlm.lm_head_fwd_reference(x, w, t)
    dx, dw = tlm.lm_head_bwd_reference(x, w, t, lse, g)
    assert (dx.dtype, dw.dtype) == (x.dtype, w.dtype)
    _assert_grad(dx, j["dx"], _grad_tol(dx.dtype))
    _assert_grad(dw, j["dw"], _grad_tol(dw.dtype))


def _chunked_bwd(x, w, t, lse, g, plan, round_each_chunk):
    """The kernels' chunked backward in plain torch: per chunk dS from the
    chunk's scores (W's rows past V zero, dS's columns past V zero), dX
    summed in f32 across chunks (or, ``round_each_chunk``, rounded to x's
    dtype after each chunk), dW's rows of the chunk.  Returns (dX in x's
    dtype, its f32 sum, dW)."""
    dt = tlm._dot_dtype(x.dtype, w.dtype)
    xo = x.to(dt).float()
    acc = torch.zeros(x.shape, dtype=torch.float32)
    dw = torch.empty_like(w)
    for v0, valid, padded in plan.chunks:
        wc = torch.zeros((padded, w.shape[1]))
        wc[:valid] = w[v0:v0 + valid].to(dt).float()
        p = torch.exp(xo @ wc.t() - lse[:, None])
        cols = v0 + torch.arange(padded)
        hit = (cols[None, :] == t[:, None]).float()
        ds = torch.where(cols[None, :] < v0 + valid, (p - hit) * g[:, None],
                         0.0).to(dt).float()
        acc = acc + ds @ wc
        if round_each_chunk:
            acc = acc.to(x.dtype).float()
        dw[v0:v0 + valid] = (ds.t() @ xo)[:valid].to(w.dtype)
    return acc.to(x.dtype), acc, dw


def test_chunked_backward_sums_dx_in_f32(monkeypatch):
    """A chunked emulation of the plain version over 4 chunks (a 256-column
    width; the last chunk padded from 232 columns) equals the unchunked
    one: dX's f32 sum within 1e-5 of its largest entry (the order of f32
    sums), dX within one bf16 ulp of each entry plus that, dW within 1e-2
    of its largest entry (dS rounded to bf16 from scores summed in another
    order, as ``_grad_tol``).  One that rounds dX to bf16 after each chunk
    misses the f32 bound by orders of magnitude."""
    x, w, t, g = _torch("bf16")
    _, lse = tlm.lm_head_fwd_reference(x, w, t)
    monkeypatch.setattr(tlm, "DS_CHUNK_BYTES", N * 256 * 2)
    plan = tlm.bwd_chunk_plan(N, V, 2)
    assert plan.width == 256 and len(plan.chunks) == 4
    assert plan.chunks[-1][1:] == (232, 256)
    ds, _ = tlm._ds(x, w, t, lse, g)
    want32 = ds @ w.float()
    want_dx, want_dw = tlm.lm_head_bwd_reference(x, w, t, lse, g)
    top = float(want32.abs().max())
    dx, acc, dw = _chunked_bwd(x, w, t, lse, g, plan, False)
    assert float((acc - want32).abs().max()) <= 1e-5 * top
    ulp = 2.0 ** -7
    assert bool(((dx.float() - want_dx.float()).abs()
                 <= ulp * want_dx.float().abs() + 1e-5 * top).all())
    _assert_grad(dw, want_dw.float().numpy(), 1e-2)
    rounded, _, _ = _chunked_bwd(x, w, t, lse, g, plan, True)
    assert float((rounded.float() - want32).abs().max()) > 1e-5 * top * 30


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)],
                         ids=["both", "dx", "dw"])
def test_autograd_takes_one_backward_call(monkeypatch, need):
    """Both gradients come from one lm_head_bwd (dS once); one alone from
    lm_head_dx or lm_head_dw (on the CPU: their plain versions)."""
    calls = []
    for name in ("lm_head_bwd_reference", "lm_head_dx_reference",
                 "lm_head_dw_reference"):
        fn = getattr(tlm, name)
        monkeypatch.setattr(tlm, name, lambda *a, _fn=fn, _name=name: (
            calls.append(_name), _fn(*a))[1])
    x, w, t, g = _torch("f32")
    x.requires_grad_(need[0])
    w.requires_grad_(need[1])
    tlm.fused_linear_cross_entropy(x, w, t).backward(g)
    want = {(True, True): ["lm_head_bwd_reference"],
            (True, False): ["lm_head_dx_reference"],
            (False, True): ["lm_head_dw_reference"]}[need]
    assert calls == want
    _, lse = tlm.lm_head_fwd_reference(x.detach(), w.detach(), t)
    ref = tlm.lm_head_bwd_reference(x.detach(), w.detach(), t, lse, g)
    for leaf, r, needed in zip((x, w), ref, need):
        assert (leaf.grad is not None) == needed
        if needed:
            assert torch.equal(leaf.grad, r)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The card script (it imports torch and numpy only), for the rule its
    phase 2 holds the dX and dW kernels to."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _emulated_kernel_grads(x, w, t, lse, g, fault):
    """The bf16 kernels' dX and dW with the scores and both products summed
    in f64 (another summation than the plain versions'), dS rounded to
    bf16 from f32; ``fault`` breaks the softmax term p."""
    s = (x.double() @ w.double().t()).float().double()
    row_lse = lse.double()[:, None]
    if fault == "next_row_lse":
        row_lse = torch.roll(row_lse, 1, 0)
    p = torch.exp(s - row_lse)
    if fault == "drop_p":
        p = torch.zeros_like(p)
    elif fault == "half_p":
        p = p / 2
    hit = (torch.arange(w.shape[0])[None, :] == t[:, None]).double()
    ds = ((p - hit) * g.double()[:, None]).float().bfloat16().double()
    return (ds @ w.double()).bfloat16(), (ds.t() @ x.double()).bfloat16()


@pytest.mark.parametrize("fault", [None, "drop_p", "half_p", "next_row_lse"],
                         ids=["exact", "drop_p", "half_p", "next_row_lse"])
@pytest.mark.parametrize("w_std", [0.02, 0.2], ids=["flat", "peaked"])
def test_card_gradient_rule_rejects_a_wrong_softmax_term(w_std, fault):
    """chip_smoke.py holds the dX and dW kernels to their plain versions
    entry by entry (one ulp, plus dS-rounding and summation-order slack).
    A stand-in for the kernels that sums in another order passes it; one
    whose softmax term is dropped, halved or takes the next row's lse
    fails it, with the embedding's N(0, 0.02) init (p near 1/V) and with
    a peaked softmax (scores' std 3.2)."""
    card = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    n, h, v = 96, 256, 4096
    x = torch.randn(n, h, generator=gen).bfloat16()
    w = (w_std * torch.randn(v, h, generator=gen)).bfloat16()
    t = torch.randint(0, v, (n,), generator=gen)
    t[3] = -1
    g = (torch.rand(n, generator=gen) < 0.5).float()
    _, lse = tlm.lm_head_fwd_reference(x, w, t)
    rdx = tlm.lm_head_dx_reference(x, w, t, lse, g)
    rdw = tlm.lm_head_dw_reference(x, w, t, lse, g)
    dx, dw = _emulated_kernel_grads(x, w, t, lse, g, fault)
    sx, sw = card._lm_head_grad_bounds(x, w, t, lse, g, True)
    rows = card._no_target_rows(v, t, g)
    verdicts = []
    for name, got, ref, slack, only in (("dx", dx, rdx, sx, None),
                                        ("dw", dw, rdw, sw, rows)):
        try:
            card.check_entrywise(name, got, ref, slack, only)
            verdicts.append(True)
        except AssertionError:
            verdicts.append(False)
    if fault is None:
        assert verdicts == [True, True]
    else:
        assert not all(verdicts), fault


def test_card_expected_launches_come_from_the_chunk_plan():
    """Phases 5 / 5f and 7 / 7f expect, per micro-batch, one lm_head_bwd
    on bf16 operands: 14 dS + dX and 7 dW launches at GPT-350M's head
    (7 chunks), 8 and 4 at BERT-large's (4 chunks)."""
    card = _chip_smoke()
    assert card.lm_head_bwd_launches(8, 8192, 50304) == {
        "lm_head_dx": 8 * 14, "lm_head_dw": 8 * 7}
    assert card.lm_head_bwd_launches(8, 8192, 30528) == {
        "lm_head_dx": 8 * 8, "lm_head_dw": 8 * 4}


@pytest.mark.parametrize("epilogue,cls", [("DsFromScores", "lm_head_dx"),
                                          ("DxOut", "lm_head_dx"),
                                          ("DwOut", "lm_head_dw")])
def test_card_profile_files_the_backward_gemm_launches(epilogue, cls):
    """The profiler files the backward's GEMM launches under #9 and #10 by
    their epilogue type, apart from the FFN's of the same names."""
    card = _chip_smoke()
    name = ("void apex_tpu_torch::gemm::gemm_tma_kernel<256, false, true, "
            f"apex_tpu_torch::lm_head::{epilogue}>(CUtensorMap, CUtensorMap, "
            f"int, apex_tpu_torch::lm_head::{epilogue})")
    assert card._kernel_class(name) == cls
    assert card._kernel_class(name.replace("lm_head::", "ffn::")) != cls


# -- the forward at any hidden size, and its row partials -------------------

@pytest.mark.parametrize("h", [1600, 100], ids=["gpt2_xl_width", "h100"])
@pytest.mark.parametrize("pair", ["bf16", "f32"])
def test_fwd_reference_matches_jax_kernel_at_any_hidden_size(pair, h):
    """lm_head_fwd_reference against the JAX ``_fwd_kernel`` in Pallas
    interpret mode at GPT-2 XL's hidden size and at one off the 8-element
    grid (the card's forward takes both since its product runs on the
    GEMM), V = 300 off the 128-column vocab blocks, row 5 targeting -1."""
    xd, wd = PAIRS[pair]
    n, v = 40, 300
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(n, h), xd)
    w = jnp.asarray(0.1 * rng.randn(v, h), wd)
    t = rng.randint(0, v, n)
    t[5] = -1
    set_force_pallas(True)
    try:
        _, jlse = jlm._fwd_impl(x, w, jnp.asarray(t), BLOCKS["block_t"],
                                BLOCKS["block_v"])
        jloss = jlm.fused_linear_cross_entropy(x, w, jnp.asarray(t),
                                               **BLOCKS)
    finally:
        set_force_pallas(None)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, xd))
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).to(
        getattr(torch, wd))
    loss, lse = tlm.lm_head_fwd_reference(tx, tw, torch.from_numpy(t))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:n, 0],
                               rtol=1e-5, atol=1e-5)
    assert float(loss[5]) == float(lse[5])


LOG2E = 1.4426950408889634


def _tile_partials_fwd(x, w, t, cols, mask=True):
    """The card's forward in plain torch: the product's scores in column
    tiles of ``cols`` (W's rows past V read as zeros, as TMA and the FMA
    tile read them), per (row, tile) the partial (m, l, t) over the tile's
    columns below V (all its columns when ``mask`` is False) with l from
    exp2 of log2(e)-scaled scores, then the combine in ascending tile
    order.  Returns (loss, lse)."""
    s, _ = tlm._scores(x, w)
    n, v = s.shape
    tiles = -(-v // cols)
    padded = torch.zeros((n, tiles * cols))
    padded[:, :v] = s
    col = torch.arange(tiles * cols)
    valid = col < v if mask else torch.ones(tiles * cols, dtype=torch.bool)
    hit = (col[None, :] == t[:, None]) & (col < v)[None, :]
    m = torch.full((n,), -1e30)
    parts = []
    for k in range(tiles):
        sl = slice(k * cols, (k + 1) * cols)
        sk = padded[:, sl]
        ok = valid[sl][None, :]
        mk = torch.where(ok, sk, -1e30).max(dim=1).values
        e = torch.exp2(sk * LOG2E - (mk * LOG2E)[:, None])
        lk = torch.where(ok, e, 0.0).sum(dim=1)
        tk = torch.where(hit[:, sl] & ok, sk, 0.0).sum(dim=1)
        parts.append((mk, lk, tk))
        m = torch.maximum(m, mk)
    l = torch.zeros(n)
    tgt = torch.zeros(n)
    for mk, lk, tk in parts:
        l = l + lk * torch.exp(mk - m)
        tgt = tgt + tk
    l = torch.where(l == 0, 1.0, l)
    lse = m + torch.log(l)
    return lse - tgt, lse


def _fwd_inputs(v, seed=0, n=24, h=64):
    """bf16 x and W (W as the tied embedding's N(0, 0.02) rows), random
    targets with row 1 in the last vocab column (the last, partly valid
    tile where V is off the tile grid) and row 2 at -1."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, generator=gen).bfloat16()
    w = (0.02 * torch.randn(v, h, generator=gen)).bfloat16()
    t = torch.randint(0, v, (n,), generator=gen)
    t[1], t[2] = v - 1, -1
    return x, w, t


@pytest.mark.parametrize("cols", [256, 128], ids=["tma_tiles", "fma_tiles"])
@pytest.mark.parametrize("v", [1000, 30522, 50304])
def test_tile_partials_combine_to_the_plain_forward(v, cols):
    """The forward's design (per-tile row partials of 256 columns on the
    TMA route, 128 on the FMA tile, masked past V, combined in tile
    order) gives the plain version's loss and lse within 1e-6 relative,
    with a target in the last tile and one at -1 (loss = lse)."""
    x, w, t = _fwd_inputs(v)
    loss, lse = _tile_partials_fwd(x, w, t, cols)
    rloss, rlse = tlm.lm_head_fwd_reference(x, w, t)
    torch.testing.assert_close(loss, rloss, rtol=1e-6, atol=0)
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=0)
    assert float(loss[2]) == float(lse[2])


@pytest.mark.parametrize("v,cols", [(1000, 256), (1000, 128), (30522, 256),
                                    (30522, 128), (50304, 256)])
def test_tile_partials_without_the_column_mask_miss(v, cols):
    """Left unmasked, the zero scores of the last tile's columns past V
    (TMA zero-fills W's missing rows) add to l: loss and lse then miss the
    plain version by more than 100x the 1e-6 the masked partials keep (V
    off the tile grid; 50304 is a multiple of 128)."""
    x, w, t = _fwd_inputs(v)
    loss, lse = _tile_partials_fwd(x, w, t, cols, mask=False)
    rloss, rlse = tlm.lm_head_fwd_reference(x, w, t)
    for got, ref in ((loss, rloss), (lse, rlse)):
        assert float(((got - ref).abs() / ref.abs()).max()) > 100 * 1e-6


def _gemm_constant(name):
    """An ``int`` constant of csrc/gemm.cuh."""
    import re
    src = (ROOT / "apex_tpu_torch" / "csrc" / "gemm.cuh").read_text()
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


class _FakeFwdLib:
    """Stands in for the kernel library: answers apex_lm_head_fwd_tiles as
    gemm() routes the product (TMA tiles for bf16 operands with rows of
    16-byte multiples on aligned bases, else the FMA tile's; widths read
    from csrc/gemm.cuh) and records apex_lm_head_fwd's arguments."""

    def __init__(self):
        self.queries, self.calls = [], []

    def apex_lm_head_fwd_tiles(self, x, w, v, h, code):
        self.queries.append((v, h, code))
        tma = code == 1 and h > 0 and h % 8 == 0 and x % 16 == 0 \
            and w % 16 == 0
        cols = _gemm_constant("kRowsBN") if tma else _gemm_constant("kFmaBN")
        return -(-v // cols)

    def apex_lm_head_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("v,tma_tiles,fma_tiles",
                         [(50304, 197, 393), (30528, 120, 239),
                          (1000, 4, 8)])
@pytest.mark.parametrize("route", ["bf16", "f32", "bf16_x_f32_w", "f16",
                                   "bf16_h100"])
def test_fwd_wrapper_asks_the_tile_count_of_its_route(monkeypatch, route, v,
                                                      tma_tiles, fma_tiles):
    """The forward's partials scratch is (3, tiles, N) for the tile count
    the C side gives for the operands the wrapper passes: bf16 for a bf16
    pair (the TMA route's 256-column tiles at H 64, the FMA tile's 128 at
    H 100), f32 for every other pair (the FMA tile); two launches counted
    (meta tensors past the device check; the library a stand-in)."""
    n = 8
    pair = "bf16" if route == "bf16_h100" else route
    h = 100 if route == "bf16_h100" else 64
    xd, wd = PAIRS[pair]
    fake = _FakeFwdLib()
    monkeypatch.setattr(tlm._kernels, "lib", lambda: fake)
    monkeypatch.setattr(tlm._kernels, "stream", lambda: 0)
    monkeypatch.setattr(tlm, "_check_operands",
                        lambda kernel, x, w, t: (t.to(torch.int32), (1, 1)))
    shapes = []
    empty = torch.empty
    monkeypatch.setattr(tlm.torch, "empty", lambda *a, **k: (
        shapes.append(tuple(a[0]) if isinstance(a[0], tuple) else a),
        empty(*a, **k))[1])
    x = torch.empty((n, h), dtype=getattr(torch, xd), device="meta")
    w = torch.empty((v, h), dtype=getattr(torch, wd), device="meta")
    t = torch.zeros(n, dtype=torch.long, device="meta")
    before = tlm.lm_head_fwd.launches
    loss, lse = tlm.lm_head_fwd(x, w, t)
    assert tlm.lm_head_fwd.launches - before == 2
    code = 1 if pair == "bf16" else 0
    want = tma_tiles if route == "bf16" else fma_tiles
    assert fake.queries == [(v, h, code)]
    (args,) = fake.calls
    assert args[6:11] == (n, v, h, want, code)
    assert (3, want, n) in shapes
    assert loss.shape == lse.shape == (n,)


@pytest.mark.parametrize("name", [
    "void apex_tpu_torch::gemm::gemm_tma_rows_kernel<apex_tpu_torch::"
    "lm_head::LseFromScores>(CUtensorMap, CUtensorMap, CUtensorMap, int, "
    "int, int, apex_tpu_torch::lm_head::LseFromScores)",
    "void apex_tpu_torch::gemm::gemm_fma_kernel<false, false, "
    "apex_tpu_torch::lm_head::LseFromScores>(void const*, void const*, int, "
    "int, int, int, int, apex_tpu_torch::lm_head::LseFromScores)",
    "apex_tpu_torch::lm_head::lm_head_fwd_combine_kernel(float const*, "
    "float*, float*, int, int)"], ids=["tma", "fma", "combine"])
def test_card_profile_files_the_forward_launches(name):
    """The profiler files the forward's product (by its epilogue type, on
    either route) and its combine under #8."""
    assert _chip_smoke()._kernel_class(name) == "lm_head_fwd"
