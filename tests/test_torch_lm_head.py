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
                 lambda: tlm.lm_head_dw(meta, wm, tm, rows, rows)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    with pytest.raises(ValueError, match=r"\(N, H\) and \(V, H\)"):
        tlm.fused_linear_cross_entropy(torch.zeros(4, 16), torch.zeros(10, 8),
                                       torch.zeros(4, dtype=torch.long))


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
