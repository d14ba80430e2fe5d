"""apex_tpu_torch's fused bias-GELU FFN against apex_tpu's on the CPU.

The same numpy inputs (m 200, k 96, f 320, n 80: off the JAX kernels'
128-lane padding and, with block_m = block_f = 128, over two token blocks
and three ffn blocks) go through the JAX kernels in Pallas interpret mode
(``set_force_pallas``) and through the port's plain versions of the three
CUDA kernels, for each operand pair: f32/f32, bf16/bf16 and bf16 x with
f32 W (the GPT models' bf16 activations with f32 parameters).  Then the
autograd op against ``jax.grad`` of the JAX op, forced through its kernels
and on its default (unfused) path, with a 3-D input and without b2; the
``mlp`` and ``fused_dense`` modules on and off the fused path; the JAX
refusals.  Last, the rule by which ``chip_smoke.py`` holds the card's
kernels to their plain versions is checked against an emulation of the
kernels, exact and with three likely faults.

Tolerances, each against the largest entry of the JAX output: f32 1e-5
(the same f32 products summed in another order); bf16 outputs and the
gradients of bf16 operands 1e-2 (both sides round h, dz and the output to
bf16 at the same places; an entry near a rounding midpoint may round the
other way after its f32 sum moved by the order of summation, one bf16 ulp
is 2**-8 relative); the f32 gradients of f32 weights under bf16
activations 1e-4 (f32 sums of the same bf16-rounded terms).  Against the
JAX default path, which rounds after each unfused op (x @ W1 and its bias
in bf16 before the GELU), bf16 results are held to 3e-2.
"""

import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import fused_dense as jfd
from apex_tpu import mlp as jmlp
from apex_tpu.ops import fused_ffn as jffn
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch import convert
from apex_tpu_torch import fused_dense as tfd
from apex_tpu_torch import mlp as tmlp
from apex_tpu_torch.ops import fused_ffn as exported

tffn = importlib.import_module("apex_tpu_torch.ops.fused_ffn")

ROOT = Path(__file__).resolve().parent.parent
M, K, F_, N = 200, 96, 320, 80
BLOCKS = (128, 128)
PAIRS = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
         "bf16_x_f32_w": ("bfloat16", "float32")}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(pair, what="act"):
    if pair == "f32":
        return 1e-5
    if what == "f32_weight" and PAIRS[pair][1] == "float32":
        return 1e-4
    return 1e-2


def _inputs(pair, seed=0, m=M):
    """numpy f32 values already rounded to each operand's dtype."""
    xd, wd = PAIRS[pair]
    rng = np.random.RandomState(seed)

    def rnd(a, d):
        return np.array(jnp.asarray(a, d).astype(jnp.float32))
    return dict(x=rnd(rng.randn(m, K), xd),
                w1=rnd(rng.randn(F_, K) / np.sqrt(K), wd),
                b1=rnd(0.1 * rng.randn(F_), wd),
                w2=rnd(rng.randn(N, F_) / np.sqrt(F_), wd),
                b2=rnd(0.1 * rng.randn(N), wd),
                dy=rnd(rng.randn(m, N), xd))


def _j(a, d):
    return jnp.asarray(a, d)


def _t(a, d):
    return torch.from_numpy(np.array(a)).to(TORCH[d])


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(name, got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{name}: max |diff| / max |ref| = {err:.3e} > {tol}"


@functools.lru_cache(maxsize=None)
def _jax_kernels(pair):
    """The JAX kernels in interpret mode: (y, z1, dx, dw1, db1, dw2)."""
    xd, wd = PAIRS[pair]
    a = _inputs(pair)
    set_force_pallas(True)
    try:
        y, res = jffn._ffn_vjp_fwd(_j(a["x"], xd), _j(a["w1"], wd),
                                   _j(a["b1"], wd), _j(a["w2"], wd),
                                   _j(a["b2"], wd), *BLOCKS)
        dx, dw1, db1, dw2, _ = jffn._ffn_vjp_bwd(*BLOCKS, res,
                                                 _j(a["dy"], xd))
    finally:
        set_force_pallas(None)
    z1 = res[5][:M, :F_]
    return tuple(_np(v) for v in (y, z1, dx, dw1, db1, dw2))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_forward_plain_version_matches_the_jax_kernel(pair):
    xd, wd = PAIRS[pair]
    a = _inputs(pair)
    y, z1 = tffn.ffn_fwd_reference(_t(a["x"], xd), _t(a["w1"], wd),
                                   _t(a["b1"], wd), _t(a["w2"], wd),
                                   _t(a["b2"], wd))
    jy, jz1 = _jax_kernels(pair)[:2]
    assert y.dtype == z1.dtype == TORCH[xd]
    _close("y", y, jy, _tol(pair))
    _close("z1", z1, jz1, _tol(pair))


@pytest.mark.parametrize("pair", list(PAIRS))
def test_backward_plain_versions_match_the_jax_kernels(pair):
    """dx and dW from the JAX kernel's own z1, as the backward reads it."""
    xd, wd = PAIRS[pair]
    a = _inputs(pair)
    _, jz1, jdx, jdw1, jdb1, jdw2 = _jax_kernels(pair)
    z1 = _t(jz1, xd)
    dy, x = _t(a["dy"], xd), _t(a["x"], xd)
    w1, w2 = _t(a["w1"], wd), _t(a["w2"], wd)
    dx = tffn.ffn_dx_reference(dy, z1, w1, w2)
    dw1, db1, dw2 = tffn.ffn_dw_reference(x, dy, z1, w1, w2)
    assert dx.dtype == TORCH[xd] and db1.dtype == torch.float32
    assert dw1.dtype == dw2.dtype == TORCH[wd]
    _close("dx", dx, jdx, _tol(pair))
    _close("dw1", dw1, jdw1, _tol(pair, "f32_weight"))
    _close("db1", db1, jdb1, _tol(pair, "f32_weight"))
    _close("dw2", dw2, jdw2, _tol(pair, "f32_weight"))


def _jax_grads(pair, force, lead, with_b2):
    """JAX fused_ffn's output and its gradients w.r.t. every operand under
    the cotangent dy."""
    xd, wd = PAIRS[pair]
    a = _inputs(pair, m=int(np.prod(lead)))
    x = _j(a["x"], xd).reshape(lead + (K,))
    dy = _j(a["dy"], xd).reshape(lead + (N,))
    ops = [_j(a[k], wd) for k in ("w1", "b1", "w2", "b2")]
    if not with_b2:
        ops = ops[:3]

    def f(x, *w):
        return jffn.fused_ffn(x, *w, block_m=BLOCKS[0], block_f=BLOCKS[1])
    set_force_pallas(True if force else None)
    try:
        y, vjp = jax.vjp(f, x, *ops)
        grads = vjp(dy)
    finally:
        set_force_pallas(None)
    return y, grads


def _port_grads(pair, lead, with_b2):
    xd, wd = PAIRS[pair]
    a = _inputs(pair, m=int(np.prod(lead)))
    x = _t(a["x"], xd).reshape(lead + (K,)).requires_grad_()
    ops = [_t(a[k], wd).requires_grad_() for k in ("w1", "b1", "w2", "b2")]
    if not with_b2:
        ops = ops[:3]
    y = exported(x, *ops)
    y.backward(_t(a["dy"], xd).reshape(lead + (N,)))
    return y, [x.grad] + [o.grad for o in ops]


_OP_CASES = [pytest.param(pair, force, lead, with_b2,
                          id=f"{pair}-{'kernels' if force else 'default'}"
                             f"-{len(lead) + 1}d{'' if with_b2 else '-no_b2'}")
             for pair in PAIRS for force in (True, False)
             for lead, with_b2 in (((M,), True), ((8, 25), False))]


@pytest.mark.parametrize("pair,force,lead,with_b2", _OP_CASES)
def test_autograd_op_matches_jax_grad(pair, force, lead, with_b2):
    jy, jg = _jax_grads(pair, force, lead, with_b2)
    ty, tg = _port_grads(pair, lead, with_b2)
    loose = not force and pair != "f32"
    names = ["dx", "dw1", "db1", "dw2", "db2"]
    _close("y", ty, jy, 3e-2 if loose else _tol(pair))
    for name, got, want in zip(names, tg, jg):
        assert got.dtype == TORCH[PAIRS[pair][0 if name == "dx" else 1]]
        _close(name, got, want, 3e-2 if loose else _tol(pair, "f32_weight"))


def test_public_op_validates_like_jax():
    x, w1, b1 = torch.zeros(4, 8), torch.zeros(16, 8), torch.zeros(16)
    w2, b2 = torch.zeros(6, 16), torch.zeros(6)
    bad = [((torch.zeros(4, 7), w1, b1, w2, b2), "x features"),
           ((x, w1, torch.zeros(15), w2, b2), "b1 shape"),
           ((x, w1, b1, torch.zeros(6, 15), b2), "w2 in-dim"),
           ((x, w1, b1, w2, torch.zeros(5)), "b2 shape")]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            jffn.fused_ffn(*(jnp.asarray(a.numpy()) for a in args))
        with pytest.raises(ValueError, match=msg):
            exported(*args)
    with pytest.raises(NotImplementedError, match="multi-GPU slice"):
        tffn.fused_ffn_tp(x, w1, b1, w2, b2, tensor_parallel_size=2)
    y = tffn.fused_ffn_tp(x, w1, b1, w2, b2)
    assert y.shape == (4, 6)
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        exported(meta, w1, b1, w2, b2)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("module", ["mlp", "fused_dense_gelu_dense"])
def test_modules_match_jax(module, fused):
    """The same JAX ``init_params`` through the JAX module and the port's
    (weights carried with the converters), f32."""
    x = np.random.RandomState(3).randn(5, 7, K).astype(np.float32)
    if module == "mlp":
        jm = jmlp.MLP([K, F_, N], activation="gelu", fused_ffn=fused)
        tm = tmlp.MLP([K, F_, N], activation="gelu", fused_ffn=fused,
                      device="cpu")
        conv = convert.mlp_params_from_jax
    else:
        jm = jfd.FusedDenseGeluDense(K, F_, N, fused_ffn=fused)
        tm = tfd.FusedDenseGeluDense(K, F_, N, fused_ffn=fused, device="cpu")
        conv = convert.fused_dense_params_from_jax
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init_params(jax.random.PRNGKey(0)))
    tm.load_state_dict(conv(params, tm))
    _close(module, tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)),
           1e-5)


def test_mlp_and_fused_dense_keep_jax_refusals_and_plain_paths():
    rng = np.random.RandomState(4)
    params = {"weights": [rng.randn(F_, K).astype(np.float32),
                          rng.randn(N, F_).astype(np.float32)],
              "biases": [rng.randn(F_).astype(np.float32),
                         rng.randn(N).astype(np.float32)]}
    x = rng.randn(6, K).astype(np.float32)
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    for act in ("none", "relu", "sigmoid", "gelu"):
        _close(act, tmlp.mlp_forward(tparams, torch.from_numpy(x), act),
               jmlp.mlp_forward(params, jnp.asarray(x), act), 1e-5)
    three = {"weights": params["weights"] + [rng.randn(4, N).astype(
        np.float32)], "biases": params["biases"] + [np.zeros(4, np.float32)]}
    refused = [(three, "gelu"), (params, "relu"),
               ({"weights": params["weights"]}, "gelu")]
    for p, act in refused:
        with pytest.raises(ValueError, match="2-layer biased GELU"):
            jmlp.mlp_forward(p, jnp.asarray(x), act, fused_ffn=True)
        with pytest.raises(ValueError, match="2-layer biased GELU"):
            tmlp.mlp_forward(jax.tree_util.tree_map(torch.from_numpy, p),
                             torch.from_numpy(x), act, fused_ffn=True)
    with pytest.raises(ValueError, match="without bias"):
        jfd.FusedDenseGeluDense(K, F_, N, bias=False)
    with pytest.raises(ValueError, match="without bias"):
        tfd.FusedDenseGeluDense(K, F_, N, bias=False, device="cpu")
    with pytest.raises(ValueError, match="unsupported activation"):
        tmlp.mlp_forward(tparams, torch.from_numpy(x), "tanh")
    dense = tfd.FusedDense(K, N, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    jd = {"weight": dense.weight.detach().numpy(),
          "bias": dense.bias.detach().numpy()}
    _close("fused_dense", dense(torch.from_numpy(x)),
           jfd.fused_dense_function(jnp.asarray(x), jd["weight"], jd["bias"]),
           1e-5)
    # a bf16 activation with f32 weights computes in f32, as jnp promotes
    xb = torch.from_numpy(x).bfloat16()
    got = tfd.fused_dense_function(xb, dense.weight, dense.bias)
    want = jfd.fused_dense_function(jnp.asarray(x, jnp.bfloat16),
                                    jd["weight"], jd["bias"])
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close("promoted", got, want, 1e-5)


# ---------------------------------------------------------------------------
# the card's rule against an emulation of the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The card script (it imports torch and numpy only), for the rule its
    phase 2 holds the FFN kernels to."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _emulated_kernels(x, w1, b1, w2, b2, dy, fault):
    """The kernels' outputs with every product summed in f64 (another
    summation than the plain versions') and their roundings: z to f32,
    z1, h, dz and the outputs to the activation dtype.  ``fault`` breaks
    one piece: the forward without b1, GELU' without its tanh-derivative
    term, or dW2 taken from z1 instead of gelu(z1).  Returns (y, z1, dx,
    dw1, db1, dw2) with the backward on the emulated z1."""
    dt = x.dtype
    X, DY = x.double(), dy.double()
    W1, W2 = w1.to(dt).double(), w2.to(dt).double()
    bias1 = 0.0 if fault == "forward_drops_b1" else b1.double()
    z = (X @ W1.t() + bias1).float()
    h = tffn._gelu(z).to(dt).double()
    y = (h @ W2.t() + b2.double()).to(dt)
    z1 = z.to(dt)
    zf = z1.float()
    if fault == "gelu_grad_drops_tanh_term":
        t = torch.tanh(tffn._GELU_C * zf * (1.0 + tffn._GELU_A * zf * zf))
        grad = 0.5 * (1.0 + t)
    else:
        grad = tffn._gelu_grad(zf)
    dz = (DY @ W2).float() * grad
    dzc = dz.to(dt).double()
    dx = (dzc @ W1).to(dt)
    dw1 = (dzc.t() @ X).to(w1.dtype)
    db1 = dz.double().sum(0).float()
    h1 = zf if fault == "dw2_from_z" else tffn._gelu(zf)
    dw2 = (DY.t() @ h1.to(dt).double()).to(w2.dtype)
    return y, z1, dx, dw1, db1, dw2


_FAULTS = [None, "forward_drops_b1", "gelu_grad_drops_tanh_term",
           "dw2_from_z"]


@pytest.mark.parametrize("fault", _FAULTS,
                         ids=["exact"] + [f for f in _FAULTS if f])
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_w", "f32_w"])
def test_card_rule_rejects_likely_kernel_faults(w_dtype, fault):
    """chip_smoke.py holds each FFN kernel output to its plain version
    entry by entry (one ulp, plus summation-order and rounding-midpoint
    slack).  A stand-in for the kernels that sums in another order passes
    it; one whose forward drops b1, whose GELU' lacks its tanh-derivative
    term or whose dW2 takes z instead of gelu(z) fails it, at bf16
    activations with bf16 (BERT O2) and f32 (GPT) weights."""
    card = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    m, k, f, n = 128, 256, 1024, 256
    x = torch.randn(m, k, generator=gen).bfloat16()
    w1 = (0.02 * torch.randn(f, k, generator=gen)).to(w_dtype)
    b1 = (0.1 * torch.randn(f, generator=gen)).to(w_dtype)
    w2 = (0.02 * torch.randn(n, f, generator=gen)).to(w_dtype)
    b2 = (0.1 * torch.randn(n, generator=gen)).to(w_dtype)
    dy = torch.randn(m, n, generator=gen).bfloat16()
    got = _emulated_kernels(x, w1, b1, w2, b2, dy, fault)
    y, z1 = got[:2]
    ry, rz1 = tffn.ffn_fwd_reference(x, w1, b1, w2, b2)
    # the backward of both sides reads the emulated forward's z1
    rdx = tffn.ffn_dx_reference(dy, z1, w1, w2)
    refs = (ry, rz1, rdx) + tffn.ffn_dw_reference(x, dy, z1, w1, w2)
    slack = card.ffn_bounds(x, w1, b1, w2, dy, z1)
    verdicts = {}
    for part, g, r in zip(("y", "z1", "dx", "dw1", "db1", "dw2"), got, refs):
        try:
            card.check_entrywise(part, g, r, slack[part])
            verdicts[part] = True
        except AssertionError:
            verdicts[part] = False
    if fault is None:
        assert all(verdicts.values()), verdicts
    else:
        assert not all(verdicts.values()), (fault, verdicts)
