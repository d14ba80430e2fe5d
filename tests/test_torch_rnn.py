"""apex_tpu_torch.RNN against apex_tpu.RNN on the CPU.

Parameters come from the JAX ``init_params`` and are carried over by
``convert.rnn_params_from_jax`` (the ``(n_in, n_out)`` weights transposed);
the same numpy inputs go through both.  Outputs, final states and
gradients are f32 recurrences of the same operations in the same order:
held at atol 1e-5 / rtol 1e-5 (outputs, states) and 1e-5 of each tensor's
largest entry (gradients, sums over 6 steps x 3 rows).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.RNN as JRNN
import apex_tpu_torch.RNN as TRNN
from apex_tpu_torch.convert import rnn_params_from_jax

FACTORIES = ["LSTM", "GRU", "RNNTanh", "RNNReLU"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(name, n_in, hidden, layers, seed, **kw):
    """The JAX module and params, and the port module with those params."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jm = getattr(JRNN, name)(n_in, hidden, num_layers=layers, **kw)
        tm = getattr(TRNN, name)(n_in, hidden, num_layers=layers,
                                 device="cpu", **kw)
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm.load_state_dict(rnn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return jm, params, tm


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", FACTORIES)
def test_outputs_and_states_match_jax(name, bias):
    jm, params, tm = _pair(name, 4, 6, 2, 0, bias=bias)
    x = np.random.RandomState(1).randn(5, 3, 4).astype(np.float32)
    jout, jstates = jm.apply(params, jnp.asarray(x))
    tout, tstates = tm.apply(torch.from_numpy(x))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    assert len(tstates) == 2 and all(
        len(s) == (2 if name == "LSTM" else 1) for s in tstates)
    for js, ts in zip(jstates, tstates):
        for a, b in zip(js, ts):
            np.testing.assert_allclose(_np(b), np.asarray(a), **TOL)


@pytest.mark.parametrize("name", FACTORIES)
def test_h0_resumes_as_jax(name):
    """``apply(x2, h0=states)`` continues the sequence: equal to JAX's
    resumed run and to the port's run over the whole sequence."""
    jm, params, tm = _pair(name, 3, 5, 2, 2)
    x = np.random.RandomState(3).randn(7, 2, 3).astype(np.float32)
    _, jst = jm.apply(params, jnp.asarray(x[:4]))
    jout, jfinal = jm.apply(params, jnp.asarray(x[4:]), h0=jst)
    _, tst = tm.apply(torch.from_numpy(x[:4]))
    tout, tfinal = tm.apply(torch.from_numpy(x[4:]), h0=tst)
    whole, wfinal = tm.apply(torch.from_numpy(x))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(tout), _np(whole[4:]), **TOL)
    for a, b, c in zip(jax.tree_util.tree_leaves(jfinal),
                       [t for s in tfinal for t in s],
                       [t for s in wfinal for t in s]):
        np.testing.assert_allclose(_np(b), np.asarray(a), **TOL)
        np.testing.assert_allclose(_np(b), _np(c), **TOL)


def test_lstm_gate_order_is_i_f_g_o():
    """The first step of layer 0 by hand from the JAX parameters, the
    JAX test's recurrence: i, f, g, o."""
    jm, params, tm = _pair("LSTM", 4, 6, 1, 4)
    x = np.random.RandomState(5).randn(1, 3, 4).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray, params)[0]
    g = x[0] @ p["i2h"]["weight"] + p["i2h"]["bias"] + p["h2h"]["bias"]
    i, f, gc, o = np.split(g, 4, -1)
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    h = sig(o) * np.tanh(sig(i) * np.tanh(gc))
    out, _ = tm.apply(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out[0]), h, **TOL)


@pytest.mark.parametrize("name", FACTORIES)
def test_grads_match_jax(name):
    jm, params, tm = _pair(name, 3, 4, 2, 6)
    x = np.random.RandomState(7).randn(6, 2, 3).astype(np.float32)
    g = jax.grad(lambda p: jnp.mean(jm.apply(p, jnp.asarray(x))[0] ** 2))(
        params)
    want = rnn_params_from_jax(jax.tree_util.tree_map(np.asarray, g), tm)
    (tm.apply(torch.from_numpy(x))[0] ** 2).mean().backward()
    for n, p in tm.named_parameters():
        ref = want[n].numpy()
        assert np.abs(ref).max() > 0
        assert np.abs(_np(p.grad) - ref).max() <= 1e-5 * np.abs(ref).max(), n


def test_h0_of_the_wrong_length_raises():
    _, _, tm = _pair("GRU", 3, 4, 2, 0)
    with pytest.raises(ValueError, match="per-layer state"):
        tm.apply(torch.zeros(2, 1, 3), h0=[(torch.zeros(1, 4),)])


@pytest.mark.parametrize("name", FACTORIES)
def test_deprecation_warning_points_at_the_caller(name):
    with pytest.warns(DeprecationWarning) as rec:
        getattr(TRNN, name)(2, 2, device="cpu")
    assert rec[0].filename == __file__
    with pytest.warns(DeprecationWarning) as jrec:
        getattr(JRNN, name)(2, 2)
    assert jrec[0].filename == __file__


def test_module_apply_of_a_function_still_walks_the_modules():
    """``nn.Module.apply(fn)`` (what a parent's ``apply`` calls) is kept
    beside the reference's ``apply(x, h0)``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        m = TRNN.LSTM(3, 4, num_layers=2, device="cpu")
    seen = []
    parent = torch.nn.Sequential(m)
    assert parent.apply(lambda mod: seen.append(type(mod).__name__)) \
        is parent
    assert seen.count("Linear") == 4 and "_LSTM" in seen


def test_init_params_matches_the_jax_bounds():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        m = TRNN.LSTM(9, 16, device="cpu").init_params(
            torch.Generator().manual_seed(0))
    for n, p in m.named_parameters():
        bound = (9 if "i2h" in n else 16) ** -0.5
        p = p.detach()
        assert float(p.abs().max()) <= bound and float(p.std()) > bound / 4


def test_raises_without_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TRNN.LSTM(2, 2)
