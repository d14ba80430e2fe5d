"""The port's conformer RNN-T recipe against the JAX example on the CPU.

The unedited ``examples/conformer/train_rnnt.py`` runs under ``runpy`` at
the tiny arguments of ``tests/test_examples.py::test_conformer_rnnt``, with
``jax.jit`` patched so that ``train_step``'s first call runs eagerly and
records its inputs (parameters, batch), its outputs (updated parameters,
loss) and, through a patched ``jax.value_and_grad``, the gradients of
``forward_loss``.  ``convert.conformer_params_from_jax`` carries the
parameters onto the port's model, whose one step (loss, backward,
``FusedNovoGrad``) on the same batch is held to:

* the loss within 1e-5 relative;
* each gradient within 1e-4 of the tensor's largest JAX entry;
* each parameter after the step within 1e-6.

Two planted faults (a swapped LSTM gate, the lattice read at
``y_len - 1``) must fall outside every one of these bounds.  The port's
example also runs end to end on the CPU with ``--device cpu``, launching
no kernel, and raises without CUDA by default.
"""

import pathlib
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from apex_tpu_torch.convert import conformer_params_from_jax
from apex_tpu_torch.examples.conformer import train_rnnt
from apex_tpu_torch.optimizers import FusedNovoGrad

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--steps", "2", "--print-freq", "1", "--batch-size", "2",
        "--layers", "1", "--hidden", "32", "--heads", "2",
        "--audio-len", "40", "--target-len", "6", "--vocab", "16",
        "--pred-hidden", "32", "--n-mels", "8"]
LOSS_RTOL, GRAD_TOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
_RECORD = {}


def _jax_recipe():
    """The JAX example's first ``train_step``: inputs, gradients, outputs
    (numpy trees), recorded once a process."""
    if _RECORD:
        return _RECORD
    real_jit, real_vag = jax.jit, jax.value_and_grad
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def jit(fn=None, **kw):
        if getattr(fn, "__name__", "") != "train_step":
            return real_jit(fn, **kw)
        jitted = real_jit(fn, **kw)

        def first_call_eager(*args):
            if "inputs" in _RECORD:
                return jitted(*args)
            _RECORD["inputs"] = np_tree(args)
            out = fn(*args)
            _RECORD["outputs"] = np_tree(out)
            return out
        return first_call_eager

    def value_and_grad(fn, *a, **kw):
        inner = real_vag(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "forward_loss":
            return inner

        def recorded(*args):
            loss, grads = inner(*args)
            if "grads" not in _RECORD:
                _RECORD["grads"] = np_tree(grads)
            return loss, grads
        return recorded

    argv = sys.argv
    try:
        jax.jit, jax.value_and_grad = jit, value_and_grad
        sys.argv = ["train_rnnt.py"] + TINY
        runpy.run_path(str(ROOT / "examples" / "conformer" / "train_rnnt.py"),
                       run_name="__main__")
    finally:
        jax.jit, jax.value_and_grad = real_jit, real_vag
        sys.argv = argv
    return _RECORD


def _chip_smoke():
    """The card script (it imports torch and numpy only): its
    ``_plant_conformer`` plants the same faults in its phase 20b."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_planted = _chip_smoke()._plant_conformer


def _port_step(rec, fault=None):
    """The port's step from the JAX parameters and batch: (loss, grads,
    params after the step) against JAX's, as the three gaps."""
    args = train_rnnt.parse_args(TINY + ["--device", "cpu"])
    model = train_rnnt.ConformerRNNT(args, "cpu")
    params, _, feats, labels, f_len, y_len = rec["inputs"]
    model.load_state_dict(conformer_params_from_jax(params, model))
    opt = FusedNovoGrad(model.parameters(), lr=args.lr)
    batch = [torch.from_numpy(np.array(a)) for a in (feats, labels, f_len,
                                                     y_len)]
    with _planted(fault):
        model.zero_grad()
        loss = model.loss(*batch)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        opt.step()
    want_g = conformer_params_from_jax(rec["grads"], model)
    want_p = conformer_params_from_jax(rec["outputs"][0], model)
    jloss = float(rec["outputs"][2])
    loss_gap = abs(float(loss.detach()) - jloss) / abs(jloss)
    grad_gap = max(float((grads[n] - want_g[n]).abs().max()
                         / want_g[n].abs().max()) for n in want_g)
    param_gap = max(float((p.detach() - want_p[n]).abs().max())
                    for n, p in model.named_parameters())
    return loss_gap, grad_gap, param_gap


def test_jax_recipe_recorded_its_first_step():
    rec = _jax_recipe()
    params, grads = rec["inputs"][0], rec["grads"]
    assert len(params["layers"]) == 1 and set(grads) == set(params)
    assert np.isfinite(rec["outputs"][2])


def test_one_step_matches_the_jax_recipe():
    loss_gap, grad_gap, param_gap = _port_step(_jax_recipe())
    assert loss_gap <= LOSS_RTOL, loss_gap
    assert grad_gap <= GRAD_TOL, grad_gap
    assert param_gap <= PARAM_ATOL, param_gap


@pytest.mark.parametrize("fault", ["lstm_gate", "lattice_end"])
def test_planted_faults_fall_outside_every_bound(fault):
    loss_gap, grad_gap, param_gap = _port_step(_jax_recipe(), fault)
    assert loss_gap > LOSS_RTOL and grad_gap > GRAD_TOL \
        and param_gap > PARAM_ATOL, (loss_gap, grad_gap, param_gap)


def test_parameter_names_are_the_jax_tree_paths():
    """Every JAX leaf lands on a port parameter of its shape (the LSTM's
    transposed), and the port has no parameter the tree lacks."""
    rec = _jax_recipe()
    args = train_rnnt.parse_args(TINY + ["--device", "cpu"])
    model = train_rnnt.ConformerRNNT(args, "cpu")
    sd = conformer_params_from_jax(rec["inputs"][0], model)
    assert set(sd) == set(model.state_dict())
    assert sd["predictor.layers.0.i2h.weight"].shape == (4 * 32, 32)
    assert sd["layers.0.attn.in_proj.weight"].shape == (96, 32)


def test_cpu_example_launches_no_kernel_and_prints_the_reference_lines(
        capsys):
    from apex_tpu_torch.ops.flash_attention import (flash_attention_dkv,
                                                    flash_attention_dq,
                                                    flash_fwd)
    from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from apex_tpu_torch.ops.multi_tensor import (multi_tensor_novograd,
                                                 multi_tensor_sumsq)
    counters = (flash_fwd, flash_attention_dq, flash_attention_dkv,
                layer_norm_fwd, layer_norm_bwd, multi_tensor_sumsq,
                multi_tensor_novograd)
    for c in counters:
        c.launches = 0
    res = train_rnnt.main(TINY + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [c.launches for c in counters] == [0] * len(counters)
    assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
    assert res["peak_memory_bytes"] is None and res["device"] == "cpu"
    assert out[0].startswith("step    1  rnnt_loss ") and "utt/s" in out[0]
    assert out[-1].startswith("DONE layers=1 hidden=32 throughput=")
    assert isinstance(res["trainer"], train_rnnt.Trainer)


def test_example_batches_are_the_jax_examples():
    """``batches`` draws what the JAX example's ``make_batch`` draws."""
    rec = _jax_recipe()
    args = train_rnnt.parse_args(TINY + ["--device", "cpu"])
    got = train_rnnt.batches(args, "cpu")()
    for g, want in zip(got, rec["inputs"][2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_example_raises_without_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_rnnt.main(TINY)
