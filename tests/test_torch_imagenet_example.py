"""The ported ImageNet example (``apex_tpu_torch/examples/imagenet/
main_amp.py``) on the CPU: a resnet18-named (bottleneck resnet26) model
at 32 x 32, batch 4, 10 classes, 2 steps after a warm-up step, at O0, O1
and O2 with FusedSGD and with the hand-written SGD, as
``tests/test_examples.py`` runs the JAX example (there with batch 16 over 8
devices).  The CPU run takes the plain versions of the kernels: no
kernel counter moves."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu_torch.examples.imagenet import main_amp
from apex_tpu_torch.ops import multi_tensor as K

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "resnet18", "--batch-size", "4", "--image-size", "32",
        "--num-classes", "10", "--steps", "2", "--print-freq", "1",
        "--device", "cpu"]
_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
COUNTERS = (K.multi_tensor_sgd, K.multi_tensor_sumsq, K.multi_tensor_scale_)


@pytest.mark.parametrize("opt_level", ["O0", "O1", "O2"])
def test_imagenet_example_trains_on_the_cpu(opt_level, capsys):
    for c in COUNTERS:
        c.launches = 0
    out = main_amp.main(ARGS + ["--opt-level", opt_level])
    printed = capsys.readouterr().out
    assert f"DONE arch=resnet18 opt_level={opt_level} devices=1" in printed
    assert printed.count("step ") == 2
    assert out["devices"] == 1 and out["device"] == "cpu"
    assert len(out["losses"]) == len(out["step_times_s"]) == 2
    assert np.all(np.isfinite(out["losses"] + [out["warmup_loss"]]))
    assert out["images_per_s"] > 0 and out["peak_memory_bytes"] is None
    trainer = out["trainer"]
    model, opt = trainer.model, trainer.optimizer
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    if opt_level == "O2":
        assert {n for n, d in dtypes.items() if d == torch.float32} == {
            n for n in dtypes if "bn_" in n}
        assert opt.master_weights
        assert all(("master" in opt.state[p]) == (p.dtype == torch.bfloat16)
                   for p in model.parameters())
    else:
        assert set(dtypes.values()) == {torch.float32}
    assert int(opt.param_groups[0]["step"]) == 3
    assert int(model.stem.num_batches_tracked) == 3
    assert [c.launches for c in COUNTERS] == [0] * len(COUNTERS)


def test_imagenet_example_hand_written_sgd():
    out = main_amp.main(ARGS + ["--no-fused-sgd"])
    trainer = out["trainer"]
    assert trainer.optimizer is None
    assert all(m.abs().sum() > 0 for m in trainer.momentum)
    assert np.all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("opt_level,extra", [
    ("O0", []), ("O2", []), ("O0", ["--loss-scale", "3e38"])],
    ids=["O0", "O2", "O0_overflow"])
def test_hand_written_sgd_step_matches_the_jax_example(opt_level, extra):
    """One ``--no-fused-sgd`` step from a non-zero momentum, held against
    the JAX example's ``train_step`` update (its ``tree_map`` lines, on the
    same parameters, gradients, momentum and loss scale): the momentum
    within one f32 ulp, the parameters within four f32 ulps of |p| +
    lr |m| (the port computes ``p - lr (m + wd p)`` as the axpby ``(1 - lr
    wd) p - lr m``), plus one bf16 ulp of the result under O2, where both
    round to bf16.  A loss scale that overflows skips both, on both
    sides."""
    args = main_amp.parse_args(ARGS + ["--no-fused-sgd", "--opt-level",
                                       opt_level] + extra)
    trainer = main_amp.Trainer(args, torch.device("cpu"))
    params = list(trainer.model.parameters())
    rng = np.random.RandomState(7)
    for m in trainer.momentum:
        m.copy_(torch.from_numpy(rng.randn(*m.shape).astype(np.float32)))
    # copies: jnp.asarray may share a numpy array's memory on the CPU
    p0 = [jnp.asarray(p.detach().float().numpy().copy(),
                      _JAX_DTYPES[p.dtype]) for p in params]
    m0 = [jnp.asarray(m.numpy().copy()) for m in trainer.momentum]
    scale = jnp.asarray(trainer.scaler.loss_scale.numpy())
    make_batch, put = main_amp.make_data(args, torch.device("cpu"))
    x, y, _ = put(*make_batch())
    trainer.step(x, y)
    grads = [jnp.asarray(p.grad.float().numpy(), _JAX_DTYPES[p.dtype])
             for p in params]

    # examples/imagenet/main_amp.py, train_step's hand-written SGD
    inv = 1.0 / scale
    finf = jamp.LossScaler.found_inf(grads)
    keep = 1.0 - finf
    opt_state = jax.tree_util.tree_map(
        lambda m, g: jnp.where(
            finf > 0, m,
            args.momentum * m + g.astype(jnp.float32) * inv),
        m0, grads)
    new = jax.tree_util.tree_map(
        lambda p, m: (p - keep * args.lr
                      * (m + args.weight_decay
                         * p.astype(jnp.float32))).astype(p.dtype),
        p0, opt_state)

    assert (float(finf) > 0) == bool(extra)
    eps = np.finfo(np.float32).eps
    for p, m, want_p, want_m, pj, mj in zip(params, trainer.momentum, new,
                                            opt_state, p0, m0):
        got, want = p.detach().float().numpy(), np.asarray(want_p,
                                                           np.float32)
        if extra:                       # overflow: nothing moves
            np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
            np.testing.assert_array_equal(got, np.asarray(pj, np.float32))
            continue
        want_m = np.asarray(want_m)
        np.testing.assert_allclose(m.numpy(), want_m, rtol=eps, atol=0)
        bound = 4 * eps * (np.abs(np.asarray(pj, np.float32))
                           + args.lr * np.abs(want_m))
        if p.dtype == torch.bfloat16:
            bound = bound + 2.0 ** -7 * np.abs(want)
        assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


def test_imagenet_example_runs_as_a_module_and_needs_a_card_by_default():
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.examples.imagenet.main_amp",
         *ARGS[:-2], "--steps", "1", "--device", "cpu", "--sync-bn"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "DONE arch=resnet18 opt_level=O1 devices=1" in res.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main_amp.main(ARGS[:-2])
