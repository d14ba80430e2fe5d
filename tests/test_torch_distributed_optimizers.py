"""The ZeRO optimizers of the port (``apex_tpu_torch.parallel.
DistributedFusedAdam`` / ``DistributedFusedLAMB``) against the JAX
package's, and the packed layout's plain-optimizer refusal.

The port runs on 2 and 4 ``gloo`` ranks on the CPU (``tests/_torch_dist.py``,
one spawn a world size for every run); the JAX optimizers run
``make_init`` / ``make_step`` on a mesh of the first N of the 8 CPU devices
with the same per-rank numpy gradients.  Three steps each: f32 and bf16
parameters with f32 masters, buckets split by ``message_size``,
``grad_scale`` and a ``noop_flag`` step, bf16 and int8 transport; the f32
runs also against the port's own unsharded optimizer on the mean
gradient; and a run that starts from the JAX state after one step,
carried by ``convert.distributed_state_from_jax``.  Parameters and every
rank's state shards (m, v, master) are compared.

Tolerances: #18's, 1e-6 relative plus 1e-6 of the largest entry, for the
f32 values (parameters, masters, moments); bf16 parameters one bf16 step
(2^-7) of their magnitude (their f32 masters within the f32 tolerance
may round to neighbouring bf16 values).  With bf16 gradients the exact
reduce-scatter sums in bf16: gloo rounds after each addition, XLA's CPU
reduction once, so the reduced gradient may differ by a bf16 rounding
(2^-8) a rank past the second, and the f32 state is held to (world - 2)
* 2^-8 of its largest entry (the f32 tolerance at world 2, where the one
addition rounds once either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch import nn

from apex_tpu.parallel import DistributedFusedAdam as JDAdam
from apex_tpu.parallel import DistributedFusedLAMB as JDLamb
from apex_tpu_torch.optimizers import (FusedAdagrad, FusedAdam, FusedLAMB,
                                       FusedNovoGrad, FusedSGD)
from apex_tpu_torch.parallel import DistributedFusedAdam

from _torch_dist import run

RTOL = 1e-6
BF16_STEP = 2.0 ** -7
SHAPES = [(33, 17), (17,), (129, 40)]
STEPS = 3
NOOP_STEPS = [{}, {"grad_scale": 0.5, "noop_flag": 1}, {"grad_scale": 0.5}]
PLAIN_STEPS = [{}, {}, {}]

RUNS = {
    "adam": dict(opt="adam", kw=dict(lr=1e-2, weight_decay=0.01), plain=True),
    "adam_master": dict(opt="adam", dtype="bfloat16",
                        kw=dict(lr=1e-2, master_weights=True)),
    "adam_split": dict(opt="adam", kw=dict(lr=1e-2, message_size=9000)),
    "adam_scale_noop": dict(opt="adam", kw=dict(lr=1e-2), steps=NOOP_STEPS),
    "adam_bf16": dict(opt="adam", kw=dict(lr=1e-2, allreduce_dtype="bf16")),
    "adam_int8": dict(opt="adam", kw=dict(lr=1e-2, allreduce_dtype="int8")),
    "lamb": dict(opt="lamb", kw=dict(lr=1e-2, weight_decay=0.01),
                 plain=True),
    "lamb_master": dict(opt="lamb", dtype="bfloat16",
                        kw=dict(lr=1e-2, master_weights=True)),
    "lamb_split": dict(opt="lamb", kw=dict(lr=1e-2, message_size=9000,
                                           use_nvlamb=True)),
    "lamb_scale_noop": dict(opt="lamb", kw=dict(lr=1e-2, max_grad_norm=0.5),
                            steps=NOOP_STEPS),
    "lamb_int8": dict(opt="lamb", kw=dict(lr=1e-2, allreduce_dtype="int8")),
    "adam_carry": dict(opt="adam", kw=dict(lr=1e-2, weight_decay=0.01),
                       carry=True),
    "lamb_carry": dict(opt="lamb", dtype="bfloat16",
                       kw=dict(lr=1e-2, master_weights=True), carry=True),
}


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _jax_run(world, c, params, grads, upto=STEPS):
    """The JAX optimizer's params and state after ``upto`` steps."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    cls = JDLamb if c["opt"] == "lamb" else JDAdam
    dtype = getattr(jnp, c.get("dtype", "float32"))
    opt = cls(world_size=world, block_rows=8, **c["kw"])
    p = {f"p{i}": jnp.asarray(v, dtype) for i, v in enumerate(params)}
    state = opt.make_init(mesh)(p)
    step = opt.make_step(mesh)
    for s in range(upto):
        g = {f"p{i}": jnp.asarray(v[s], dtype) for i, v in enumerate(grads)}
        p, state = step(g, p, state, **c.get("steps", PLAIN_STEPS)[s])
    tonp = lambda t: np.asarray(t, np.float32)            # noqa: E731
    return ([tonp(p[f"p{i}"]) for i in range(len(params))],
            jax.tree_util.tree_map(tonp, state))


def _close(name, got, want, rtol=RTOL):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)


@pytest.fixture(scope="module", params=[2, 4])
def zero(request, tmp_path_factory):
    world = request.param
    rng = np.random.RandomState(30 + world)
    params = [_bf16(rng.randn(*s).astype(np.float32)) for s in SHAPES]
    grads = [_bf16((rng.randn(STEPS, world, *s) * 0.1).astype(np.float32))
             for s in SHAPES]
    runs = {}
    for name, c in RUNS.items():
        kw = dict(c["kw"], block_rows=8)
        steps = c.get("steps", PLAIN_STEPS)
        runs[name] = dict(opt=c["opt"], kw=kw, step_kw=steps,
                          dtype=c.get("dtype", "float32"),
                          plain=c.get("plain", False),
                          steps=list(range(STEPS)))
        if c.get("carry"):
            p1, s1 = _jax_run(world, c, params, grads, upto=1)
            runs[name].update(steps=list(range(1, STEPS)),
                              carry=dict(params=p1, state=s1))
    mlp_shapes = [(16, 8), (16,), (4, 16), (4,)]
    inp = dict(params=params, grads=grads, runs=runs,
               mlp=[(rng.randn(*s) * 0.3).astype(np.float32)
                    for s in mlp_shapes],
               x=rng.randn(8 * world, 8).astype(np.float32),
               y=rng.randn(8 * world, 4).astype(np.float32))
    out = run(tmp_path_factory.mktemp(f"zero{world}"), world, "zero", inp)
    return world, params, grads, out


@pytest.mark.parametrize("name", list(RUNS))
def test_zero_optimizer_matches_jax(zero, name):
    world, params, grads, out = zero
    c = RUNS[name]
    ref_p, ref_s = _jax_run(world, c, params, grads)
    bf16 = c.get("dtype") == "bfloat16"
    state_tol = max(RTOL, (world - 2) * 2.0 ** -8) if bf16 else RTOL
    for r in range(world):
        res = out[r][name]
        assert res["step"] == int(ref_s["step"])
        for i, (got, want) in enumerate(zip(res["params"], ref_p)):
            _close(f"{name} param {i} rank {r}", got, want,
                   BF16_STEP if bf16 else RTOL)
        for key, shards in res["state"].items():
            full = ref_s["buckets"][key]
            assert set(shards) == set(full), (key, set(shards), set(full))
            for k, got in shards.items():
                rows = full[k].shape[0] // world
                assert got.shape == (rows, 128)
                _close(f"{name} {key} {k} rank {r}", got,
                       full[k][r * rows:(r + 1) * rows], state_tol)
        if "plain" in res:
            for got, want in zip(res["plain"], res["params"]):
                _close(f"{name} unsharded", got, want)
    keys = set(out[0][name]["state"])
    assert keys == set(ref_s["buckets"])
    if name == "adam_split":
        assert len(keys) > 1


def test_master_params_gather_the_shards(zero):
    world, _, _, out = zero
    for name in ("adam_master", "lamb_master", "adam"):
        for r in range(world):
            res = out[r][name]
            for m, p in zip(res["master_params"], res["params"]):
                assert m.dtype == np.float32 and m.shape == p.shape
                if name == "adam":
                    np.testing.assert_array_equal(m, p)
                else:
                    np.testing.assert_array_equal(_bf16(m), p)


def test_zero_optimizer_refuses_ddp_parameters(zero):
    """The ZeRO reduce-scatter is the gradient reduction: an optimizer
    over a DistributedDataParallel module's parameters, or over some of
    the wrapped model's, raises."""
    world, _, _, out = zero
    for r in range(world):
        assert len(out[r]["refused"]) == 2
        for msg in out[r]["refused"]:
            assert "not a DistributedDataParallel" in msg, msg


def test_zero_overflow_on_one_rank_skips_every_rank(zero):
    """fp16 O2 with a dynamic scaler and an inf in the last rank's
    gradient only: every rank skips the step (parameters unchanged, step
    count 0) and halves its loss scale; the next step is taken by all,
    with finite parameters equal on every rank."""
    world, _, _, out = zero
    ov = [out[r]["overflow"] for r in range(world)]
    for r in range(world):
        for a, b in zip(ov[r]["params"][0], ov[r]["start"]):
            np.testing.assert_array_equal(a, b)
        assert ov[r]["scale"] == [128.0, 128.0]
        assert ov[r]["step"] == [0, 1]
        for a, b, c in zip(ov[r]["params"][1], ov[0]["params"][1],
                           ov[r]["start"]):
            assert np.all(np.isfinite(a))
            np.testing.assert_array_equal(a, b)
        assert not all(np.array_equal(a, c) for a, c in zip(
            ov[r]["params"][1], ov[r]["start"]))


@pytest.mark.parametrize("cls", [FusedAdam, FusedLAMB, FusedSGD,
                                 FusedAdagrad, FusedNovoGrad])
def test_plain_optimizers_refuse_the_packed_layout(cls):
    """``bucketed=True`` on a plain optimizer raises JAX's ValueError; the
    ZeRO optimizers take the packed layout by default and refuse
    ``bucketed=False``."""
    params = [nn.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError, match="bucketed=True"):
        cls(params, bucketed=True)
    assert not cls(params).bucketed
    assert DistributedFusedAdam(params).bucketed
    with pytest.raises(ValueError, match="require bucketed=True"):
        DistributedFusedAdam(params, bucketed=False)
    with pytest.raises(ValueError, match="world_size=2"):
        DistributedFusedAdam(params, world_size=2)
