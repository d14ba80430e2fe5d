"""Data parallelism of the port (``apex_tpu_torch.parallel``: the DDP
reduction, ``DistributedDataParallel``, ``Reducer``,
``allreduce_gradients``, SyncBatchNorm across ranks, LARC) against the JAX
package.

The port runs on 2 and 4 ``gloo`` ranks on the CPU (``tests/_torch_dist.py``,
one spawn a world size and case); the JAX package runs the same per-rank
numpy inputs through ``shard_map`` on the first N of the 8 CPU devices
(the DDP reduce in every mode of ``tests/test_parallel.py::TestDDP``,
SyncBatchNorm's forward), or serially on the whole batch (the training
reference, SyncBatchNorm's gradients: what the sum over ranks of the
per-rank losses must give).

Tolerances: f32 sums 1e-6 relative to the output's largest entry (the
backends' and XLA's summation orders differ); a bf16 leaf one bf16 step
(2^-7) of its largest entry per rank summed; SyncBatchNorm and the
two-step MLP training 1e-5 of the largest entry (statistics and GEMMs
summed in other orders); LARC 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from torch import nn

from apex_tpu.parallel import DistributedDataParallel as JDDP
from apex_tpu.parallel import LARC as JLARC
from apex_tpu.parallel import larc as jlarc
from apex_tpu.parallel import sync_batchnorm as jS
from apex_tpu.optimizers import FusedSGD as JFusedSGD
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import LARC, DistributedDataParallel, larc

from _torch_dist import run

SUM_RTOL = 1e-6
BF16_STEP = 2.0 ** -7
BN_TOL = 1e-5
TRAIN_TOL = 1e-5

MODES = {
    "avg": {},
    "sum": {"gradient_average": False},
    "predivide_avg": {"gradient_predivide_factor": 2.0},
    "predivide_sum": {"gradient_predivide_factor": 2.0,
                      "gradient_average": False},
    "fp32": {"allreduce_always_fp32": True},
    "f32": {"allreduce_dtype": "f32"},
    "bf16": {"allreduce_dtype": "bf16"},
    "int8": {"allreduce_dtype": "int8"},
}
GRAD_SHAPES = {"w": (9, 50), "b": (37,), "h": (3, 200)}
BF16_LEAVES = ("h",)
TRAIN = {"buckets": {"kw": {"message_size": 256}, "no_sync": False},
         "delay": {"kw": {"delay_allreduce": True}, "no_sync": False},
         "no_sync": {"kw": {}, "no_sync": True},
         "int8": {"kw": {"allreduce_dtype": "int8"}, "no_sync": False}}
MLP_SHAPES = [(16, 8), (16,), (4, 16), (4,)]


def _mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("data",))


def _close(name, got, want, rtol):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=rtol * scale, err_msg=name)


def _ddp_inputs(world):
    rng = np.random.RandomState(10 + world)
    grads = {k: rng.randn(world, *s).astype(np.float32)
             for k, s in GRAD_SHAPES.items()}
    for k in BF16_LEAVES:      # bf16-representable: both sides start equal
        grads[k] = torch.from_numpy(grads[k]).to(torch.bfloat16).float(
        ).numpy()
    mlp = [(rng.randn(*s) * 0.3).astype(np.float32) for s in MLP_SHAPES]
    other = [(rng.randn(*s) * 0.3).astype(np.float32) for s in MLP_SHAPES]
    mlp_grads = [rng.randn(world, *s).astype(np.float32) for s in MLP_SHAPES]
    return dict(grads=grads, bf16=BF16_LEAVES, modes=MODES, mlp=mlp,
                mlp_other=other, mlp_grads=mlp_grads,
                x=rng.randn(8 * world, 8).astype(np.float32),
                y=rng.randn(8 * world, 4).astype(np.float32), train=TRAIN)


def _jax_reduce(inp, world, kw):
    mesh = _mesh(world)
    ddp = JDDP(mesh=mesh, **kw)
    keys = list(GRAD_SHAPES)

    def body(*gs):
        grads = {k: (g[0].astype(jnp.bfloat16) if k in BF16_LEAVES else g[0])
                 for k, g in zip(keys, gs)}
        out = ddp.reduce(grads)
        return tuple(out[k].astype(jnp.float32)[None] for k in keys)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"),) * 3,
                              out_specs=P("data")))
    return dict(zip(keys, (np.asarray(v) for v in
                           f(*(inp["grads"][k] for k in keys)))))


def _jax_train(inp, world):
    """Two lr-0.1 SGD steps of the MLP on the whole batch's mean squared
    error (what DDP's averaged per-rank gradients must give)."""
    def loss(p, x, y):
        h = jnp.tanh(x @ p[0].T + p[1])
        return jnp.mean((h @ p[2].T + p[3] - y) ** 2)

    params = [jnp.asarray(v) for v in inp["mlp"]]
    for _ in range(2):
        g = jax.grad(loss)(params, jnp.asarray(inp["x"]),
                           jnp.asarray(inp["y"]))
        params = [p - 0.1 * gi for p, gi in zip(params, g)]
    return [np.asarray(p) for p in params]


@pytest.fixture(scope="module", params=[2, 4])
def ddp_ranks(request, tmp_path_factory):
    world = request.param
    inp = _ddp_inputs(world)
    out = run(tmp_path_factory.mktemp(f"ddp{world}"), world, "ddp", inp)
    return world, inp, out


@pytest.mark.parametrize("mode", list(MODES))
def test_ddp_reduce_matches_jax(ddp_ranks, mode):
    """``ddp.reduce`` in every mode of ``TestDDP``: average on / off,
    predivide (average and sum), fp32 sums, ``allreduce_dtype`` f32 / bf16
    / int8."""
    world, inp, out = ddp_ranks
    ref = _jax_reduce(inp, world, MODES[mode])
    for r in range(world):
        for k in GRAD_SHAPES:
            got = out[r][f"reduce_{mode}"][k]
            if k in BF16_LEAVES and mode != "fp32":
                tol = BF16_STEP * world
            else:
                tol = SUM_RTOL
            _close(f"{mode} {k} rank {r}", got, ref[k][r], tol)


def test_allreduce_gradients_reducer_and_accumulate(ddp_ranks):
    world, inp, out = ddp_ranks
    for r in range(world):
        for k in ("w", "b"):
            mean = inp["grads"][k].astype(np.float64).mean(0)
            _close("allreduce avg", out[r]["allreduce_avg"][k], mean,
                   SUM_RTOL)
            _close("allreduce sum", out[r]["allreduce_sum"][k],
                   mean * world, SUM_RTOL)
            _close("reducer tree", out[r]["reducer_tree"][k], mean,
                   SUM_RTOL)
            np.testing.assert_array_equal(out[r]["accumulate"][k],
                                          2.0 * inp["grads"][k][r])
            assert out[r]["accumulate"][k].dtype == np.float64
        for got, g in zip(out[r]["reducer_module"], inp["mlp_grads"]):
            _close("reducer module", got, g.astype(np.float64).mean(0),
                   SUM_RTOL)


@pytest.mark.parametrize("name", list(TRAIN))
def test_ddp_module_trains_like_the_whole_batch(ddp_ranks, name):
    """The wrapper broadcasts rank 0's parameters, scatters the batch by
    rank and reduces in hooks (small buckets, ``delay_allreduce``,
    ``no_sync`` micro-batches, int8 transport): two SGD steps equal the
    whole batch's on every rank."""
    world, inp, out = ddp_ranks
    ref = _jax_train(inp, world)
    tol = TRAIN_TOL if name != "int8" else 2e-2
    for r in range(world):
        for i, (got, want) in enumerate(zip(out[r][f"train_{name}"], ref)):
            _close(f"{name} param {i} rank {r}", got, want, tol)
        for a, b in zip(out[r][f"train_{name}"], out[0][f"train_{name}"]):
            np.testing.assert_array_equal(a, b)


def test_allreduce_dtype_needs_a_group():
    """JAX refuses ``allreduce_dtype`` without the world size (no mesh);
    the port, without a process group to read it from."""
    with pytest.raises(ValueError, match="world size"):
        DistributedDataParallel(nn.Linear(2, 2), allreduce_dtype="int8")
    with pytest.raises(ValueError, match="world size"):
        JDDP(allreduce_dtype="int8")


# -- SyncBatchNorm across ranks ----------------------------------------------

def _bn_inputs(world):
    rng = np.random.RandomState(20 + world)
    c = 3
    return dict(x=(rng.randn(world, 2, c, 4, 5) * 1.5 + 0.5).astype(
        np.float32), dy=rng.randn(world, 2, c, 4, 5).astype(np.float32),
        w=rng.uniform(0.5, 1.5, c).astype(np.float32),
        b=rng.randn(c).astype(np.float32))


def _jax_bn(inp, world):
    c = inp["w"].shape[0]
    state = jS.BatchNormState(jnp.zeros(c), jnp.ones(c),
                              jnp.zeros((), jnp.int32))
    w, b = jnp.asarray(inp["w"]), jnp.asarray(inp["b"])
    mesh = _mesh(world)

    def body(x):
        y, st = jS.sync_batch_norm(x[0], w, b, state, training=True,
                                   axis_name="data")
        return y[None], st.running_mean, st.running_var

    y, rm, rv = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                                      out_specs=(P("data"), P(), P())))(
        inp["x"])
    whole = jnp.asarray(inp["x"].reshape(-1, *inp["x"].shape[2:]))
    dy = jnp.asarray(inp["dy"].reshape(whole.shape))

    def loss(x, w, b):
        y, _ = jS.sync_batch_norm(x, w, b, state, training=True)
        return jnp.sum(y * dy)

    dx, dw, db = jax.grad(loss, argnums=(0, 1, 2))(whole, w, b)
    y_eval, _ = jS.sync_batch_norm(
        whole, w, b, jS.BatchNormState(rm, rv, jnp.ones((), jnp.int32)),
        training=False)
    return dict(y=np.asarray(y), rm=np.asarray(rm), rv=np.asarray(rv),
                dx=np.asarray(dx).reshape(inp["x"].shape), dw=np.asarray(dw),
                db=np.asarray(db), y_eval=np.asarray(y_eval).reshape(
                    inp["x"].shape))


@pytest.mark.parametrize("world", [2, 4])
def test_sync_batchnorm_across_ranks_matches_jax(tmp_path, world):
    """Forward (the module and the functional form), running statistics,
    the eval output, and the gradients of sum(y * dy): each rank's dx
    carries every rank's share of the statistics' gradient, and the
    parameters' gradients summed over the ranks are the whole batch's."""
    inp = _bn_inputs(world)
    out = run(tmp_path, world, "syncbn", inp)
    ref = _jax_bn(inp, world)
    for r in range(world):
        o = out[r]
        _close("y", o["y"], ref["y"][r], BN_TOL)
        _close("functional y", o["functional"][0], ref["y"][r], BN_TOL)
        _close("dx", o["dx"], ref["dx"][r], BN_TOL)
        _close("dw", o["dw"], ref["dw"], BN_TOL)
        _close("db", o["db"], ref["db"], BN_TOL)
        rm, rv, n = o["running"]
        _close("running mean", rm, ref["rm"], BN_TOL)
        _close("running var", rv, ref["rv"], BN_TOL)
        _close("functional running mean", o["functional"][1], ref["rm"],
               BN_TOL)
        _close("functional running var", o["functional"][2], ref["rv"],
               BN_TOL)
        assert n == 1
        _close("eval", o["eval"], ref["y_eval"][r], BN_TOL)


# -- LARC (no collective) ----------------------------------------------------

@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_larc_matches_jax(clip, wd):
    """Two LARC(FusedSGD) steps against the JAX wrapper, a zero gradient
    and a zero parameter among the leaves (the base-rate guard)."""
    rng = np.random.RandomState(3)
    shapes = [(7, 5), (5,), (130,), (3, 3)]
    vals = [rng.randn(*s).astype(np.float32) for s in shapes]
    vals[3][:] = 0.0
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    for g in grads:
        g[1][:] = 0.0
    kw = dict(lr=0.1, momentum=0.9, weight_decay=wd)
    params = [nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    opt = LARC(FusedSGD(params, **kw), trust_coefficient=0.02, clip=clip)
    jopt = JLARC(JFusedSGD(bucketed=False, **kw), trust_coefficient=0.02,
                 clip=clip)
    jp = {str(i): jnp.asarray(v) for i, v in enumerate(vals)}
    jstate = jopt.init(jp)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()
        jp, jstate = jopt.step({str(i): jnp.asarray(gi)
                                for i, gi in enumerate(g)}, jp, jstate)
        assert opt.param_groups[0]["weight_decay"] == wd
    for i, p in enumerate(params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[str(i)]),
                                   rtol=1e-6, atol=1e-7)
    # the functional transform
    t = larc(0.02, clip, 1e-8, wd, 0.1)
    tg, _ = t.update([torch.from_numpy(g) for g in grads[0]], t.init(None),
                     [torch.from_numpy(v) for v in vals])
    jt = jlarc(0.02, clip, 1e-8, wd, 0.1)
    jg, _ = jt.update([jnp.asarray(g) for g in grads[0]], jt.init(None),
                      [jnp.asarray(v) for v in vals])
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="params"):
        t.update(tg, None)


# -- the examples' data-parallel path ------------------------------------------

IMAGENET_ARGV = ["--device", "cpu", "--arch", "resnet18", "--batch-size", "8",
                 "--image-size", "64", "--num-classes", "10", "--steps", "2",
                 "--opt-level", "O0", "--sync-bn", "--lr", "1e-4"]


def test_imagenet_example_data_parallel_path_matches_one_process(tmp_path):
    """``examples/imagenet/main_amp`` on 2 gloo ranks with ``--sync-bn``
    (each rank its half of the global batch, batch statistics over both,
    DDP-averaged gradients) trains as one rank on the whole batch (a
    group of one: the same statistics formula, the JAX package's
    ``E[x^2] - mean^2``): the first loss (before any update) agrees to
    1e-5, the mean of the ranks' later losses to the one rank's to 1e-4,
    each parameter's move over the three steps to 5% in norm
    (``|move_2 - move_1| / |move_1|``), and the ranks' parameters are bit
    for bit the same.

    The move is held in norm, not entry by entry, because single entries
    of this network's f32 gradients are ill-conditioned: against the same
    gradients in f64 they are off by up to 12% of a tensor's largest
    entry (median 0.6%), so the ranks' other summation orders move single
    entries by up to 18%.  In norm the largest gap measured is 2.1% (a
    batch norm's weight; 1.4% over all parameters), where a missing
    average, a sum where a mean belongs or local statistics each move a
    parameter by 100% or more.  The simple DDP example runs on both
    ranks."""
    out = run(tmp_path, 2, "examples", {"argv": IMAGENET_ARGV}, timeout=240)
    one, = run(tmp_path, 1, "examples", {"argv": IMAGENET_ARGV})
    got = np.mean([o["losses"] for o in out], axis=0)
    np.testing.assert_allclose(got[0], one["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got, one["losses"], rtol=1e-4)
    from apex_tpu_torch.examples.imagenet import main_amp
    start = [p.detach().numpy() for p in main_amp.Trainer(
        main_amp.parse_args(IMAGENET_ARGV), torch.device("cpu")
    ).model.parameters()]
    for i, (p0, p1) in enumerate(zip(start, one["params"])):
        want = p1 - p0
        for o in out:
            gap = (np.linalg.norm(o["params"][i] - p0 - want)
                   / np.linalg.norm(want))
            assert gap <= 0.05, f"param {i}: move off by {gap:.3%} in norm"
            np.testing.assert_array_equal(o["params"][i], out[0]["params"][i])
    for o in out:
        assert o["devices"] == 2 and o["simple"][1] == 2
        assert np.all(np.isfinite(o["simple"][0]))
    assert one["devices"] == 1
