"""The compressed collectives, the packed bucket layout and the rank layout
of the port (``apex_tpu_torch.utils.compressed_allreduce``,
``multi_tensor_apply.bucketing``, ``transformer.parallel_state``) against
the JAX package.

The port runs on 2 and 4 ``gloo`` ranks on the CPU (``tests/_torch_dist.py``,
one spawn a world size for every collective case); the JAX package runs
the same per-rank numpy inputs through ``shard_map`` on a mesh of the first
N of the 8 CPU devices.

Tolerances: quantization, bucketing and the rank layout bit for bit; the
collectives' f32 sums 1e-6 relative to each output's largest entry (the
backends' and XLA's summation orders differ; the quantized modes' payloads
are rounded identically, so only the f32 sum of the ``world`` shards can
differ, in its last place).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.multi_tensor_apply import bucketing as jB
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.utils import compressed_allreduce as jCA
from apex_tpu_torch.multi_tensor_apply import bucketing as tB
from apex_tpu_torch.utils import compressed_allreduce as tCA

from _torch_dist import run

SUM_RTOL = 1e-6
MODES = (None, "bf16", "int8")
LEAVES = {"odd": (37,), "mat": (9, 50), "big": (3, 200)}


def _mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("data",))


def _inputs(world):
    rng = np.random.RandomState(world)
    x = (rng.randn(world, 8 * world, 128) * rng.uniform(
        0.01, 10.0, (world, 8 * world, 1))).astype(np.float32)
    x[:, 3] = 0.0                      # an all-zero row on every rank
    leaves = {k: rng.randn(world, *s).astype(np.float32)
              for k, s in LEAVES.items()}
    return dict(x=x, leaves=leaves, layouts=[(1, 1), (2, 1), (1, 2)]
                if world == 4 else [(1, 1), (2, 1)])


def _jax_collectives(inp, world):
    def body(x, odd, mat, big):
        x = x[0]
        out = {}
        for mode in MODES:
            rs = jCA.reduce_scatter(x, "data", world, mode)
            out[f"rs_{mode}"] = rs[None]
            out[f"ag_{mode}"] = jCA.all_gather_rows(rs, "data", mode)[None]
            for name, t in (("odd", odd), ("mat", mat), ("big", big)):
                out[f"psum_{name}_{mode}"] = jCA.psum_compressed(
                    t[0], "data", world, mode)[None]
        return out

    f = jax.jit(jax.shard_map(body, mesh=_mesh(world),
                              in_specs=(P("data"),) * 4,
                              out_specs=P("data")))
    got = f(inp["x"], *(inp["leaves"][k] for k in ("odd", "mat", "big")))
    return {k: np.asarray(v) for k, v in got.items()}


def _close(name, got, want, rtol=SUM_RTOL):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=name)


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    inp = _inputs(world)
    out = run(tmp_path_factory.mktemp(f"ca{world}"), world, "collectives",
              inp)
    return world, inp, out, _jax_collectives(inp, world)


@pytest.mark.parametrize("mode", MODES)
def test_reduce_scatter_and_all_gather_match_jax(ranks, mode):
    world, inp, out, ref = ranks
    for r in range(world):
        _close(f"rs {mode} rank {r}", out[r][f"rs_{mode}"],
               ref[f"rs_{mode}"][r])
        _close(f"ag {mode} rank {r}", out[r][f"ag_{mode}"],
               ref[f"ag_{mode}"][r])
    if mode is None:
        exact = inp["x"].astype(np.float64).sum(0)
        k = exact.shape[0] // world
        for r in range(world):
            _close("rs vs f64", out[r]["rs_None"], exact[r * k:(r + 1) * k])


@pytest.mark.parametrize("mode", MODES)
def test_psum_compressed_matches_jax(ranks, mode):
    world, inp, out, ref = ranks
    for name in LEAVES:
        for r in range(world):
            got = out[r][f"psum_{name}_{mode}"]
            assert got.shape == inp["leaves"][name].shape[1:]
            _close(f"psum {name} {mode} rank {r}", got,
                   ref[f"psum_{name}_{mode}"][r])


def test_int8_tree_keeps_integers_exact_and_indivisible_rows_raise(ranks):
    world, inp, out, _ = ranks
    for r in range(world):
        np.testing.assert_array_equal(out[r]["tree_i"],
                                      np.full(3, world * (world + 1) // 2))
        np.testing.assert_array_equal(out[r]["tree_f"],
                                      out[r]["psum_odd_int8"])
        assert "not divisible" in out[r]["indivisible"]


def test_rank_layout_matches_the_jax_mesh(ranks):
    """``initialize_model_parallel(tp, pp)`` lays the ranks out as the JAX
    package lays out devices 0..N-1; each axis's group is the line of that
    array through the rank."""
    world, inp, out, _ = ranks
    for tp, pp in inp["layouts"]:
        mesh = jps.initialize_model_parallel(tp, pp,
                                             devices=jax.devices()[:world])
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        jps.destroy_model_parallel()
        for r in range(world):
            np.testing.assert_array_equal(out[r][f"layout_{tp}_{pp}"], ids)
            d, p, t = (int(i[0]) for i in np.nonzero(ids == r))
            assert out[r][f"ranks_{tp}_{pp}"] == (d, p, t)
            groups = out[r][f"groups_{tp}_{pp}"]
            assert groups["data"] == list(ids[:, p, t])
            assert groups["pipe"] == list(ids[d, :, t])
            assert groups["model"] == list(ids[d, p, :])


# -- in process: the codec and the bucket layout, bit for bit ---------------

def test_quantize_int8_is_bitwise_jax():
    """Bit for bit the JAX codec as it runs, compiled (inside shard_map):
    XLA turns ``max / 127`` into a product with the f32 reciprocal, so
    the eager JAX op differs from it in some rows' scales."""
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 128) * rng.uniform(1e-6, 1e4, (64, 1))).astype(
        np.float32)
    x[5] = 0.0
    x[7, :3] = [1e30, -1e30, 0.5]          # a row whose max dwarfs the rest
    x[9] = np.arange(128, dtype=np.float32) - 63.5   # halves at x/scale
    x = np.concatenate([x, (rng.randn(4096, 128) * 0.1).astype(np.float32)])
    jq, js = jax.jit(jCA.quantize_int8)(jnp.asarray(x))
    tq, ts = tCA.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tCA.dequantize_int8(tq, ts).numpy(),
        np.asarray(jCA.dequantize_int8(jq, js)))
    assert tq.dtype == torch.int8 and ts.shape == (x.shape[0], 1)
    np.testing.assert_array_equal(
        tCA.pad_rows(torch.from_numpy(x[:5]), 4).numpy(),
        np.asarray(jCA.pad_rows(jnp.asarray(x[:5]), 4)))
    for bad in ("fp8", torch.float16):
        with pytest.raises(ValueError, match="not supported"):
            tCA.check_mode(bad)
    assert [tCA.check_mode(m) for m in (None, "f32", torch.float32, "bf16",
                                        torch.bfloat16, "int8", torch.int8)
            ] == [None, None, None, "bf16", "bf16", "int8", "int8"]


SHAPES = [(33, 17), (), (17,), (129, 40), (1,), (128,), (2, 3, 5)]


@pytest.mark.parametrize("block_rows", [1, 8, 512])
def test_bucket_layout_is_bitwise_jax(block_rows):
    rng = np.random.RandomState(block_rows)
    vals = [np.asarray(rng.randn(*s), np.float32) for s in SHAPES]
    jm = jB.bucket_meta(SHAPES, jnp.float32, block_rows)
    tm = tB.bucket_meta(SHAPES, torch.float32, block_rows)
    assert (tm.shapes, tm.sizes, tm.padded_sizes, tm.row_offsets, tm.nrows,
            tm.block_rows) == (jm.shapes, jm.sizes, jm.padded_sizes,
                               jm.row_offsets, jm.nrows, jm.block_rows)
    jflat = np.asarray(jB.flatten_bucket([jnp.asarray(v) for v in vals], jm))
    tflat = tB.flatten_bucket([torch.from_numpy(v) for v in vals], tm)
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    for got, want in zip(tB.unflatten_bucket(tflat, tm),
                         jB.unflatten_bucket(jnp.asarray(jflat), jm)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tB.row_tensor_ids(tm), jB.row_tensor_ids(jm))
    # a shard's rows, packed alone, are the bucket's rows; its segments
    # cover exactly the rows of its tensors
    world = 4 if tm.nrows % 4 == 0 else 1
    k = tm.nrows // world
    ids = tB.row_tensor_ids(tm)
    used = tB.used_rows(tm)
    for r in range(world):
        rows = tB.flatten_rows([torch.from_numpy(v) for v in vals], tm,
                               r * k, (r + 1) * k)
        np.testing.assert_array_equal(rows.numpy(), jflat[r * k:(r + 1) * k])
        covered = np.zeros(k, bool)
        for s in tB.shard_segments(tm, r * k, (r + 1) * k):
            assert np.all(ids[r * k + s.start:r * k + s.stop] == s.index)
            covered[s.start:s.stop] = True
        np.testing.assert_array_equal(
            covered, np.arange(r * k, (r + 1) * k) < used)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [1, 1000, 4096, 40_000, 10_000_000])
def test_split_by_message_size_is_jax(dtype, cap):
    shapes = SHAPES + [(1000,), (7, 7), (300, 3)]
    assert tB.split_by_message_size(shapes, getattr(torch, dtype), cap) \
        == jB.split_by_message_size(shapes, getattr(jnp, dtype), cap)


def test_group_by_dtype_and_bad_cap():
    ts = [torch.zeros(2), torch.zeros(3, dtype=torch.bfloat16),
          torch.zeros(1), torch.zeros(4, dtype=torch.bfloat16)]
    assert tB.group_by_dtype(ts) == {torch.float32: [0, 2],
                                     torch.bfloat16: [1, 3]}
    with pytest.raises(ValueError, match="positive"):
        tB.split_by_message_size([(3,)], torch.float32, 0)


def test_collectives_without_a_group_are_identities():
    """No torch.distributed: an axis of one rank, every collective the
    identity (the quantized modes still round their payload)."""
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 128).astype(
        np.float32))
    assert torch.equal(tCA.reduce_scatter(x), x)
    assert torch.equal(tCA.all_gather_rows(x), x)
    assert torch.equal(tCA.psum_compressed(x), x)
    q, s = tCA.quantize_int8(x)
    assert torch.equal(tCA.reduce_scatter(x, mode="int8"),
                       tCA.dequantize_int8(q, s))
