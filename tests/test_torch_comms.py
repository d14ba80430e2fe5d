"""apex_tpu_torch.observability.comms and the rest of
apex_tpu_torch.utils.profiling, on the CPU.

* ``collective_stats`` at 2 ``gloo`` ranks (one spawn of
  ``tests/_torch_dist.py``, ``tests/_torch_obs_ranks.py``): the
  reference's hand-computed cases (``tests/test_metrics.py``: a psum of a
  per-device f32[4, 16] moves 4·16·4 bytes, the tiled all-gather 8·16·4)
  against JAX's ``collective_stats`` of the same ``shard_map`` programs,
  plus a reduce-scatter (the full operand), a one-hop send/recv ring (one
  permute per rank) and an all-to-all; each op's ``scope`` is the range or
  span it ran under.  ``wire_bytes`` and ``format_stats`` are JAX's on the
  same accounting.
* A ZeRO step of a small GPT (``DistributedFusedAdam`` over small
  buckets) counts one reduce-scatter of the full bucket and one all-gather
  of the full result per bucket of its layout, plus the overflow flag's
  all-reduce when the step takes a ``noop_flag``; a DDP step one
  all-reduce per bucket of its layout.  Exact counts and bytes.
* Profiling: ranges balance and warn once on an unmatched pop;
  ``program_hash`` is stable on a repeat and tells two functions apart;
  ``memory_stats``' ``temp`` of a small GPT's training step under remat
  "full" is below the step without remat.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.observability import comms as J
from apex_tpu.utils.collectives import shard_map_compat

from _torch_dist import start
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.observability import (collective_stats, format_stats,
                                          wire_bytes)
from apex_tpu_torch.utils import profiling

WORLD = 2
TINY = dict(vocab_size=32, hidden_size=16, num_layers=2,
            num_attention_heads=4, max_seq_len=8)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comms")
    parts = {"comms_hand": {},
             "comms_zero": dict(cfg=TINY, seed=3, message_size=2048)}
    return start(tmp, WORLD, "obs", {"parts": parts}, timeout=240).result()


def _jax_stats(body, **specs):
    mesh = jax.make_mesh((2,), ("tp",), devices=jax.devices()[:2])
    fn = shard_map_compat(body, mesh=mesh, in_specs=P("tp"), **specs)
    return J.collective_stats(fn, jnp.ones((8, 16), jnp.float32))


def _only(stats, kind):
    """The one op of ``kind`` in ``stats``; every other kind is empty."""
    for k in ("all_reduce", "all_gather", "reduce_scatter",
              "collective_permute", "all_to_all"):
        if k != kind:
            assert stats[k]["count"] == 0, k
    assert stats[kind]["count"] == 1 and stats["total"]["count"] == 1
    return stats[kind]["ops"][0]


@pytest.mark.parametrize("rank", range(WORLD))
def test_psum_and_all_gather_match_jax(ranks, rank):
    out = ranks[rank]["comms_hand"]
    jpsum = _jax_stats(lambda x: jax.lax.psum(x, "tp"), out_specs=P())
    jgather = _jax_stats(lambda x: jax.lax.all_gather(x, "tp", tiled=True),
                         out_specs=P())
    op = _only(out["psum"], "all_reduce")
    assert out["psum"]["all_reduce"]["bytes"] == 4 * 16 * 4 \
        == jpsum["all_reduce"]["bytes"]
    assert op["group_size"] == 2 == jpsum["all_reduce"]["ops"][0][
        "group_size"]
    assert op["scope"] == "attn" and op["op"] == "c10d::allreduce_"
    op = _only(out["gather"], "all_gather")
    assert out["gather"]["all_gather"]["bytes"] == 8 * 16 * 4 \
        == jgather["all_gather"]["bytes"]
    assert op["scope"] == "gather" and op["group_size"] == 2
    # ring all-reduce over k=2: 2*(k-1)/k = 1.0x payload, as in JAX
    assert out["wire"] == 4 * 16 * 4 == J.wire_bytes(jpsum)
    assert "all_reduce" in out["table"] and "total" in out["table"]
    assert "attn" in out["table"]


@pytest.mark.parametrize("rank", range(WORLD))
def test_scatter_permute_and_all_to_all(ranks, rank):
    out = ranks[rank]["comms_hand"]
    op = _only(out["scatter"], "reduce_scatter")
    assert op["bytes"] == 4 * 16 * 4 and op["group_size"] == 2
    assert op["op"] == "c10d::_reduce_scatter_base_"
    # the send counts; its recv is the peer's send seen from here
    op = _only(out["ring"], "collective_permute")
    assert op["bytes"] == 4 * 16 * 4 and op["scope"] == "ring"
    assert out["ring"]["dispatched"] == {"c10d::send": 1, "c10d::recv_": 1}
    op = _only(out["a2a"], "all_to_all")
    assert op["bytes"] == 4 * 16 * 4 and op["scope"] == ""


@pytest.mark.parametrize("rank", range(WORLD))
def test_zero_step_counts_its_bucket_layout(ranks, rank):
    out = ranks[rank]["comms_zero"]
    layout = out["zero_layout"]
    assert out["world"] == WORLD and len(layout) > 1
    full = [r * c * b for r, c, b in layout]
    for key, flag in (("zero", 0), ("zero_noop", 1)):
        st = out[key]
        assert st["reduce_scatter"]["count"] == len(layout)
        assert [o["bytes"] for o in st["reduce_scatter"]["ops"]] == full
        assert st["all_gather"]["count"] == len(layout)
        assert [o["bytes"] for o in st["all_gather"]["ops"]] == full
        # the overflow flag's all-reduce: one int32, with a noop_flag
        assert st["all_reduce"]["count"] == flag
        assert [o["bytes"] for o in st["all_reduce"]["ops"]] == [4] * flag
        assert st["total"]["bytes"] == 2 * sum(full) + 4 * flag
        assert {o["scope"] for k in ("reduce_scatter", "all_gather",
                                     "all_reduce")
                for o in st[k]["ops"]} <= {"zero_step"}
        assert {o["group_size"] for o in st["reduce_scatter"]["ops"]} \
            == {WORLD}


@pytest.mark.parametrize("rank", range(WORLD))
def test_ddp_step_counts_its_bucket_layout(ranks, rank):
    out = ranks[rank]["comms_zero"]
    st, layout = out["ddp"], out["ddp_layout"]
    assert len(layout) > 1
    assert st["all_reduce"]["count"] == len(layout)
    assert sorted(o["bytes"] for o in st["all_reduce"]["ops"]) \
        == sorted(r * c * b for r, c, b in layout)
    assert st["total"]["count"] == len(layout)
    assert {o["scope"] for o in st["all_reduce"]["ops"]} == {"ddp_step"}


def test_format_and_wire_match_jax_on_one_accounting():
    text = """
  %ar = f32[4,16]{1,0} all-reduce(f32[4,16]{1,0} %dot), channel_id=1, replica_groups={{0,1,2,3}}, metadata={op_name="jit(f)/attn/psum"}
  %ag-start = (f32[4]{0}, f32[8]{0}) all-gather-start(f32[4]{0} %x), replica_groups={{0,1}}
  %ag-done = f32[8]{0} all-gather-done((f32[4]{0}, f32[8]{0}) %ag-start)
  %cp = bf16[16]{0} collective-permute(bf16[16]{0} %y), source_target_pairs={{0,1}}
"""
    st = J.hlo_collective_stats(text)
    assert wire_bytes(st) == J.wire_bytes(st)
    for by_scope in (False, True):
        assert format_stats(st, by_scope=by_scope) \
            == J.format_stats(st, by_scope=by_scope)


def test_no_collectives_without_torch_distributed():
    st = collective_stats(lambda x: x * 2, torch.ones(3))
    assert st["total"] == {"count": 0, "bytes": 0}
    assert st["dispatched"] == {} and wire_bytes(st) == 0


# -- profiling ---------------------------------------------------------------


def test_ranges_balance_and_unmatched_pop_warns_once(monkeypatch):
    monkeypatch.setattr(profiling, "_POP_MISMATCH_WARNED", False)
    assert profiling.range_depth() == 0
    profiling.range_push("outer")
    profiling.range_push("inner")
    assert profiling.range_depth() == 2
    assert profiling.current_scope() == "inner"
    profiling.range_pop()
    assert profiling.current_scope() == "outer"
    profiling.range_pop()
    assert profiling.range_depth() == 0 and profiling.current_scope() == ""
    with profiling.annotate("a"):
        with profiling.annotate("b"):
            assert profiling.range_depth() == 2
        assert profiling.current_scope() == "a"
    assert profiling.range_depth() == 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        profiling.range_pop()
        profiling.range_pop()
    assert len(caught) == 1 and "range_pop" in str(caught[0].message)


def test_ranges_are_per_thread_with_an_explicit_fallback():
    """A thread with no open range has no scope of its own, whatever
    another thread has open; it names that thread's range only when given
    its stack (as ``collective_stats`` does for autograd's device
    thread)."""
    import threading
    seen = {}
    with profiling.annotate("caller"):
        home = profiling.range_stack()

        def worker():
            seen["own"] = profiling.current_scope()
            seen["fallback"] = profiling.current_scope(home)
            with profiling.annotate("worker"):
                seen["inner"] = profiling.current_scope(home)
            seen["depth"] = profiling.range_depth()
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert profiling.current_scope() == "caller"
    assert seen == {"own": "", "fallback": "caller", "inner": "worker",
                    "depth": 0}
    assert profiling.range_depth() == 0


def test_ranges_enter_the_profiler():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("monitored_region"):
            torch.ones(4) * 2
        profiling.range_push("pushed_region")
        torch.ones(4) + 1
        profiling.range_pop()
    names = {e.name for e in prof.events()}
    assert {"monitored_region", "pushed_region"} <= names


def test_program_hash_stable_and_distinct():
    x = torch.randn(8, 8)

    def f(x):
        return (x @ x).relu().sum(0)

    def g(x):
        return (x @ x).sigmoid().sum(0)
    h = profiling.program_hash(f, x)
    assert h == profiling.program_hash(f, x) and len(h) == 64
    assert h != profiling.program_hash(g, x)
    # the shapes are part of the program, the values are not
    assert h == profiling.program_hash(f, torch.randn(8, 8))
    assert h != profiling.program_hash(f, torch.randn(4, 4))
    assert profiling.assert_same_program(f, x) == h
    assert profiling.assert_same_program(h) == h


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("traced"):
            torch.ones(16).sum()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1 and "traced" in files[0].read_text()


def test_memory_stats_temp_falls_under_full_remat():
    r = np.random.RandomState(0)
    cfg = dict(vocab_size=64, hidden_size=64, num_layers=4,
               num_attention_heads=4, max_seq_len=64)
    tokens = torch.from_numpy(r.randint(0, 64, (4, 64)))
    targets = torch.from_numpy(r.randint(0, 64, (4, 64)))
    temp = {}
    for policy in (None, "full"):
        kw = {} if policy is None else dict(remat=True, remat_policy=policy)
        model = GPTModel(GPTConfig(**cfg, **kw), device="cpu").init_params(
            torch.Generator().manual_seed(0))

        def step(tokens, targets):
            loss = model.loss(tokens, targets)
            loss.backward()
            return loss.detach()
        st = profiling.memory_stats(step, tokens, targets)
        assert st["argument"] == 2 * tokens.numel() * 8
        assert st["output"] == 4 and st["alias"] == 0
        assert st["generated_code"] == 0
        temp[policy] = st["temp"]
    assert 0 < temp["full"] < temp[None]
