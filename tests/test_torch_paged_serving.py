"""The paged serving tier of apex_tpu_torch against apex_tpu on the CPU.

Inputs come from numpy seeds and go through both packages; each check
states its tolerance:

* the block pool's bookkeeping (block ids, refcounts, the prefix trie, LRU
  eviction, copy-on-write) follows the JAX pool op for op, and the int8
  pool's storage (``quantize_kv_blocks``, ``write_context_kv``,
  ``_quant_insert``) is bitwise JAX's;
* the paged attention ops: the decode plain version against the JAX
  Pallas kernel in interpret mode and the JAX default path (f32, 1e-5), on
  a shuffled table whose rows share blocks with ragged lengths; the chunk
  and int8 ops against JAX (f32, 1e-5);
* the tiny GPT of ``tests/test_serving.py`` (f32): ``decode_step_paged``
  logits bitwise the port's own ``decode_step``; ``PagedInferenceEngine``
  greedy tokens equal to JAX's engine with prefix sharing, chunked prefill,
  speculative decoding (a perfect draft accepts every proposal), pool
  pressure and ``preempt()``; seeded stochastic tokens equal to the port's
  contiguous engine (the port's sampling streams cannot replay
  ``jax.random``); ``kv_quant="int8"`` tokens equal to JAX's, its pool state
  independent of the scheduler's token budget;
* every constructor refusal of the JAX engine has a counterpart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.inference import (InferenceEngine as JEngine,
                                Request as JRequest)
from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.ops import flash_attention as jfa
from apex_tpu.serving import (PagedInferenceEngine as JPaged,
                              PagedKVCache as JPool,
                              QuantizedPagedKVCache as JQPool,
                              SpeculativeConfig as JSpec,
                              TickScheduler as JSched)
from apex_tpu.utils import set_force_pallas

from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.inference import (InferenceEngine, Request,
                                      SamplingParams)
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, ParallelAttention
from apex_tpu_torch.ops import flash_attention as tfa
from apex_tpu_torch.serving import (PagedInferenceEngine, PagedKVCache,
                                    QuantizedPagedKVCache, SpeculativeConfig,
                                    TickScheduler)

TINY = dict(vocab_size=32, hidden_size=16, num_layers=2,
            num_attention_heads=2, max_seq_len=16)
TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jm = JModel(JConfig(**TINY))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = GPTConfig(**TINY)
    tm = GPTModel(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return jm, jp, tm


def _greedy_requests():
    return [(0, [1, 2, 3, 4, 5], 6), (1, [1, 2, 3, 9], 5),
            (2, [1, 2, 3, 4, 5, 6, 7], 4), (3, [4, 4, 4], 5)]


def _seeded_requests():
    """The JAX tests' stochastic surface: temperature, top-k, top-p."""
    return [
        Request(0, [1, 2, 3, 4, 5], max_new_tokens=6),
        Request(1, [1, 2, 3, 9], max_new_tokens=5, seed=7,
                sampling=SamplingParams(temperature=0.8, top_k=5)),
        Request(2, [1, 2, 3, 4, 5, 6, 7], max_new_tokens=4, seed=3,
                sampling=SamplingParams(temperature=1.1, top_p=0.9)),
        Request(3, [4, 4, 4], max_new_tokens=5, seed=11,
                sampling=SamplingParams(temperature=1.0, top_k=8,
                                        top_p=0.8)),
    ]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(dataclasses.replace(r))
    return {r.request_id: (r.tokens, r.finish_reason) for r in engine.run()}


def _run_both(jeng, teng, specs):
    jr = _run(jeng, [JRequest(i, p, max_new_tokens=n) for i, p, n in specs])
    tr = _run(teng, [Request(i, p, max_new_tokens=n) for i, p, n in specs])
    return jr, tr


# -- the block pool ----------------------------------------------------------

def _pools(blocks=9, bs=4, **kw):
    return (JPool(blocks, bs, layers=2, kv_heads=2, head_dim=4,
                  dtype=jnp.float32, **kw),
            PagedKVCache(blocks, bs, layers=2, kv_heads=2, head_dim=4,
                         dtype=torch.float32, device="cpu", **kw))


def _same_books(jp, tp):
    assert tp.stats() == jp.stats()
    assert (tp.free_blocks, tp.used_blocks, tp.shared_blocks,
            tp.block_bytes, tp.free_bytes(), tp.occupancy()) == (
        jp.free_blocks, jp.used_blocks, jp.shared_blocks, jp.block_bytes,
        jp.free_bytes(), jp.occupancy())


def _seq_ids(seq):
    return None if seq is None else (list(seq.block_ids), seq.num_tokens,
                                     seq.shared_tokens)


def _script(pool, sysp):
    """One op sequence: sharing, prefix cap, release with trie retention,
    LRU eviction under demand, exhaustion, fork and copy-on-write."""
    out = []
    a = pool.acquire(sysp + [9])
    pool.register_prefix(a, sysp + [9])
    b = pool.acquire(sysp + [10])
    c = pool.acquire(sysp)                # fully cached: capped
    out += [_seq_ids(s) for s in (a, b, c)]
    f = pool.fork(b)
    tail = len(b.block_ids) - 1
    out.append((pool.ensure_writable(f, tail), pool.ensure_writable(a, 0)))
    for s in (a, b, c, f):
        pool.release(s)
    d = pool.acquire([7] * 30)            # evicts the cached prefix
    out += [_seq_ids(d), _seq_ids(pool.acquire([5] * 4))]
    out.append(pool.ensure_capacity(d, 31))
    out.append(list(pool.table_row(d, 9)))
    return out


def test_pool_bookkeeping_follows_jax_op_for_op():
    jp, tp = _pools(blocks=10)
    sysp = [1, 2, 3, 4, 5, 6, 7, 8]
    assert _script(tp, sysp) == _script(jp, sysp)
    _same_books(jp, tp)
    # the fork's tail and a's trie-shared first block each copy once
    assert tp.evicted_blocks > 0 and tp.cow_copies == 2


def test_pool_prefix_sharing_stores_shared_blocks_once():
    jp, tp = _pools(blocks=17)
    sysp = [1, 2, 3, 4, 5, 6, 7, 8]
    for pool in (jp, tp):
        a = pool.acquire(sysp + [9])
        pool.register_prefix(a, sysp + [9])
        b = pool.acquire(sysp + [10])
        assert b.shared_tokens == 8 and b.block_ids[:2] == a.block_ids[:2]
    assert tp.used_blocks == 4 and tp.shared_blocks == 2
    _same_books(jp, tp)


@pytest.mark.parametrize("kw", [dict(num_blocks=1), dict(block_size=0)])
def test_pool_refusals_match_jax(kw):
    args = dict(num_blocks=4, block_size=4, layers=1, kv_heads=1, head_dim=4)
    args.update(kw)
    with pytest.raises(ValueError):
        JPool(**args)
    with pytest.raises(ValueError):
        PagedKVCache(**args, device="cpu")


def test_write_context_kv_matches_jax():
    """A prompt of 10 over blocks of 4 behind a shared 4-token prefix: the
    pool holds JAX's values (bitwise, f32) at every block."""
    rng = np.random.RandomState(0)
    jp, tp = _pools(blocks=9)
    toks = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    for pool in (jp, tp):
        a = pool.acquire(toks[:4] + [11])
        pool.register_prefix(a, toks[:4] + [11])
    kv = rng.randn(2, 2, 16, 2, 4).astype(np.float32)   # bucket-padded
    ja, ta = jp.acquire(toks), tp.acquire(toks)
    jp.write_context_kv(ja, jnp.asarray(kv), 10)
    tp.write_context_kv(ta, torch.from_numpy(kv), 10)
    assert ta.block_ids == ja.block_ids and ta.shared_tokens == 4
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))


def test_quantized_pool_storage_matches_jax():
    """Zero-on-alloc, one-shot quantized prefill KV and copy-on-write of
    the scales, bitwise JAX's int8 and scales."""
    rng = np.random.RandomState(1)
    jp = JQPool(9, 4, layers=2, kv_heads=2, head_dim=4, dtype=jnp.float32)
    tp = QuantizedPagedKVCache(9, 4, layers=2, kv_heads=2, head_dim=4,
                               dtype=torch.float32, device="cpu")
    assert tp.block_bytes == jp.block_bytes
    assert tp.data.dtype == torch.int8
    kv = rng.randn(2, 2, 8, 2, 4).astype(np.float32)
    kv[1, 0, :, 1] = 0.0                  # an all-zero (block, head) slice
    ja, ta = jp.acquire(list(range(1, 7))), tp.acquire(list(range(1, 7)))
    jp.write_context_kv(ja, jnp.asarray(kv), 6)
    tp.write_context_kv(ta, torch.from_numpy(kv), 6)
    jf, tf = jp.fork(ja), tp.fork(ta)
    assert (tp.ensure_writable(tf, 1), tp.cow_copies) == (
        jp.ensure_writable(jf, 1), jp.cow_copies)
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    np.testing.assert_array_equal(tp.scales.numpy(), np.asarray(jp.scales))
    assert (tp.scales[ta.block_ids[0], 1, 0, 1] == 1.0).item()


# -- the paged attention ops -------------------------------------------------

def _paged_inputs(seed, b=4, nb=4, bs=8, h=2, d=16, pool_blocks=24):
    """A shuffled table whose rows 1 and 2 share their first two blocks,
    ragged lengths (1 token, mid-block, block edge, full), and the rest of
    each row padded with the garbage block 0."""
    rng = np.random.RandomState(seed)
    pk = rng.randn(pool_blocks, bs, h, d).astype(np.float32)
    pv = rng.randn(pool_blocks, bs, h, d).astype(np.float32)
    lens = np.array([1, 17, 24, nb * bs], np.int32)
    ids = list(rng.permutation(np.arange(1, pool_blocks)))
    tables = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lens):
        need = -(-int(n) // bs)
        tables[i, :need] = [ids.pop() for _ in range(need)]
    tables[2, :2] = tables[1, :2]
    q = rng.randn(b, h, d).astype(np.float32)
    return q, pk, pv, tables, lens


def _to_jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _to_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_gather_paged_kv_matches_jax():
    _, pk, _, tables, _ = _paged_inputs(0)
    np.testing.assert_array_equal(
        tfa.gather_paged_kv(*_to_torch(pk, tables)).numpy(),
        np.asarray(jfa.gather_paged_kv(*_to_jax(pk, tables))))


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["jax_interpret_kernel", "jax_default_path"])
def test_decode_paged_plain_version_matches_jax(pallas):
    """The plain version of #7 against the JAX Pallas ``_decode_paged_kernel``
    in interpret mode and against the JAX default path, f32 within 1e-5."""
    args = _paged_inputs(1)
    set_force_pallas(True if pallas else None)
    try:
        want = np.asarray(jfa.flash_attention_decode_paged(*_to_jax(*args)))
    finally:
        set_force_pallas(None)
    got = tfa.flash_attention_decode_paged(*_to_torch(*args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    q, pk, pv, tables, lens = _to_torch(*args)
    np.testing.assert_array_equal(
        got.numpy(), tfa.flash_attention_decode_reference(
            q, tfa.gather_paged_kv(pk, tables),
            tfa.gather_paged_kv(pv, tables), lens).numpy())


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("pallas", [True, False],
                         ids=["jax_interpret_kernel", "jax_default_path"])
def test_decode_paged_matches_jax_at_the_chunk_edges(pallas, bs):
    """#7's plain version against JAX at the lengths where the card's
    split-K kernel cuts a row (0, 1, DECODE_SPLIT - 1, DECODE_SPLIT,
    DECODE_SPLIT + 1, the whole table and past it), at both of the
    engine's block sizes, through a shuffled table; f32 within 1e-5."""
    split = tfa.DECODE_SPLIT
    nb = 3 * split // bs
    lens = np.array([0, 1, split - 1, split, split + 1, nb * bs,
                     nb * bs + 100], np.int32)
    b, h, d = len(lens), 1, 16
    rng = np.random.RandomState(6)
    pool_blocks = 1 + int(sum(min(-(-n // bs), nb) for n in lens))
    pk = rng.randn(pool_blocks, bs, h, d).astype(np.float32)
    pv = rng.randn(pool_blocks, bs, h, d).astype(np.float32)
    ids = list(rng.permutation(np.arange(1, pool_blocks)))
    tables = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lens):
        need = min(-(-int(n) // bs), nb)
        tables[i, :need] = [ids.pop() for _ in range(need)]
    q = rng.randn(b, h, d).astype(np.float32)
    args = (q, pk, pv, tables, lens)
    set_force_pallas(True if pallas else None)
    try:
        want = np.asarray(jfa.flash_attention_decode_paged(*_to_jax(*args)))
    finally:
        set_force_pallas(None)
    got = tfa.flash_attention_decode_paged(*_to_torch(*args))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert not got[0].any()


def test_chunk_paged_matches_jax():
    q1, pk, pv, tables, _ = _paged_inputs(2)
    rng = np.random.RandomState(3)
    q = rng.randn(4, 2, 3, 16).astype(np.float32)
    qpos = np.array([[0, 1, 2], [14, 15, 16], [21, 22, 23], [29, 30, 31]],
                    np.int32)
    want = jfa.flash_attention_chunk_paged(*_to_jax(q, pk, pv, tables, qpos))
    got = tfa.flash_attention_chunk_paged(*_to_torch(q, pk, pv, tables,
                                                     qpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("zero_block", [False, True])
def test_quantize_kv_blocks_bitwise_matches_jax(zero_block):
    x = np.random.RandomState(4).randn(3, 2, 2, 8, 2, 16).astype(np.float32)
    if zero_block:
        x[1, 0] = 0.0
        x[2, 1, 0, :, 1] = 0.0
    jq8, jsc = jfa.quantize_kv_blocks(jnp.asarray(x))
    tq8, tsc = tfa.quantize_kv_blocks(torch.from_numpy(x))
    assert tq8.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        tfa.dequantize_kv_blocks(tq8, tsc).numpy(),
        np.asarray(jfa.dequantize_kv_blocks(jq8, jsc)))


def _quant_pool_inputs(seed):
    q, pk, pv, tables, lens = _paged_inputs(seed)
    k8, ksc = jfa.quantize_kv_blocks(jnp.asarray(pk))
    v8, vsc = jfa.quantize_kv_blocks(jnp.asarray(pv))
    return q, np.asarray(k8), np.asarray(v8), np.asarray(ksc), \
        np.asarray(vsc), tables, lens


def test_decode_and_chunk_paged_quant_match_jax():
    q, k8, v8, ksc, vsc, tables, lens = _quant_pool_inputs(5)
    want = jfa.flash_attention_decode_paged_quant(
        *_to_jax(q, k8, v8, ksc, vsc, tables, lens))
    got = tfa.flash_attention_decode_paged_quant(
        *_to_torch(q, k8, v8, ksc, vsc, tables, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    qc = np.random.RandomState(6).randn(4, 2, 2, 16).astype(np.float32)
    qpos = np.stack([lens - 2, lens - 1], axis=1).clip(0)
    want = jfa.flash_attention_chunk_paged_quant(
        *_to_jax(qc, k8, v8, ksc, vsc, tables, qpos))
    got = tfa.flash_attention_chunk_paged_quant(
        *_to_torch(qc, k8, v8, ksc, vsc, tables, qpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_quant_insert_bitwise_matches_jax(tiny):
    """One token's K/V into an int8 pool: the dequantize / insert /
    requantize of the whole block, bitwise JAX's pool and scales."""
    jm = tiny[0]
    rng = np.random.RandomState(7)
    blocks = rng.randn(6, 2, 2, 4, 2, 8).astype(np.float32)
    blocks[4] = 0.0                       # a freshly zeroed block
    pool, scales = (np.asarray(a) for a in jfa.quantize_kv_blocks(
        jnp.asarray(blocks)))
    bids = np.array([4, 2, 0], np.int32)
    offs = np.array([0, 3, 1], np.int32)
    k = rng.randn(3, 2, 8).astype(np.float32)
    v = rng.randn(3, 2, 8).astype(np.float32)
    jpool, jsc = jm.layers[0].attention._quant_insert(
        *_to_jax(pool, scales), 1, *_to_jax(bids, offs, k, v))
    tpool, tsc = _to_torch(pool, scales)
    ParallelAttention._quant_insert(tpool, tsc, 1,
                                    *_to_torch(bids, offs, k, v))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


# -- the model's paged decode ------------------------------------------------

def test_decode_step_paged_logits_bitwise_the_contiguous_step(tiny):
    """Prompt through five decode steps, the paged step's logits are
    BITWISE the contiguous step's, as the JAX package asserts."""
    tm = tiny[2]
    base = InferenceEngine(tm, max_slots=2, device="cpu",
                           cache_dtype=torch.float32)
    paged = PagedInferenceEngine(tm, max_slots=2, block_size=4,
                                 device="cpu", cache_dtype=torch.float32)
    for i, pr in enumerate(([1, 2, 3, 4, 5], [7, 8, 9])):
        base.submit(Request(i, pr, max_new_tokens=8))
        paged.submit(Request(i, pr, max_new_tokens=8))
    base._admit()
    paged._admit()
    for _ in range(5):
        toks = np.zeros((2,), np.int64)
        pos = np.zeros((2,), np.int32)
        for s, st in base._active.items():
            toks[s], pos[s] = st.next_token, st.position
            assert paged._grow(s, st.position + 1)
        bl, _ = tm.decode_step(torch.from_numpy(toks), base.cache.data,
                               torch.from_numpy(pos))
        pl, _ = tm.decode_step_paged(torch.from_numpy(toks),
                                     paged.pool.data,
                                     torch.from_numpy(paged._tables),
                                     torch.from_numpy(pos))
        np.testing.assert_array_equal(bl.numpy().view(np.uint32),
                                      pl.numpy().view(np.uint32))
        base._advance_slots(sorted(base._active), bl.numpy())
        paged._advance_slots(sorted(paged._active), pl.numpy())


def test_decode_chunk_matches_jax(tiny):
    """A 6-token chunk at positions 2..7 over a pool holding positions
    0..1: logits and the pool within 1e-5 of JAX's."""
    jm, jp, tm = tiny
    rng = np.random.RandomState(8)
    pool = rng.randn(5, 2, 2, 4, 2, 8).astype(np.float32)
    tables = np.array([[3, 1, 0, 0]], np.int32)
    toks = np.array([[5, 9, 2, 7, 1, 3]])
    pos = np.arange(2, 8, dtype=np.int32)[None]
    wb = tables[0][pos // 4]
    wo = pos % 4
    jl, jpool = jm.decode_chunk(jp, jnp.asarray(toks), *_to_jax(
        pool, tables, pos, wb, wo))
    tpool = torch.from_numpy(pool.copy())
    tl, _ = tm.decode_chunk(torch.from_numpy(toks), tpool,
                            *_to_torch(tables, pos, wb, wo))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-5,
                               rtol=1e-5)


# -- the paged engine --------------------------------------------------------

def _engines(tiny, **kw):
    jm, jp, tm = tiny
    jkw = dict(kw)
    if "scheduler" in kw:
        s = kw["scheduler"]
        jkw["scheduler"] = JSched(s.token_budget, s.min_chunk, s.max_chunk)
    if "speculative" in kw:
        jkw["speculative"] = JSpec(jm, jp, num_tokens=kw[
            "speculative"].num_tokens)
    slots = kw.pop("max_slots", 4)
    jkw.pop("max_slots", None)
    return (JPaged(jm, jp, max_slots=slots, block_size=4,
                   cache_dtype=jnp.float32, **jkw),
            PagedInferenceEngine(tm, max_slots=slots, block_size=4,
                                 device="cpu", cache_dtype=torch.float32,
                                 **kw))


MODES = {
    "monolithic": {},
    "chunked": dict(scheduler=TickScheduler(token_budget=8, min_chunk=2,
                                            max_chunk=4),
                    chunked_prefill=True),
    "speculative": dict(speculative=2),
    "chunked_speculative": dict(chunked_prefill=True, speculative=3),
    "no_prefix_sharing": dict(share_prefixes=False),
}


def _mode_kw(tiny, mode):
    kw = dict(MODES[mode])
    if "speculative" in kw:
        kw["speculative"] = SpeculativeConfig(tiny[2],
                                              num_tokens=kw["speculative"])
    return kw


@pytest.mark.parametrize("mode", sorted(MODES))
def test_paged_engine_greedy_tokens_match_jax(tiny, mode):
    """Greedy streams equal the JAX paged engine's and the JAX contiguous
    engine's, token for token."""
    jeng, teng = _engines(tiny, **_mode_kw(tiny, mode))
    jr, tr = _run_both(jeng, teng, _greedy_requests())
    assert tr == jr
    jm, jp, _ = tiny
    ref = _run(JEngine(jm, jp, max_slots=4, cache_dtype=jnp.float32),
               [JRequest(i, p, max_new_tokens=n)
                for i, p, n in _greedy_requests()])
    assert tr == ref
    if mode.endswith("speculative"):
        # draft == target: every proposal matches the canonical stream
        assert teng.spec_proposed > 0 and teng.spec_accept_rate == 1.0
        assert (teng.spec_proposed, teng.spec_accepted) == (
            jeng.spec_proposed, jeng.spec_accepted)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_paged_engine_seeded_tokens_match_the_contiguous_engine(tiny, mode):
    """Greedy and seeded stochastic requests in one batch: the paged
    engine's streams are the port's contiguous engine's."""
    tm = tiny[2]
    ref = _run(InferenceEngine(tm, max_slots=4, device="cpu",
                               cache_dtype=torch.float32),
               _seeded_requests())
    out = _run(PagedInferenceEngine(tm, max_slots=4, block_size=4,
                                    device="cpu", cache_dtype=torch.float32,
                                    **_mode_kw(tiny, mode)),
               _seeded_requests())
    assert out == ref


def test_prefix_sharing_saves_blocks_as_jax(tiny):
    sysp = [1, 2, 3, 4, 5, 6, 7, 8]
    specs = [(i, sysp + [9 + i], 3) for i in range(4)]
    jeng, teng = _engines(tiny)
    for i, p, n in specs:
        jeng.submit(JRequest(i, p, max_new_tokens=n))
        teng.submit(Request(i, p, max_new_tokens=n))
    jeng.step()
    teng.step()
    assert teng.pool.shared_blocks == 2
    assert teng.pool.stats() == jeng.pool.stats()
    assert teng._tables.tolist() == jeng._tables.tolist()
    jr = {r.request_id: r.tokens for r in jeng.run()}
    assert {r.request_id: r.tokens for r in teng.run()} == jr


def test_pool_pressure_preempts_and_resumes_token_identical(tiny):
    """An undersized pool forces mid-decode preemption of the most
    recently admitted request; every stream still equals JAX's (and the
    contiguous engine's)."""
    jeng, teng = _engines(tiny, max_slots=3, num_blocks=7)
    specs = [(i, [1 + i, 2, 3, 4, 5], 8) for i in range(3)]
    jr, tr = _run_both(jeng, teng, specs)
    assert tr == jr
    assert teng.metrics.requeued > 0
    assert teng.metrics.requeued == jeng.metrics.requeued
    tm = tiny[2]
    ref = _run(InferenceEngine(tm, max_slots=3, device="cpu",
                               cache_dtype=torch.float32),
               [Request(i, p, max_new_tokens=n) for i, p, n in specs])
    assert tr == ref


@pytest.mark.parametrize("paged", [False, True])
def test_preempt_requeues_and_resumes_token_identical(tiny, paged):
    """``preempt()`` after two steps frees every slot (and the paged
    engine's exclusive blocks) and requeues; the resumed streams equal the
    uninterrupted JAX run."""
    jm, jp, tm = tiny
    specs = [(i, [1 + i, 2, 3, 4, 5], 8) for i in range(2)]
    ref = _run(JEngine(jm, jp, max_slots=2, cache_dtype=jnp.float32),
               [JRequest(i, p, max_new_tokens=n) for i, p, n in specs])
    if paged:
        eng = PagedInferenceEngine(tm, max_slots=2, block_size=4,
                                   device="cpu", cache_dtype=torch.float32)
    else:
        eng = InferenceEngine(tm, max_slots=2, device="cpu",
                              cache_dtype=torch.float32)
    for i, p, n in specs:
        eng.submit(Request(i, p, max_new_tokens=n))
    eng.step()
    eng.step()
    before = eng.pool.used_blocks if paged else None
    assert eng.preempt() == 2
    assert eng.active_requests == 0 and eng.queue_depth == 2
    if paged:
        assert eng.pool.used_blocks < before
    assert {r.request_id: (r.tokens, r.finish_reason)
            for r in eng.run()} == ref
    assert eng.metrics.requeued == 2


def _kv_quant_prefill(engine, specs):
    """Submit ``specs`` and step until every prompt is prefilled; returns
    each request's full prompt blocks ``(codes, scales)`` (no later append
    requantizes them)."""
    for i, p, n in specs:
        engine.submit(Request(i, p, max_new_tokens=n) if isinstance(
            engine, PagedInferenceEngine) else JRequest(i, p,
                                                        max_new_tokens=n))
    while engine._prefilling or engine._queue:
        engine.step()
    out = {}
    for slot, seq in engine._seqs.items():
        rid = engine._active[slot].request.request_id
        ids = np.asarray(seq.block_ids[:len(specs[rid][1]) // 4])
        out[rid] = (np.asarray(engine.pool.data)[ids],
                    np.asarray(engine.pool.scales)[ids])
    return out


KV_QUANT_SPECS = [(i, [1 + i, 2, 3 + i, 4, 5, 6, 7, 8, 9, 10 + i], 5)
                  for i in range(3)]


def test_kv_quant_tokens_and_pool_match_jax(tiny):
    """``kv_quant="int8"`` with every prompt prefilled in the first tick:
    greedy streams equal JAX's, and each prompt's int8 blocks agree with
    JAX's to one code step and 1e-6 of a scale (the two f32 models' K/V
    agree to ~1e-7, not bitwise)."""
    sched = TickScheduler(token_budget=32, min_chunk=2, max_chunk=16)
    jeng, teng = _engines(tiny, kv_quant="int8", chunked_prefill=True,
                          scheduler=sched, max_slots=3)
    got = _kv_quant_prefill(teng, KV_QUANT_SPECS)
    want = _kv_quant_prefill(jeng, KV_QUANT_SPECS)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in got:
        codes = got[rid][0].astype(np.int32)
        assert np.abs(codes - want[rid][0]).max() <= 1
        np.testing.assert_allclose(got[rid][1], want[rid][1], rtol=1e-6,
                                   atol=0)
    tr = {r.request_id: (r.tokens, r.finish_reason) for r in teng.run()}
    jr = {r.request_id: (r.tokens, r.finish_reason) for r in jeng.run()}
    assert tr == jr


def test_kv_quant_pool_is_independent_of_the_token_budget(tiny):
    """Budgets of 4 and 32 tokens slice the prompts differently (at 4,
    decode rounds run while later prompts still prefill) yet leave each
    prompt's int8 blocks and scales bitwise the same, and the same
    streams.  The JAX engine fails this at budget 4: its decode round
    writes a still-prefilling slot's token 0 at position 0 through that
    slot's real table row; the port points such rows at the garbage
    block."""
    tm = tiny[2]
    runs = []
    for budget in (4, 32):
        eng = PagedInferenceEngine(
            tm, max_slots=3, block_size=4, device="cpu",
            cache_dtype=torch.float32, kv_quant="int8",
            chunked_prefill=True,
            scheduler=TickScheduler(budget, 2, min(budget, 16)))
        blocks = _kv_quant_prefill(eng, KV_QUANT_SPECS)
        runs.append((blocks, {r.request_id: r.tokens for r in eng.run()}))
    (a, ta), (b, tb) = runs
    assert ta == tb
    assert a and set(a) <= set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid][0], b[rid][0])
        np.testing.assert_array_equal(a[rid][1], b[rid][1])


def test_tick_scheduler_plans_as_jax():
    cases = [((32, 4, 16), (8, [(0, 100), (1, 100)], 0)),
             ((8, 4, 16), (8, [(0, 100), (1, 100)], 0)),
             ((32, 4, 16), (4, [(0, 100)], 3)),
             ((32, 4, 16), (7, [(0, 100)], 3)),
             ((64, 8, 64), (0, [(3, 5), (1, 0), (2, 70)], 0))]
    for sched, (dec, pre, spec) in cases:
        want = JSched(*sched).plan(dec, pre, spec)
        got = TickScheduler(*sched).plan(dec, pre, spec)
        assert (got.chunks, got.decode) == (want.chunks, want.decode)
    with pytest.raises(ValueError):
        TickScheduler(token_budget=0)


# -- refusals ----------------------------------------------------------------

REFUSALS = {
    "kv_quant_mode": (dict(kv_quant="fp4"), ValueError, "kv_quant"),
    "kv_quant_with_speculative": (
        dict(kv_quant="int8", chunked_prefill=True, speculative=True),
        ValueError, "speculative"),
    "kv_quant_without_chunked_prefill": (dict(kv_quant="int8"), ValueError,
                                         "chunked"),
    "prefill_only_without_chunked_prefill": (dict(prefill_only=True),
                                             ValueError, "prefill_only"),
    "block_size_not_dividing_max_seq": (dict(block_size=5), ValueError,
                                        "block_size"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_paged_engine_refusals_match_jax(tiny, name):
    jm, jp, tm = tiny
    kw, exc, match = REFUSALS[name]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("speculative"):
        jkw["speculative"] = JSpec(jm, jp)
        tkw["speculative"] = SpeculativeConfig(tm)
    with pytest.raises(exc):
        JPaged(jm, jp, **jkw)
    with pytest.raises(exc, match=match):
        PagedInferenceEngine(tm, device="cpu", **tkw)


def test_speculative_config_refusals_match_jax(tiny):
    jm, jp, tm = tiny
    with pytest.raises(ValueError):
        JSpec(jm, jp, num_tokens=0)
    with pytest.raises(ValueError, match="num_tokens"):
        SpeculativeConfig(tm, num_tokens=0)
    other = GPTModel(GPTConfig(**dict(TINY, vocab_size=64)), device="cpu")
    jother = JModel(JConfig(**dict(TINY, vocab_size=64)))
    with pytest.raises(ValueError):
        JSpec(jother, jp).validate_against(jm)
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeConfig(other).validate_against(tm)


def test_fleet_parts_raise_naming_their_slice(tiny):
    """The fleet parts (``NotImplementedError`` naming the fleet slice
    until it was ported) now build and refuse only what JAX's engine
    refuses: an unknown request id, and a handoff into a pool of another
    cache kind."""
    jm, jp, tm = tiny
    for make, req in ((lambda **kw: JPaged(jm, jp, **kw), JRequest),
                      (lambda **kw: PagedInferenceEngine(tm, device="cpu",
                                                         **kw), Request)):
        pf = make(chunked_prefill=True, prefill_only=True, block_size=4)
        assert pf.prefill_only and pf.handoffs_ready() == []
        eng = make(block_size=4)
        with pytest.raises(KeyError):
            eng.export_kv(0)
        pf.submit(req(0, [1, 2, 3], max_new_tokens=4))
        while not pf.handoffs_ready():
            pf.step()
        handoff = pf.export_kv(0)
        other = make(chunked_prefill=True, kv_quant="int8", block_size=4)
        with pytest.raises(ValueError, match="kind"):
            other.adopt_kv(handoff)
        assert eng.adopt_kv(handoff) >= 0
