"""The serving fleet of apex_tpu_torch against apex_tpu on the CPU.

The tiny GPT of ``tests/test_fleet.py`` (f32; the port's weights are the
JAX init carried over with ``gpt_params_from_jax``) serves the same greedy
requests through the JAX package and the port.  Every check is exact:
host-side state and tokens alike.

* ``ServingFaultInjector.from_seed`` schedules, its fault windows and its
  applied-fault log;
* the engine's deferred parts: ``export_inflight`` / ``adopt`` (contiguous
  and paged), ``deadline`` / ``timeout`` eviction with partial tokens, the
  injected admission faults and ``cancel``;
* ``FleetRouter`` responses (ids, tokens, finish reasons), health log,
  fault log, counters and ``recovery_report()`` under a replica kill
  (contiguous and paged), a slow replica, retry-budget shedding, hedging,
  drain / remove / add, and degradation shedding;
* ``tools/loadgen_torch.run_scenario`` reports equal to
  ``tools/loadgen.py``'s at ``tests/test_fleet.py``'s ``_scenario_ns``
  (the port's report adds ``shed_reasons``).

Seeded stochastic sampling cannot replay ``jax.random``; its migration is
held against the port's own uninterrupted engine.
"""

import argparse
import dataclasses
import importlib
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.inference as jinf
import apex_tpu.serving as jsrv
from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.utils.profiling import ServingMetrics as JMetrics

import apex_tpu_torch.inference as tinf
import apex_tpu_torch.serving as tsrv
from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.utils.profiling import ServingMetrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=32, hidden_size=16, num_layers=2,
            num_attention_heads=2, max_seq_len=16)


def _port_model(jm_cfg_kw, jp):
    cfg = GPTConfig(**jm_cfg_kw)
    tm = GPTModel(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return tm


@pytest.fixture(scope="module")
def sides():
    """One namespace per package: its model, engines, serving module."""
    jm = JModel(JConfig(**TINY))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = _port_model(TINY, jp)

    def jengine(paged, clock, **kw):
        if paged:
            kw.setdefault("block_size", 4)
            return jsrv.PagedInferenceEngine(
                jm, jp, max_slots=2, metrics=JMetrics(clock), clock=clock,
                cache_dtype=jnp.float32, **kw)
        return jinf.InferenceEngine(jm, jp, max_slots=2, clock=clock,
                                    metrics=JMetrics(clock), **kw)

    def tengine(paged, clock, **kw):
        if paged:
            kw.setdefault("block_size", 4)
            return tsrv.PagedInferenceEngine(
                tm, max_slots=2, metrics=ServingMetrics(clock),
                clock=clock, cache_dtype=torch.float32, device="cpu", **kw)
        return tinf.InferenceEngine(tm, max_slots=2, clock=clock,
                                    metrics=ServingMetrics(clock),
                                    device="cpu", **kw)

    return {"jax": types.SimpleNamespace(inf=jinf, srv=jsrv,
                                         engine=jengine),
            "torch": types.SimpleNamespace(inf=tinf, srv=tsrv,
                                           engine=tengine)}


def _same(sides, fn, *args):
    out = {k: fn(ns, *args) for k, ns in sides.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


SPECS = [(0, [1, 2, 3, 4, 5], 6), (1, [1, 2, 3, 9], 5),
         (2, [1, 2, 3, 4, 5, 6, 7], 4), (3, [4, 4, 4], 5)]


def _requests(ns, specs=SPECS, **kw):
    return [ns.inf.Request(i, list(p), max_new_tokens=n, **kw)
            for i, p, n in specs]


def _responses(rs):
    return sorted((r.request_id, list(r.tokens), r.finish_reason)
                  for r in rs)


# -- the fault injector ------------------------------------------------------

@pytest.mark.parametrize("seed,rates", [
    (3, {"replica_crash": 0.05, "slow_replica": 0.1,
         "reject_admission": 0.2}),
    (4, {"stuck_decode": 0.1, "kv_pool_exhaustion": 0.3}),
    (0, {"replica_crash": 0.02, "capacity_change": 0.1,
         "slow_replica": 0.05})],
    ids=["crash_slow_reject", "stuck_exhaust", "with_capacity"])
def test_injector_from_seed_matches_jax(sides, seed, rates):
    def script(ns):
        inj = ns.srv.ServingFaultInjector.from_seed(seed, 60, 3, rates)
        return [dataclasses.asdict(f) for f in inj.schedule]
    assert _same(sides, script)
    assert tsrv.SERVING_FAULT_KINDS == jsrv.SERVING_FAULT_KINDS


def test_injector_windows_and_log_match_jax(sides):
    def script(ns):
        f = ns.srv.ServingFault(3, 0, "stuck_decode", duration=2)
        g = ns.srv.ServingFault(5, 1, "capacity_change", magnitude=2)
        inj = ns.srv.ServingFaultInjector([f, g])
        seen = [len(inj.faults_at(t, r)) for t in range(7) for r in (0, 1)]
        for t in (3, 4, 5):
            inj.activate(t, 0)
        cap = [inj.capacity_change_at(t) is not None for t in range(7)]
        bad = []
        for kw in (dict(kind="grad_spike"),
                   dict(kind="replica_crash", duration=0)):
            try:
                ns.srv.ServingFault(0, 0, **kw)
            except ValueError:
                bad.append(kw)
        return seen, list(inj.log), cap, len(bad)
    _same(sides, script)


# -- the engine's deferred parts ---------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_export_inflight_then_adopt_matches_jax(sides, paged):
    def script(ns):
        clock = ns.srv.VirtualClock()
        src = ns.engine(paged, clock)
        dst = ns.engine(paged, clock)
        for r in _requests(ns):
            src.submit(r)
        for _ in range(3):
            src.step()
        moved = src.export_inflight()
        assert not src._active and not src._queue
        for req, progress in moved:
            dst.adopt(req, progress)
        out = _responses(src.completed + dst.run())
        with pytest.raises(ValueError):
            dst.adopt(ns.inf.Request(9, [1] * 10), progress=[2] * 6)
        return ([(r.request_id, p) for r, p in moved], out,
                src.metrics.migrated, src.metrics.pending_requests,
                dst.metrics.pending_requests)
    _same(sides, script)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_seeded_migration_resumes_the_uninterrupted_stream(sides, paged):
    ns = sides["torch"]
    samp = [tinf.SamplingParams(temperature=0.8, top_k=5),
            tinf.SamplingParams(temperature=1.1, top_p=0.9),
            tinf.SamplingParams(temperature=1.0, top_k=8, top_p=0.8),
            tinf.SamplingParams()]
    reqs = [tinf.Request(i, p, max_new_tokens=n, seed=7 * i + 1,
                         sampling=samp[i]) for i, p, n in SPECS]
    ref = ns.engine(paged, tsrv.VirtualClock())
    for r in reqs:
        ref.submit(dataclasses.replace(r))
    want = _responses(ref.run())
    clock = tsrv.VirtualClock()
    src, dst = ns.engine(paged, clock), ns.engine(paged, clock)
    for r in reqs:
        src.submit(dataclasses.replace(r))
    for _ in range(2):
        src.step()
    for req, progress in src.export_inflight():
        dst.adopt(req, progress)
    assert _responses(src.completed + dst.run()) == want


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_deadline_and_timeout_match_jax(sides, paged):
    """A deadline and a timeout trip mid-decode and in the queue; each
    evicted request carries its partial tokens."""
    def script(ns):
        clock = ns.srv.VirtualClock()
        eng = ns.engine(paged, clock)
        R = ns.inf.Request
        eng.submit(R(0, [1, 2, 3], max_new_tokens=8, deadline=0.35))
        eng.submit(R(1, [4, 5, 6, 7], max_new_tokens=8, timeout=0.25))
        eng.submit(R(2, [1, 2], max_new_tokens=3, deadline=0.05))
        eng.submit(R(3, [3, 3], max_new_tokens=3, timeout=0.45))
        eng.submit(R(4, [5, 1], max_new_tokens=2))
        while eng.queue_depth or eng.active_requests:
            eng.step()
            clock.advance(0.1)
        with pytest.raises(ValueError):
            eng.submit(R(5, [1], timeout=0.0))
        m = eng.metrics
        return (_responses(eng.completed), m.evicted, m.timeouts,
                m.pending_requests, m.registry.prometheus())
    out = _same(sides, script)
    reasons = {rid: reason for rid, _, reason in out[0]}
    assert reasons[0] == "evicted" and reasons[1] == "timeout"


def test_injected_faults_and_cancel_match_jax(sides):
    def script(ns):
        clock = ns.srv.VirtualClock()
        eng = ns.engine(False, clock)
        R = ns.inf.Request
        eng.injected_faults = frozenset({"reject_admission"})
        try:
            eng.submit(R(0, [1, 2, 3]))
            rejected = False
        except ns.inf.QueueFull:
            rejected = True
        eng.injected_faults = frozenset({"kv_pool_exhaustion"})
        for i in range(1, 4):
            eng.submit(R(i, [1, 2, 3], max_new_tokens=4))
        eng.step()
        stalled = eng.queue_depth
        eng.injected_faults = frozenset()
        eng.step()
        cancelled = [eng.cancel(1), eng.cancel(3), eng.cancel(99)]
        return (rejected, stalled, cancelled, _responses(eng.run()),
                eng.metrics.cancelled)
    out = _same(sides, script)
    assert out[0] and out[1] == 3


# -- the fleet ---------------------------------------------------------------

def _fleet(ns, *, n=2, paged=False, injector=None, **kw):
    clock = ns.srv.VirtualClock()
    replicas = [ns.engine(paged, clock) for _ in range(n)]
    kw.setdefault("suspect_after", 1)
    kw.setdefault("dead_after", 2)
    kw.setdefault("recover_after", 2)
    return ns.srv.FleetRouter(replicas, injector=injector, clock=clock,
                              **kw), replicas, clock


def _fleet_state(fleet, out):
    return dict(out=_responses(out), health=list(fleet.health_log),
                recovery=fleet.recovery_report(), pending=fleet.pending,
                dup=fleet.duplicate_responses, retries=fleet.retries,
                hedges=fleet.hedges, migrations=fleet.migrations,
                text=fleet.registry.prometheus()
                if getattr(fleet, "registry", None) is not None else None)


def _kill(ns, paged):
    inj = ns.srv.ServingFaultInjector([ns.srv.ServingFault(
        3, 0, "replica_crash", duration=10 ** 6)])
    fleet, _, _ = _fleet(ns, paged=paged, injector=inj)
    for r in _requests(ns):
        fleet.submit(r)
    st = _fleet_state(fleet, fleet.run(max_steps=200))
    return dict(st, log=list(inj.log))


def _crash_recover(ns):
    inj = ns.srv.ServingFaultInjector([ns.srv.ServingFault(
        1, 1, "replica_crash", duration=3)])
    fleet, _, _ = _fleet(ns, injector=inj)
    for r in _requests(ns):
        fleet.submit(r)
    for _ in range(8):
        fleet.step()
    return dict(_fleet_state(fleet, fleet.run(max_steps=100)),
                health_now=[fleet.health(i).value for i in (0, 1)])


def _slow(ns):
    inj = ns.srv.ServingFaultInjector([ns.srv.ServingFault(
        1, 1, "slow_replica", magnitude=0.5, duration=6)])
    fleet, _, _ = _fleet(ns, n=3, injector=inj, slow_after=2)
    for i in range(6):
        fleet.submit(ns.inf.Request(i, [1, 2, 3], max_new_tokens=8))
    mid = []
    for _ in range(14):
        fleet.step()
        mid.append(fleet.health(1).value)
    return dict(_fleet_state(fleet, fleet.completed), mid=mid)


def _retry_shed(ns):
    inj = ns.srv.ServingFaultInjector([ns.srv.ServingFault(
        1, 0, "replica_crash", duration=10 ** 6)])
    fleet, _, clock = _fleet(ns, n=1, injector=inj, retry_budget=2,
                             retry_base_s=0.01)
    fleet.step()
    fleet.step()
    placed = fleet.submit(ns.inf.Request(0, [1, 2, 3]))
    for _ in range(30):
        fleet.step()
        clock.advance(0.05)
    fleet0, _, _ = _fleet(ns, n=1, injector=ns.srv.ServingFaultInjector([
        ns.srv.ServingFault(1, 0, "replica_crash", duration=10 ** 6)]),
        retry_budget=0)
    fleet0.step()
    fleet0.step()
    try:
        fleet0.submit(ns.inf.Request(0, [1, 2, 3]))
        shed = None
    except ns.srv.RequestShed as e:
        shed = (e.reason.value, e.retry_after_s)
    return dict(_fleet_state(fleet, fleet.completed), placed=placed,
                shed=shed)


def _hedge(ns):
    inj = ns.srv.ServingFaultInjector([ns.srv.ServingFault(
        1, 0, "stuck_decode", duration=10 ** 6)])
    fleet, _, clock = _fleet(ns, injector=inj, suspect_after=2,
                             dead_after=6, hedge_after_s=0.1)
    fleet.submit(ns.inf.Request(0, [1, 2, 3, 4], max_new_tokens=5))
    for _ in range(30):
        fleet.step()
        clock.advance(0.05)
    return _fleet_state(fleet, fleet.completed)


def _drain_remove_add(ns):
    fleet, replicas, _ = _fleet(ns)
    for r in _requests(ns):
        fleet.submit(r)
    fleet.step()
    fleet.begin_drain(0)
    first = _responses(fleet.run(max_steps=200))
    drained = fleet.drained(0)
    eng = fleet.remove_replica(0)
    live = [i for i, _ in fleet._live()]
    assert fleet.add_replica(eng) == 0
    fleet.submit(ns.inf.Request(7, [4, 5], max_new_tokens=2))
    fleet.begin_drain(1)
    fleet.cancel_drain(1)
    st = _fleet_state(fleet, fleet.run(max_steps=50))
    return dict(st, first=first, drained=drained, live=live)


def _degrade(ns):
    fleet, _, _ = _fleet(ns)
    fleet.ladder = ns.srv.DegradationLadder()
    out = []
    for level, prompt in ((3, [1, 2, 3]), (2, [1] * 12), (2, [1, 2, 3])):
        fleet.ladder.level = level
        try:
            out.append(fleet.submit(ns.inf.Request(len(out), prompt)))
        except ns.srv.RequestShed as e:
            out.append((e.reason.value, e.retry_after_s))
    lad = ns.srv.DegradationLadder(thresholds=(2.0, 6.0, 14.4),
                                   step_down_s=1.0)
    steps = [lad.update(b, t) for b, t in ((1.0, 0.0), (7.0, 0.1),
                                           (20.0, 0.2), (0.0, 0.3),
                                           (0.0, 1.4), (0.0, 2.5),
                                           (7.0, 2.6))]
    return out, steps


SCENARIOS = {
    "replica_kill": lambda ns: _kill(ns, False),
    "replica_kill_paged": lambda ns: _kill(ns, True),
    "crash_recover": _crash_recover,
    "slow_replica": _slow,
    "retry_budget_shed": _retry_shed,
    "hedge": _hedge,
    "drain_remove_add": _drain_remove_add,
    "degrade": _degrade,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_matches_jax(sides, name):
    out = _same(sides, SCENARIOS[name])
    if name.startswith("replica_kill"):
        assert out["migrations"] > 0 and out["pending"] == 0
        assert len(out["out"]) == len(SPECS)
    if name == "hedge":
        assert out["hedges"] == 1 and len(out["out"]) == 1


def test_flush_prefixes_and_pool_gauges_match_jax():
    from apex_tpu.observability import MetricsRegistry as JRegistry
    from apex_tpu_torch.observability import MetricsRegistry

    def script(pool_cls, reg, **kw):
        pool = pool_cls(9, 4, layers=2, kv_heads=2, head_dim=4,
                        registry=reg, name="p1", **kw)
        seq = pool.acquire([1] * 8)
        pool.register_prefix(seq, [1] * 8)
        again = pool.acquire([1] * 9)
        pool.release(seq)
        pool.release(again)
        free = pool.free_blocks
        n = pool.flush_prefixes()
        return (free, n, pool.free_blocks, pool.flush_prefixes(),
                pool.stats(), pool.kind, reg.prometheus())

    for jcls, tcls in ((jsrv.PagedKVCache, tsrv.PagedKVCache),
                       (jsrv.QuantizedPagedKVCache,
                        tsrv.QuantizedPagedKVCache)):
        want = script(jcls, JRegistry(clock=float), dtype=jnp.float32)
        got = script(tcls, MetricsRegistry(clock=float),
                     dtype=torch.float32, device="cpu")
        assert got == want
        assert want[1] == 2 and want[3] == 0


def test_router_shed_matches_jax(sides):
    def script(ns):
        clock = ns.srv.VirtualClock()
        router = ns.srv.Router([ns.engine(False, clock) for _ in range(2)],
                               max_queue_depth=1)
        out = []
        for i in range(6):
            try:
                out.append(router.submit(ns.inf.Request(i, [1, 2, 3])))
            except ns.srv.RequestShed as e:
                out.append((e.reason.value, e.retry_after_s))
        return out
    out = _same(sides, script)
    assert any(isinstance(x, tuple) for x in out)


# -- the loadgen scenarios ---------------------------------------------------

def _scenario_ns(**kw):
    base = dict(
        scenario="replica_kill", requests=8, rate=1e9, replicas=3,
        max_slots=2, max_queue=64, max_queue_depth=4,
        burn_threshold=14.4, burn_window_s=60.0, ttft_slo_s=0.5,
        block_size=4, chunked=False, token_budget=32, client_retries=3,
        tick_s=0.02, e2e_slo_s=3.0, max_ticks=600, retry_budget=4,
        hedge_after_s=None, ladder_step_down_s=0.5, kill_tick=3,
        kill_replica=1, kill_duration=10 ** 6, slow_tick=4, slow_s=0.1,
        slow_duration=40, burst_n=4, burst_gap_s=0.3, period_s=2.0,
        seed=0, min_prompt=4, pareto_shape=2.5, max_new=4,
        shared_prefix_prob=0.5, shared_prefix_len=8, num_prefixes=2,
        vocab=32, hidden=16, layers=2, heads=2, max_seq=32)
    base.update(kw)
    return argparse.Namespace(**base)


def _tool(name):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def loadgen_model():
    """The port's model with the weights ``tools/loadgen.py`` draws."""
    ns = _scenario_ns()
    kw = dict(vocab_size=ns.vocab, hidden_size=ns.hidden,
              num_layers=ns.layers, num_attention_heads=ns.heads,
              max_seq_len=ns.max_seq)
    jp = JModel(JConfig(**kw)).init_params(jax.random.PRNGKey(0))
    return _port_model(kw, jp)


@pytest.mark.parametrize("scenario,kw", [
    ("replica_kill", {}),
    ("bursty", dict(requests=12, burst_n=6, burst_gap_s=0.1,
                    max_queue_depth=1, client_retries=1)),
    ("slow_replica", dict(requests=6)),
    ("steady", dict(requests=6, chunked=True))],
    ids=["replica_kill", "bursty", "slow_replica", "steady_chunked"])
def test_loadgen_scenario_report_matches_jax(loadgen_model, scenario, kw):
    want = _tool("loadgen").run_scenario(_scenario_ns(scenario=scenario,
                                                      **kw))
    got = _tool("loadgen_torch").run_scenario(
        _scenario_ns(scenario=scenario, device="cpu", **kw),
        model=loadgen_model)
    reasons = got.pop("shed_reasons")
    assert got == want
    assert sum(reasons.values()) >= got["shed_client"]
    assert None not in reasons          # every shed named its reason
    if scenario == "replica_kill":
        assert got["migrations"] > 0 and got["lost"] == []
