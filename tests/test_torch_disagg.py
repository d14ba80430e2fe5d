"""Disaggregated serving and pool capacity of apex_tpu_torch against
apex_tpu on the CPU.

The tiny GPT of ``tests/test_disagg.py`` (f32, max_seq 32; the port's
weights are the JAX init carried over with ``gpt_params_from_jax``)
serves the same greedy requests through both packages.

* ``export_kv`` payloads against JAX's: the f32 pool's blocks and the
  int8 pool's scales within 1e-6 of the payload's largest magnitude (the
  K/V the two chunk forwards compute differ in the last bits, and a
  scale is absmax / 127 of them), the int8 pool's data bitwise;
  ``kv_len``, ``kv_tokens``, ``generated``, the tags and ``nbytes()``
  exactly;
* ``adopt_kv`` installs the payload bit for bit (``torch.equal`` on the
  decode pool's rows, data and scales) and refuses what JAX refuses;
* ``DisaggregatedFleet`` (f32 and int8 pools) tokens, handoff counts and
  bytes exactly JAX's, also with a prefill replica killed, with a
  ``dcn_fault`` the channel's retry absorbs, and with the re-prefill
  fallback after the retries run out;
* ``LocalDcnChannel.send`` keeps bytes and devices;
* ``PoolCapacityController`` splits, stats, shift log and ``audit()``
  exactly JAX's, manual and burn-driven; the fault helpers
  (``FaultInjector``, ``fault_mode``) likewise;
* ``tools/loadgen_torch.run_disagg_scenario`` reports equal to
  ``tools/loadgen.py``'s.
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
import apex_tpu.resilience as jres
import apex_tpu.serving as jsrv
from apex_tpu.mpmd.channel import LocalDcnChannel as JChannel
from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.observability.slo import SLOMonitor as JSLO
from apex_tpu.observability.slo import SLOTarget as JTarget
from apex_tpu.utils.profiling import ServingMetrics as JMetrics

import apex_tpu_torch.inference as tinf
import apex_tpu_torch.resilience as tres
import apex_tpu_torch.serving as tsrv
from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.mpmd import DcnTimeout, Edge, LocalDcnChannel
from apex_tpu_torch.observability.slo import SLOMonitor, SLOTarget
from apex_tpu_torch.utils.profiling import ServingMetrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=32, hidden_size=16, num_layers=2,
            num_attention_heads=2, max_seq_len=32)
SPECS = [(0, [1, 2, 3, 4, 5], 6), (1, [1, 2, 3, 9], 5),
         (2, [1, 2, 3, 4, 5, 6, 7], 4), (3, [4, 4, 4], 5),
         (4, [1, 2, 3, 4, 5, 6, 7, 8, 2], 3)]


def _port_model(kw, jp):
    cfg = GPTConfig(**kw)
    tm = GPTModel(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return tm


@pytest.fixture(scope="module")
def sides():
    jm = JModel(JConfig(**TINY))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = _port_model(TINY, jp)

    def jengine(clock, slo=False, **kw):
        kw.setdefault("chunked_prefill", True)
        kw.setdefault("block_size", 4)
        mon = JSLO([JTarget("ttft", 0.5, objective=0.9),
                    JTarget("token_latency", 0.5, objective=0.9)],
                   clock=clock) if slo else None
        return jsrv.PagedInferenceEngine(
            jm, jp, max_slots=4, cache_dtype=jnp.float32,
            metrics=JMetrics(clock, slo=mon), clock=clock, **kw)

    def tengine(clock, slo=False, **kw):
        kw.setdefault("chunked_prefill", True)
        kw.setdefault("block_size", 4)
        mon = SLOMonitor([SLOTarget("ttft", 0.5, objective=0.9),
                          SLOTarget("token_latency", 0.5, objective=0.9)],
                         clock=clock) if slo else None
        return tsrv.PagedInferenceEngine(
            tm, max_slots=4, cache_dtype=torch.float32,
            metrics=ServingMetrics(clock, slo=mon), clock=clock,
            device="cpu", **kw)

    return {"jax": types.SimpleNamespace(inf=jinf, srv=jsrv, res=jres,
                                         engine=jengine),
            "torch": types.SimpleNamespace(inf=tinf, srv=tsrv, res=tres,
                                           engine=tengine)}


def _same(sides, fn, *args):
    out = {k: fn(ns, *args) for k, ns in sides.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _requests(ns):
    return [ns.inf.Request(i, list(p), max_new_tokens=n)
            for i, p, n in SPECS]


def _responses(rs):
    return sorted((r.request_id, list(r.tokens), r.finish_reason)
                  for r in rs)


def _parked(ns, quant):
    clock = ns.srv.VirtualClock()
    pf = ns.engine(clock, kv_quant=quant, prefill_only=True)
    for r in _requests(ns):
        pf.submit(r)
    for _ in range(200):
        if len(pf.handoffs_ready()) == len(SPECS):
            break
        pf.step()
        clock.advance(0.01)
    return pf, clock


# -- the handoff -------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_export_kv_payloads_match_jax(sides, quant):
    out = {}
    for name, ns in sides.items():
        pf, _ = _parked(ns, quant)
        ready = pf.handoffs_ready()
        hs = [pf.export_kv(rid) for _, rid in ready]
        out[name] = (ready, hs, pf.metrics.migrated, pf.active_requests)
    (jr, jh, jm, ja), (tr, th, tm, ta) = out["jax"], out["torch"]
    assert (tr, tm, ta) == (jr, jm, ja) and ta == 0
    for a, b in zip(jh, th):
        assert (b.request.request_id, b.generated, b.kv_len, b.kv_tokens,
                b.block_size, b.kind, b.nbytes()) == (
            a.request.request_id, a.generated, a.kv_len, a.kv_tokens,
            a.block_size, a.kind, a.nbytes())
        assert sorted(b.payload) == sorted(a.payload)
        for key in a.payload:
            got, want = b.payload[key].numpy(), np.asarray(a.payload[key])
            assert got.dtype == want.dtype and got.shape == want.shape
            if key == "data" and quant == "int8":
                np.testing.assert_array_equal(got, want)
            else:
                # relative to the payload's largest magnitude: the chunk
                # forward's roundoff is absolute, ~1e-8 on K/V of ~0.2,
                # and the int8 scales (absmax / 127) inherit it
                err = np.max(np.abs(got - want)) / np.max(np.abs(want))
                assert err <= 1e-6, err


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_adopt_kv_installs_the_payload_bitwise(sides, quant):
    ns = sides["torch"]
    pf, clock = _parked(ns, quant)
    dc = ns.engine(clock, kv_quant=quant)
    for _, rid in pf.handoffs_ready()[:4]:
        h = pf.export_kv(rid)
        slot = dc.adopt_kv(h)
        seq = dc._seqs[slot]
        start = seq.shared_tokens // dc.pool.block_size
        ids = torch.tensor(seq.block_ids[start:])
        assert torch.equal(dc.pool.data[ids], h.payload["data"][start:])
        if quant:
            assert torch.equal(dc.pool.scales[ids],
                               h.payload["scales"][start:])
    while not pf.handoffs_ready():        # the fifth request's prefill
        pf.step()
    with pytest.raises(tinf.QueueFull):         # every decode slot taken
        dc.adopt_kv(pf.export_kv(pf.handoffs_ready()[0][1]))


def test_handoff_refusals_match_jax(sides):
    def script(ns):
        pf, clock = _parked(ns, None)
        out = []
        try:
            pf.export_kv(99)
        except KeyError:
            out.append("key")
        h = pf.export_kv(pf.handoffs_ready()[0][1])
        for eng, change in (
                (ns.engine(clock, kv_quant="int8"), {}),
                (ns.engine(clock, block_size=8), {}),
                (ns.engine(clock), {"generated": h.generated + [1] * 40})):
            try:
                eng.adopt_kv(dataclasses.replace(h, **change))
            except ValueError as e:
                out.append(str(e).split(";")[0].split(" ")[1])
        busy = ns.engine(clock)
        busy.injected_faults = frozenset({"reject_admission"})
        try:
            busy.adopt_kv(h)
        except ns.inf.QueueFull:
            out.append("rejected")
        mid = ns.engine(clock, prefill_only=True,
                        scheduler=ns.srv.TickScheduler(token_budget=4,
                                                       min_chunk=2,
                                                       max_chunk=2))
        mid.submit(ns.inf.Request(0, list(range(1, 12))))
        mid.step()
        try:
            mid.export_kv(0)
        except ValueError:
            out.append("mid-prefill")
        return out
    out = _same(sides, script)
    assert len(out) == 6


# -- the channel -------------------------------------------------------------

def test_channel_round_trip_keeps_bytes_and_faults_consume_once():
    inj = tres.FaultInjector([tres.Fault(step=2, kind="dcn_fault")])
    ch = LocalDcnChannel(fault_injector=inj, max_retries=1, alpha_s=1e-3,
                         beta_s_per_byte=1e-9)
    payload = {"data": torch.arange(24, dtype=torch.int8).reshape(2, 12),
               "scales": torch.rand(2, 3)}
    got = ch.send_with_retry(payload, step=2, edge=Edge(0, 1))
    for k in payload:
        assert torch.equal(got[k], payload[k])
        assert got[k].device == payload[k].device
        assert got[k].data_ptr() != payload[k].data_ptr()
    assert (ch.sends, ch.retries, ch.bytes_sent) == (1, 1, 24 + 24)
    jch = JChannel(fault_injector=jres.FaultInjector(
        [jres.Fault(step=2, kind="dcn_fault")]), max_retries=1,
        alpha_s=1e-3, beta_s_per_byte=1e-9)
    jch.send_with_retry({k: v.numpy() for k, v in payload.items()}, step=2,
                        edge=jsrv.disagg.Edge(0, 1))
    assert ch.simulated_seconds == jch.simulated_seconds
    inj2 = tres.FaultInjector([tres.Fault(step=s, kind="dcn_fault")
                               for s in (5, 5)])
    with pytest.raises(DcnTimeout):
        LocalDcnChannel(fault_injector=inj2, max_retries=0).send_with_retry(
            payload, step=5)


# -- the fleet ---------------------------------------------------------------

def _disagg(ns, quant=None, n_prefill=2, n_decode=2, **kw):
    clock = ns.srv.VirtualClock()
    pf = [ns.engine(clock, kv_quant=quant, prefill_only=True)
          for _ in range(n_prefill)]
    dc = [ns.engine(clock, kv_quant=quant) for _ in range(n_decode)]
    return ns.srv.DisaggregatedFleet(pf, dc, clock=clock, **kw), clock


def _run(fleet, clock, reqs):
    for r in reqs:
        fleet.submit(r)
    for _ in range(400):
        busy = fleet.step()
        clock.advance(0.01)
        if not busy and fleet.pending == 0:
            break
    ch = fleet.channel
    return dict(out=_responses(fleet.completed), handoffs=fleet.handoffs,
                fallbacks=fleet.fallbacks, pending=fleet.pending,
                dup=fleet.duplicate_responses, bytes=ch.handoff_bytes,
                lost=ch.lost_handoffs, retries=ch.retries, sends=ch.sends,
                sim=ch.simulated_seconds,
                health=list(fleet.prefill.health_log))


def _plain(ns, quant):
    fleet, clock = _disagg(ns, quant)
    return _run(fleet, clock, _requests(ns))


def _killed_prefill(ns):
    inj = ns.srv.ServingFaultInjector([ns.srv.ServingFault(
        2, 0, "replica_crash", duration=10 ** 6)])
    fleet, clock = _disagg(ns, prefill_injector=inj,
                           prefill_kw=dict(suspect_after=1, dead_after=2),
                           handoff_retry_ticks=4)
    return dict(_run(fleet, clock, _requests(ns)), log=list(inj.log))


def _dcn_retry(ns):
    ch = ns.srv.KvChannel(fault_injector=ns.res.FaultInjector(
        [ns.res.Fault(step=s, kind="dcn_fault") for s in range(1, 40)]),
        max_retries=1, alpha_s=1e-4, beta_s_per_byte=1e-10)
    fleet, clock = _disagg(ns, channel=ch)
    return _run(fleet, clock, _requests(ns))


def _fallback(ns):
    ch = ns.srv.KvChannel(fault_injector=ns.res.FaultInjector(
        [ns.res.Fault(step=s, kind="dcn_fault") for s in range(1, 40)]),
        max_retries=0)
    fleet, clock = _disagg(ns, channel=ch)
    return _run(fleet, clock, _requests(ns))


FLEETS = {"f32": lambda ns: _plain(ns, None),
          "int8": lambda ns: _plain(ns, "int8"),
          "killed_prefill": _killed_prefill,
          "dcn_retry": _dcn_retry,
          "reprefill_fallback": _fallback}


@pytest.mark.parametrize("name", list(FLEETS))
def test_disaggregated_fleet_matches_jax(sides, name):
    out = _same(sides, FLEETS[name])
    assert out["pending"] == 0 and out["dup"] == 0
    assert len(out["out"]) == len(SPECS)
    if name in ("f32", "int8"):
        assert out["handoffs"] == len(SPECS) and out["fallbacks"] == 0
    if name == "dcn_retry":
        assert out["retries"] > 0 and out["lost"] == 0
    if name == "reprefill_fallback":
        assert out["fallbacks"] >= 1 and out["lost"] == out["fallbacks"]


def test_disaggregated_fleet_matches_the_single_pool_engine(sides):
    """The port's fleet against the port's own chunked paged engine (the
    JAX tests' reference): the same tokens, int8 handoffs under 0.3x the
    f32 bytes."""
    ns = sides["torch"]
    ref = ns.engine(ns.srv.VirtualClock())
    for r in _requests(ns):
        ref.submit(r)
    want = _responses(ref.run())
    f32, i8 = _plain(ns, None), _plain(ns, "int8")
    assert f32["out"] == want
    assert i8["bytes"] < 0.30 * f32["bytes"]


# -- the pool capacity controller --------------------------------------------

def _stack(ns, n_prefill=3, n_decode=2, **ctl_kw):
    clock = ns.srv.VirtualClock()
    pf = [ns.engine(clock, slo=True, prefill_only=True)
          for _ in range(n_prefill)]
    dc = [ns.engine(clock, slo=True) for _ in range(n_decode)]
    fleet = ns.srv.DisaggregatedFleet(pf, dc, clock=clock)
    ctl_kw.setdefault("burn_high", 2.0)
    ctl_kw.setdefault("burn_low", 0.5)
    ctl_kw.setdefault("confirm_ticks", 2)
    ctl_kw.setdefault("cooldown_s", 1.0)
    ctl = ns.res.PoolCapacityController(
        {"prefill": fleet.prefill, "decode": fleet.decode},
        lambda pool: ns.engine(clock, slo=True,
                               prefill_only=(pool == "prefill")),
        clock=clock, **ctl_kw)
    return fleet, ctl, clock


def _ctl_state(ctl):
    return dict(split=ctl.split, stats=dict(ctl.stats),
                log=[dict(e) for e in ctl.shift_log], audit=ctl.audit(),
                shifting=ctl.shifting)


def _manual_shift(ns):
    fleet, ctl, clock = _stack(ns)
    for r in _requests(ns):
        fleet.submit(r)
    ctl.request_shift("to_decode")
    for _ in range(80):
        busy = fleet.step()
        ctl.tick()
        clock.advance(0.05)
        if not busy and fleet.pending == 0 and not ctl.shifting:
            break
    return dict(_ctl_state(ctl), out=_responses(fleet.completed))


def _burn_shift(ns):
    fleet, ctl, clock = _stack(ns)
    dec = [e for _, e in fleet.decode._live()]
    for _ in range(30):
        for e in dec:
            for _ in range(5):
                e.metrics.slo.observe("token_latency", 5.0)
        fleet.step()
        ctl.tick()
        clock.advance(0.05)
        if ctl.stats["shifts"] == 1 and not ctl.shifting:
            break
    return _ctl_state(ctl)


def _faulted_shifts(ns):
    inj = ns.srv.ServingFaultInjector(
        [ns.srv.ServingFault(t, 0, "capacity_change", magnitude=m)
         for t, m in ((2, 1), (40, 2), (80, 3))])
    fleet, ctl, clock = _stack(ns, serving_injector=inj, cooldown_s=0.1,
                               drain_timeout_ticks=3)
    for _ in range(3):
        ctl.request_shift("to_decode")
    for _ in range(120):
        fleet.step()
        ctl.tick()
        clock.advance(0.05)
    return dict(_ctl_state(ctl), log_faults=list(inj.log))


CONTROLLERS = {"manual": _manual_shift, "burn": _burn_shift,
               "faulted": _faulted_shifts}


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_pool_capacity_controller_matches_jax(sides, name):
    out = _same(sides, CONTROLLERS[name])
    assert out["audit"] == []
    if name != "faulted":
        assert out["split"] == {"prefill": 2, "decode": 3}


def test_capacity_and_fault_helpers_match_jax(sides):
    def script(ns):
        modes = [ns.res.fault_mode(m) for m in (0, 1, 2, 3, 9)]
        bad = 0
        for kw in (dict(total_chips=4, train_chips=3, serve_chips=2),
                   dict(total_chips=4, train_chips=2, serve_chips=2,
                        chips_per_replica=0)):
            try:
                ns.res.CapacityBudget(**kw)
            except ValueError:
                bad += 1
        inj = ns.res.FaultInjector.from_seed(
            5, 50, {"nan_grads": 0.1, "dcn_fault": 0.2,
                    "capacity_change": 0.1})
        sched = [dataclasses.asdict(f) for f in inj.schedule]
        dcn = [inj.check_dcn(s) is not None for s in range(50)]
        again = [inj.check_dcn(s) is not None for s in range(50)]
        cap = [inj.check_capacity_change(s) is not None for s in range(50)]
        return (modes, ns.res.CAPACITY_FAULT_MODES, bad, sched, dcn, again,
                cap, ns.res.FAULT_KINDS)
    out = _same(sides, script)
    assert any(out[4]) and not any(out[5])


# -- the loadgen's disaggregated scenarios -----------------------------------

def _disagg_ns(**kw):
    base = dict(
        scenario="disagg_diurnal", requests=8, rate=50.0, max_slots=2,
        max_queue=64, max_queue_depth=4, burn_threshold=14.4,
        burn_window_s=60.0, ttft_slo_s=0.5, tpot_slo_s=0.5, block_size=4,
        token_budget=32, client_retries=3, tick_s=0.02, e2e_slo_s=3.0,
        max_ticks=800, retry_budget=4, ladder_step_down_s=0.5, seed=0,
        min_prompt=4, pareto_shape=2.5, max_new=4, prefill_replicas=2,
        decode_replicas=2, weight_quant="none", kv_quant="none", tenants=3,
        vocab=32, hidden=16, layers=2, heads=2, max_seq=32)
    base.update(kw)
    return argparse.Namespace(**base)


def _tool(name):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("scenario", ["disagg_diurnal",
                                      "disagg_longctx_fair",
                                      "disagg_quant"])
def test_loadgen_disagg_report_matches_jax(scenario):
    ns = _disagg_ns(scenario=scenario)
    kw = dict(vocab_size=ns.vocab, hidden_size=ns.hidden,
              num_layers=ns.layers, num_attention_heads=ns.heads,
              max_seq_len=ns.max_seq)
    jp = JModel(JConfig(**kw)).init_params(jax.random.PRNGKey(0))
    if scenario == "disagg_quant":
        kw["weight_quant"] = "int8"
    model = _port_model(kw, jp)
    want = _tool("loadgen").run_disagg_scenario(_disagg_ns(
        scenario=scenario))
    got = _tool("loadgen_torch").run_disagg_scenario(
        _disagg_ns(scenario=scenario, device="cpu"), model=model)
    assert got == want
    assert got["gates"]["exactly_once"] and got["handoffs"] > 0
