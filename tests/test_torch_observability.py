"""The serving observability of apex_tpu_torch against apex_tpu on the CPU.

The same scripted event sequence, on a fake clock, drives the JAX
modules and their ports; every check is exact (host-side state):

* ``MetricsRegistry``: ``prometheus()`` text, ``snapshot()``, the JSONL
  stream and ``replay_jsonl`` of it;
* ``SLOMonitor``: rolling percentiles, burn rates, alerts, the snapshot
  gauges, window resets;
* ``Tracer`` spans, instants, async spans and flows (``device=True`` too:
  the port enters ``torch.profiler.record_function``);
* ``RequestTracer`` records and ``summary()``, ``ServingMetrics`` with a
  registry and an SLO monitor (``summary()`` and the ``serving_*``
  series);
* ``FleetCollector`` merged timelines and ``check_flows`` verdicts,
  including a broken chain, and ``FlightRecorder`` snapshots;
* ``InferenceEngine(registry=, tracer=)`` on the tiny GPT: the registry
  text and the trace events equal JAX's engine on the same requests.
"""

import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

import apex_tpu.observability as jobs
from apex_tpu.inference import InferenceEngine as JEngine
from apex_tpu.inference import Request as JRequest
from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.utils.profiling import ServingMetrics as JMetrics

import apex_tpu_torch.observability as tobs
from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.inference import InferenceEngine, Request
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.utils.profiling import ServingMetrics

TINY = dict(vocab_size=32, hidden_size=16, num_layers=2,
            num_attention_heads=2, max_seq_len=16)
SIDES = {"jax": (jobs, JMetrics), "torch": (tobs, ServingMetrics)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _both(fn):
    """Run ``fn(obs, metrics_cls)`` for JAX and the port."""
    return {k: fn(*v) for k, v in SIDES.items()}


def _same(fn):
    out = _both(fn)
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- registry ----------------------------------------------------------------

def _registry_script(obs, _):
    clock = FakeClock(100.0)
    reg = obs.MetricsRegistry(clock=clock)
    buf = io.StringIO()
    reg.attach_stream(buf)
    c = reg.counter("req_total", "requests", labelnames=("route",))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    rng = np.random.RandomState(0)
    for i in range(40):
        clock.advance(0.25)
        c.inc(route="a" if i % 3 else "b")
        g.set(float(rng.randint(0, 9)))
        h.observe(float(rng.exponential(0.2)))
        if i % 7 == 0:
            reg.event("tick", i=i)
    assert reg.counter("req_total", labelnames=("route",)) is c
    with pytest.raises(ValueError):
        reg.gauge("req_total")
    lines = buf.getvalue().splitlines()
    replayed, records = obs.replay_jsonl(lines)
    return dict(text=reg.prometheus(), snap=reg.snapshot(), lines=lines,
                replay=replayed.prometheus(), records=records,
                p50=h.percentile(0.5), count=h.count(), sum=h.sum(),
                value=c.value(route="a"))


def test_registry_text_snapshot_stream_and_replay_match_jax():
    out = _same(_registry_script)
    assert out["replay"] == out["text"]
    assert len(out["records"]) == 6


def test_registry_defaults_match_jax():
    assert tobs.registry.DEFAULT_BUCKETS == jobs.registry.DEFAULT_BUCKETS


# -- SLO ---------------------------------------------------------------------

def _slo_script(obs, _):
    clock = FakeClock()
    reg = obs.MetricsRegistry(clock=clock)
    mon = obs.SLOMonitor(
        [obs.SLOTarget("ttft", 0.2, objective=0.9),
         obs.SLOTarget("token_latency", 0.05, objective=0.99,
                       name="tpot")],
        clock=clock, registry=reg,
        burn_windows=(obs.BurnWindow(60.0, 5.0, 14.4),
                      obs.BurnWindow(300.0, 30.0, 6.0)))
    rng = np.random.RandomState(1)
    trail = []
    for i in range(300):
        clock.advance(0.5)
        slow = 100 <= i < 160
        mon.observe("ttft", float(rng.exponential(0.5 if slow else 0.05)))
        mon.observe("token_latency", float(rng.exponential(0.02)))
        if i % 25 == 0:
            trail.append((mon.alerts(), mon.percentile("ttft", 0.95)))
    tgt = mon.targets[0]
    burns = [mon.burn_rate(tgt, w) for w in (5.0, 30.0, 60.0, 300.0)]
    snap = mon.snapshot()
    mon.reset_windows("shift-1")
    after = (mon.snapshot(), mon.epoch, mon.epoch_tag)
    rp = obs.RollingPercentiles(window_s=10.0, slots=5, clock=clock)
    for v in rng.exponential(1.0, 50):
        clock.advance(0.1)
        rp.observe(float(v))
    return dict(trail=trail, burns=burns, snap=snap, after=after,
                text=reg.prometheus(), rp=(rp.count(), rp.percentile(0.5),
                                           rp.percentile(0.99)))


def test_slo_percentiles_burn_rates_and_alerts_match_jax():
    out = _same(_slo_script)
    assert any(alerts for alerts, _ in out["trail"])      # the burst fired


# -- spans and the request tracer --------------------------------------------

def _span_script(obs, _):
    clock = FakeClock(1.0)
    tr = obs.Tracer(clock=clock, id_tag="r0")
    with tr.span("outer", mode="x"):
        clock.advance(0.5)
        with tr.span("inner"):
            clock.advance(0.25)
            tr.instant("mark", k=1)
    with pytest.raises(KeyError):
        with tr.span("boom", device=False):
            clock.advance(0.1)
            raise KeyError("x")
    tr.async_span("req", 7, 1.0, 2.0, reason="length")
    tr.flow("s", "req:7", phase="enqueue")
    tr.flow("f", "req:7", phase="finish")
    rt = obs.RequestTracer(clock=clock, tracer=tr)
    for rid in range(3):
        rt.enqueue(rid, ctx=obs.TraceContext.mint(rid))
    clock.advance(0.2)
    rt.admit(0)
    rt.admit(1)
    clock.advance(0.3)
    rt.first_token(0)
    rt.first_token(1)
    for _ in range(4):
        clock.advance(0.05)
        rt.decode_tick(0)
        rt.decode_tick(1)
    rt.requeue(1)
    rt.migrate(1, 0, 1)
    rt.resumed(1)
    rt.finish(0, "length")
    rt.finish(1, "migrated")
    rt.finish(2, "evicted")
    rt.degrade(2)
    ev = [{k: v for k, v in e.items() if k not in ("pid", "tid")}
          for e in tr.events]
    recs = [dataclasses.asdict(r) for r in rt.records]
    return dict(events=ev, records=recs, summary=rt.summary(),
                pending=rt.pending, depth=tr.depth(),
                verdict=obs.check_flows(tr.events))


def test_tracer_spans_and_request_tracer_match_jax():
    out = _same(_span_script)
    assert out["verdict"]["complete"]          # req:0 finished its chain


def test_device_span_enters_the_profiler_range():
    tr = tobs.Tracer(id_tag="p")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("fleet_tick"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "fleet_tick" in names
    assert tr.events[0]["name"] == "fleet_tick"


def _metrics_script(obs, metrics_cls):
    clock = FakeClock()
    reg = obs.MetricsRegistry(clock=clock)
    slo = obs.SLOMonitor([obs.SLOTarget("ttft", 0.1, objective=0.9)],
                         clock=clock)
    m = metrics_cls(clock, registry=reg, slo=slo, max_samples=8)
    for rid in range(12):
        m.request_submitted(rid)
        clock.advance(0.01 * (rid % 4))
        m.request_admitted(rid, 0.01 * (rid % 4))
        clock.advance(0.05)
        m.first_token(rid)
        for _ in range(rid % 3 + 1):
            clock.advance(0.02)
            m.token(rid)
        m.step(rid % 4 + 1, 4)
        end = ("length", "evicted", "timeout", "error", "requeued",
               "migrated", "cancelled")[rid % 7]
        if end == "length":
            m.request_decode_ticks(rid, rid % 3 + 1)
            m.request_finished(rid, "length")
        elif end == "requeued":
            m.request_requeued(rid)
        else:
            getattr(m, f"request_{end}")(rid)
    return dict(summary=m.summary(), text=reg.prometheus(),
                pending=m.pending_requests, slo=slo.snapshot())


def test_serving_metrics_registry_and_slo_match_jax():
    out = _same(_metrics_script)
    assert "serving_finished_total" in out["text"]
    assert out["pending"] == 2                 # the two requeued requests


# -- fleetobs ----------------------------------------------------------------

def _fleet_script(obs, _):
    clock = FakeClock()
    trs = {n: obs.Tracer(clock=clock, id_tag=n) for n in ("router", "r0",
                                                          "r1")}
    ctxs = {rid: obs.TraceContext.mint(rid) for rid in range(3)}
    for rid, ctx in ctxs.items():
        obs.emit_flow(trs["router"], ctx, "route", request_id=rid)
        clock.advance(0.1)
        obs.emit_flow(trs["r0"], ctx, "enqueue", request_id=rid)
    ctx = ctxs[1]                               # migrates r0 -> r1
    clock.advance(0.1)
    obs.emit_flow(trs["r0"], ctx, "migrate_out", request_id=1)
    ctx.next_hop(replica="r1")
    obs.emit_flow(trs["r1"], ctx, "resume", request_id=1)
    for rid in (0, 1):
        clock.advance(0.1)
        obs.emit_flow(trs["r1" if rid else "r0"], ctxs[rid], "finish",
                      final=True, request_id=rid)
    ctxs[2].parent = "nowhere"                  # break request 2's chain
    obs.emit_flow(trs["r0"], ctxs[2], "finish", final=True, request_id=2)
    trs["r0"].async_span("request", 9, 0.0, 0.1)   # an orphan slice
    fc = obs.FleetCollector()
    for n, tr in trs.items():
        fc.add_replica(n, tracer=tr)
    rec = obs.FlightRecorder(clock=clock, window_s=0.25, keep=4)
    for i in range(8):
        clock.advance(0.1)
        rec.record("replica0", "tick", i=i)
        rec.record("router", "route", i=i)
    snap = rec.trigger("replica_dead", replica=0)
    cont = fc.continuity()
    return dict(cont=cont, merged=fc.merged_timeline(),
                offsets=fc.offsets_us(), snap=snap, last=rec.last,
                ctx=ctxs[1].to_dict())


def test_fleetobs_flows_collector_and_recorder_match_jax():
    out = _same(_fleet_script)
    cont = out["cont"]
    assert sorted(cont["complete"]) == ["req:0", "req:1"]
    assert list(cont["broken"]) == ["req:2"]
    assert cont["orphans"]


# -- the engine's registry and tracer ----------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jm = JModel(JConfig(**TINY))
    jp = jm.init_params(jax.random.PRNGKey(0))
    cfg = GPTConfig(**TINY)
    tm = GPTModel(cfg, device="cpu")
    tm.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg))
    return jm, jp, tm


def _engine_run(make, req_cls, obs):
    clock = FakeClock()
    reg = obs.MetricsRegistry(clock=clock)
    tr = obs.Tracer(clock=clock, id_tag="e0")
    eng = make(clock, reg, tr)
    specs = [(0, [1, 2, 3, 4, 5], 6), (1, [1, 2, 3, 9], 5),
             (2, [1, 2, 3, 4, 5, 6, 7], 4), (3, [4, 4, 4], 5)]
    for rid, p, n in specs:
        eng.submit(req_cls(rid, p, max_new_tokens=n,
                           trace=obs.TraceContext.mint(rid)))
    while eng.queue_depth or eng.active_requests:
        eng.step()
        clock.advance(0.01)
    ev = [{k: v for k, v in e.items() if k not in ("pid", "tid")}
          for e in tr.events]
    return dict(text=reg.prometheus(), events=ev,
                tokens={r.request_id: r.tokens for r in eng.completed},
                summary=eng.trace.summary())


def test_engine_registry_and_tracer_match_jax(tiny):
    jm, jp, tm = tiny
    j = _engine_run(lambda c, r, t: JEngine(jm, jp, max_slots=2, clock=c,
                                            registry=r, tracer=t),
                    JRequest, jobs)
    t = _engine_run(lambda c, r, t: InferenceEngine(
        tm, max_slots=2, clock=c, registry=r, tracer=t, device="cpu"),
        Request, tobs)
    assert t == j
    assert "serving_kv_free_bytes" in t["text"]
    assert json.dumps(t["events"])            # serialisable trace
