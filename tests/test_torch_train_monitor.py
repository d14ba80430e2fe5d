"""apex_tpu_torch.observability.train_monitor against apex_tpu's, on the
CPU.

* The reference's ``TestTrainingMonitor`` cases (``tests/test_metrics.py``)
  on the port: a guarded small GPT with a planted ``nan_grads`` whose
  anomaly counts match ``GuardedTrainStep.stats`` and whose JSONL
  ``train_step`` records carry the alerting keys; the loss-scale series
  and ``report()`` with a scaler; a plain step's tokens/s and MFU; the
  JSONL stream through ``stream_path``; skew and the SLO feed.
* The same small GPT (JAX's weights through ``convert.py``) under the
  port's and JAX's ``GuardedTrainStep``, each monitored, with the same
  seeded faults (NaN gradients, inf losses, spikes and a rollback): the
  same JSONL records and registry counters — loss and grad norm to rtol
  1e-5 (the guard tests' tolerance), everything else equal.
* The monitor adds no work to the step: a monitored step dispatches the
  same aten op sequence as an unmonitored one (``program_hash``) and its
  outputs are bit for bit the unmonitored step's.
* ``calibrated_peak_flops`` runs its probe on the CPU when asked.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.observability import (MetricsRegistry as JRegistry,
                                    TrainingMonitor as JMonitor)
from apex_tpu.optimizers import FusedAdam as JFusedAdam
from apex_tpu.resilience import (CheckpointManager as JManager,
                                 FaultInjector as JInjector,
                                 GuardedTrainStep as JGuard)

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.observability import (MetricsRegistry, SLOMonitor,
                                          SLOTarget, TrainingMonitor,
                                          calibrated_peak_flops,
                                          replay_jsonl)
from apex_tpu_torch.observability.train_monitor import _STEP_KEYS
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import (CheckpointManager, Fault,
                                       FaultInjector, GuardedTrainStep)
from apex_tpu_torch.utils.profiling import program_hash

TINY = dict(vocab_size=32, hidden_size=16, num_layers=2,
            num_attention_heads=4, max_seq_len=8)
GPT = dict(vocab_size=64, hidden_size=64, num_layers=2,
           num_attention_heads=4, max_seq_len=16, fused_lm_head=False)
LR = 1e-4
N_STEPS = 10
RATES = {"nan_grads": 0.12, "inf_loss": 0.12, "grad_spike": 0.2}
GUARD_KW = dict(warmup_steps=2, spike_factor=10.0, max_consecutive=2)
RTOL = 1e-5


def _tiny_gpt_guard(scaler=None, injector=None):
    """The reference's ``_tiny_gpt_guard`` on the port."""
    model = GPTModel(GPTConfig(**TINY), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    adam = FusedAdam(model.parameters(), lr=1e-3)
    guard = GuardedTrainStep(lambda m, x, y: m.loss(x, y), adam,
                             scaler=scaler, fault_injector=injector)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 32, (2, 8)))
    targets = torch.from_numpy(rng.randint(0, 32, (2, 8)))
    return guard, model, tokens, targets


class TestTrainingMonitor:
    def test_guarded_step_series_and_anomaly_parity(self):
        inj = FaultInjector([Fault(step=1, kind="nan_grads")])
        guard, model, tokens, targets = _tiny_gpt_guard(injector=inj)
        buf = io.StringIO()
        reg = MetricsRegistry()
        reg.attach_stream(buf)
        mon = TrainingMonitor(reg, tokens_per_step=16)
        h = {"g": guard.init_state()}

        def step(tokens, targets, step):
            r = guard(model, h["g"], tokens, targets, step=step)
            h["g"] = r.guard_state
            return r

        monitored = mon.wrap(step)
        for i in range(3):
            monitored(tokens, targets, step=i)

        assert guard.stats["steps"] == 3 and guard.stats["skipped"] == 1
        assert mon.stats["steps"] == 3
        assert mon.stats["skipped"] == guard.stats["skipped"]

        records = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        steps = [r for r in records if r.get("event") == "train_step"]
        assert len(steps) == 3
        for r in steps:
            assert set(_STEP_KEYS) <= set(r)
        anomalous = [r for r in steps if r.get("anomaly")]
        assert len(anomalous) == 1
        assert anomalous[0]["anomaly"] == "nonfinite"
        assert steps[-1]["anomalies"] == 1

        prom = reg.prometheus()
        for series in ("train_step_time_seconds", "train_tokens_per_s",
                       "train_grad_norm", "train_loss",
                       "train_steps_total"):
            assert series in prom
        assert 'train_anomalies_total{kind="nonfinite"} 1' in prom

    def test_loss_scale_series_with_scaler(self):
        scaler = LossScaler("dynamic", init_scale=8.0, device="cpu")
        guard, model, tokens, targets = _tiny_gpt_guard(scaler=scaler)
        reg = MetricsRegistry()
        mon = TrainingMonitor(reg)
        h = {"g": guard.init_state()}

        def step(tokens, targets):
            r = guard(model, h["g"], tokens, targets)
            h["g"] = r.guard_state
            return r

        monitored = mon.wrap(step)
        monitored(tokens, targets)
        assert reg.get("train_loss_scale").value() == 8.0
        rep = mon.report(guard=guard, scaler=scaler)
        assert rep["scaler"]["loss_scale"] == 8.0
        assert rep["guard"]["steps"] == 1

    def test_plain_step_and_mfu(self):
        clock = iter([0.0, 0.5, 1.0, 1.5]).__next__
        mon = TrainingMonitor(tokens_per_step=100,
                              flops_per_token=1000.0, peak_flops=1e6,
                              clock=clock)

        monitored = mon.wrap(lambda: 2.5)   # plain step returning a loss
        assert monitored() == 2.5
        r = mon.registry
        assert r.get("train_step_time_s_last").value() == 0.5
        assert r.get("train_tokens_per_s").value() == 200.0
        assert r.get("train_mfu").value() == pytest.approx(0.2)
        assert r.get("train_loss").value() == 2.5

    def test_stream_path_opens_file(self, tmp_path):
        path = str(tmp_path / "m.jsonl")
        mon = TrainingMonitor(stream_path=path)
        mon.record(0.1)
        mon.close()
        reg, records = replay_jsonl(open(path))
        assert reg.get("train_steps_total").value() == 1
        assert any(r.get("event") == "train_step" for r in records)


def test_skew_slo_and_straggler_match_jax():
    """The same step times through both monitors: skew, SLO samples and
    the JSONL records (no torch.distributed: no straggler ratio)."""
    times = [0.1, 0.1, 0.12, 0.3, 0.1, 0.11]
    out = []
    for mod in ("port", "jax"):
        buf = io.StringIO()
        if mod == "port":
            reg = MetricsRegistry()
            slo = SLOMonitor([SLOTarget("step_time", 0.2, objective=0.9)],
                             clock=lambda: 0.0)
            mon = TrainingMonitor(reg, tokens_per_step=64, slo=slo,
                                  skew_window=4, straggler_every=2)
        else:
            from apex_tpu.observability.slo import (SLOMonitor as JSLO,
                                                    SLOTarget as JTarget)
            reg = JRegistry()
            slo = JSLO([JTarget("step_time", 0.2, objective=0.9)],
                       clock=lambda: 0.0)
            mon = JMonitor(reg, tokens_per_step=64, slo=slo, skew_window=4,
                           straggler_every=2)
        reg.attach_stream(buf)
        for i, dt in enumerate(times):
            mon.record(dt, step=i)
        recs = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        for r in recs:
            r.pop("ts", None)
        out.append((recs, reg.get("train_step_time_skew").value(),
                    slo.snapshot(), mon.stats))
    (tr, tskew, tslo, tstats), (jr, jskew, jslo, jstats) = out
    assert tr == jr and tskew == jskew and tstats == jstats
    assert json.dumps(tslo, sort_keys=True, default=str) \
        == json.dumps(jslo, sort_keys=True, default=str)


# -- the guarded GPT in both packages -----------------------------------------


def _gpt_batch(step):
    r = np.random.RandomState(500 + step)
    return (r.randint(0, GPT["vocab_size"], (2, 16)),
            r.randint(0, GPT["vocab_size"], (2, 16)))


def _run(pkg, tmp):
    """A monitored guarded run of ``N_STEPS`` steps with seeded faults and
    a rollback; returns the JSONL records (without wall times) and the
    registry."""
    jmodel = JModel(JConfig(**GPT))
    params = jmodel.init_params(jax.random.PRNGKey(4))
    buf = io.StringIO()
    if pkg == "jax":
        opt = JFusedAdam(lr=LR, bucketed=False)
        guard = JGuard(lambda p, x, y: jmodel.loss(p, x, y), opt,
                       checkpoint=JManager(str(tmp / "j")),
                       fault_injector=JInjector.from_seed(11, N_STEPS, RATES),
                       **GUARD_KW)
        reg = JRegistry()
        h = {"p": params, "o": opt.init(params), "g": guard.init_state()}
        guard.save(0, h["p"], h["o"], h["g"])

        def step(x, y, step):
            r = guard(h["p"], h["o"], h["g"], jnp.asarray(x),
                      jnp.asarray(y), step=step)
            h["p"], h["o"], h["g"] = r.params, r.opt_state, r.guard_state
            return r

        def save(s):
            guard.save(s, h["p"], h["o"], h["g"])
        mon = JMonitor(reg, tokens_per_step=32, flops_per_token=100.0,
                       peak_flops=1e9)
    else:
        cfg = GPTConfig(**GPT)
        model = GPTModel(cfg, device="cpu")
        model.load_state_dict(gpt_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), cfg))
        opt = FusedAdam(model.parameters(), lr=LR)
        guard = GuardedTrainStep(
            lambda m, x, y: m.loss(x, y), opt,
            checkpoint=CheckpointManager(str(tmp / "t")),
            fault_injector=FaultInjector.from_seed(11, N_STEPS, RATES),
            **GUARD_KW)
        reg = MetricsRegistry()
        h = {"g": guard.init_state()}
        guard.save(0, model, h["g"])

        def step(x, y, step):
            r = guard(model, h["g"], torch.from_numpy(x),
                      torch.from_numpy(y), step=step)
            h["g"] = r.guard_state
            return r

        def save(s):
            guard.save(s, model, h["g"])
        mon = TrainingMonitor(reg, tokens_per_step=32, flops_per_token=100.0,
                              peak_flops=1e9)
    reg.attach_stream(buf)
    monitored = mon.wrap(step)
    s, calls = 0, 0
    while s < N_STEPS and calls < 2 * N_STEPS:
        res = monitored(*_gpt_batch(s), step=s)
        s, calls = res.next_step, calls + 1
        if s % 3 == 0 and not res.rolled_back:
            save(s)
    recs = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    recs = [r for r in recs if r.get("event") == "train_step"]
    assert len(recs) == calls
    for r in recs:
        for k in ("ts", "step_time_s", "tokens_per_s", "mfu",
                  "step_time_skew"):
            r.pop(k)
    return recs, reg, guard.stats, mon.stats


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("monitor")
    return _run("port", tmp), _run("jax", tmp)


def test_monitored_guard_records_match_jax(both):
    (trecs, _, tguard, tstats), (jrecs, _, jguard, jstats) = both
    assert len(trecs) == len(jrecs)
    kinds = {r.get("anomaly") for r in trecs}
    assert {"nonfinite", "spike", None} <= kinds       # non-vacuous
    assert any(r.get("rolled_back") for r in trecs)
    for t, j in zip(trecs, jrecs):
        assert sorted(t) == sorted(j)
        for k in t:
            if k in ("loss", "grad_norm"):
                if np.isfinite(j[k]):
                    assert t[k] == pytest.approx(j[k], rel=RTOL)
                else:
                    assert not np.isfinite(t[k])
            else:
                assert t[k] == j[k], k
    assert tguard == jguard
    for k in ("steps", "skipped", "rollbacks"):
        assert tstats[k] == jstats[k]


def test_monitored_guard_counters_match_jax(both):
    (_, treg, tguard, _), (_, jreg, _, _) = both
    for name in ("train_steps_total", "train_rollbacks_total"):
        assert treg.get(name).value() == jreg.get(name).value()
    for kind in ("nonfinite", "spike"):
        assert treg.get("train_anomalies_total").value(kind=kind) \
            == jreg.get("train_anomalies_total").value(kind=kind)
    assert treg.get("train_anomalies_total").value(kind="nonfinite") \
        == tguard["nonfinite"]
    assert treg.get("train_anomalies_total").value(kind="spike") \
        == tguard["spikes"]
    assert treg.get("train_rollbacks_total").value() == tguard["rollbacks"]


def test_monitor_adds_no_work_to_the_step():
    """A monitored step dispatches the same ops as an unmonitored one from
    the same state, and ends in the same state bit for bit."""
    runs = []
    for monitored in (False, True):
        inj = FaultInjector([Fault(step=1, kind="nan_grads")])
        guard, model, tokens, targets = _tiny_gpt_guard(injector=inj)
        mon = TrainingMonitor(tokens_per_step=16, flops_per_token=10.0,
                              peak_flops=1e9)
        h = {"g": guard.init_state()}

        def step(tokens, targets, step, guard=guard, model=model, h=h):
            r = guard(model, h["g"], tokens, targets, step=step)
            h["g"] = r.guard_state
            return r
        fn = mon.wrap(step) if monitored else step
        hashes = [program_hash(lambda i=i: fn(tokens, targets, step=i))
                  for i in range(3)]
        runs.append((hashes, [p.detach().clone()
                              for p in model.parameters()],
                     [t.clone() for t in h["g"]]))
    (h0, p0, g0), (h1, p1, g1) = runs
    assert h0 == h1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_calibrated_peak_flops_on_the_cpu():
    peak = calibrated_peak_flops(chain=2, n=64, iters=1, device="cpu")
    assert np.isfinite(peak) and peak > 0
