"""apex_tpu_torch.resilience.autopilot against apex_tpu's, on the CPU.

* The reference's ``FakeTrainer`` recipe (``tests/test_autopilot.py``: a
  plan, a rank pool, ``replan_to`` and the drain/re-shard stats) driven by
  the port's and JAX's ``ParallelismAutopilot`` through the same drift
  schedules — detection (too few measurements, a one-window spike, two
  confirming windows), a commit through the gate, a ``plan_regression``
  rollback, a failed replan, the full commit-then-rollback cycle, the
  cooldown queue, a manual request, the drift environment's scaling:
  equal adoption logs (outcomes, ticks, reasons, gate and baseline means),
  ``stats`` counts, replans, applied faults, registry counters and
  ``audit()``.  Floats compare to 1e-12 relative; wall-time fields
  (``last_refit_s``, ``last_adoption``'s timings) are left out.
* Constructor validation and the fault hooks as in the reference.
* At 4 ``gloo`` ranks (one spawn of ``tests/_torch_dist.py``,
  ``tests/_torch_obs_ranks.py``) a real ``ElasticTrainer`` (ZeRO) fed the
  reference day's ``_drift_dt`` step times commits dp 4 -> 2 when the
  links drift, and when they recover under an injected ``plan_regression``
  rolls the re-adoption back to dp 2: the live state is bit for bit the
  checkpoint the rollback stamped, ``audit() == []``, and every rank
  agrees.
"""

from types import SimpleNamespace

import pytest

from apex_tpu.observability import MetricsRegistry as JRegistry
from apex_tpu.observability import costmodel as JC
from apex_tpu.resilience import (Fault as JFault,
                                 FaultInjector as JInjector,
                                 ParallelismAutopilot as JAutopilot,
                                 TopologySpec as JSpec)

from _torch_dist import start
from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.observability import costmodel as TC
from apex_tpu_torch.resilience import (ADOPTION_OUTCOMES, Fault,
                                       FaultInjector, ParallelismAutopilot,
                                       TopologySpec)

ALPHA0, BETA0 = 2e-3, 1e-9
GRAD_BYTES = 144
SERIAL_S = 0.12
RTOL = 1e-12

PKGS = {
    "port": SimpleNamespace(C=TC, Autopilot=ParallelismAutopilot,
                            Fault=Fault, Injector=FaultInjector,
                            Spec=TopologySpec, Registry=MetricsRegistry,
                            pool="_ranks"),
    "jax": SimpleNamespace(C=JC, Autopilot=JAutopilot, Fault=JFault,
                           Injector=JInjector, Spec=JSpec,
                           Registry=JRegistry, pool="_devices"),
}


def _chip_smoke():
    """The card script (it imports torch and numpy only)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_FAKE = _chip_smoke().FakeTrainer


def FakeTrainer(pkg, dp=4, n=4, fail_replans=0):
    """The reference's trainer surface (``chip_smoke.FakeTrainer``) in
    ``pkg``'s spec, its pool under ``pkg``'s name."""
    return _FAKE(pkg.Spec(dp=dp), range(n), pool=pkg.pool,
                 fail_replans=fail_replans)


def _profile(pkg):
    return pkg.C.fit_cost_model(
        pkg.C.simulate_link_measurements(ALPHA0, BETA0, link_class="dcn",
                                         ops=("psum",)),
        meta={"source": "test"})


def _step_dt(pkg, dp, scale=1.0):
    fit = pkg.C.CostFit(ALPHA0 * scale, BETA0 * scale)
    comm = fit.predict("psum", GRAD_BYTES, dp) if dp > 1 else 0.0
    return SERIAL_S / dp + comm


def _make(pkg, trainer, clockv, **kw):
    kw.setdefault("min_dp", 2)
    kw.setdefault("link_class", "dcn")
    kw.setdefault("drift_threshold", 0.3)
    kw.setdefault("confirm_windows", 2)
    kw.setdefault("min_measurements", 8)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("gate_steps", 2)
    kw.setdefault("gate_tolerance", 1.2)
    kw.setdefault("grad_bytes", GRAD_BYTES)
    return pkg.Autopilot(trainer, _profile(pkg), clock=lambda: clockv[0],
                         **kw)


def _drive(pkg, tr, ap, clockv, n_steps, scale_at, ticks_per_step=2):
    for step in range(tr.current_step, tr.current_step + n_steps):
        tr.current_step = step + 1
        ap.record_step(_step_dt(pkg, tr.plan.spec.dp, scale_at(step)))
        for _ in range(ticks_per_step):
            ap.tick()
        clockv[0] += 0.1


def _drifted(pkg, scale, **kw):
    return pkg.C.simulate_link_measurements(
        ALPHA0 * scale, BETA0 * scale, link_class="dcn", ops=("psum",), **kw)


# -- the scenarios (each returns what both packages must agree on) -----------


def _too_few(pkg, tr, ap, clockv):
    for i in range(20):
        if i < 5:
            ap.observe(_drifted(pkg, 16, dtypes=("f32",), sizes=(1 << 12,),
                                group_sizes=(2,))[:1])
        tr.current_step += 1
        ap.record_step(_step_dt(pkg, 4, 16.0))
        ap.tick()
        clockv[0] += 0.1
    n = len(ap.profile.fresh_measurements)
    ap.observe(_drifted(pkg, 16))
    ap.tick()
    return {"buffered": n}


def _spike(pkg, tr, ap, clockv):
    drifted, clean = _drifted(pkg, 16), _drifted(pkg, 1)
    for window in [drifted, clean, drifted, clean, drifted]:
        ap.observe(window)
        tr.current_step += 1
        ap.record_step(_step_dt(pkg, 4))
        ap.tick()
        clockv[0] += 0.1
    return {}


def _confirm(pkg, tr, ap, clockv):
    for _ in range(2):
        ap.observe(_drifted(pkg, 16))
        tr.current_step += 1
        ap.record_step(_step_dt(pkg, 4, 16.0))
        ap.tick()
        clockv[0] += 0.1
    return {}


def _commit(pkg, tr, ap, clockv):
    ap.injector = pkg.Injector([pkg.Fault(2, "cost_drift", magnitude=16.0)])
    _drive(pkg, tr, ap, clockv, 10, lambda s: 16.0 if s >= 2 else 1.0)
    return {}


def _regression(pkg, tr, ap, clockv):
    ap.injector = pkg.Injector([
        pkg.Fault(2, "cost_drift", magnitude=16.0),
        pkg.Fault(2, "plan_regression", magnitude=4.0)])
    _drive(pkg, tr, ap, clockv, 10, lambda s: 16.0 if s >= 2 else 1.0)
    return {}


def _full_cycle(pkg, tr, ap, clockv):
    ap.injector = pkg.Injector([
        pkg.Fault(2, "cost_drift", magnitude=16.0),
        pkg.Fault(8, "cost_drift", magnitude=1 / 16),
        pkg.Fault(8, "plan_regression", magnitude=4.0)])
    _drive(pkg, tr, ap, clockv, 24,
           lambda s: 16.0 if 2 <= s < 8 else 1.0)
    return {}


def _cooldown(pkg, tr, ap, clockv):
    ap.injector = pkg.Injector([pkg.Fault(2, "cost_drift", magnitude=16.0),
                                pkg.Fault(9, "cost_drift", magnitude=16.0)])

    def scale_at(step):
        return (16.0 if step >= 2 else 1.0) * (16.0 if step >= 9 else 1.0)
    _drive(pkg, tr, ap, clockv, 10, scale_at)
    mid = {"adoptions": ap.stats["adoptions"], "replans": len(tr.replans)}
    _drive(pkg, tr, ap, clockv, 20, scale_at)
    mid["queued"] = ap.queued
    clockv[0] += 200.0
    _drive(pkg, tr, ap, clockv, 2, scale_at)
    return mid


def _manual(pkg, tr, ap, clockv):
    for _ in range(4):
        tr.current_step += 1
        ap.record_step(_step_dt(pkg, 4))
    ap.request_adoption()
    _drive(pkg, tr, ap, clockv, 4, lambda s: 1.0)
    return {}


def _environment(pkg, tr, ap, clockv):
    ap.injector = pkg.Injector([pkg.Fault(0, "cost_drift")])
    tr.current_step = 1
    ap.tick()
    first = list(ap._drift_env[("psum", "f32", "dcn")])
    ap.injector = pkg.Injector([pkg.Fault(1, "cost_drift", magnitude=0.5)])
    ap.tick()
    return {"first": first, "second": list(ap._drift_env[("psum", "f32",
                                                            "dcn")])}


SCENARIOS = {
    "too_few": (_too_few, {}, {}),
    "spike": (_spike, {}, {}),
    "confirm": (_confirm, {}, {}),
    "commit": (_commit, {}, {}),
    "regression": (_regression, {"registry": True}, {}),
    "replan_failure": (_commit, {}, {"fail_replans": 1}),
    "full_cycle": (_full_cycle, {"cooldown_s": 0.5, "registry": True}, {}),
    "cooldown": (_cooldown, {"cooldown_s": 100.0}, {}),
    "manual": (_manual, {}, {}),
    "environment": (_environment, {}, {}),
}
_WALL = ("last_refit_s", "last_adoption")


def _run(pkg_name, scenario):
    pkg = PKGS[pkg_name]
    fn, ap_kw, tr_kw = SCENARIOS[scenario]
    ap_kw = dict(ap_kw)
    reg = pkg.Registry() if ap_kw.pop("registry", False) else None
    tr = FakeTrainer(pkg, **tr_kw)
    clockv = [0.0]
    ap = _make(pkg, tr, clockv, registry=reg, **ap_kw)
    extra = fn(pkg, tr, ap, clockv)
    inj = ap.injector
    out = {"extra": extra,
           "log": [dict(e) for e in ap.adoption_log],
           "stats": {k: v for k, v in ap.stats.items() if k not in _WALL},
           "last_adoption": (None if ap.stats["last_adoption"] is None else
                             {k: ap.stats["last_adoption"][k]
                              for k in ("outcome", "old", "new",
                                        "baseline_s", "gate_s")}),
           "replans": [s.describe() for s in tr.replans],
           "final": tr.plan.spec.describe(), "queued": ap.queued,
           "adopting": ap.adopting, "audit": ap.audit(),
           "faults": None if inj is None else list(inj.log)}
    if reg is not None:
        c = reg.get("autopilot_adoptions_total")
        out["counters"] = {o: c.value(outcome=o) for o in ADOPTION_OUTCOMES}
        out["drift_gauge"] = reg.get("autopilot_drift_detected").value()
    return out


def _equal(a, b, path="."):
    if isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=RTOL, abs=0.0), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fake_trainer_scenarios_match_jax(scenario):
    port, ref = _run("port", scenario), _run("jax", scenario)
    _equal(port, ref)
    assert port["audit"] == []


def test_scenarios_are_not_vacuous():
    outcomes = {s: [e["outcome"] for e in _run("port", s)["log"]]
                for s in ("commit", "regression", "replan_failure",
                          "full_cycle")}
    assert outcomes == {"commit": ["commit"], "regression": ["rollback"],
                        "replan_failure": ["rollback"],
                        "full_cycle": ["commit", "rollback"]}
    assert _run("port", "too_few")["stats"]["refits"] == 1
    assert _run("port", "spike")["stats"]["drift_confirmed"] == 0
    assert _run("port", "confirm")["stats"]["drift_confirmed"] == 1
    cool = _run("port", "cooldown")
    assert cool["extra"]["queued"] <= 1 and cool["stats"]["no_change"] >= 1
    assert _run("port", "manual")["log"][0]["manual"]
    env = _run("port", "environment")["extra"]
    assert env["first"][0] == pytest.approx(ALPHA0 * 2.0)
    assert env["second"][0] == pytest.approx(ALPHA0)


@pytest.mark.parametrize("kw", [
    {"drift_threshold": 0.0},
    {"confirm_windows": 0},
    {"gate_steps": 0},
    {"gate_tolerance": 0.9},
    {"refit_every": 0},
    {"structural_threshold": -1.0},
])
def test_bad_knobs_refused(kw):
    with pytest.raises(ValueError):
        _make(PKGS["port"], FakeTrainer(PKGS["port"]), [0.0], **kw)


def test_structural_channel_matches_jax():
    outs = []
    for name in ("port", "jax"):
        pkg = PKGS[name]
        tr = FakeTrainer(pkg)
        clockv = [0.0]
        ap = _make(pkg, tr, clockv, structural_threshold=0.5)
        got = []
        for score in (0.6, 0.2, 0.7, {"drift_score": 0.9, "worst_op": "f",
                                      "misordered": [1, 2]}):
            got.append(ap.observe_anatomy(score))
        tr.current_step += 1
        ap.record_step(_step_dt(pkg, 4))
        ap.tick()
        outs.append((got, [dict(e) for e in ap.adoption_log],
                     ap.stats["structural_confirmed"], ap.audit()))
    _equal(outs[0], outs[1])
    assert outs[0][0] == [False, False, False, True]


def test_zero_plan_grows_back_from_dp_one():
    """At dp 1 a ZeRO plan says zero_shard 1: the trainer's base plan
    decides that the larger plans are sharded (JAX's ranker would offer dp
    2 with zero_shard 1, which a ZeRO factory cannot build)."""
    pkg = PKGS["port"]
    tr = FakeTrainer(pkg, dp=1, n=2)
    tr.plan = SimpleNamespace(spec=TopologySpec(dp=1, zero_shard=1))
    tr._base_spec = TopologySpec(dp=2, zero_shard=2)
    ap = _make(pkg, tr, [0.0], min_dp=1)
    ap.record_step(_step_dt(pkg, 1))
    got = {r["spec"].dp: r["spec"].zero_shard for r in ap._rank_plans()}
    assert got == {1: 1, 2: 2}
    del tr._base_spec                       # no base plan: JAX's rule
    assert {r["spec"].dp: r["spec"].zero_shard
            for r in ap._rank_plans()} == {1: 1, 2: 1}


def test_grad_bytes_and_pool_from_the_trainer():
    """Without ``grad_bytes`` the ranker reads the model's parameters, and
    its pool is the trainer's rank list."""
    import torch
    pkg = PKGS["port"]
    tr = FakeTrainer(pkg, dp=4, n=4)
    tr.model = torch.nn.Linear(8, 4)            # 144 bytes of f32
    clockv = [0.0]
    ap = _make(pkg, tr, clockv, grad_bytes=None)
    for _ in range(3):
        ap.record_step(_step_dt(pkg, 4))
    ranked = ap._rank_plans()
    assert ap._grad_bytes == GRAD_BYTES
    assert sorted(r["spec"].dp for r in ranked) == [2, 4]
    assert all(isinstance(r["spec"], TopologySpec) for r in ranked)


# -- a real ElasticTrainer at 4 gloo ranks ------------------------------------


CYCLE = dict(drift_step=6, recover_step=14, drift_scale=16.0,
             regression_scale=4.0, alpha=2e-3, beta=1e-9, serial_s=0.12,
             steps=24, seed=77_000)


@pytest.fixture(scope="module")
def cycles(tmp_path_factory):
    """One spawn at 4 ranks (dp 4 -> 2 -> 4 rolled back) and one at 2
    (dp 2 -> 1 -> 2 rolled back: growing a ZeRO plan back from dp 1),
    started together."""
    import numpy as np
    tmp = tmp_path_factory.mktemp("autopilot")
    r = np.random.RandomState(5)
    spawns = {}
    for world in (4, 2):
        c = dict(CYCLE, w=r.randn(8, 4).astype(np.float32),
                 b=np.zeros(4, np.float32), tmp=str(tmp / f"w{world}"),
                 min_dp=world // 2)
        spawns[world] = start(tmp / f"w{world}", world, "obs",
                              {"parts": {"autopilot_cycle": c}}, timeout=300)
    return {w: [o["autopilot_cycle"] for o in s.result()]
            for w, s in spawns.items()}


@pytest.mark.parametrize("world", [4, 2])
def test_real_trainer_commits_then_rolls_back(cycles, world):
    cycle, half = cycles[world], world // 2
    r0 = cycle[0]
    assert [e["outcome"] for e in r0["log"]] == ["commit", "rollback"]
    assert r0["log"][0]["old"].startswith(f"dp={world}") \
        and r0["log"][0]["new"].startswith(f"dp={half}")
    assert r0["log"][1]["fault"] \
        and r0["log"][1]["new"].startswith(f"dp={world}")
    assert r0["log"][1]["new"].endswith(f"zero={world}")
    assert r0["log"][1]["reason"].startswith("measured regression")
    assert r0["final"] == TopologySpec(dp=half, zero_shard=half).to_dict()
    assert r0["audit"] == []
    assert r0["stats"]["adoptions"] == 1 and r0["stats"]["rollbacks"] == 1
    assert r0["counters"] == (1.0, 1.0)
    assert sorted(r0["faults"]) == [
        (CYCLE["drift_step"], "cost_drift"),
        (CYCLE["recover_step"], "cost_drift"),
        (CYCLE["recover_step"], "plan_regression")]
    # commit (one replan), the re-adoption and its rollback (two)
    assert r0["replans"] == 3
    assert half in r0["dps"] and world in r0["dps"] \
        and r0["dps"][-1] == half
    # every rank took the same decisions at the same ticks
    for r in cycle[1:]:
        assert r["log"] == r0["log"] and r["stats"] == r0["stats"]
        assert r["dps"] == r0["dps"] and r["audit"] == []


@pytest.mark.parametrize("world", [4, 2])
def test_rollback_state_is_the_stamped_checkpoint(cycles, world):
    import numpy as np
    half = world // 2
    for rank, r in enumerate(cycles[world]):
        after = r["after"]
        assert after["stamp"] \
            == TopologySpec(dp=half, zero_shard=half).to_dict()
        assert after["spec"] == after["stamp"]
        if rank < half:                 # the ranks of the dp-W/2 plan
            assert after["restored"] is not None
            assert len(after["restored"]) == len(after["live"]) > 0
            for a, b in zip(after["live"], after["restored"]):
                np.testing.assert_array_equal(a, b)
        else:
            assert after["restored"] is None and after["live"] is None


@pytest.mark.parametrize("world", [4, 2])
def test_ranks_decide_as_one_process(cycles, world):
    """The job's adoptions start and resolve at the ticks, and with the
    outcomes, of one process's autopilot over the FakeTrainer recipe fed
    the first rank's step times on the same schedule: the tick's broadcast
    neither delays nor reorders a decision."""
    from _torch_obs_ranks import _GRAD_BYTES, drift_dt
    c = CYCLE
    inj = FaultInjector([
        Fault(c["drift_step"], "cost_drift", magnitude=c["drift_scale"]),
        Fault(c["recover_step"], "cost_drift",
              magnitude=1.0 / c["drift_scale"]),
        Fault(c["recover_step"], "plan_regression",
              magnitude=c["regression_scale"])])
    tr = FakeTrainer(PKGS["port"], dp=world, n=world)
    profile = TC.fit_cost_model(TC.simulate_link_measurements(
        c["alpha"], c["beta"], link_class="dcn", ops=("psum",)),
        meta={"source": "test"})
    clockv = [0.0]
    ap = ParallelismAutopilot(
        tr, profile, min_dp=world // 2, link_class="dcn",
        drift_threshold=0.3, confirm_windows=2, min_measurements=8,
        cooldown_s=0.5, gate_steps=2, gate_tolerance=1.2, injector=inj,
        grad_bytes=_GRAD_BYTES, clock=lambda: clockv[0])
    for step in range(c["steps"]):
        tr.current_step = step + 1
        ap.record_step(drift_dt(step, tr.plan.spec.dp, c))
        ap.tick()
        ap.tick()
        clockv[0] += 0.1
    want = [(e["tick"], e["outcome"]) for e in ap.adoption_log]
    assert [o for _, o in want] == ["commit", "rollback"]
    for r in cycles[world]:
        assert [(e["tick"], e["outcome"]) for e in r["log"]] == want
        assert r["stats"]["refits"] == ap.stats["refits"]
        assert r["stats"]["drift_confirmed"] == ap.stats["drift_confirmed"]
