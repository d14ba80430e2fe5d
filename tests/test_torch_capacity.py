"""apex_tpu_torch.resilience.capacity's train/serve ``CapacityController``
against apex_tpu's, on the CPU.

Every case of the reference's ``tests/test_capacity.py`` runs the JAX
controller and the port's over separate but identical stub trainers and
fleets (``tests/_torch_capacity_fakes.py``), the same clock and the same
burn sequence and fault schedule: the ``shift_log``, ``audit()``, ``split``,
stats, leases and the trainer's re-plans are equal, and the reference's own
assertions hold on the port's.  Then one spawn of ``tests/_torch_dist.py``
on 2 ``gloo`` ranks drives a real ``ElasticTrainer`` (dp 2) through an
injected mid-shift crash: the split and the trainer's parameters and
optimizer state roll back bit for bit, the retry commits at dp 1 and
training goes on.
"""

import types

import numpy as np
import pytest

import apex_tpu.resilience as jres
import apex_tpu.serving as jserving
from apex_tpu.resilience import faults as jfaults

import apex_tpu_torch.resilience as tres
import apex_tpu_torch.serving as tserving
from apex_tpu_torch.resilience import faults as tfaults

import _torch_capacity_fakes as fakes
from _torch_dist import run

PKGS = {"jax": types.SimpleNamespace(res=jres, serving=jserving,
                                     faults=jfaults),
        "torch": types.SimpleNamespace(res=tres, serving=tserving,
                                       faults=tfaults)}


def make_controller(pkg, clockv=None, *, dp=4, **kw):
    clockv = clockv if clockv is not None else [0.0]
    clock = lambda: clockv[0]                                # noqa: E731
    fleet = fakes.FakeFleet(clock=clock)
    trainer = fakes.FakeTrainer(pkg.res.TopologySpec, dp=dp)
    kw.setdefault("min_train_dp", 2)
    kw.setdefault("burn_high", 6.0)
    kw.setdefault("burn_low", 1.0)
    kw.setdefault("confirm_ticks", 3)
    kw.setdefault("cooldown_s", 10.0)
    ctl = pkg.res.CapacityController(trainer, fleet, fakes.FakeEngine,
                                     clock=clock, **kw)
    return ctl, trainer, fleet, clockv


def observed(ctl, trainer, fleet):
    stats = dict(ctl.stats)
    return dict(log=[dict(e) for e in ctl.shift_log], audit=ctl.audit(),
                split=ctl.split, stats=stats, leases=ctl.outstanding_leases,
                shifting=ctl.shifting, replans=list(trainer.replans),
                dp=trainer.plan.spec.dp, live=len(fleet._live()),
                draining=sorted(fleet.draining))


# -- scenarios: each drives one controller and returns what it observed --------


def burn_inside_band(pkg):
    ctl, trainer, fleet, _ = make_controller(pkg)
    for i in range(200):
        fleet.set_burn(1.0001 if i % 2 else 5.9999)
        ctl.tick()
    return observed(ctl, trainer, fleet)


def burn_at_threshold(pkg):
    ctl, trainer, fleet, _ = make_controller(pkg, confirm_ticks=3)
    fleet.set_burn(6.0)
    for _ in range(3):
        ctl.tick()
    return observed(ctl, trainer, fleet)


def burn_just_below(pkg):
    ctl, trainer, fleet, _ = make_controller(pkg, confirm_ticks=3)
    fleet.set_burn(5.999999)
    for _ in range(50):
        ctl.tick()
    return observed(ctl, trainer, fleet)


def broken_streak(pkg):
    ctl, trainer, fleet, _ = make_controller(pkg, confirm_ticks=3)
    for _ in range(10):
        fleet.set_burn(7.0)
        ctl.tick()
        ctl.tick()
        fleet.set_burn(3.0)
        ctl.tick()
    return observed(ctl, trainer, fleet)


def cooldown(pkg):
    ctl, trainer, fleet, clockv = make_controller(pkg, confirm_ticks=2,
                                                  cooldown_s=10.0)
    fleet.set_burn(8.0)
    ctl.tick()
    ctl.tick()
    mid = ctl.stats["shifts"]
    fleet.set_burn(0.0)
    for _ in range(20):
        clockv[0] += 0.1
        ctl.tick()
    held = ctl.stats["shifts"]
    clockv[0] += 10.0
    for _ in range(3):
        ctl.tick()
    return dict(observed(ctl, trainer, fleet), mid=mid, held=held)


def slo_reset(pkg):
    ctl, trainer, fleet, _ = make_controller(pkg, confirm_ticks=1)
    survivors = [e for _, e in fleet._live()]
    fleet.set_burn(9.0)
    ctl.tick()
    return dict(observed(ctl, trainer, fleet),
                resets=[e.metrics.slo.resets for e in survivors])


def queued_never_interleaves(pkg):
    ctl, trainer, fleet, _ = make_controller(pkg, cooldown_s=0.0)
    marks = [ctl.request_shift("to_serving")]
    ctl.tick()
    marks.append((ctl.stats["shifts"], ctl.outstanding_leases))
    fleet.drain_done = False
    ctl.request_shift("to_training")
    ctl.tick()
    marks.append(ctl.shifting)
    ctl.request_shift("to_serving")
    for _ in range(5):
        ctl.tick()
    marks.append((ctl.shifting, ctl._shift.direction, len(ctl.shift_log)))
    fleet.drain_done = True
    ctl.tick()
    marks.append((ctl.shifting, ctl.stats["shifts"]))
    ctl.tick()
    return dict(observed(ctl, trainer, fleet), marks=marks)


def infeasible_dropped(pkg):
    ctl, trainer, fleet, _ = make_controller(pkg)
    ctl.request_shift("to_training")
    ctl.tick()
    try:
        ctl.request_shift("sideways")
        error = None
    except ValueError as e:
        error = str(e)
    return dict(observed(ctl, trainer, fleet), error=error)


def stuck_drain(pkg):
    sinj = pkg.serving.ServingFaultInjector([pkg.serving.ServingFault(
        0, 0, "capacity_change", magnitude=2.0, duration=10 ** 9)])
    ctl, trainer, fleet, _ = make_controller(
        pkg, cooldown_s=0.0, drain_timeout_ticks=5, serving_injector=sinj)
    ctl.request_shift("to_serving")
    for _ in range(8):
        ctl.tick()
    return observed(ctl, trainer, fleet)


def failed_reshard(pkg):
    sinj = pkg.serving.ServingFaultInjector([pkg.serving.ServingFault(
        0, 0, "capacity_change", magnitude=3.0, duration=10 ** 9)])
    ctl, trainer, fleet, _ = make_controller(pkg, cooldown_s=0.0,
                                             serving_injector=sinj)
    ctl.request_shift("to_serving")
    ctl.tick()
    first = observed(ctl, trainer, fleet)
    ctl.request_shift("to_serving")
    ctl.tick()
    return dict(observed(ctl, trainer, fleet), first=first)


def crash_on_drain_back(pkg):
    ctl, trainer, fleet, _ = make_controller(pkg, cooldown_s=0.0)
    ctl.request_shift("to_serving")
    ctl.tick()
    ctl.injector = pkg.res.FaultInjector([pkg.res.Fault(0,
                                                        "capacity_change")])
    ctl.request_shift("to_training")
    ctl.tick()
    first = observed(ctl, trainer, fleet)
    ctl.request_shift("to_training")
    for _ in range(3):
        ctl.tick()
    return dict(observed(ctl, trainer, fleet), first=first)


SCENARIOS = {f.__name__: f for f in (
    burn_inside_band, burn_at_threshold, burn_just_below, broken_streak,
    cooldown, slo_reset, queued_never_interleaves, infeasible_dropped,
    stuck_drain, failed_reshard, crash_on_drain_back)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_matches_jax(name):
    got = SCENARIOS[name](PKGS["torch"])
    want = SCENARIOS[name](PKGS["jax"])
    assert got == want


# -- the reference's own assertions, on the port -------------------------------


def test_fault_mode_budget_and_band():
    assert [tres.fault_mode(m) for m in (0, 1, 2, 3, 99)] == \
        [jres.fault_mode(m) for m in (0, 1, 2, 3, 99)]
    assert set(tres.CAPACITY_FAULT_MODES) == set(jres.CAPACITY_FAULT_MODES)
    tres.CapacityBudget(6, 4, 2)
    with pytest.raises(ValueError):
        tres.CapacityBudget(6, 4, 3)
    with pytest.raises(ValueError):
        tres.CapacityBudget(6, 4, 2, chips_per_replica=0)
    with pytest.raises(ValueError):
        make_controller(PKGS["torch"], burn_high=1.0, burn_low=6.0)


def test_reference_assertions_hold_on_the_port():
    p = PKGS["torch"]
    r = burn_inside_band(p)
    assert r["stats"]["shifts"] == 0 and r["log"] == [] and r["audit"] == []
    r = burn_at_threshold(p)
    assert r["stats"]["shifts"] == 1 and r["dp"] == 2
    assert r["split"] == (2, 4) and r["audit"] == []
    assert burn_just_below(p)["replans"] == []
    assert broken_streak(p)["stats"]["shifts"] == 0
    r = cooldown(p)
    assert (r["mid"], r["held"], r["stats"]["shifts"]) == (1, 1, 2)
    assert r["dp"] == 4 and r["split"] == (4, 2) and r["leases"] == 0
    assert slo_reset(p)["resets"] == [["shift-1"], ["shift-1"]]
    r = queued_never_interleaves(p)
    assert r["marks"][3] == (True, "to_training", 2)
    assert [e["direction"] for e in r["log"]] == [
        "to_serving", "to_training", "to_serving"]
    assert all(e["outcome"] == "commit" for e in r["log"])
    r = infeasible_dropped(p)
    assert r["stats"]["shifts"] == 0 and r["error"]
    r = stuck_drain(p)
    assert r["stats"]["rollbacks"] == 1 and r["split"] == (4, 2)
    assert "timed out" in r["log"][0]["reason"]
    r = failed_reshard(p)
    assert r["first"]["stats"]["rollbacks"] == 1 and r["first"]["live"] == 2
    assert r["stats"]["shifts"] == 1 and r["split"] == (2, 4)
    r = crash_on_drain_back(p)
    assert r["first"]["leases"] == 1 and r["first"]["draining"] == []
    assert r["first"]["split"] == (2, 4)
    assert r["stats"]["shifts"] == 2 and r["split"] == (4, 2)


def test_fault_schedules_unchanged_by_the_capacity_kind():
    idx = tfaults.FAULT_KINDS.index("capacity_change")
    rates = {k: 0.15 for k in tfaults.FAULT_KINDS[:idx]}
    inj = tres.FaultInjector.from_seed(5, 40, rates)
    expected = tfaults.seeded_schedule(5, 40, tfaults.FAULT_KINDS[:idx],
                                       rates)
    assert [(f.step, f.kind) for f in inj.schedule] == expected
    assert expected == jfaults.seeded_schedule(
        5, 40, jfaults.FAULT_KINDS[:idx], rates)
    f = tres.FaultInjector([tres.Fault(4, "capacity_change",
                                       magnitude=3.0)])
    got = f.check_capacity_change(4)
    assert tres.fault_mode(got.magnitude) == "failed_reshard"
    assert f.check_capacity_change(4) is None


# -- a real trainer under the controller, on 2 gloo ranks -----------------------


def test_mid_shift_crash_restores_real_trainer_bitwise(tmp_path):
    r = np.random.RandomState(3)
    c = dict(w=r.randn(8, 4).astype(np.float32), b=np.zeros(4, np.float32),
             seed=60_000, n=5, tmp=str(tmp_path))
    for out in run(tmp_path, 2, "elastic", {"parts": {"capacity_crash": c}},
                   timeout=120):
        out = out["capacity_crash"]
        crash = out["after_crash"]
        assert crash["stats"]["rollbacks"] == 1
        assert crash["stats"]["shifts"] == 0
        assert crash["dp"] == 2 and crash["split"] == (2, 2)
        assert len(crash["state"]) == len(out["pre"])
        for got, want in zip(crash["state"], out["pre"]):
            np.testing.assert_array_equal(got, want)
        assert out["after_retry"] == {"shifts": 1, "split": (1, 3), "dp": 1}
        assert out["step"] == 3
        assert out["log"] == [
            {"direction": "to_serving", "fault": "mid_shift_crash",
             "outcome": "rollback"},
            {"direction": "to_serving", "fault": None, "outcome": "commit"}]
