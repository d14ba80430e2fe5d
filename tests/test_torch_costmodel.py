"""apex_tpu_torch.observability.costmodel against apex_tpu's, on the CPU.

* The framework-free part (the ring model, the least-squares fit, the
  ``CostModel`` with its refits, drift reports, validation, staleness and
  JSON, ``holdout_split``, ``simulate_link_measurements``) is a copy: the
  same measurements — synthesized with seeded noise, and drawn from a
  seed — give the JAX package's fits, predictions and reports to 1e-12
  relative (equal in practice), and a profile saved by either package
  loads in the other.
* ``probe_collectives`` over 2 and 4 ``gloo`` ranks (one spawn each of
  ``tests/_torch_dist.py``, ``tests/_torch_obs_ranks.py``) returns a
  measurement for every (op, dtype, group, size) cell, the same list on
  every rank, and fits; under two ranks it raises naming the world size.
* ``LocalDcnChannel.from_cost_model`` prices the link as JAX's.
"""

import json
import math

import numpy as np
import pytest

from apex_tpu.mpmd.channel import LocalDcnChannel as JChannel
from apex_tpu.observability import costmodel as J

from _torch_dist import start
from apex_tpu_torch.mpmd.channel import LocalDcnChannel
from apex_tpu_torch.observability import costmodel as T

RTOL = 1e-12
SIZES = (1 << 10, 1 << 12, 1 << 14)
DTYPES = ("f32", "bf16", "int8")


def _measurements(mod, seed=0):
    """Two tiers of synthesized points with seeded jitter, and a set of
    points drawn from a seed (all four ops, three dtypes)."""
    ms = (mod.simulate_link_measurements(2e-6, 4e-11, link_class="ici",
                                         dtypes=DTYPES, rel_noise=0.2,
                                         seed=seed)
          + mod.simulate_link_measurements(1e-3, 1e-8, link_class="dcn",
                                           rel_noise=0.1, seed=seed + 1))
    r = np.random.RandomState(seed + 2)
    for op in mod.COLLECTIVE_OPS:
        for k in (2, 4, 8):
            for nb in (1 << 11, 1 << 15, 1 << 19):
                ms.append(mod.Measurement(op=op, dtype="f32", group_size=k,
                                          nbytes=nb,
                                          time_s=float(r.uniform(1e-6,
                                                                 1e-3)),
                                          link_class="ici"))
    return ms


def _n_local(nbytes_local, dtype, k):
    """The probe's per-rank element count (the reference's rule)."""
    n = max(nbytes_local // T._DTYPE_WIDTH[dtype], k)
    n -= n % k
    return max(n, k)


def _as(mod, ms):
    return [mod.Measurement.from_dict(m.to_dict()) for m in ms]


def _close(a, b):
    assert a == pytest.approx(b, rel=RTOL, abs=0.0)


def _same_curves(jm, tm):
    jc, tc = jm.curves(), tm.curves()
    assert sorted(jc) == sorted(tc)
    for key in jc:
        for f in ("alpha_s", "beta_s_per_byte", "max_rel_err"):
            _close(getattr(tc[key], f), getattr(jc[key], f))
        assert tc[key].n_points == jc[key].n_points


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("probe")
    c = dict(dtypes=list(DTYPES), sizes=list(SIZES), iters=2, rounds=2)
    spawns = {w: start(tmp / f"w{w}", w, "obs", {"parts": {"probe": c}},
                       timeout=240) for w in (2, 4)}
    return {w: [o["probe"] for o in s.result()] for w, s in spawns.items()}


def test_ring_model_matches_jax():
    for op in T.COLLECTIVE_OPS:
        for k in (1, 2, 3, 4, 8):
            assert T.ring_hops(op, k) == J.ring_hops(op, k)
            for nb in (0, 7, 4096, 1 << 20):
                assert T.ring_wire_bytes(op, nb, k) \
                    == J.ring_wire_bytes(op, nb, k)
    with pytest.raises(ValueError):
        T.ring_hops("broadcast", 2)
    assert T.PROFILE_VERSION == J.PROFILE_VERSION
    assert T.HLO_KIND_TO_OP == J.HLO_KIND_TO_OP
    assert T.COLLECTIVE_OPS == J.COLLECTIVE_OPS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_predict_and_validate_match_jax(seed):
    jms = _measurements(J, seed)
    tms = _as(T, jms)
    jm, tm = J.fit_cost_model(jms), T.fit_cost_model(tms)
    _same_curves(jm, tm)
    for op in T.COLLECTIVE_OPS:
        for lc in ("ici", "dcn", "other"):
            for dt in ("f32", "bf16", "f8"):
                _close(tm.predict(op, 12345, 4, dtype=dt, link_class=lc),
                       jm.predict(op, 12345, 4, dtype=dt, link_class=lc))
    with pytest.raises(ValueError):
        tm.predict("broadcast", 1, 2)
    jtrain, jheld = J.holdout_split(jms)
    ttrain, theld = T.holdout_split(tms)
    assert [m.to_dict() for m in ttrain] == [m.to_dict() for m in jtrain]
    assert [m.to_dict() for m in theld] == [m.to_dict() for m in jheld]
    jv = J.fit_cost_model(jtrain).validate(jheld)
    tv = T.fit_cost_model(ttrain).validate(theld)
    assert tv["n"] == jv["n"] and tv["within_tolerance"] \
        == jv["within_tolerance"]
    _close(tv["worst_ratio"], jv["worst_ratio"])
    for a, b in zip(tv["rows"], jv["rows"]):
        assert {k: a[k] for k in ("op", "dtype", "group_size", "nbytes",
                                  "link_class")} \
            == {k: b[k] for k in ("op", "dtype", "group_size", "nbytes",
                                  "link_class")}
        _close(a["pred_s"], b["pred_s"])
        _close(a["ratio"], b["ratio"])


def test_predict_stats_matches_jax():
    jm = J.fit_cost_model(_measurements(J))
    tm = T.CostModel.from_json(jm.to_json())
    stats = {"all_reduce": {"count": 2, "bytes": 3 << 20, "ops": [
                 {"bytes": 1 << 20, "group_size": 4},
                 {"bytes": 2 << 20, "group_size": None}]},
             "all_gather": {"count": 1, "bytes": 4096,
                            "ops": [{"bytes": 4096, "group_size": 2}]},
             "collective_permute": {"count": 1, "bytes": 512,
                                    "ops": [{"bytes": 512,
                                             "group_size": 8}]},
             "total": {"count": 4, "bytes": (3 << 20) + 4608}}
    for lcs in (None, "dcn", {"collective_permute": "dcn"}):
        jp = jm.predict_stats(stats, group_size=4, link_classes=lcs)
        tp = tm.predict_stats(stats, group_size=4, link_classes=lcs)
        assert sorted(jp) == sorted(tp)
        _close(tp["total_s"], jp["total_s"])
        for kind in jp:
            if kind != "total_s":
                _close(tp[kind]["pred_s"], jp[kind]["pred_s"])
                assert tp[kind]["modeled_as"] == jp[kind]["modeled_as"]


def test_refit_and_drift_report_match_jax():
    base_j = J.fit_cost_model(J.simulate_link_measurements(
        2e-3, 1e-9, link_class="dcn", ops=("psum",)), meta={"s": 1})
    base_t = T.CostModel.from_json(base_j.to_json())
    short = J.simulate_link_measurements(
        2e-3, 1e-9, link_class="dcn", ops=("psum",), sizes=(4096,),
        group_sizes=(2,))
    # too few points: declined, buffer kept
    assert base_j.update(short) == base_t.update(_as(T, short)) == 1
    rj, rt = base_j.refit(8), base_t.refit(8)
    assert rj["refitted"] is rt["refitted"] is False
    assert rt["reason"] == rj["reason"]
    drifted = J.simulate_link_measurements(
        32e-3, 16e-9, link_class="dcn", ops=("psum",), rel_noise=0.05)
    base_j.update(drifted)
    base_t.update(_as(T, drifted))
    rj, rt = base_j.refit(8, now=1000.0), base_t.refit(8, now=1000.0)
    assert rt["refitted"] and rt["n"] == rj["n"]
    _same_curves(rj["model"], rt["model"])
    assert rt["model"].meta == rj["model"].meta
    assert sorted(rt["drift"]["curves"]) == sorted(rj["drift"]["curves"])
    for k, v in rj["drift"]["curves"].items():
        _close(rt["drift"]["curves"][k], v)
    _close(rt["drift"]["max_drift"], rj["drift"]["max_drift"])
    assert rt["drift"]["n_shared"] == rj["drift"]["n_shared"]
    assert base_t.fresh_measurements == ()
    # staleness stamps
    assert rt["model"].profile_age(now=1010.0) \
        == rj["model"].profile_age(now=1010.0) == 10.0
    assert rt["model"].is_stale(5.0, now=1010.0)
    assert not rt["model"].is_stale(50.0, now=1010.0)
    assert T.CostModel({}).is_stale(1e9)


def test_profile_json_crosses_packages(tmp_path):
    jms = _measurements(J)
    jm = J.fit_cost_model(jms, meta={"host": "a"})
    tm = T.fit_cost_model(_as(T, jms), meta={"host": "a"})
    jm.meta["probed_at"] = tm.meta["probed_at"] = 1234.5
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jm.save(jpath, measurements=jms)
    tm.save(tpath, measurements=_as(T, jms))
    # the same document, byte for byte
    assert open(jpath).read() == open(tpath).read()
    for path in (jpath, tpath):
        t_model, t_ms = T.load_profile(path)
        j_model, j_ms = J.load_profile(path)
        _same_curves(j_model, t_model)
        assert t_model.meta == j_model.meta
        assert [m.to_dict() for m in t_ms] == [m.to_dict() for m in j_ms]
    # version refusal and the unversioned warning, as in JAX
    doc = json.load(open(tpath))
    doc["version"] = T.PROFILE_VERSION + 1
    with pytest.raises(ValueError, match="version"):
        T.CostModel.from_json(doc)
    del doc["version"]
    with pytest.warns(UserWarning, match="no version"):
        T.CostModel.from_json(doc)


def test_channel_from_cost_model_matches_jax():
    ms = J.simulate_link_measurements(1e-3, 1e-8)
    jm = J.fit_cost_model(ms)
    tm = T.fit_cost_model(_as(T, ms))
    jc, tc = JChannel.from_cost_model(jm), LocalDcnChannel.from_cost_model(
        tm, max_retries=1)
    _close(tc.alpha_s, jc.alpha_s)
    _close(tc.beta_s_per_byte, jc.beta_s_per_byte)
    assert tc.max_retries == 1
    _close(tc.transfer_seconds(1 << 20), jc.transfer_seconds(1 << 20))


def test_probe_under_two_ranks_raises():
    with pytest.raises(RuntimeError, match="world size 1"):
        T.probe_collectives()


@pytest.mark.parametrize("world", [2, 4])
def test_probe_measures_every_cell_and_fits(probes, world):
    ranks = probes[world]
    groups = [k for k in (2, 4, 8) if world % k == 0 and k <= world]
    want = {(op, dt, k, T._payload_bytes(op, dt, _n_local(s, dt, k), k))
            for op in T.COLLECTIVE_OPS for dt in DTYPES for k in groups
            for s in SIZES}
    got = ranks[0]["measurements"]
    cells = set()
    for m in got:
        cells.add((m["op"], m["dtype"], m["group_size"], m["nbytes"]))
        assert math.isfinite(m["time_s"]) and m["time_s"] > 0
        assert m["link_class"] == "ici"
    assert cells == want and len(got) == len(want)
    # every rank returns the same list and the same fit
    for r in ranks[1:]:
        assert r["measurements"] == got
        assert r["profile"]["fits"] == ranks[0]["profile"]["fits"]
    model = T.CostModel.from_json(ranks[0]["profile"])
    assert sorted(model.curves()) == sorted(
        (op, dt, "ici") for op in T.COLLECTIVE_OPS for dt in DTYPES)
    for fit in model.curves().values():
        assert fit.alpha_s >= 0 and fit.beta_s_per_byte >= 0
        assert fit.n_points == len(groups) * len(SIZES)
    # the measured points load in JAX's package and fit the same
    jm = J.fit_cost_model([J.Measurement.from_dict(m) for m in got])
    _same_curves(jm, model)
