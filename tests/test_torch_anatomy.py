"""apex_tpu_torch.observability.anatomy against apex_tpu's, on the CPU.

* The same events through JAX's and the port's ``reconstruct`` /
  ``attribute`` / ``diff_timelines`` / ``attribution_counter_events`` and
  the renderers give equal results: events from ``synthesize_events`` of a
  ``simulate`` (both schedules, a slow DCN world, a reordered timeline,
  the engine's folded last stage) and from JAX's ``MpmdPipeline`` at
  ``measure_ops=True``.
* The port engine's own events at ``measure_ops=True`` reconstruct (one op
  event a job, the last stage's folded) and their attribution sums to each
  stage's makespan within 1e-9 relative.
* ``ParallelismAutopilot.observe_anatomy`` takes the port's
  ``diff_timelines`` dict as JAX's takes JAX's.
* ``tools/step_anatomy_torch.py``'s JSON, text table and merged trace equal
  ``tools/step_anatomy.py``'s on the same trace.
"""

import dataclasses
import importlib
import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTConfig as JConfig, GPTModel as JModel
from apex_tpu.mpmd import MpmdPipeline as JPipeline
from apex_tpu.observability import anatomy as janat
from apex_tpu.observability import costmodel as JC
from apex_tpu.parallel.plan import ParallelPlan as JPlan
from apex_tpu.resilience import (ParallelismAutopilot as JAutopilot,
                                 TopologySpec as JSpec)

from apex_tpu_torch.convert import gpt_params_from_jax
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.mpmd import MpmdPipeline
from apex_tpu_torch.mpmd.schedule import SCHEDULES, edge_link_classes, simulate
from apex_tpu_torch.observability import anatomy as tanat
from apex_tpu_torch.observability import costmodel as TC
from apex_tpu_torch.parallel.plan import ParallelPlan
from apex_tpu_torch.resilience import ParallelismAutopilot, TopologySpec

_TOOLS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
S, M = 4, 8
KW = dict(vocab_size=32, hidden_size=16, num_layers=4,
          num_attention_heads=4, max_seq_len=16)


def _import_tool(name):
    sys.path.insert(0, _TOOLS)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def make_sim(*, t_fwd=1.0, t_bwd=2.0, ici=0.05, dcn=1.5, schedule="1f1b",
             s=S, m=M, pods=2):
    classes = edge_link_classes(s, pods)
    link = {e: (dcn if lc == "dcn" else ici) for e, lc in classes.items()}
    return simulate(SCHEDULES[schedule](s, m), s, m, t_fwd=t_fwd,
                    t_bwd=t_bwd, link_seconds=link, link_classes=classes,
                    blocking_sends=False)


def _plain(tl):
    """A timeline's fields (the two packages' classes differ by name)."""
    d = dataclasses.asdict(tl)
    d["order"] = [tuple(op) for op in tl.order()]
    d["props"] = (tl.t0, tl.t_end, tl.makespan, tl.busy)
    return d


def _both(events, predicted=None, fold=False):
    """Every function of the two modules on the same events; returns the
    pairs (port, JAX)."""
    out = {}
    tl = (tanat.reconstruct(events), janat.reconstruct(events))
    out["timeline"] = tuple(_plain(t) for t in tl)
    attr = (tanat.attribute(tl[0]), janat.attribute(tl[1]))
    out["attribute"] = attr
    out["counters"] = (tanat.attribution_counter_events(attr[0]),
                       janat.attribution_counter_events(attr[1]))
    out["table"] = (tanat.render_attribution_table(attr[0]),
                    janat.render_attribution_table(attr[1]))
    if predicted is not None:
        diff = (tanat.diff_timelines(tl[0], predicted, fold_last_fwd=fold),
                janat.diff_timelines(tl[1], predicted, fold_last_fwd=fold))
        out["diff"] = diff
        out["render_diff"] = (tanat.render_diff(diff[0]),
                              janat.render_diff(diff[1]))
    return out


def _reordered(sim):
    tl = tanat.reconstruct(tanat.synthesize_events(sim, n_stages=S,
                                                   n_microbatches=M))
    ops = [dict(o) for o in tl.ops]
    a, b = [i for i, o in enumerate(ops) if o["stage"] == 1][:2]
    for k in ("kind", "mb"):
        ops[a][k], ops[b][k] = ops[b][k], ops[a][k]
    return [e for e in tanat.synthesize_events(
        sim, n_stages=S, n_microbatches=M) if e["name"] != "mpmd_op"] + [
        {"name": "mpmd_op", "ph": "X", "cat": "host", "ts": o["start"] * 1e6,
         "dur": (o["end"] - o["start"]) * 1e6, "pid": 0,
         "tid": o["stage"], "args": {"op": o["kind"], "stage": o["stage"],
                                     "mb": o["mb"], "step": 0}}
        for o in ops]


def _folded(sim, s, m):
    """The engine's execution model: the last stage's fwd folded into its
    bwd (one joint op spanning both)."""
    evs = tanat.synthesize_events(sim, n_stages=s, n_microbatches=m)
    fwd_start = {e["args"]["mb"]: e["ts"] for e in evs
                 if e["name"] == "mpmd_op" and e["args"]["stage"] == s - 1
                 and e["args"]["op"] == "fwd"}
    out = []
    for e in evs:
        a = e.get("args", {})
        if e["name"] == "mpmd_op" and a["stage"] == s - 1:
            if a["op"] == "fwd":
                continue
            e = dict(e, ts=fwd_start[a["mb"]],
                     dur=e["ts"] + e["dur"] - fwd_start[a["mb"]],
                     args=dict(a, folded_fwd=True))
        out.append(e)
    return out


CASES = {
    "1f1b": lambda: (tanat.synthesize_events(make_sim(), n_stages=S,
                                             n_microbatches=M),
                     make_sim(), False),
    "dcn_hiding": lambda: (tanat.synthesize_events(
        make_sim(schedule="dcn_hiding"), n_stages=S, n_microbatches=M),
        make_sim(schedule="dcn_hiding"), False),
    "slow_dcn": lambda: (tanat.synthesize_events(
        make_sim(dcn=6.0), n_stages=S, n_microbatches=M), make_sim(), False),
    "uniform_slowdown": lambda: (tanat.synthesize_events(
        make_sim(t_fwd=2.0, t_bwd=4.0, ici=0.1, dcn=3.0), n_stages=S,
        n_microbatches=M), make_sim(), False),
    "reordered": lambda: (_reordered(make_sim()), make_sim(), False),
    "folded": lambda: (_folded(make_sim(s=2, m=3), 2, 3),
                       make_sim(s=2, m=3), True),
    "two_steps": lambda: (
        tanat.synthesize_events(make_sim(), n_stages=S, n_microbatches=M,
                                step=3)
        + tanat.synthesize_events(make_sim(dcn=3.0), n_stages=S,
                                  n_microbatches=M, step=7, t0=100.0),
        make_sim(), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_anatomy_equals_jax_on_synthesized_events(case):
    events, predicted, fold = CASES[case]()
    for key, (got, want) in _both(events, predicted, fold).items():
        assert got == want, key


def test_synthesize_and_errors_equal_jax():
    sim = make_sim()
    for kw in ({}, {"schedule": "dcn_hiding", "step": 2, "t0": 5.0,
                    "pid": 3}):
        assert (tanat.synthesize_events(sim, n_stages=S, n_microbatches=M,
                                        **kw)
                == janat.synthesize_events(sim, n_stages=S,
                                           n_microbatches=M, **kw))
    evs = tanat.synthesize_events(sim, n_stages=S, n_microbatches=M)
    dup = [e for e in evs if e["name"] == "mpmd_op"][0]
    for bad, kw in ([{"name": "x", "ph": "X"}], {}), (evs + [dup], {}), \
            (evs, {"step": 5}):
        msgs = []
        for mod in (tanat, janat):
            with pytest.raises(ValueError) as e:
                mod.reconstruct(bad, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for form in ({"traceEvents": evs}, json.dumps(evs)):
        assert _plain(tanat.reconstruct(form)) == _plain(
            janat.reconstruct(form))
    assert tanat.CATEGORIES == janat.CATEGORIES


@pytest.fixture(scope="module")
def engine_events():
    """Measured events of one step of each engine at (dp 1, pp 2, 2 pods),
    M = 2, measure_ops=True, on the same weights and tokens."""
    params = JModel(JConfig(**KW)).init_params(jax.random.PRNGKey(3))
    sd = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             GPTConfig(**KW))
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, KW["vocab_size"], (4, 16))
    targets = rng.randint(0, KW["vocab_size"], (4, 16))
    jeng = JPipeline(KW, params, JPlan(pp=2, n_microbatches=2, n_pods=2),
                     devices=jax.devices()[:2], measure_ops=True)
    jeng.loss_and_grads(tokens, targets, step=0)
    eng = MpmdPipeline(KW, sd, ParallelPlan(pp=2, n_microbatches=2,
                                            n_pods=2, dp=1),
                       device="cpu", measure_ops=True)
    eng.loss_and_grads(torch.from_numpy(tokens), torch.from_numpy(targets),
                       step=0)
    return dict(jax=jeng.anatomy_events(), port=eng.anatomy_events())


def test_anatomy_equals_jax_on_jax_engine_events(engine_events):
    events = engine_events["jax"]
    step_anatomy = _import_tool("step_anatomy")
    tl = janat.reconstruct(events)
    predicted = step_anatomy.predicted_from_measured(tl)
    for key, (got, want) in _both(events, predicted, True).items():
        assert got == want, key


def test_port_engine_events_reconstruct_and_sum(engine_events):
    events = engine_events["port"]
    tl = tanat.reconstruct(events)
    assert (tl.n_stages, tl.n_microbatches, tl.schedule) == (2, 2, "1f1b")
    assert tl.meta["measured"] is True
    # the last stage folds its forward: 2SM - M ops
    assert len(tl.ops) == 2 * 2 * 2 - 2
    assert all(o["folded_fwd"] for o in tl.ops if o["stage"] == 1)
    assert {(x["src"], x["dst"], x["kind"]) for x in tl.xfers} == {
        (0, 1, "fwd"), (1, 0, "bwd"), (1, 0, "head_grad"),
        (0, 1, "embed_total")}
    assert all(x["link_class"] == "dcn" for x in tl.xfers)
    attr = tanat.attribute(tl)
    for st in attr["per_stage"]:
        assert abs(st["total"] - attr["makespan"]) <= \
            1e-9 * attr["makespan"]
    assert attr["totals"]["compute"] > 0
    step_anatomy = _import_tool("step_anatomy_torch")
    diff = tanat.diff_timelines(tl, step_anatomy.predicted_from_measured(tl),
                                fold_last_fwd=True)
    assert diff["matched"] == diff["n_ops"] == len(tl.ops)
    assert not diff["missing"] and not diff["extra"]
    # the JAX engine's events have the same structure
    jtl = janat.reconstruct(engine_events["jax"])
    assert [tuple(op) for op in jtl.order()] == [tuple(op)
                                                 for op in tl.order()]
    assert sorted((x["src"], x["dst"], x["kind"], x["mb"])
                  for x in jtl.xfers) == sorted(
        (x["src"], x["dst"], x["kind"], x["mb"]) for x in tl.xfers)


def _autopilot(pkg):
    spec = pkg.Spec(dp=2)
    trainer = SimpleNamespace(
        plan=SimpleNamespace(spec=spec), stats={"last_checkpoint_s": 1e-3,
                                                "last_reshard_s": 2e-3},
        current_step=0, replans=[], params={}, **{pkg.pool: list(range(4))})
    profile = pkg.C.fit_cost_model(
        pkg.C.simulate_link_measurements(2e-3, 1e-9, link_class="dcn",
                                         ops=("psum",)),
        meta={"source": "test"})
    return pkg.Autopilot(trainer, profile, min_dp=2, link_class="dcn",
                         ranker=lambda prof: [{"spec": spec,
                                               "predicted_s": 0.1}],
                         cooldown_s=0.0, structural_threshold=0.3)


def test_observe_anatomy_takes_the_ports_diff():
    sim = make_sim()
    events = tanat.synthesize_events(make_sim(dcn=12.0), n_stages=S,
                                     n_microbatches=M)
    diffs = (tanat.diff_timelines(tanat.reconstruct(events), sim),
             janat.diff_timelines(janat.reconstruct(events), sim))
    assert diffs[0] == diffs[1] and diffs[0]["drift_score"] >= 0.3
    logs = []
    for pkg, diff in (
            (SimpleNamespace(C=TC, Autopilot=ParallelismAutopilot,
                             Spec=TopologySpec, pool="_ranks"), diffs[0]),
            (SimpleNamespace(C=JC, Autopilot=JAutopilot, Spec=JSpec,
                             pool="_devices"), diffs[1])):
        ap = _autopilot(pkg)
        ap.record_step(0.1)
        confirmed = [ap.observe_anatomy(diff) for _ in range(4)]
        ap.tick()
        entry = ap.adoption_log[0]
        logs.append((confirmed, ap.stats["structural_confirmed"],
                     ap.stats["last_structural"], entry["source"],
                     entry["outcome"], entry["drift"], entry["detail"],
                     ap.audit()))
    assert logs[0] == logs[1]
    assert logs[0][0] == [False, True, False, True]
    assert logs[0][3:5] == ("anatomy", "no_change")


def _cli(tool, argv, capsys):
    rc = _import_tool(tool).main(argv)
    assert rc == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("source", ["synthesized", "jax_engine",
                                    "port_engine"])
def test_cli_equals_jax(source, engine_events, tmp_path, capsys):
    if source == "synthesized":
        events = tanat.synthesize_events(make_sim(), n_stages=S,
                                         n_microbatches=M)
    else:
        events = engine_events[source.split("_")[0]]
    trace = tmp_path / "step.trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    outs = {}
    for tool in ("step_anatomy_torch", "step_anatomy"):
        out = tmp_path / f"{tool}.merged.json"
        js = json.loads(_cli(tool, ["--trace", str(trace),
                                    "--diff-simulated", "--json"], capsys))
        text = _cli(tool, ["--trace", str(trace), "--diff-simulated",
                           "--out", str(out)], capsys)
        outs[tool] = (js, text, json.loads(out.read_text()))
    assert outs["step_anatomy_torch"] == outs["step_anatomy"]
    js = outs["step_anatomy_torch"][0]
    assert set(js) == {"schedule", "attribution", "diff", "predicted"}
    assert js["diff"]["matched"] == js["schedule"]["n_ops"]
    plan = tmp_path / "MPMD_PLAN.json"
    plan.write_text(json.dumps({"n_stages": 99, "plan": {}}))
    with pytest.raises(SystemExit, match="wrong trace/plan pair"):
        _import_tool("step_anatomy_torch").main(
            ["--trace", str(trace), "--plan", str(plan)])
