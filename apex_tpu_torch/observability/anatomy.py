"""Step anatomy — measured critical-path attribution for MPMD steps; port
of ``apex_tpu/observability/anatomy.py`` (pure Python: the same
reconstruction, attribution, differ and renderers).

:func:`~apex_tpu_torch.mpmd.schedule.simulate` *predicts* where a pipeline
step's time goes; this module measures it.  Three layers, one data
model (the same ``Op(stage, kind, mb)`` vocabulary as
:func:`~apex_tpu_torch.mpmd.schedule.stage_ops_1f1b`):

* :func:`reconstruct` ingests Chrome trace events — the structured
  ``mpmd_op`` / ``mpmd_xfer`` spans
  :class:`~apex_tpu_torch.mpmd.engine.MpmdPipeline` emits under
  ``trace=True`` (or :func:`synthesize_events` fabricates from a
  simulation) — and rebuilds the measured per-stage, per-op schedule
  as a :class:`MeasuredTimeline`.

* :func:`attribute` partitions every second of every stage's
  ``[t0, t_end]`` window into exactly one of five categories::

      compute      the stage was running an op
      exposed_ici  waiting on an ICI hop whose payload existed
      exposed_dcn  waiting on a DCN hop whose payload existed
      bubble       waiting on upstream/downstream COMPUTE (the
                   schedule's pipeline bubble; includes tail drain)
      host_gap     none of the above — host dispatch, data stalls,
                   anything the op/xfer records can't explain

  The partition is a single cursor walk over boundary timestamps, so
  per-stage category sums telescope to the makespan exactly (float
  association error only — well under 1e-9 relative).

* :func:`diff_timelines` aligns the measured timeline against
  ``simulate()``'s predicted one: per-op latency ratios (normalized
  by their median, so a uniformly slow machine is NOT structural
  drift — that is the cost model's job), mis-ordered ops, ops the
  model didn't see, and bubbles the model didn't predict, folded into
  one ``drift_score`` that
  :meth:`~apex_tpu_torch.resilience.autopilot.ParallelismAutopilot.observe_anatomy`
  consumes as an attribution-rich drift signal.

``tools/step_anatomy_torch.py`` is the CLI.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from apex_tpu_torch.mpmd.schedule import Op

__all__ = [
    "OP_EVENT", "XFER_EVENT", "SCHEDULE_EVENT", "CATEGORIES",
    "MeasuredTimeline", "reconstruct", "attribute", "diff_timelines",
    "synthesize_events", "attribution_counter_events",
    "render_attribution_table", "render_diff",
]

# event names the engine emits and the reconstructor filters on; the
# shared vocabulary is the contract between mpmd.engine and this module
OP_EVENT = "mpmd_op"
XFER_EVENT = "mpmd_xfer"
SCHEDULE_EVENT = "mpmd_schedule"

CATEGORIES = ("compute", "exposed_ici", "exposed_dcn", "bubble",
              "host_gap")


def _op_key(stage: int, kind: str, mb: int) -> str:
    return f"s{stage}.{kind}.m{mb}"


# --------------------------------------------------------------------------
# reconstruction: trace events -> measured timeline
# --------------------------------------------------------------------------


@dataclass
class MeasuredTimeline:
    """The measured schedule of one step, rebuilt from trace events.

    ``ops`` rows are ``{stage, kind, mb, start, end, folded_fwd}``
    (seconds on the tracer clock, sorted by start); ``xfers`` rows are
    ``{src, dst, kind, mb, link_class, start, end}`` where ``kind`` is
    ``fwd``/``bwd`` for schedule edges (``mb >= 0``) and
    ``head_grad``/``embed_total`` for the tied-embedding sync
    (``mb == -1``)."""

    n_stages: int
    n_microbatches: int
    ops: List[Dict[str, object]]
    xfers: List[Dict[str, object]] = field(default_factory=list)
    schedule: Optional[str] = None
    step: Optional[int] = None
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def t0(self) -> float:
        return min(float(o["start"]) for o in self.ops)

    @property
    def t_end(self) -> float:
        ends = [float(o["end"]) for o in self.ops]
        ends.extend(float(x["end"]) for x in self.xfers)
        return max(ends)

    @property
    def makespan(self) -> float:
        return self.t_end - self.t0

    @property
    def busy(self) -> List[float]:
        b = [0.0] * self.n_stages
        for o in self.ops:
            b[int(o["stage"])] += float(o["end"]) - float(o["start"])
        return b

    def stage_ops(self, s: int) -> List[Dict[str, object]]:
        return [o for o in self.ops if int(o["stage"]) == s]

    def order(self) -> List[Op]:
        """The measured total order in the schedule's Op vocabulary."""
        return [Op(int(o["stage"]), str(o["kind"]), int(o["mb"]))
                for o in self.ops]


def _as_event_list(events) -> List[dict]:
    if isinstance(events, str):
        events = json.loads(events)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return [e for e in events if isinstance(e, dict)]


def reconstruct(events, *, step: Optional[int] = None
                ) -> MeasuredTimeline:
    """Rebuild the measured schedule of one step from trace events.

    ``events`` is a Chrome trace (the ``{"traceEvents": [...]}`` dict,
    a bare event list, or the JSON string of either) containing the
    engine's ``mpmd_op``/``mpmd_xfer`` spans; other events are
    ignored.  ``step`` selects which step to reconstruct when the
    trace holds several (default: the newest)."""
    evs = _as_event_list(events)
    op_evs = [e for e in evs
              if e.get("name") == OP_EVENT and e.get("ph") == "X"]
    if not op_evs:
        raise ValueError(
            f"no {OP_EVENT!r} events in trace — run the MPMD engine "
            "with trace=True (or synthesize_events) to get op records")
    steps = sorted({int(e.get("args", {}).get("step", 0))
                    for e in op_evs})
    if step is None:
        step = steps[-1]
    step = int(step)
    if step not in steps:
        raise ValueError(f"step {step} not in trace (has {steps})")

    ops: List[Dict[str, object]] = []
    seen: set = set()
    for e in op_evs:
        a = e.get("args", {})
        if int(a.get("step", 0)) != step:
            continue
        key = (int(a["stage"]), str(a["op"]), int(a["mb"]))
        if key in seen:
            raise ValueError(f"duplicate op event for {key} "
                             f"at step {step}")
        seen.add(key)
        start = float(e["ts"]) / 1e6
        ops.append({"stage": key[0], "kind": key[1], "mb": key[2],
                    "start": start,
                    "end": start + float(e.get("dur", 0.0)) / 1e6,
                    "folded_fwd": bool(a.get("folded_fwd", False))})
    ops.sort(key=lambda o: (o["start"], o["stage"]))

    xfers: List[Dict[str, object]] = []
    for e in evs:
        if e.get("name") != XFER_EVENT or e.get("ph") != "X":
            continue
        a = e.get("args", {})
        if int(a.get("step", 0)) != step:
            continue
        start = float(e["ts"]) / 1e6
        xfers.append({"src": int(a["src"]), "dst": int(a["dst"]),
                      "kind": str(a["kind"]), "mb": int(a.get("mb", -1)),
                      "link_class": str(a.get("link_class", "ici")),
                      "start": start,
                      "end": start + float(e.get("dur", 0.0)) / 1e6})
    xfers.sort(key=lambda x: x["start"])

    meta: Dict[str, object] = {}
    for e in evs:
        if e.get("name") == SCHEDULE_EVENT:
            a = dict(e.get("args", {}))
            if int(a.get("step", step)) == step or not meta:
                meta = a
    S = int(meta.get("n_stages",
                     1 + max(int(o["stage"]) for o in ops)))
    M = int(meta.get("n_microbatches",
                     1 + max(int(o["mb"]) for o in ops)))
    return MeasuredTimeline(
        n_stages=S, n_microbatches=M, ops=ops, xfers=xfers,
        schedule=meta.get("schedule"), step=step, meta=meta)


# --------------------------------------------------------------------------
# attribution: where did every second go?
# --------------------------------------------------------------------------


def _dependency(op: Dict[str, object], S: int, has_op: set
                ) -> Tuple[Optional[tuple], Optional[tuple]]:
    """The (producer op key, incoming xfer key) an op waits on.

    The xfer key is ``(dst, kind, mb)``; ``None`` means no transfer
    gates the op (first-stage fwd, or a last-stage bwd whose own fwd
    ran locally)."""
    s, kind, m = int(op["stage"]), str(op["kind"]), int(op["mb"])
    if kind == "fwd":
        if s == 0:
            return None, None
        return (s - 1, "fwd", m), (s, "fwd", m)
    if s < S - 1:
        return (s + 1, "bwd", m), (s, "bwd", m)
    # last-stage bwd: gated by its own fwd if one ran, else (the
    # engine's folded fwd+bwd) by the upstream activation arriving
    if (s, "fwd", m) in has_op and not op.get("folded_fwd"):
        return (s, "fwd", m), None
    if S >= 2:
        return (s - 1, "fwd", m), (s, "fwd", m)
    return None, None


def attribute(tl: MeasuredTimeline) -> Dict[str, object]:
    """Partition each stage's ``[t0, t_end]`` into the five
    :data:`CATEGORIES`.

    A gap before an op splits at the op's producer-end and
    transfer-end timestamps: waiting for the producer to finish is
    ``bubble``, waiting for the hop after the payload existed is
    ``exposed_<class>``, and the remainder up to the op start is
    ``host_gap``.  The tied-embedding sync transfers (``mb == -1``)
    claim their window on both endpoint stages as exposed link time;
    everything after a stage's last explained instant is ``bubble``
    (the drain).  Per-stage sums equal the makespan by construction
    (one monotone cursor from ``t0`` to ``t_end``)."""
    S = tl.n_stages
    t0, t_end = tl.t0, tl.t_end
    makespan = t_end - t0
    op_end = {(int(o["stage"]), str(o["kind"]), int(o["mb"])):
              float(o["end"]) for o in tl.ops}
    has_op = set(op_end)
    xfer_in = {(int(x["dst"]), str(x["kind"]), int(x["mb"])): x
               for x in tl.xfers if int(x["mb"]) >= 0}

    per_stage: List[Dict[str, object]] = []
    totals = {c: 0.0 for c in CATEGORIES}
    for s in range(S):
        acc = {c: 0.0 for c in CATEGORIES}
        segments: List[Dict[str, object]] = []
        cursor = t0

        def emit(t1: float, cat: str) -> None:
            nonlocal cursor
            t1 = min(max(float(t1), cursor), t_end)
            if t1 > cursor:
                acc[cat] += t1 - cursor
                segments.append({"t0": cursor, "t1": t1,
                                 "category": cat})
                cursor = t1

        for o in tl.stage_ops(s):
            start = float(o["start"])
            if start > cursor:
                dep, xin = _dependency(o, S, has_op)
                prod = op_end.get(dep) if dep is not None else None
                if prod is None:
                    emit(start, "host_gap")
                else:
                    emit(min(prod, start), "bubble")
                    x = xfer_in.get(xin) if xin is not None else None
                    if x is not None:
                        emit(min(float(x["end"]), start),
                             "exposed_" + str(x["link_class"]))
                    emit(start, "host_gap")
            emit(float(o["end"]), "compute")

        # tail: the tied-embedding sync hops this stage terminates
        # are exposed link time; the rest of the drain is bubble
        for x in tl.xfers:
            if int(x["mb"]) >= 0:
                continue
            if s not in (int(x["src"]), int(x["dst"])):
                continue
            emit(float(x["start"]), "bubble")
            emit(float(x["end"]), "exposed_" + str(x["link_class"]))
        emit(t_end, "bubble")

        row: Dict[str, object] = {"stage": s, **acc}
        row["total"] = sum(acc[c] for c in CATEGORIES)
        row["segments"] = segments
        per_stage.append(row)
        for c in CATEGORIES:
            totals[c] += acc[c]

    denom = S * makespan if makespan > 0 else 1.0
    return {
        "t0": t0, "t_end": t_end, "makespan": makespan,
        "n_stages": S,
        "per_stage": per_stage,
        "totals": totals,
        "fractions": {c: totals[c] / denom for c in CATEGORIES},
    }


# --------------------------------------------------------------------------
# differ: measured vs. predicted
# --------------------------------------------------------------------------


def _median(xs: Sequence[float]) -> float:
    ss = sorted(xs)
    n = len(ss)
    if n == 0:
        return 1.0
    mid = n // 2
    return ss[mid] if n % 2 else 0.5 * (ss[mid - 1] + ss[mid])


def diff_timelines(measured: MeasuredTimeline,
                   predicted: Dict[str, object], *,
                   fold_last_fwd: bool = False) -> Dict[str, object]:
    """Align a measured timeline against a ``simulate()`` result.

    ``predicted`` is the dict ``simulate()`` returns (``op_times`` /
    ``xfers`` / ``busy`` / ``makespan``).  ``fold_last_fwd=True``
    merges the predicted last stage's fwd into its bwd per
    microbatch — the engine's execution model, where the last stage
    runs one joint fwd+bwd program.

    Per-op ratios are measured/predicted durations; ``drift_score``
    is the max of (a) the worst median-normalized ratio deviation —
    a uniform slowdown is curve drift, the cost model's business, so
    it is divided out — (b) the worst per-stage idle fraction the
    model did NOT predict, and (c) the fraction of ops mis-ordered,
    missing, or unpredicted."""
    S = measured.n_stages
    pops: Dict[tuple, float] = {}
    p_order: List[tuple] = []
    for r in predicted["op_times"]:
        k = (int(r["stage"]), str(r["kind"]), int(r["mb"]))
        pops[k] = float(r["end"]) - float(r["start"])
        p_order.append(k)
    if fold_last_fwd:
        last = S - 1
        for m in range(measured.n_microbatches):
            fk, bk = (last, "fwd", m), (last, "bwd", m)
            if fk in pops and bk in pops:
                pops[bk] += pops.pop(fk)
        p_order = [k for k in p_order if k in pops]

    mops: Dict[tuple, float] = {}
    m_order: List[tuple] = []
    for o in measured.ops:
        k = (int(o["stage"]), str(o["kind"]), int(o["mb"]))
        mops[k] = float(o["end"]) - float(o["start"])
        m_order.append(k)

    matched = [k for k in p_order if k in mops]
    missing = [k for k in p_order if k not in mops]
    extra = [k for k in m_order if k not in pops]
    ratios: Dict[str, float] = {}
    for k in matched:
        p = pops[k]
        ratios[_op_key(*k)] = (mops[k] / p) if p > 0 else math.inf
    med = _median([r for r in ratios.values() if math.isfinite(r)])
    med = med if med > 0 else 1.0
    max_dev, worst = 0.0, None
    for key, r in ratios.items():
        dev = abs(r / med - 1.0) if math.isfinite(r) else math.inf
        if dev > max_dev:
            max_dev, worst = dev, key

    misordered: List[Dict[str, object]] = []
    for s in range(S):
        ms = [k for k in m_order if k[0] == s]
        ps = [k for k in p_order if k[0] == s]
        for i, (mk, pk) in enumerate(zip(ms, ps)):
            if mk != pk:
                misordered.append({"stage": s, "position": i,
                                   "measured": _op_key(*mk),
                                   "predicted": _op_key(*pk)})

    m_makespan = measured.makespan
    p_makespan = float(predicted["makespan"])
    p_busy = [float(b) for b in predicted["busy"]]
    if fold_last_fwd:
        # predicted busy already includes the folded fwd compute, and
        # so does the measured joint program's span — comparable as-is
        pass
    m_busy = measured.busy
    per_stage_idle: List[Dict[str, float]] = []
    unpred = 0.0
    for s in range(S):
        mi = 1.0 - (m_busy[s] / m_makespan if m_makespan > 0 else 0.0)
        pi = 1.0 - (p_busy[s] / p_makespan if p_makespan > 0 else 0.0)
        per_stage_idle.append({"stage": s, "measured": mi,
                               "predicted": pi})
        unpred = max(unpred, mi - pi)
    unpred = max(0.0, unpred)

    n = max(len(p_order), 1)
    structural = max(len(misordered), len(missing) + len(extra)) / n
    drift = max(max_dev, unpred, structural)
    return {
        "n_ops": len(p_order),
        "matched": len(matched),
        "missing": [_op_key(*k) for k in missing],
        "extra": [_op_key(*k) for k in extra],
        "ratios": ratios,
        "median_ratio": med,
        "max_ratio_deviation": max_dev,
        "worst_op": worst,
        "misordered": misordered,
        "per_stage_idle": per_stage_idle,
        "unpredicted_bubble_fraction": unpred,
        "makespan_ratio": (m_makespan / p_makespan
                           if p_makespan > 0 else math.inf),
        "drift_score": drift,
    }


# --------------------------------------------------------------------------
# synthesis: simulate() -> trace events (round-trips + deterministic CI)
# --------------------------------------------------------------------------


def synthesize_events(sim: Dict[str, object], *, n_stages: int,
                      n_microbatches: int, schedule: str = "1f1b",
                      step: int = 0, t0: float = 0.0,
                      pid: int = 0) -> List[dict]:
    """Fabricate the engine's ``mpmd_op``/``mpmd_xfer`` trace events
    from a ``simulate()`` result — what a run matching the model
    EXACTLY would have traced.  Feeds round-trip tests and the
    deterministic bench leg; ``reconstruct`` of the output rebuilds
    the simulated schedule."""
    events: List[dict] = [{
        "name": SCHEDULE_EVENT, "ph": "i", "cat": "host", "s": "t",
        "ts": t0 * 1e6, "pid": pid, "tid": 0,
        "args": {"n_stages": int(n_stages),
                 "n_microbatches": int(n_microbatches),
                 "schedule": schedule, "step": int(step),
                 "measured": False},
    }]
    for r in sim["op_times"]:
        events.append({
            "name": OP_EVENT, "ph": "X", "cat": "host",
            "ts": (t0 + float(r["start"])) * 1e6,
            "dur": (float(r["end"]) - float(r["start"])) * 1e6,
            "pid": pid, "tid": int(r["stage"]),
            "args": {"op": str(r["kind"]), "stage": int(r["stage"]),
                     "mb": int(r["mb"]), "step": int(step)},
        })
    for x in sim["xfers"]:
        events.append({
            "name": XFER_EVENT, "ph": "X", "cat": "host",
            "ts": (t0 + float(x["start"])) * 1e6,
            "dur": (float(x["end"]) - float(x["start"])) * 1e6,
            "pid": pid, "tid": int(x["src"]),
            "args": {"src": int(x["src"]), "dst": int(x["dst"]),
                     "kind": str(x["kind"]), "mb": int(x["mb"]),
                     "link_class": str(x["link_class"]),
                     "step": int(step)},
        })
    return events


# --------------------------------------------------------------------------
# rendering: Perfetto counter lanes + text tables
# --------------------------------------------------------------------------


def attribution_counter_events(attribution: Dict[str, object], *,
                               pid: int = 0) -> List[dict]:
    """Perfetto counter tracks (``ph: "C"``), one lane per stage:
    at each attribution segment boundary the active category's series
    steps to 1 and the others to 0 — merged next to the op spans the
    timeline shows WHY each gap exists."""
    events: List[dict] = []
    zero = {c: 0 for c in CATEGORIES}
    for st in attribution["per_stage"]:
        name = f"anatomy/stage{st['stage']}"
        for seg in st["segments"]:
            args = dict(zero)
            args[str(seg["category"])] = 1
            events.append({"name": name, "ph": "C", "cat": "anatomy",
                           "ts": float(seg["t0"]) * 1e6, "pid": pid,
                           "args": args})
        events.append({"name": name, "ph": "C", "cat": "anatomy",
                       "ts": float(attribution["t_end"]) * 1e6,
                       "pid": pid, "args": dict(zero)})
    return events


def render_attribution_table(attribution: Dict[str, object]) -> str:
    """The per-stage attribution as an aligned text table."""
    cols = ["stage"] + list(CATEGORIES) + ["total"]
    rows = [cols]
    for st in attribution["per_stage"]:
        rows.append([str(st["stage"])]
                    + [f"{float(st[c]):.6f}" for c in CATEGORIES]
                    + [f"{float(st['total']):.6f}"])
    tot = attribution["totals"]
    rows.append(["sum"] + [f"{float(tot[c]):.6f}" for c in CATEGORIES]
                + [f"{sum(float(tot[c]) for c in CATEGORIES):.6f}"])
    frac = attribution["fractions"]
    rows.append(["frac"] + [f"{float(frac[c]):.4f}" for c in CATEGORIES]
                + ["1.0000"])
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = ["  ".join(c.rjust(w) for c, w in zip(r, widths))
             for r in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    head = (f"makespan {attribution['makespan']:.6f}s over "
            f"{attribution['n_stages']} stages")
    return head + "\n" + "\n".join(lines)


def render_diff(diff: Dict[str, object], *, top: int = 5) -> str:
    """The differ's verdict as a short text report."""
    lines = [
        f"drift_score {diff['drift_score']:.4f}  "
        f"(median ratio {diff['median_ratio']:.3f}, "
        f"makespan ratio {diff['makespan_ratio']:.3f})",
        f"ops matched {diff['matched']}/{diff['n_ops']}"
        + (f"  missing {diff['missing']}" if diff["missing"] else "")
        + (f"  extra {diff['extra']}" if diff["extra"] else ""),
    ]
    med = diff["median_ratio"]
    devs = sorted(diff["ratios"].items(),
                  key=lambda kv: -abs(kv[1] / med - 1.0))
    for key, r in devs[:top]:
        lines.append(f"  {key}: x{r:.3f} "
                     f"({(r / med - 1.0) * 100.0:+.1f}% vs median)")
    if diff["misordered"]:
        lines.append(f"misordered ops: {len(diff['misordered'])} "
                     f"(first: {diff['misordered'][0]})")
    if diff["unpredicted_bubble_fraction"] > 0:
        lines.append("unpredicted bubble fraction "
                     f"{diff['unpredicted_bubble_fraction']:.4f}")
    return "\n".join(lines)
