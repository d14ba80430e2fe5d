#!/usr/bin/env python
"""Step anatomy CLI: where did every second of an MPMD step go?

The counterpart of ``tools/step_anatomy.py`` over ``apex_tpu_torch`` (the
same options, the same JSON schema).  Feeds a Chrome trace (the port's
``MpmdPipeline`` ``trace=True`` / ``measure_ops=True`` events, saved via
``Tracer.save`` or a ``FleetCollector`` merge) through
:mod:`apex_tpu_torch.observability.anatomy`:

* reconstruct the measured per-stage, per-op schedule;
* attribute each stage's window to compute / exposed-ici /
  exposed-dcn / pipeline-bubble / host-gap (sums to the makespan
  exactly);
* with ``--diff-simulated``, align it against ``simulate()``'s
  predicted schedule — per-op latency ratios, mis-ordered ops,
  unpredicted bubbles, one drift score.  The prediction's op costs
  default to the MEASURED medians (so the diff isolates structure
  from scale); override with ``--t-fwd``/``--t-bwd``/``--link-s``.

Usage:
    python tools/step_anatomy_torch.py --trace step.trace.json
    python tools/step_anatomy_torch.py --trace step.trace.json --json
    python tools/step_anatomy_torch.py --trace step.trace.json \\
        --plan ckpt_dir/MPMD_PLAN.json --diff-simulated \\
        --out annotated.trace.json

``--out`` writes the original events back out with per-stage
attribution counter lanes merged in — one Perfetto file showing the
ops AND why each gap exists.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _median(xs):
    ss = sorted(xs)
    n = len(ss)
    if n == 0:
        return 0.0
    mid = n // 2
    return ss[mid] if n % 2 else 0.5 * (ss[mid - 1] + ss[mid])


def load_trace(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        obj = json.load(f)
    if isinstance(obj, dict):
        return obj.get("traceEvents", [])
    if isinstance(obj, list):
        return obj
    raise ValueError(f"{path}: expected a trace-event list or a "
                     "{'traceEvents': [...]} object")


def predicted_from_measured(tl, *, schedule=None, t_fwd=None,
                            t_bwd=None, link_s=None):
    """A ``simulate()`` run of the plan's schedule priced from the
    measured timeline: per-kind median op durations, per-edge median
    transfer times (async sends — the MPMD execution model).  The
    resulting diff is pure STRUCTURE: a uniformly slow machine diffs
    clean, a schedule the model can't explain does not."""
    from apex_tpu_torch.mpmd.schedule import SCHEDULES, simulate

    name = schedule or tl.schedule or "1f1b"
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; "
                         f"one of {sorted(SCHEDULES)}")
    order = SCHEDULES[name](tl.n_stages, tl.n_microbatches)
    durs = {"fwd": [], "bwd": []}
    for o in tl.ops:
        durs[str(o["kind"])].append(float(o["end"]) - float(o["start"]))
    tf = float(t_fwd) if t_fwd is not None else (
        _median(durs["fwd"]) or _median(durs["bwd"]) or 1e-6)
    tb = float(t_bwd) if t_bwd is not None else (
        _median(durs["bwd"]) or tf)
    link_seconds, link_classes = {}, {}
    by_edge = {}
    for x in tl.xfers:
        if int(x["mb"]) < 0:
            continue
        e = min(int(x["src"]), int(x["dst"]))
        by_edge.setdefault(e, []).append(
            float(x["end"]) - float(x["start"]))
        link_classes[e] = str(x["link_class"])
    for e, ts in by_edge.items():
        link_seconds[e] = float(link_s) if link_s is not None \
            else _median(ts)
    sim = simulate(order, tl.n_stages, tl.n_microbatches,
                   t_fwd=tf, t_bwd=tb, link_seconds=link_seconds,
                   link_classes=link_classes or None,
                   blocking_sends=False)
    sim["priced_with"] = {"schedule": name, "t_fwd": tf, "t_bwd": tb,
                          "link_seconds": {str(k): v for k, v
                                           in link_seconds.items()}}
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", required=True,
                    help="Chrome trace JSON with mpmd_op/mpmd_xfer "
                         "events (MpmdPipeline trace=True)")
    ap.add_argument("--step", type=int, default=None,
                    help="step to reconstruct (default: newest in "
                         "the trace)")
    ap.add_argument("--plan", default=None,
                    help="MPMD_PLAN.json for stage-count cross-check "
                         "and the schedule name when the trace lacks "
                         "its mpmd_schedule marker")
    ap.add_argument("--diff-simulated", action="store_true",
                    help="also diff measured vs the simulated "
                         "schedule (priced from measured medians)")
    ap.add_argument("--t-fwd", type=float, default=None,
                    help="override predicted per-op fwd seconds")
    ap.add_argument("--t-bwd", type=float, default=None,
                    help="override predicted per-op bwd seconds")
    ap.add_argument("--link-s", type=float, default=None,
                    help="override predicted per-edge link seconds")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON (schema: "
                         "{schedule, attribution, diff})")
    ap.add_argument("--table", action="store_true",
                    help="emit text tables (the default)")
    ap.add_argument("--out", default=None,
                    help="write the input events + attribution "
                         "counter lanes as one merged Perfetto trace")
    args = ap.parse_args(argv)

    from apex_tpu_torch.observability.anatomy import (
        attribute, attribution_counter_events, diff_timelines,
        reconstruct, render_attribution_table, render_diff)

    events = load_trace(args.trace)
    tl = reconstruct(events, step=args.step)

    schedule = tl.schedule
    if args.plan:
        with open(args.plan, encoding="utf-8") as f:
            stamp = json.load(f)
        n_stages = int(stamp.get("n_stages", tl.n_stages))
        if n_stages != tl.n_stages:
            raise SystemExit(
                f"plan stamp says {n_stages} stages but the trace "
                f"reconstructs {tl.n_stages} — wrong trace/plan pair")
        schedule = schedule or stamp.get("plan", {}).get("schedule")

    attr = attribute(tl)
    diff = None
    sim = None
    if args.diff_simulated:
        sim = predicted_from_measured(
            tl, schedule=schedule, t_fwd=args.t_fwd, t_bwd=args.t_bwd,
            link_s=args.link_s)
        # the engine folds the last stage's fwd into its joint bwd
        # program exactly when no last-stage fwd op was traced
        folded = not any(int(o["stage"]) == tl.n_stages - 1
                         and str(o["kind"]) == "fwd" for o in tl.ops)
        diff = diff_timelines(tl, sim, fold_last_fwd=folded)

    if args.out:
        merged = list(events) + attribution_counter_events(attr)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": merged,
                       "displayTimeUnit": "ms"}, f)

    if args.json:
        report = {
            "schedule": {
                "name": schedule,
                "step": tl.step,
                "n_stages": tl.n_stages,
                "n_microbatches": tl.n_microbatches,
                "n_ops": len(tl.ops),
                "makespan_s": tl.makespan,
                "busy_s": tl.busy,
            },
            "attribution": {
                "makespan": attr["makespan"],
                "totals": attr["totals"],
                "fractions": attr["fractions"],
                "per_stage": [
                    {k: v for k, v in st.items() if k != "segments"}
                    for st in attr["per_stage"]],
            },
            "diff": diff,
        }
        if sim is not None:
            report["predicted"] = sim["priced_with"]
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print(f"step {tl.step}: {tl.n_stages} stages x "
              f"{tl.n_microbatches} microbatches "
              f"({len(tl.ops)} measured ops, "
              f"schedule {schedule or 'unknown'})")
        print(render_attribution_table(attr))
        if diff is not None:
            print()
            print(render_diff(diff))
    return 0


if __name__ == "__main__":
    sys.exit(main())
