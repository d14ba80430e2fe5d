"""Host-driven MPMD pipeline schedules and their event-driven simulator —
port of ``apex_tpu/mpmd/schedule.py`` (pure Python, the same orders, the
same messages, the same ``simulate`` dicts).

The ring engine (:mod:`apex_tpu_torch.transformer.pipeline_parallel.ring`)
runs the whole 1F1B schedule as uniform ticks — every stage advances in
lockstep, which is exactly right when the stage-to-stage hop is a fast
point-to-point exchange.  Across pods the hop is a DCN transfer that is
orders of magnitude slower than a tick, and a lockstep schedule would
expose every hop on the critical path.  The MPMD engine
(:class:`~apex_tpu_torch.mpmd.engine.MpmdPipeline`) therefore runs each
stage as its own program and the *host* issues jobs in an explicit total
order; this module owns that order.

Two schedules:

* :func:`schedule_1f1b` — the classic schedule (stage ``s`` warms up
  with ``min(S-1-s, M)`` forwards, then alternates 1 forward / 1
  backward, then drains).  With *blocking* sends (the sender stalls
  while the hop is in flight) every cross-pod edge sits on the critical
  path.
* :func:`schedule_dcn_hiding` — the same alternation with
  ``extra_inflight`` additional warmup forwards per stage, run with
  *asynchronous* sends.  The extra in-flight microbatches buffer the
  slow hop: a stage keeps computing while the DCN transfer drains,
  which is the near-zero-bubble regime (arXiv 2412.14374's
  pre-shifted-buffer observation, executed host-side).

:func:`simulate` prices a schedule against per-stage compute times and
per-edge link times and returns makespan / bubble fraction / exposed
vs. hidden link seconds per link class, plus the predicted timeline that
:mod:`apex_tpu_torch.observability.anatomy` diffs a measured step
against.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "Op", "stage_ops_1f1b", "merge_stage_ops", "schedule_1f1b",
    "schedule_dcn_hiding", "validate_order", "edge_link_classes",
    "simulate", "SCHEDULES",
]


class Op(NamedTuple):
    """One unit of stage work: run microbatch ``mb`` through stage
    ``stage``'s forward (``kind == "fwd"``) or backward
    (``kind == "bwd"``) program."""
    stage: int
    kind: str
    mb: int


def stage_ops_1f1b(n_stages: int, n_microbatches: int, *,
                   extra_inflight: int = 0) -> List[List[Op]]:
    """Per-stage op lists: warmup ``min(S-1-s+extra_inflight, M)``
    forwards, then alternate 1 forward / 1 backward, then drain
    backwards.  ``extra_inflight == 0`` is classic 1F1B."""
    S, M = int(n_stages), int(n_microbatches)
    if S < 1 or M < 1:
        raise ValueError(f"need n_stages >= 1 and n_microbatches >= 1, "
                         f"got S={n_stages}, M={n_microbatches}")
    if extra_inflight < 0:
        raise ValueError(f"extra_inflight must be >= 0, "
                         f"got {extra_inflight}")
    per_stage: List[List[Op]] = []
    for s in range(S):
        w = min(S - 1 - s + extra_inflight, M)
        ops = [Op(s, "fwd", m) for m in range(w)]
        for k in range(M - w):
            ops.append(Op(s, "fwd", w + k))
            ops.append(Op(s, "bwd", k))
        ops.extend(Op(s, "bwd", k) for k in range(M - w, M))
        per_stage.append(ops)
    return per_stage


def merge_stage_ops(per_stage: Sequence[Sequence[Op]]) -> List[Op]:
    """Merge per-stage op lists into one dependency-valid total order.

    Greedy: repeatedly scan stages from the LAST to the first and take
    the head op whose dependencies (``fwd`` needs the upstream ``fwd``,
    ``bwd`` needs the downstream ``bwd`` and the local ``fwd``) are
    already in the order.  Scanning deep-first drains cotangents as
    early as they exist, which is what 1F1B wants.  Raises if no
    progress can be made (an invalid per-stage interleaving)."""
    S = len(per_stage)
    heads = [0] * S
    done = set()
    order: List[Op] = []

    def ready(op: Op) -> bool:
        s, kind, m = op
        if kind == "fwd":
            return s == 0 or (s - 1, "fwd", m) in done
        return ((s, "fwd", m) in done
                and (s == S - 1 or (s + 1, "bwd", m) in done))

    total = sum(len(ops) for ops in per_stage)
    while len(order) < total:
        progressed = False
        for s in reversed(range(S)):
            if heads[s] < len(per_stage[s]):
                op = per_stage[s][heads[s]]
                if ready(op):
                    order.append(op)
                    done.add(tuple(op))
                    heads[s] += 1
                    progressed = True
        if not progressed:
            stuck = [per_stage[s][heads[s]] for s in range(S)
                     if heads[s] < len(per_stage[s])]
            raise ValueError(
                f"per-stage op lists deadlock; next-up ops with "
                f"unsatisfied dependencies: {stuck}")
    return order


def schedule_1f1b(n_stages: int, n_microbatches: int) -> List[Op]:
    """Classic 1F1B as one host-executable total order."""
    return merge_stage_ops(stage_ops_1f1b(n_stages, n_microbatches))


def schedule_dcn_hiding(n_stages: int, n_microbatches: int, *,
                        extra_inflight: int = 1) -> List[Op]:
    """1F1B with ``extra_inflight`` extra warmup forwards per stage —
    run with asynchronous sends, the extra in-flight microbatches keep
    every stage busy while a DCN hop drains.  ``extra_inflight`` is
    the depth knob, sized to ``ceil(link_seconds / stage_seconds)``."""
    return merge_stage_ops(stage_ops_1f1b(
        n_stages, n_microbatches, extra_inflight=extra_inflight))


SCHEDULES = {"1f1b": schedule_1f1b, "dcn_hiding": schedule_dcn_hiding}


def validate_order(order: Sequence[Op], n_stages: int,
                   n_microbatches: int) -> None:
    """Check a total order is executable: every (stage, microbatch)
    runs exactly one fwd and one bwd, and every op's dependencies
    precede it.  Raises ``ValueError`` with the offending op."""
    S, M = int(n_stages), int(n_microbatches)
    done = set()
    for op in order:
        s, kind, m = op
        if not (0 <= s < S and 0 <= m < M and kind in ("fwd", "bwd")):
            raise ValueError(f"op {op} out of range for S={S}, M={M}")
        if tuple(op) in done:
            raise ValueError(f"op {op} issued twice")
        if kind == "fwd" and s > 0 and (s - 1, "fwd", m) not in done:
            raise ValueError(f"{op} before upstream fwd")
        if kind == "bwd":
            if (s, "fwd", m) not in done:
                raise ValueError(f"{op} before its own fwd")
            if s < S - 1 and (s + 1, "bwd", m) not in done:
                raise ValueError(f"{op} before downstream bwd")
        done.add(tuple(op))
    if len(done) != 2 * S * M:
        raise ValueError(
            f"order has {len(done)} ops, want {2 * S * M} "
            f"(one fwd + one bwd per stage per microbatch)")


def edge_link_classes(n_stages: int, n_pods: int) -> Dict[int, str]:
    """Link class of each stage boundary: edge ``e`` joins stage ``e``
    to ``e+1`` and is ``"dcn"`` exactly when it crosses a pod boundary
    (stages are split into ``n_pods`` contiguous blocks)."""
    S, p = int(n_stages), max(int(n_pods), 1)
    if S % p:
        raise ValueError(f"n_pods ({p}) must divide n_stages ({S})")
    per_pod = S // p
    return {e: ("dcn" if (e + 1) % per_pod == 0 else "ici")
            for e in range(S - 1)}


def simulate(order: Sequence[Op], n_stages: int, n_microbatches: int, *,
             t_fwd: float, t_bwd: float,
             link_seconds: Optional[Dict[int, float]] = None,
             link_classes: Optional[Dict[int, str]] = None,
             blocking_sends: bool = True) -> Dict[str, object]:
    """Event-driven price of a schedule.

    Each stage is a serial executor; op start = max(stage free,
    message arrival).  ``link_seconds[e]`` is the one-way transfer time
    over edge ``e`` (both directions); ``blocking_sends=True`` stalls
    the SENDER for the transfer too — the SPMD/ppermute model where
    the hop sits inside the program — while ``False`` is the MPMD
    async-send model (the host hands the payload to the channel and
    the stage keeps computing).

    Returns ``makespan``, ``busy`` (per-stage busy seconds — the
    per-stage granularity the anatomy differ aligns measured stages
    against), ``bubble_fraction`` (1 − mean busy / makespan),
    per-link-class totals ``link_time`` and ``exposed`` (seconds a
    stage actually waited on a hop beyond its own readiness),
    ``hidden_fraction`` per class, plus the full predicted timeline:
    ``op_times`` (one ``{stage, kind, mb, start, end}`` row per op, in
    issue order) and ``xfers`` (one ``{src, dst, kind, mb, link_class,
    start, end}`` row per stage-boundary transfer) — the records
    :mod:`apex_tpu_torch.observability.anatomy` reconstructs and diffs a
    measured run against."""
    S, M = int(n_stages), int(n_microbatches)
    validate_order(order, S, M)
    link_seconds = dict(link_seconds or {})
    link_classes = dict(link_classes if link_classes is not None
                        else edge_link_classes(S, 1))
    free = [0.0] * S
    busy = [0.0] * S
    out_t: Dict[Tuple[int, str, int], float] = {}
    link_time = {"ici": 0.0, "dcn": 0.0}
    exposed = {"ici": 0.0, "dcn": 0.0}
    op_times: List[Dict[str, object]] = []
    xfers: List[Dict[str, object]] = []

    for op in order:
        s, kind, m = op
        dur = float(t_fwd if kind == "fwd" else t_bwd)
        # the incoming message, if any: fwd from s-1, bwd from s+1
        src = s - 1 if kind == "fwd" else s + 1
        edge = min(s, src)
        if 0 <= src < S:
            link = float(link_seconds.get(edge, 0.0))
            lc = link_classes.get(edge, "ici")
            produced = out_t[(src, kind, m)]
            arrival = produced + link
            link_time[lc] += link
            start = max(free[s], arrival)
            exposed[lc] += max(0.0, arrival - max(free[s], produced))
            xfers.append({"src": src, "dst": s, "kind": kind, "mb": m,
                          "link_class": lc, "start": produced,
                          "end": arrival})
        else:
            start = free[s]
        end = start + dur
        busy[s] += dur
        out_t[(s, kind, m)] = end
        op_times.append({"stage": s, "kind": kind, "mb": m,
                         "start": start, "end": end})
        sends = (kind == "fwd" and s < S - 1) or (kind == "bwd" and s > 0)
        if sends and blocking_sends:
            dst_edge = s if kind == "fwd" else s - 1
            free[s] = end + float(link_seconds.get(dst_edge, 0.0))
        else:
            free[s] = end

    makespan = max(out_t.values())
    hidden = {lc: (1.0 - exposed[lc] / link_time[lc]
                   if link_time[lc] > 0 else 1.0)
              for lc in link_time}
    return {
        "makespan": makespan,
        "busy": list(busy),
        "bubble_fraction": 1.0 - (sum(busy) / S) / makespan,
        "link_time": link_time,
        "exposed": exposed,
        "hidden_fraction": hidden,
        "op_times": op_times,
        "xfers": xfers,
    }
