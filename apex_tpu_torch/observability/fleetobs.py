"""Fleet-wide observability: causal traces, merged timelines, black box.

PR 12's fleet made a request's life MULTI-process in spirit (N replica
engines, one router, migration and hedging between them) while every
observability primitive stayed single-process: a request migrated off a
dead replica leaves two trace fragments with no shared identity, and
"fleet TTFT burn" does not exist anywhere.  This module is the missing
layer:

* :class:`TraceContext` — the causal identity a request carries across
  hops: trace id, parent span, current replica tag, hop counter.  The
  router mints it at submission, the engines' request tracers stamp
  flow events (Chrome ``ph: "s"/"t"/"f"``) against it at every
  lifecycle edge, and migration/hedging bump the hop — so a merged
  trace stitches one request's journey across replicas into a single
  Perfetto flow arrow chain.
* :func:`check_flows` — the measured version of "the trace looks
  connected": per trace id, verifies exactly one flow start, a
  terminal flow end, unbroken parent→span linkage, and (for migrated
  requests) spans from ≥ 2 replicas; also reports orphan request
  slices that no flow chain claims.
* :class:`FleetCollector` — merges N replicas' Chrome traces and JSONL
  metric streams onto one clock-aligned timeline (the N-stream
  generalization of ``tools/metrics_report.py --trace``'s two-stream
  offset rule), replays every replica's raw histogram observations
  into one fleet-level :class:`~apex_tpu_torch.observability.slo.SLOMonitor`
  for fleet burn, and derives ``fleet_*`` rollup series.
* :class:`FlightRecorder` — a bounded per-source ring of recent spans,
  metric deltas, applied faults, and scheduler decisions that dumps a
  correlated all-sources snapshot (±window around the trigger) when
  something detonates: replica death, degradation-ladder escalation,
  training guard rollback.

Everything here is host-side pure Python over the existing trace/
registry/SLO formats — no new dependencies, fully replayable on the
virtual clock.

Port of ``apex_tpu/observability/fleetobs.py``; it imports no JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.observability.registry import replay_jsonl
from apex_tpu_torch.observability.slo import SLOMonitor, SLOTarget
from apex_tpu_torch.observability.spans import Tracer

# registry histogram -> SLOMonitor metric name, for replaying merged
# JSONL observation events into a fleet-level monitor
SERVING_SLO_METRICS = {
    "serving_ttft_seconds": "ttft",
    "serving_token_latency_seconds": "token_latency",
    "serving_queue_wait_seconds": "queue_wait",
}

DEFAULT_FLEET_TARGETS = (
    SLOTarget("ttft", 0.5, objective=0.95),
    SLOTarget("token_latency", 0.1, objective=0.99),
)

# --------------------------------------------------------------------------
# causal trace propagation
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TraceContext:
    """The per-request causal identity carried across the fleet.

    Minted once (at ``Router.submit``), mutated in place as the request
    moves: every flow emission advances ``parent`` to the just-emitted
    span id, and every cross-replica transfer (migration, hedge copy)
    bumps ``hop``.  In-process fleets share the object; a real
    multi-process fleet would ship :meth:`to_dict` across the wire.
    """
    trace_id: str
    parent: str = "root"
    replica: Optional[str] = None
    hop: int = 0
    started: bool = False           # has the "s" flow event been emitted?
    seq: int = 0                    # per-context span id disambiguator

    @classmethod
    def mint(cls, request_id) -> "TraceContext":
        return cls(trace_id=f"req:{request_id}")

    def next_hop(self, replica: Optional[str] = None) -> "TraceContext":
        """Advance to the next hop (migration / hedge transfer)."""
        self.hop += 1
        self.replica = replica
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TraceContext":
        return cls(**d)


def emit_flow(tracer: Optional[Tracer], ctx: Optional[TraceContext],
              phase: str, *, final: bool = False,
              ts: Optional[float] = None, **args) -> Optional[dict]:
    """Emit one flow event for ``ctx`` on ``tracer`` and advance the
    context's parent chain.  The first emission for a context is the
    flow start (``ph: "s"``), ``final=True`` is the flow end
    (``ph: "f"``), everything between is a step (``ph: "t"``).  No-op
    (returns None) without a tracer or a context — tracing stays
    strictly opt-in on the hot path."""
    if tracer is None or ctx is None:
        return None
    span = f"{ctx.trace_id}#{ctx.hop}.{phase}.{ctx.seq}"
    ctx.seq += 1
    ph = "f" if final else ("t" if ctx.started else "s")
    ev = tracer.flow(ph, ctx.trace_id, ts, phase=phase, span=span,
                     parent=ctx.parent, hop=ctx.hop,
                     replica=tracer.id_tag, **args)
    ctx.started = True
    ctx.parent = span
    return ev


def check_flows(events: Sequence[dict], *,
                require_finish: bool = True) -> dict:
    """Verify flow-chain integrity over (merged) trace events.

    Groups flow events (``cat == "reqflow"``) by trace id and checks,
    per chain: exactly one start; at least one end when
    ``require_finish``; no event earlier than the start or later than
    the last end; and unbroken linkage — every non-start event's
    ``args.parent`` names the ``args.span`` of another event in the
    SAME chain.  Also reports orphan request slices: async ``request``
    begin events whose (replica tag, request id) no flow chain claims.

    Returns ``{"chains": {tid: info}, "complete": [...],
    "broken": {tid: [reasons]}, "orphans": [...]}`` where each chain
    info carries ``events`` / ``phases`` / ``replicas`` / ``hops``.
    """
    chains: Dict[str, List[dict]] = {}
    for ev in events:
        if ev.get("cat") == Tracer.FLOW_CAT and ev.get("ph") in "stf":
            chains.setdefault(ev["id"], []).append(ev)

    report = {"chains": {}, "complete": [], "broken": {}, "orphans": []}
    claimed: set = set()            # (replica tag, request id) pairs
    for tid, evs in sorted(chains.items()):
        evs = sorted(evs, key=lambda e: e.get("ts", 0.0))
        problems = []
        starts = [e for e in evs if e["ph"] == "s"]
        ends = [e for e in evs if e["ph"] == "f"]
        if len(starts) != 1:
            problems.append(f"{len(starts)} flow starts (want 1)")
        if require_finish and not ends:
            problems.append("no flow end")
        if starts and evs[0]["ts"] < starts[0]["ts"]:
            problems.append("event precedes the flow start")
        if ends and max(e["ts"] for e in evs) > max(e["ts"]
                                                   for e in ends):
            problems.append("event after the last flow end")
        spans = {e.get("args", {}).get("span") for e in evs}
        hops = [e.get("args", {}).get("hop", 0) for e in evs]
        for e in evs:
            a = e.get("args", {})
            if e["ph"] == "s":
                if a.get("parent") not in (None, "root"):
                    problems.append(
                        f"start parented to {a.get('parent')!r}")
            elif a.get("parent") not in spans:
                problems.append(
                    f"dangling parent {a.get('parent')!r} at phase "
                    f"{a.get('phase')!r}")
            rep, rid = a.get("replica"), a.get("request_id")
            if rep is not None and rid is not None:
                claimed.add((str(rep), str(rid)))
        info = {
            "events": len(evs),
            "phases": [e.get("args", {}).get("phase") for e in evs],
            "replicas": sorted({str(e["args"]["replica"]) for e in evs
                                if e.get("args", {}).get("replica")
                                is not None}),
            "hops": hops,
            "migrated": any(e.get("args", {}).get("phase") ==
                            "migrate_out" for e in evs),
        }
        if info["migrated"] and len(info["replicas"]) < 2:
            problems.append("migrated but spans a single replica")
        report["chains"][tid] = info
        if problems:
            report["broken"][tid] = problems
        else:
            report["complete"].append(tid)

    for ev in events:
        if (ev.get("ph") == "b" and ev.get("name") == "request"
                and ev.get("cat") == "request"):
            ident = str(ev.get("id", ""))
            tag, _, rid = ident.rpartition("/")
            if (tag, rid) not in claimed:
                report["orphans"].append(ident)
    return report


# --------------------------------------------------------------------------
# fleet aggregation
# --------------------------------------------------------------------------

def align_offset(ref_range: Optional[Tuple[float, float]],
                 other_range: Optional[Tuple[float, float]]) -> float:
    """The additive offset that aligns ``other`` onto ``ref``'s clock:
    0 when either range is empty or the ranges already overlap (shared
    clock), else min-to-min (different epochs — the 2-stream rule from
    ``tools/metrics_report.py``, reused for N streams by folding each
    stream onto the union of the already-aligned ones)."""
    if not ref_range or not other_range:
        return 0.0
    if other_range[0] > ref_range[1] or other_range[1] < ref_range[0]:
        return ref_range[0] - other_range[0]
    return 0.0


class _ReplayClock:
    """A clock that reports whatever timestamp the replay loop set —
    lets a fresh SLOMonitor relive merged history in order."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class FleetCollector:
    """Merge N replicas' traces and metric streams into one view.

    Each :meth:`add_replica` contributes a Chrome-trace event list
    and/or a JSONL metrics stream.  :meth:`merged_timeline` emits one
    Perfetto-loadable trace with per-replica process lanes and
    clock-aligned timestamps; :meth:`fleet_burn` replays every
    replica's raw histogram observations (the JSONL streams carry each
    observation, not just cumulative state) into a single fleet-level
    :class:`SLOMonitor`; :meth:`fleet_series` rolls counters up into
    ``fleet_*`` totals; :meth:`continuity` runs :func:`check_flows`
    over the merged events.
    """

    PID_BASE = 1000

    def __init__(self):
        self._replicas: List[dict] = []

    def add_replica(self, name: str, *,
                    tracer: Optional[Tracer] = None,
                    trace_events: Optional[Sequence[dict]] = None,
                    trace_path: Optional[str] = None,
                    jsonl_lines: Optional[Sequence[str]] = None,
                    jsonl_path: Optional[str] = None) -> None:
        events: List[dict] = []
        if tracer is not None:
            events = tracer.events
        elif trace_events is not None:
            events = list(trace_events)
        elif trace_path is not None:
            with open(trace_path, encoding="utf-8") as f:
                raw = json.load(f)
            events = raw["traceEvents"] if isinstance(raw, dict) else raw
        lines: List[str] = []
        if jsonl_lines is not None:
            lines = [ln for ln in jsonl_lines if ln.strip()]
        elif jsonl_path is not None:
            with open(jsonl_path, encoding="utf-8") as f:
                lines = [ln for ln in f if ln.strip()]
        self._replicas.append({"name": name, "events": events,
                               "lines": lines})

    # -- clock alignment -----------------------------------------------------

    @staticmethod
    def _ts_range(rep: dict) -> Optional[Tuple[float, float]]:
        """This replica's timestamp range in MICROSECONDS (trace events
        are µs; JSONL ``ts`` fields are seconds and scale up)."""
        ts = [e["ts"] for e in rep["events"] if "ts" in e]
        for ln in rep["lines"]:
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if "ts" in rec:
                ts.append(rec["ts"] * 1e6)
        return (min(ts), max(ts)) if ts else None

    def offsets_us(self) -> Dict[str, float]:
        """Per-replica additive µs offsets onto the fleet timeline.
        The first replica anchors the clock; each later stream that is
        disjoint from the union of everything aligned so far is shifted
        min-to-min onto it."""
        out: Dict[str, float] = {}
        union: Optional[Tuple[float, float]] = None
        for rep in self._replicas:
            rng = self._ts_range(rep)
            off = align_offset(union, rng)
            out[rep["name"]] = off
            if rng is not None:
                lo, hi = rng[0] + off, rng[1] + off
                union = ((lo, hi) if union is None
                         else (min(union[0], lo), max(union[1], hi)))
        return out

    # -- merged outputs ------------------------------------------------------

    def events(self) -> List[dict]:
        """All replicas' trace events on the aligned clock, pid-mapped
        into per-replica lanes, sorted by timestamp."""
        offs = self.offsets_us()
        merged: List[dict] = []
        for i, rep in enumerate(self._replicas):
            off = offs[rep["name"]]
            pid = self.PID_BASE + i
            for ev in rep["events"]:
                ev = dict(ev)
                ev["pid"] = pid
                if "tid" in ev:
                    ev["tid"] = pid
                if "ts" in ev:
                    ev["ts"] = ev["ts"] + off
                merged.append(ev)
        merged.sort(key=lambda e: e.get("ts", 0.0))
        return merged

    def merged_timeline(self) -> dict:
        """One Perfetto-loadable Chrome trace: per-replica process
        lanes (``process_name`` metadata), aligned clocks, applied
        offsets recorded in the trace metadata."""
        offs = self.offsets_us()
        events: List[dict] = []
        for i, rep in enumerate(self._replicas):
            events.append({"name": "process_name", "ph": "M",
                           "pid": self.PID_BASE + i,
                           "args": {"name": f"replica:{rep['name']}"}})
        events.extend(self.events())
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"apex_tpu.fleet_offsets_us": offs}}

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.merged_timeline(), f)
        return path

    def merged_records(self) -> List[Tuple[float, str, dict]]:
        """All replicas' JSONL records as ``(aligned_ts_s, replica,
        record)`` in fleet-time order (declare records, which carry no
        ``ts``, are skipped)."""
        offs = self.offsets_us()
        out: List[Tuple[float, str, dict]] = []
        for rep in self._replicas:
            off_s = offs[rep["name"]] / 1e6
            for ln in rep["lines"]:
                try:
                    rec = json.loads(ln)
                except ValueError:
                    continue
                if "ts" in rec:
                    out.append((rec["ts"] + off_s, rep["name"], rec))
        out.sort(key=lambda r: r[0])
        return out

    # -- fleet-level SLO burn ------------------------------------------------

    def fleet_slo(self, targets: Sequence[SLOTarget] = DEFAULT_FLEET_TARGETS,
                  *, metric_map: Dict[str, str] = SERVING_SLO_METRICS,
                  registry=None, **kwargs) -> SLOMonitor:
        """Replay every replica's raw histogram observations, in merged
        fleet-time order, into one fresh :class:`SLOMonitor` — the
        fleet-aggregate burn view.  The monitor's clock is left parked
        at the last replayed timestamp so ``burn_rate`` / ``snapshot``
        read the end-of-history state."""
        clock = _ReplayClock()
        mon = SLOMonitor(targets, clock=clock, registry=registry,
                         **kwargs)
        last = 0.0
        for ts, _, rec in self.merged_records():
            metric = metric_map.get(rec.get("name", ""))
            if rec.get("event") != "histogram" or metric is None:
                continue
            clock.t = last = ts
            mon.observe(metric, rec["value"])
        clock.t = last
        return mon

    def fleet_burn(self, targets: Sequence[SLOTarget] =
                   DEFAULT_FLEET_TARGETS, *,
                   window_s: float = 300.0) -> Dict[str, float]:
        """Fleet-wide burn multiple per SLO target over the trailing
        window of merged history."""
        mon = self.fleet_slo(targets)
        return {t.name: mon.burn_rate(t, window_s) for t in mon.targets}

    # -- rollups -------------------------------------------------------------

    def fleet_series(self) -> Dict[str, float]:
        """``fleet_*`` rollups: every counter summed across replicas
        and label sets, every histogram's count and sum likewise."""
        out: Dict[str, float] = {}
        for rep in self._replicas:
            if not rep["lines"]:
                continue
            reg, _ = replay_jsonl(rep["lines"])
            for name, info in reg.snapshot().items():
                for val in info["series"].values():
                    if isinstance(val, dict):       # histogram
                        for k in ("count", "sum"):
                            key = f"fleet_{name}_{k}"
                            out[key] = out.get(key, 0.0) + val[k]
                    else:
                        key = f"fleet_{name}"
                        out[key] = out.get(key, 0.0) + val
        return out

    def replica_table(self) -> List[dict]:
        """Per-replica health/burn/occupancy rows for the fleet
        report."""
        rows = []
        for rep in self._replicas:
            row = {"replica": rep["name"],
                   "span_events": len(rep["events"]),
                   "requests": 0, "occupancy": None, "burn": {},
                   "health": None}
            if rep["lines"]:
                reg, records = replay_jsonl(rep["lines"])
                snap = reg.snapshot()
                h = snap.get("serving_requests_total", {})
                row["requests"] = int(sum(
                    v for v in h.get("series", {}).values()
                    if not isinstance(v, dict)))
                occ = snap.get("serving_slot_occupancy", {})
                vals = [v for v in occ.get("series", {}).values()
                        if not isinstance(v, dict)]
                if vals:
                    row["occupancy"] = vals[-1]
                sub = FleetCollector()
                sub.add_replica(rep["name"], trace_events=rep["events"],
                                jsonl_lines=rep["lines"])
                row["burn"] = sub.fleet_burn()
                for _, _, rec in reversed(sub.merged_records()):
                    if rec.get("event") == "replica_health":
                        row["health"] = rec.get("state")
                        break
            rows.append(row)
        return rows

    def continuity(self, **kwargs) -> dict:
        """:func:`check_flows` over the merged timeline."""
        return check_flows(self.events(), **kwargs)


# --------------------------------------------------------------------------
# anomaly flight recorder
# --------------------------------------------------------------------------

class FlightRecorder:
    """Bounded rings of recent observability entries, dumped as one
    correlated snapshot when something detonates.

    Sources call ``record(source, kind, **fields)`` continuously —
    spans, metric deltas, applied faults, scheduler decisions; each
    source keeps its newest ``keep`` entries.  ``trigger(kind)`` cuts a
    snapshot: every source's entries within ``±window_s`` of the
    trigger instant, plus the trigger details — the serving equivalent
    of a crash dump's "last N seconds from every subsystem".  Snapshot
    retention is bounded too (``max_dumps``); with a ``registry``
    attached, ``flight_recorder_snapshots_total{trigger}`` counts
    dumps.
    """

    def __init__(self, *, clock=time.monotonic, keep: int = 256,
                 window_s: float = 30.0, max_dumps: int = 8,
                 registry=None):
        self.clock = clock
        self.keep = int(keep)
        self.window_s = float(window_s)
        self.max_dumps = int(max_dumps)
        self._rings: Dict[str, collections.deque] = {}
        self.dumps: List[dict] = []
        self._seq = 0
        self._c_snaps = None
        if registry is not None:
            self._c_snaps = registry.counter(
                "flight_recorder_snapshots_total",
                "correlated flight-recorder snapshots cut",
                labelnames=("trigger",))

    def record(self, source: str, kind: str, **fields) -> None:
        ring = self._rings.get(source)
        if ring is None:
            ring = self._rings[source] = collections.deque(
                maxlen=self.keep)
        ring.append((self.clock(), kind, fields))

    def trigger(self, kind: str, **details) -> dict:
        """Cut a correlated snapshot around NOW and retain it."""
        now = self.clock()
        lo, hi = now - self.window_s, now + self.window_s
        snap = {"trigger": kind, "details": dict(details), "ts": now,
                "window_s": self.window_s, "seq": self._seq,
                "sources": {}}
        self._seq += 1
        for source, ring in sorted(self._rings.items()):
            snap["sources"][source] = [
                {"ts": ts, "kind": k, **f}
                for ts, k, f in ring if lo <= ts <= hi]
        self.dumps.append(snap)
        if len(self.dumps) > self.max_dumps:
            del self.dumps[:len(self.dumps) - self.max_dumps]
        if self._c_snaps is not None:
            self._c_snaps.inc(trigger=kind)
        return snap

    @property
    def last(self) -> Optional[dict]:
        return self.dumps[-1] if self.dumps else None

    def save(self, path: str) -> str:
        """Write the retained snapshots as JSON."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"snapshots": self.dumps}, f)
        return path
