"""Labeled metrics registry with JSONL + Prometheus exporters.

The single sink every apex_tpu telemetry producer writes to
(:class:`~apex_tpu_torch.utils.profiling.ServingMetrics`, the training
monitor, ``bench.py``'s per-leg results).  Three instrument kinds, the
Prometheus trio:

* :class:`Counter` — monotonically increasing (requests served,
  anomalies skipped);
* :class:`Gauge` — a value that goes both ways (tokens/s, loss scale);
* :class:`Histogram` — bucketed observations with sum/count (step
  time, TTFT).

All instruments are labeled: a metric is declared once with its label
NAMES and every sample carries a full set of label VALUES — partial or
unknown labels raise, the Prometheus contract.  Mutations are
thread-safe (one registry lock; the serving engine and an async
checkpoint writer may share a registry) and the clock is injectable so
tests drive deterministic timestamps.

Two export surfaces:

* **JSONL event stream** — every mutation appends one JSON object
  (``ts``/``event``/``name``/``labels``/``value``) to any attached
  stream, plus free-form records via :meth:`MetricsRegistry.event`
  (the training monitor's per-step records ride this).  Append-only,
  machine-tailable, and lossless: :func:`replay_jsonl` rebuilds an
  identical registry from a stream.
* **Prometheus text snapshot** — :meth:`MetricsRegistry.prometheus`
  renders the current state in the text exposition format
  (``# HELP``/``# TYPE`` + samples; histograms as cumulative
  ``_bucket{le=...}`` series with ``_sum``/``_count``) for scrape-style
  collection.

Port of ``apex_tpu/observability/registry.py``; it imports no JAX.
"""

from __future__ import annotations

import io
import json
import math
import re
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

# Prometheus default buckets, in seconds — right-sized for step/request
# latencies, overridable per histogram
DEFAULT_BUCKETS = (.005, .01, .025, .05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labelnames: Sequence[str], labels: dict) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"label mismatch: declared {sorted(labelnames)}, "
            f"got {sorted(labels)}")
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_labels(labelnames: Sequence[str], key: Tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(labelnames, key)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str]):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _record(self, key: Tuple[str, ...], value: float) -> None:
        self._registry._emit_metric(self, key, value)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, registry, name, help, labelnames):
        super().__init__(registry, name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(self.labelnames, labels)
        with self._registry._lock:
            self._values[key] = self._values.get(key, 0.0) + amount
            self._record(key, amount)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def _samples(self):
        for key, v in sorted(self._values.items()):
            yield self.name, self.labelnames, key, "", v


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, registry, name, help, labelnames):
        super().__init__(registry, name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._registry._lock:
            self._values[key] = float(value)
            self._record(key, float(value))

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._registry._lock:
            self._values[key] = self._values.get(key, 0.0) + amount
            self._record(key, self._values[key])

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def _samples(self):
        for key, v in sorted(self._values.items()):
            yield self.name, self.labelnames, key, "", v


class Histogram(_Metric):
    """Fixed-boundary bucketed observations.

    Memory is BOUNDED by construction: per label set the histogram
    holds ``len(buckets)+1`` counts plus a sum/total — never the raw
    samples — so a serving run observing millions of latencies stays
    O(buckets).  :meth:`percentile` interpolates quantiles from the
    bucket counts (choose boundaries that bracket the latencies you
    care about; the answer is exact only at boundaries).
    """

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs
        # per label-set: [per-bucket counts..., +Inf count], sum, count
        self._counts: Dict[Tuple[str, ...], list] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        v = float(value)
        with self._registry._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v
            self._totals[key] = self._totals.get(key, 0) + 1
            self._record(key, v)

    def count(self, **labels) -> int:
        return self._totals.get(_label_key(self.labelnames, labels), 0)

    def sum(self, **labels) -> float:
        return self._sums.get(_label_key(self.labelnames, labels), 0.0)

    def percentile(self, q: float, **labels) -> float:
        """The q-quantile (``0 <= q <= 1``) interpolated from bucket
        counts — ``histogram_quantile`` semantics: linear within the
        selected bucket, saturating at the top finite boundary for
        observations in the overflow bucket; 0.0 with no samples."""
        key = _label_key(self.labelnames, labels)
        with self._registry._lock:
            counts = list(self._counts.get(key, ()))
            total = self._totals.get(key, 0)
        if not total:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                return lo + (self.buckets[i] - lo) \
                    * max(rank - cum, 0.0) / c
            cum += c
        return self.buckets[-1]               # pragma: no cover

    def _samples(self):
        for key in sorted(self._counts):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[key][i]
                yield (self.name + "_bucket", self.labelnames, key,
                       f'le="{_fmt_value(b)}"', cum)
            yield (self.name + "_bucket", self.labelnames, key,
                   'le="+Inf"', self._totals[key])
            yield self.name + "_sum", self.labelnames, key, "", \
                self._sums[key]
            yield self.name + "_count", self.labelnames, key, "", \
                self._totals[key]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Declare-once, label-checked metrics with streaming export.

    ``clock`` stamps JSONL events (default wall time, so streams from
    different hosts interleave meaningfully); pass a fake counter in
    tests for deterministic output.
    """

    def __init__(self, clock=time.time):
        self.clock = clock
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._streams: list = []        # (fileobj, owned: bool)

    # -- declaration ---------------------------------------------------------

    def _declare(self, cls, name: str, help: str,
                 labelnames: Sequence[str], **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already declared as "
                        f"{existing.kind}{existing.labelnames}")
                return existing
            m = cls(self, name, help, labelnames, **kw)
            self._metrics[name] = m
            if self._streams:
                self._write(self._declare_record(m))
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, labelnames,
                             buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # -- JSONL event stream --------------------------------------------------

    def open_stream(self, path: str) -> None:
        """Append JSONL events to ``path`` (opened append-mode, owned —
        closed by :meth:`close`)."""
        self._attach(open(path, "a", encoding="utf-8"), owned=True)

    def attach_stream(self, fileobj) -> None:
        """Append JSONL events to a caller-owned file-like object."""
        self._attach(fileobj, owned=False)

    def _attach(self, fileobj, owned: bool) -> None:
        with self._lock:
            # replays reconstruct metric CONFIG (type/help/buckets) from
            # declare records, so a late-attached stream gets the
            # declarations it missed
            for name in sorted(self._metrics):
                fileobj.write(json.dumps(
                    self._declare_record(self._metrics[name]),
                    sort_keys=True) + "\n")
            self._streams.append((fileobj, owned))

    def _declare_record(self, m: _Metric) -> dict:
        rec = {"ts": self.clock(), "event": "declare", "kind": m.kind,
               "name": m.name, "help": m.help,
               "labelnames": list(m.labelnames)}
        if isinstance(m, Histogram):
            rec["buckets"] = list(m.buckets)
        return rec

    def close(self) -> None:
        for f, owned in self._streams:
            try:
                f.flush()
                if owned:
                    f.close()
            except (OSError, ValueError):
                pass
        self._streams = []

    def _write(self, record: dict) -> None:
        if not self._streams:
            return
        line = json.dumps(record, sort_keys=True) + "\n"
        for f, _ in self._streams:
            f.write(line)
            f.flush()

    def _emit_metric(self, metric: _Metric, key, value: float) -> None:
        # no attached stream -> no record, and crucially no clock() call:
        # callers may share an injected clock with the registry
        # (ServingMetrics does), and a phantom tick per mutation would
        # skew their own timing reads
        if not self._streams:
            return
        self._write({"ts": self.clock(), "event": metric.kind,
                     "name": metric.name,
                     "labels": dict(zip(metric.labelnames, key)),
                     "value": value})

    def event(self, event: str, **fields) -> None:
        """Free-form JSONL record (e.g. one ``train_step`` record per
        step from the training monitor).  ``event`` names the record
        type; ``fields`` land as top-level keys."""
        with self._lock:
            if not self._streams:
                return
            self._write({"ts": self.clock(), "event": event, **fields})

    # -- snapshots -----------------------------------------------------------

    def prometheus(self) -> str:
        """Prometheus text exposition format snapshot of every metric."""
        out = io.StringIO()
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    out.write(f"# HELP {name} {m.help}\n")
                out.write(f"# TYPE {name} {m.kind}\n")
                for sname, lnames, key, extra, v in m._samples():
                    out.write(f"{sname}{_fmt_labels(lnames, key, extra)}"
                              f" {_fmt_value(v)}\n")
        return out.getvalue()

    def snapshot(self) -> dict:
        """Nested plain-dict view: name -> {kind, labels->value} (for
        histograms: labels -> {count, sum})."""
        with self._lock:
            out = {}
            for name, m in self._metrics.items():
                if isinstance(m, Histogram):
                    series = {key: {"count": m._totals[key],
                                    "sum": m._sums[key]}
                              for key in m._counts}
                else:
                    series = dict(m._values)
                out[name] = {"kind": m.kind,
                             "labelnames": m.labelnames,
                             "series": series}
            return out


def replay_jsonl(lines: Iterable[str],
                 registry: Optional[MetricsRegistry] = None
                 ) -> Tuple[MetricsRegistry, list]:
    """Rebuild a registry from a JSONL event stream.

    ``declare`` records recreate each metric with its original help
    text, label names and (for histograms) bucket boundaries; metric
    events (``counter``/``gauge``/``histogram``) are then re-applied in
    order — counters re-accumulate their deltas, gauges re-play their
    sets, histograms re-observe every sample — so the rebuilt
    registry's :meth:`~MetricsRegistry.prometheus` snapshot is
    byte-identical to the producer's.  Free-form records are returned
    as the second element for record-level consumers
    (``tools/metrics_report.py``).
    """
    reg = registry if registry is not None else MetricsRegistry()
    records = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        kind = rec.get("event")
        if kind == "declare" and rec.get("kind") in _KINDS:
            kw = {"buckets": tuple(rec["buckets"])} \
                if rec.get("kind") == "histogram" else {}
            reg._declare(_KINDS[rec["kind"]], rec["name"],
                         rec.get("help", ""),
                         tuple(rec.get("labelnames", ())), **kw)
        elif kind in _KINDS and "name" in rec:
            labels = rec.get("labels", {})
            m = getattr(reg, kind)(rec["name"],
                                   labelnames=tuple(labels))
            if kind == "counter":
                m.inc(rec["value"], **labels)
            elif kind == "gauge":
                m.set(rec["value"], **labels)
            else:
                m.observe(rec["value"], **labels)
        else:
            records.append(rec)
    return reg, records
