"""SLO targets, rolling percentiles, multi-window burn-rate alerts.

The registry's :class:`~apex_tpu_torch.observability.registry.Histogram` is
cumulative — right for dashboards, wrong for alerting, where "TTFT p95
over the last five minutes" must FORGET last week.  This module adds the
rolling layer on top:

* :class:`RollingPercentiles` — bounded-memory sliding-window quantile
  estimation.  The window is split into time slots, each slot holds
  fixed-boundary bucket counts (the same boundary semantics as the
  registry histogram), expired slots are dropped as the clock advances,
  and quantiles interpolate within the merged counts —
  ``histogram_quantile`` over a window, O(slots × buckets) memory
  regardless of traffic.
* :class:`SLOTarget` — a declarative objective: "``objective`` of
  ``metric`` observations are good (``value <= threshold``)", e.g.
  TTFT p95 < 200 ms is ``SLOTarget("ttft", 0.2, objective=0.95)``.
* :class:`SLOMonitor` — feeds observations to the percentile windows
  and, per target, to rolling good/total counts; **burn rate** over a
  window is ``bad_fraction / (1 - objective)`` (burn 1.0 = consuming
  the error budget exactly on schedule), and alerts use the standard
  multi-window formulation: a (short, long) pair fires only when BOTH
  windows burn above the pair's threshold — the long window filters
  blips, the short window makes recovery reset the alert quickly.

Wired in: ``ServingMetrics(slo=...)`` feeds ``ttft`` /
``token_latency`` / ``queue_wait``; ``TrainingMonitor(slo=...)`` feeds
``step_time``.  With a registry attached, the monitor exports
``slo_events_total`` / ``slo_burn_rate`` / ``slo_alert`` /
``slo_latency_quantile`` series on every :meth:`SLOMonitor.snapshot`.

Port of ``apex_tpu/observability/slo.py``; it imports no JAX.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

from apex_tpu_torch.observability.registry import DEFAULT_BUCKETS


class RollingPercentiles:
    """Sliding-window quantiles from time-slotted bucket counts.

    ``window_s`` seconds of history in ``slots`` equal slots; an
    observation lands in the current slot's bucket counts and slots
    older than the window are dropped lazily, so memory is a constant
    ``slots × (len(buckets)+1)`` ints.  ``percentile(q)`` merges the
    live slots and linearly interpolates inside the selected bucket
    (the overflow bucket reports the top finite boundary — the same
    saturation behavior as Prometheus ``histogram_quantile``).
    """

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window_s: float = 300.0, slots: int = 30,
                 clock=time.monotonic):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("need at least one bucket boundary")
        if window_s <= 0 or slots < 1:
            raise ValueError("window_s must be > 0 and slots >= 1")
        self.buckets = bs
        self.window_s = float(window_s)
        self.slots = int(slots)
        self.slot_s = self.window_s / self.slots
        self.clock = clock
        # (slot_index, [bucket counts..., overflow]) — append-right,
        # expire-left
        self._ring: collections.deque = collections.deque()

    def _current(self) -> list:
        idx = int(self.clock() // self.slot_s)
        self._expire(idx)
        if not self._ring or self._ring[-1][0] != idx:
            self._ring.append((idx, [0] * (len(self.buckets) + 1)))
        return self._ring[-1][1]

    def _expire(self, idx: int) -> None:
        while self._ring and self._ring[0][0] <= idx - self.slots:
            self._ring.popleft()

    def observe(self, value: float) -> None:
        counts = self._current()
        counts[bisect.bisect_left(self.buckets, float(value))] += 1

    def reset(self) -> None:
        """Drop every live slot — the window restarts empty."""
        self._ring.clear()

    def _merged(self) -> list:
        self._expire(int(self.clock() // self.slot_s))
        merged = [0] * (len(self.buckets) + 1)
        for _, counts in self._ring:
            for i, c in enumerate(counts):
                merged[i] += c
        return merged

    def count(self) -> int:
        return sum(self._merged())

    def percentile(self, q: float) -> float:
        """The q-quantile (``0 <= q <= 1``) of the window, interpolated
        within its bucket; 0.0 on an empty window."""
        merged = self._merged()
        total = sum(merged)
        if not total:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(merged):
            if not c:
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):     # overflow: saturate
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * max(rank - cum, 0.0) / c
            cum += c
        return self.buckets[-1]                # pragma: no cover


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """``objective`` of ``metric`` observations satisfy
    ``value <= threshold`` — e.g. "95% of TTFTs under 200 ms" is
    ``SLOTarget("ttft", threshold=0.2, objective=0.95)``."""
    metric: str
    threshold: float
    objective: float = 0.99
    name: str = ""

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}")
        if not self.name:
            object.__setattr__(
                self, "name", f"{self.metric}_le_{self.threshold:g}")


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One multi-window alert rule: fire when BOTH the short and the
    long window burn the error budget faster than ``threshold``×."""
    short_s: float
    long_s: float
    threshold: float

    @property
    def label(self) -> str:
        return f"{self.short_s:g}s/{self.long_s:g}s"


# the SRE-book page/ticket pair: 14.4x over (5m, 1h) exhausts a 30-day
# budget in ~2 days; 6x over (30m, 6h) in ~5 days
DEFAULT_BURN_WINDOWS = (BurnWindow(300.0, 3600.0, 14.4),
                        BurnWindow(1800.0, 21600.0, 6.0))


class _WindowedCounts:
    """Rolling (good, total) event counts in time slots, queryable over
    any lookback up to ``max_window_s``."""

    def __init__(self, slot_s: float, max_window_s: float, clock):
        self.slot_s = slot_s
        self.max_slots = max(1, int(round(max_window_s / slot_s)))
        self.clock = clock
        self._ring: collections.deque = collections.deque()  # [idx, good, total]

    def add(self, good: bool) -> None:
        idx = int(self.clock() // self.slot_s)
        while self._ring and self._ring[0][0] <= idx - self.max_slots:
            self._ring.popleft()
        if not self._ring or self._ring[-1][0] != idx:
            self._ring.append([idx, 0, 0])
        slot = self._ring[-1]
        slot[1] += bool(good)
        slot[2] += 1

    def reset(self) -> None:
        """Drop every live slot — the window restarts empty."""
        self._ring.clear()

    def rates(self, window_s: float) -> Tuple[int, int]:
        """(bad, total) over the trailing ``window_s`` seconds."""
        idx = int(self.clock() // self.slot_s)
        n = max(1, int(round(window_s / self.slot_s)))
        bad = total = 0
        for sidx, good, tot in self._ring:
            if sidx > idx - n:
                bad += tot - good
                total += tot
        return bad, total


class SLOMonitor:
    """Rolling SLO evaluation over a set of :class:`SLOTarget`\\ s.

    ``observe(metric, value)`` is the single ingestion point (the
    serving/training monitors call it); everything else is derived on
    read.  With a ``registry`` attached, ``slo_events_total{slo,good}``
    counts every classified event live, and :meth:`snapshot` refreshes
    ``slo_burn_rate{slo,window}`` / ``slo_alert{slo,window}`` /
    ``slo_latency_quantile{metric,quantile}`` gauges.  Memory is
    bounded: per metric one :class:`RollingPercentiles`, per target one
    slot ring covering the longest burn window.
    """

    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, targets: Sequence[SLOTarget], *,
                 clock=time.monotonic, registry=None,
                 burn_windows: Sequence[BurnWindow] = DEFAULT_BURN_WINDOWS,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 percentile_window_s: float = 300.0,
                 slots_per_window: int = 30):
        self.targets = tuple(targets)
        names = [t.name for t in self.targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO target names: {names}")
        self.burn_windows = tuple(burn_windows)
        self.clock = clock
        self.registry = registry
        self._by_metric: Dict[str, list] = {}
        for t in self.targets:
            self._by_metric.setdefault(t.metric, []).append(t)
        self._pcts = {
            m: RollingPercentiles(buckets=buckets,
                                  window_s=percentile_window_s,
                                  slots=slots_per_window, clock=clock)
            for m in self._by_metric}
        slot_s = (min(w.short_s for w in self.burn_windows)
                  / slots_per_window) if self.burn_windows else 1.0
        max_w = (max(w.long_s for w in self.burn_windows)
                 if self.burn_windows else 1.0)
        self._counts = {t.name: _WindowedCounts(slot_s, max_w, clock)
                        for t in self.targets}
        # window epoch: bumped by reset_windows() at capacity-change
        # boundaries so burn is never computed across a shift
        self.epoch = 0
        self.epoch_tag: Optional[str] = None
        self._c_events = self._g_burn = None
        if registry is not None:
            self._c_events = registry.counter(
                "slo_events_total", "events classified against SLO "
                "targets", labelnames=("slo", "good"))
            self._g_burn = registry.gauge(
                "slo_burn_rate", "error-budget burn multiple per "
                "window", labelnames=("slo", "window"))
            self._g_alert = registry.gauge(
                "slo_alert", "1 while the window pair fires",
                labelnames=("slo", "window"))
            self._g_quant = registry.gauge(
                "slo_latency_quantile", "rolling-window quantile",
                labelnames=("metric", "quantile"))
            self._g_epoch = registry.gauge(
                "slo_window_epoch",
                "burn/percentile window epoch (bumped on reset_windows)")
            self._g_epoch.set(0)

    # -- window epochs -------------------------------------------------------

    def reset_windows(self, epoch: Optional[str] = None) -> None:
        """Forget every rolling window (burn counts AND percentile
        slots) and bump the window epoch.

        The capacity controller calls this when the capacity split
        changes: burn computed over a pre-shift window describes a
        fleet that no longer exists, and acting on it immediately
        re-triggers the next shift — the stale-burn flapping bug.
        After a reset, burn is 0.0 until post-shift traffic refills the
        windows.  ``epoch`` is an optional tag (e.g. ``"shift-3"``)
        surfaced as :attr:`epoch_tag`; :attr:`epoch` is a monotonic
        counter exported as the ``slo_window_epoch`` gauge.
        """
        for c in self._counts.values():
            c.reset()
        for p in self._pcts.values():
            p.reset()
        self.epoch += 1
        self.epoch_tag = epoch
        if self.registry is not None:
            self._g_epoch.set(self.epoch)
            self.registry.event("slo_window_reset", epoch=self.epoch,
                                tag=epoch)

    # -- ingestion -----------------------------------------------------------

    def observe(self, metric: str, value: float) -> None:
        """Classify one observation of ``metric`` against every target
        on it (metrics without a target are ignored — the serving layer
        feeds unconditionally)."""
        targets = self._by_metric.get(metric)
        if not targets:
            return
        self._pcts[metric].observe(value)
        for t in targets:
            good = value <= t.threshold
            self._counts[t.name].add(good)
            if self._c_events is not None:
                self._c_events.inc(slo=t.name, good=str(good).lower())

    # -- derived -------------------------------------------------------------

    def burn_rate(self, target: SLOTarget, window_s: float) -> float:
        """Error-budget burn multiple over the window: 1.0 = burning
        exactly the budgeted rate; 0.0 when the window saw no events."""
        bad, total = self._counts[target.name].rates(window_s)
        if not total:
            return 0.0
        return (bad / total) / (1.0 - target.objective)

    def percentile(self, metric: str, q: float) -> float:
        return self._pcts[metric].percentile(q)

    def alerts(self) -> list:
        """Currently-firing (target, window-pair) alerts."""
        out = []
        for t in self.targets:
            for w in self.burn_windows:
                bs = self.burn_rate(t, w.short_s)
                bl = self.burn_rate(t, w.long_s)
                if bs > w.threshold and bl > w.threshold:
                    out.append({"slo": t.name, "window": w.label,
                                "burn_short": bs, "burn_long": bl,
                                "threshold": w.threshold})
        return out

    def snapshot(self) -> dict:
        """Full rolling-state view; also refreshes the registry gauges
        (burn rates, alert flags, quantiles) when one is attached."""
        firing = {(a["slo"], a["window"]) for a in self.alerts()}
        targets = {}
        for t in self.targets:
            wins = {}
            for w in self.burn_windows:
                wins[w.label] = {
                    "burn_short": self.burn_rate(t, w.short_s),
                    "burn_long": self.burn_rate(t, w.long_s),
                    "threshold": w.threshold,
                    "firing": (t.name, w.label) in firing}
                if self._g_burn is not None:
                    self._g_burn.set(wins[w.label]["burn_short"],
                                     slo=t.name, window=w.label)
                    self._g_alert.set(
                        float(wins[w.label]["firing"]),
                        slo=t.name, window=w.label)
            targets[t.name] = {"metric": t.metric,
                               "threshold": t.threshold,
                               "objective": t.objective,
                               "windows": wins}
        pcts = {}
        for m, rp in self._pcts.items():
            pcts[m] = {f"p{int(q * 100)}": rp.percentile(q)
                       for q in self.QUANTILES}
            pcts[m]["n"] = rp.count()
            if self._g_burn is not None:
                for q in self.QUANTILES:
                    self._g_quant.set(rp.percentile(q), metric=m,
                                      quantile=f"p{int(q * 100)}")
        return {"targets": targets, "percentiles": pcts,
                "alerts": sorted(firing)}
