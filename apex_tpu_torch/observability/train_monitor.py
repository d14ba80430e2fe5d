"""Training-loop telemetry: wrap any train step, get operator metrics —
port of ``apex_tpu/observability/train_monitor.py``.

``TrainingMonitor`` turns a train step — a
:class:`~apex_tpu_torch.resilience.guard.GuardedTrainStep` or any callable
— into the same step plus a metrics tap:

* **step time** (histogram + last-value gauge), measured wall-clock
  around the step's own host readback (the guard's one telemetry readback
  waits for the card, so the window covers the device work; the monitor
  adds no ``synchronize`` or ``.item()`` of its own);
* **tokens/s** and, when FLOP accounting is configured, **achieved
  MFU** — the ``tokens_per_step * flops_per_token / dt / peak``
  protocol from ``bench.py``, with the peak supplied directly or
  measured once by :func:`calibrated_peak_flops` (a chained-dependent
  bf16 matmul probe, so the "peak" is what this card actually sustains,
  not the spec sheet);
* **grad-norm / loss / loss-scale series** read from the guard's
  :class:`~apex_tpu_torch.resilience.guard.StepResult` host fields
  (``grad_norm``, ``loss_value``, ``loss_scale_value``) — all carried
  by the ONE readback the guard already performs;
* **anomaly / rollback counters** labeled by kind, cross-checkable
  against ``GuardedTrainStep.stats``.

Every step also appends one ``train_step`` record to the registry's
JSONL stream with the keys an alerting pipeline needs
(``step``/``step_time_s``/``tokens_per_s``/``loss``/``grad_norm``/
``anomalies``/...), and the registry's Prometheus snapshot exposes the
same series for scrape-style collection.
"""

from __future__ import annotations

import collections
import functools
import statistics
import time
from typing import Any, Callable, Optional

from apex_tpu_torch.observability.registry import MetricsRegistry

_STEP_KEYS = ("step", "step_time_s", "tokens_per_s", "loss",
              "grad_norm", "anomalies")


def calibrated_peak_flops(chain: int = 32, n: int = 2048,
                          iters: int = 2, device=None) -> float:
    """Sustained bf16 matmul FLOP/s on ``device`` (default the card) — the
    paired-calibration probe from ``bench.py``: ``chain`` DEPENDENT n×n
    products, each rescaled by its largest entry as the JAX probe does,
    timed over ``iters`` chains and closed by a hard sync (a 1-element
    device->host readback after ``torch.cuda.synchronize``), the least of
    three such windows.  Smaller
    defaults than the bench (one-shot use at monitor construction).

    The rate is the products': the same chain of rescales alone is timed
    the same way and its time taken off.  XLA fuses the rescale into the
    product's program on the TPU, so the JAX probe mostly times the
    product; in eager PyTorch the rescale is six unfused elementwise and
    reduction kernels a link.  JAX runs the chain as one compiled program; on the
    card each chain is captured once into a CUDA graph and replayed, so
    the host's launches do not stand between the kernels.  On the CPU the
    chains run eagerly."""
    import torch

    from apex_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    # the JAX probe draws both operands from one key: the same matrix
    b = torch.randn((n, n), generator=gen).to(dev, torch.bfloat16)

    def rescale(c):
        return c * (1.0 / torch.clamp(c.abs().max(), min=1.0)).to(
            torch.bfloat16)

    def seconds_a_link(link):
        a = b.clone()

        def run(c):
            for _ in range(chain):
                c = link(c)
            return c

        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                run(a)                        # warm-up outside the capture
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = run(a)

            def step():
                graph.replay()
                a.copy_(out)                  # the next chain's input
        else:
            def step():
                a.copy_(run(a))

        def sync():
            if a.is_cuda:
                torch.cuda.synchronize(a.device)
            a[0, 0].item()
        step()
        sync()
        best = float("inf")
        for _ in range(3):            # noise only adds: the least window
            t0 = time.perf_counter()
            for _ in range(iters):
                step()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best / (iters * chain)

    both = seconds_a_link(lambda c: rescale(torch.matmul(c, b)))
    dt = both - seconds_a_link(rescale)
    if dt <= 0.0:
        raise RuntimeError(
            f"calibrated_peak_flops: a product and its rescale took "
            f"{both!r} s a link, no more than the rescale alone; raise "
            f"n ({n}) or iters ({iters})")
    return 2.0 * n ** 3 / dt


class TrainingMonitor:
    """``monitored = TrainingMonitor(...).wrap(step_fn)`` — same
    signature, same return value, metrics recorded per call.

    ``tokens_per_step`` enables the tokens/s gauge;
    ``flops_per_token`` + ``peak_flops`` enable the MFU gauge
    (``peak_flops="calibrated"`` runs :func:`calibrated_peak_flops`
    once, lazily, at the first monitored step, on the card; a caller
    elsewhere passes ``calibrated_peak_flops(device=...)``'s number).
    ``registry`` defaults
    to a fresh :class:`MetricsRegistry`; pass ``stream_path`` to open a
    JSONL event stream on it.  ``clock`` is injectable for tests.

    Straggler visibility: every step sets ``train_step_time_skew`` —
    this step's time over the rolling median of the last
    ``skew_window`` steps, minus one (0.0 = on trend; 1.0 = a 2× step)
    — the single-process "is something stalling" gauge.  Under
    :mod:`torch.distributed` with more than one rank,
    ``straggler_every=N`` additionally all-gathers the step time over the
    default group every N steps and sets ``train_straggler_ratio``
    (slowest/fastest rank); it costs a host sync per sample, so it
    defaults to off (0).  ``slo=`` feeds each
    step time to an :class:`~apex_tpu_torch.observability.slo.SLOMonitor`
    as metric ``"step_time"``.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 tokens_per_step: Optional[int] = None,
                 flops_per_token: Optional[float] = None,
                 peak_flops: Any = None,
                 stream_path: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 slo: Any = None,
                 skew_window: int = 32,
                 straggler_every: int = 0):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        if stream_path is not None:
            self.registry.open_stream(stream_path)
        self.clock = clock
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.slo = slo
        self.straggler_every = straggler_every
        self._recent_dt: collections.deque = \
            collections.deque(maxlen=max(skew_window, 2))
        self.steps = 0
        self._totals = {"anomalies": 0, "rollbacks": 0, "time_s": 0.0}
        r = self.registry
        self._h_step = r.histogram(
            "train_step_time_seconds", "wall seconds per train step")
        self._g_step = r.gauge("train_step_time_s_last",
                               "last step wall seconds")
        self._g_tps = r.gauge("train_tokens_per_s",
                              "tokens per second (last step)")
        self._g_mfu = r.gauge("train_mfu",
                              "achieved fraction of peak FLOP/s")
        self._g_loss = r.gauge("train_loss", "loss (last step)")
        self._g_gnorm = r.gauge("train_grad_norm",
                                "unscaled grad norm (last step)")
        self._g_scale = r.gauge("train_loss_scale",
                                "dynamic loss scale (last step)")
        self._c_steps = r.counter("train_steps_total", "steps run")
        self._c_anom = r.counter(
            "train_anomalies_total", "guard-skipped steps by kind",
            labelnames=("kind",))
        self._c_roll = r.counter("train_rollbacks_total",
                                 "checkpoint rollbacks")
        self._g_skew = r.gauge(
            "train_step_time_skew",
            "step time / rolling median - 1 (0 = on trend)")
        self._g_straggler = r.gauge(
            "train_straggler_ratio",
            "slowest/fastest host step time (multi-controller only)")

    # -- wiring --------------------------------------------------------------

    def wrap(self, step_fn: Callable) -> Callable:
        """Wrap a train step.  A :class:`GuardedTrainStep` (anything
        returning an object with ``grad_norm``/``skipped``/``anomaly``
        fields) gets the full series; a plain callable gets step
        time/tokens/MFU and, when its return value is a scalar-like
        loss, the loss series."""
        @functools.wraps(getattr(step_fn, "__call__", step_fn))
        def monitored(*args, **kwargs):
            t0 = self.clock()
            result = step_fn(*args, **kwargs)
            self.record(self.clock() - t0, result,
                        step=kwargs.get("step"))
            return result
        monitored.monitor = self
        return monitored

    def record(self, dt: float, result: Any = None,
               step: Optional[int] = None) -> None:
        """Record one step from its wall time + (optionally) its
        :class:`StepResult`-like outcome.  Usable directly by loops
        that time themselves."""
        if step is None:
            step = self.steps
        self.steps += 1
        self._totals["time_s"] += dt
        self._h_step.observe(dt)
        self._g_step.set(dt)
        self._c_steps.inc()
        rec = {"step": int(step), "step_time_s": dt,
               "anomalies": self._totals["anomalies"]}

        # skew vs the rolling median of RECENT steps (this step is
        # appended after the read, so a stall shows against the trend
        # rather than diluting it)
        med = statistics.median(self._recent_dt) if self._recent_dt else dt
        skew = (dt / med - 1.0) if med > 0 else 0.0
        self._recent_dt.append(dt)
        self._g_skew.set(skew)
        rec["step_time_skew"] = skew
        if self.slo is not None:
            self.slo.observe("step_time", dt)
        if self.straggler_every and self.steps % self.straggler_every == 0:
            ratio = self._straggler_ratio(dt)
            if ratio is not None:
                self._g_straggler.set(ratio)
                rec["straggler_ratio"] = ratio

        if self.tokens_per_step:
            tps = self.tokens_per_step / dt if dt > 0 else 0.0
            self._g_tps.set(tps)
            rec["tokens_per_s"] = tps
            if self.flops_per_token:
                peak = self._resolve_peak()
                if peak:
                    mfu = tps * self.flops_per_token / peak
                    self._g_mfu.set(mfu)
                    rec["mfu"] = mfu

        gnorm = getattr(result, "grad_norm", None)
        if gnorm is not None:
            self._g_gnorm.set(gnorm)
            rec["grad_norm"] = float(gnorm)
        loss = getattr(result, "loss_value", None)
        if loss is None and result is not None \
                and not hasattr(result, "params"):
            try:                          # plain step returning a loss
                loss = float(result)
            except (TypeError, ValueError):
                loss = None
        if loss is not None:
            self._g_loss.set(loss)
            rec["loss"] = float(loss)
        scale = getattr(result, "loss_scale_value", None)
        if scale is not None:
            self._g_scale.set(scale)
            rec["loss_scale"] = float(scale)
        if getattr(result, "skipped", False):
            kind = getattr(result, "anomaly", None) or "unknown"
            self._totals["anomalies"] += 1
            rec["anomalies"] = self._totals["anomalies"]
            rec["anomaly"] = kind
            self._c_anom.inc(kind=kind)
        if getattr(result, "rolled_back", False):
            self._totals["rollbacks"] += 1
            rec["rolled_back"] = True
            self._c_roll.inc()
        self.registry.event("train_step", **rec)

    @staticmethod
    def _straggler_ratio(dt: float) -> Optional[float]:
        """slowest/fastest rank step time via an all-gather over the
        default group; None without torch.distributed or at one rank (the
        skew gauge covers that case)."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() <= 1:
            return None
        all_dt = [None] * dist.get_world_size()
        dist.all_gather_object(all_dt, float(dt))
        lo = min(all_dt)
        return max(all_dt) / max(lo, 1e-12)

    def _resolve_peak(self) -> Optional[float]:
        if self.peak_flops == "calibrated":
            self.peak_flops = calibrated_peak_flops()
        return self.peak_flops

    # -- summaries -----------------------------------------------------------

    @property
    def stats(self) -> dict:
        """Host-side rollup, shape-compatible with
        ``GuardedTrainStep.stats`` on the shared keys."""
        t = self._totals
        mean = t["time_s"] / self.steps if self.steps else 0.0
        out = {"steps": self.steps, "skipped": t["anomalies"],
               "rollbacks": t["rollbacks"],
               "mean_step_time_s": mean,
               "tokens_per_s": (self.tokens_per_step / mean
                                if self.tokens_per_step and mean else None)}
        return out

    def report(self, guard=None, scaler=None) -> dict:
        """End-of-run summary.  Pass the guard to fold in its full
        per-kind counters; pass the port's ``LossScaler`` (which holds its
        own state, the JAX ``scaler_state``) to fold in
        ``LossScaler.stats()`` (a few scalar reads, at report time
        only)."""
        out = dict(self.stats)
        if guard is not None:
            out["guard"] = dict(guard.stats)
        if scaler is not None:
            out["scaler"] = scaler.stats()
        return out

    def close(self) -> None:
        self.registry.close()
