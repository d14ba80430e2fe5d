"""apex_tpu_torch.observability — port of ``apex_tpu.observability``: the
serving telemetry.

* :mod:`~apex_tpu_torch.observability.registry` — labeled
  Counter/Gauge/Histogram :class:`MetricsRegistry` with an append-only
  JSONL event stream and a Prometheus text-format snapshot;
* :mod:`~apex_tpu_torch.observability.spans` — host-side span tracing
  (:func:`span`) emitting Chrome trace-event JSON; a span also enters
  ``torch.profiler.record_function`` under the same name;
* :mod:`~apex_tpu_torch.observability.slo` — :class:`SLOMonitor`, rolling
  percentiles + declarative :class:`SLOTarget` s + multi-window burn-rate
  alerts;
* :mod:`~apex_tpu_torch.observability.request_trace` —
  :class:`RequestTracer`, per-request lifecycle spans in the serving
  engine;
* :mod:`~apex_tpu_torch.observability.fleetobs` — :class:`TraceContext`
  causal propagation across replicas, :class:`FleetCollector` merged
  timelines, :func:`check_flows` trace continuity, and the
  :class:`FlightRecorder` black box;
* :mod:`~apex_tpu_torch.observability.train_monitor` —
  :class:`TrainingMonitor`, wrapping a train step (notably
  :class:`~apex_tpu_torch.resilience.GuardedTrainStep`) into step-time /
  tokens-s / MFU / grad-norm / loss-scale / anomaly series, with
  :func:`calibrated_peak_flops`;
* :mod:`~apex_tpu_torch.observability.comms` — per-collective byte
  accounting of one call (:func:`collective_stats`) from the ``c10d``
  ops it dispatches;
* :mod:`~apex_tpu_torch.observability.costmodel` — the collective probe
  over :mod:`torch.distributed` (:func:`probe_collectives`) and the fitted
  alpha-beta ring :class:`CostModel` (``tools/comms_probe_torch.py`` is
  the CLI).

* :mod:`~apex_tpu_torch.observability.anatomy` — measured critical-path
  attribution of the MPMD engine's traced steps (:func:`reconstruct`,
  :func:`attribute`, :func:`diff_timelines` against
  :func:`~apex_tpu_torch.mpmd.schedule.simulate`;
  ``tools/step_anatomy_torch.py`` is the CLI).

``hlo_collective_stats`` has no counterpart (there is no HLO).
"""

from apex_tpu_torch.observability.anatomy import (MeasuredTimeline, attribute,
                                                  diff_timelines, reconstruct,
                                                  synthesize_events)
from apex_tpu_torch.observability.comms import (collective_stats,
                                                format_stats, wire_bytes)
from apex_tpu_torch.observability.costmodel import (CostModel, Measurement,
                                                    fit_cost_model,
                                                    load_profile,
                                                    probe_collectives)
from apex_tpu_torch.observability.fleetobs import (FleetCollector,
                                                   FlightRecorder,
                                                   TraceContext, check_flows,
                                                   emit_flow)
from apex_tpu_torch.observability.registry import (Counter, Gauge, Histogram,
                                                   MetricsRegistry,
                                                   replay_jsonl)
from apex_tpu_torch.observability.request_trace import (RequestRecord,
                                                        RequestTracer)
from apex_tpu_torch.observability.slo import (BurnWindow, RollingPercentiles,
                                              SLOMonitor, SLOTarget)
from apex_tpu_torch.observability.spans import Tracer, default_tracer, span
from apex_tpu_torch.observability.train_monitor import (TrainingMonitor,
                                                        calibrated_peak_flops)

__all__ = ["BurnWindow", "CostModel", "Counter", "FleetCollector",
           "FlightRecorder", "Gauge", "Histogram", "Measurement",
           "MeasuredTimeline", "attribute", "diff_timelines", "reconstruct",
           "synthesize_events",
           "MetricsRegistry", "RequestRecord", "RequestTracer",
           "RollingPercentiles", "SLOMonitor", "SLOTarget", "TraceContext",
           "Tracer", "TrainingMonitor", "calibrated_peak_flops",
           "check_flows", "collective_stats", "default_tracer", "emit_flow",
           "fit_cost_model", "format_stats", "load_profile",
           "probe_collectives", "replay_jsonl", "span", "wire_bytes"]
