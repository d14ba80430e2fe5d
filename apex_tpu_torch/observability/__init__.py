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
  :class:`FlightRecorder` black box.

``anatomy``, ``comms``, ``costmodel`` and ``train_monitor`` are not ported
yet.
"""

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

__all__ = ["BurnWindow", "Counter", "FleetCollector", "FlightRecorder",
           "Gauge", "Histogram", "MetricsRegistry", "RequestRecord",
           "RequestTracer", "RollingPercentiles", "SLOMonitor", "SLOTarget",
           "TraceContext", "Tracer", "check_flows", "default_tracer",
           "emit_flow", "replay_jsonl", "span"]
