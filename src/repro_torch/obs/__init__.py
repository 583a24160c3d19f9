"""Observability of the port: tracing, metrics, time-series, SLOs,
exposition (copies of ``repro/obs``; the device profile is
``torch.profiler``).

Zero-dependency (numpy only) and off-hot-path by construction: every
instrument lives on the host side, never inside a kernel, and the
whole layer is a no-op until `enable()` attaches a recorder (span
tracing) or `enable_metrics()` flips the registry pushes on (the
lighter switch the SLO/telemetry path uses).

    rec = obs.enable()                # tracing on, events -> ring buffer
    ... serve traffic ...
    obs.disable()
    rec.export_jsonl("trace.jsonl")   # -> tools/trace_report.py

    obs.enable_metrics()              # registry pushes without tracing
    store = obs.TimeSeriesStore()     # windowed rates / percentiles
    mon = obs.SLOMonitor(store, obs.node_objectives(0, slo_s=1.5))
    srv = obs.TelemetryServer(metrics_fn=lambda: obs.to_prometheus(
        obs.registry().snapshot()), health_fn=mon.health).start()
"""
from repro_torch.obs.export import (TelemetryServer, parse_key,
                                    parse_prometheus, render_dashboard,
                                    to_prometheus)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, enable_metrics,
                                     escape_label, metric_key,
                                     metrics_enabled, percentile, registry,
                                     unescape_label)
from repro_torch.obs.recorder import (FlightRecorder, start_device_profile,
                                      stop_device_profile)
from repro_torch.obs.slo import (DEFAULT_WINDOWS, FIRING, OK, Objective,
                                 SLOMonitor, node_objectives)
from repro_torch.obs.timeseries import TimeSeriesStore
from repro_torch.obs.trace import (NULL_SPAN, Tracer, get_tracer,
                                   query_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentile",
    "registry", "metric_key", "escape_label", "unescape_label",
    "enable_metrics", "metrics_enabled", "FlightRecorder",
    "start_device_profile", "stop_device_profile", "NULL_SPAN", "Tracer",
    "get_tracer", "query_trace", "enable", "disable", "enabled",
    "TimeSeriesStore", "Objective", "SLOMonitor", "node_objectives",
    "DEFAULT_WINDOWS", "OK", "FIRING", "to_prometheus", "parse_prometheus",
    "parse_key", "TelemetryServer", "render_dashboard",
]


def enable(recorder=None, capacity=131072):
    """Turn tracing on. Returns the recorder events will land in."""
    rec = recorder if recorder is not None else FlightRecorder(capacity)
    tr = get_tracer()
    tr.recorder = rec
    tr.enabled = True
    return rec


def disable():
    """Turn tracing off (the fast path goes back to zero clock reads)."""
    tr = get_tracer()
    tr.enabled = False
    rec, tr.recorder = tr.recorder, None
    tr.reset()
    return rec


def enabled():
    return get_tracer().enabled
