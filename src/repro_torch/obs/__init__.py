"""Observability of the port: the metrics registry, its time series and
the SLO monitors that feed the cluster runtime (copies of
``repro/obs/{metrics,timeseries,slo}.py``).  Span tracing, the flight
recorder and the exposition server are not ported yet."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, enable_metrics,
                                     metric_key, metrics_enabled,
                                     percentile, registry)
from repro_torch.obs.slo import (DEFAULT_WINDOWS, FIRING, OK,  # noqa: F401
                                 Objective, SLOMonitor, node_objectives)
from repro_torch.obs.timeseries import TimeSeriesStore  # noqa: F401
