"""Labelled counters / gauges / histograms with snapshot + delta.

A copy of ``repro/obs/metrics.py`` (the port imports nothing of the
reference).

The registry is always importable and cheap enough to leave on: every
instrument is a host-side scalar update at per-request or per-slot
granularity (never per decode step inside jitted code).  `snapshot()`
freezes the world to plain dicts; `delta(prev)` diffs two snapshots so
`cluster_serve --metrics-every` can print per-slot rollups without
resetting anything.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import get_tracer as _get_tracer

# reservoir bound per histogram: plenty for smoke/bench scale, and a
# hard cap on memory for million-query replays
_RESERVOIR = 4096

# metric pushes can be wanted without full span tracing (SLO feedback,
# /metrics exposition); either switch turns them on
_METRICS_ON = False


def enable_metrics(on: bool = True) -> None:
    """Turn metric pushes on without attaching a span recorder (the
    SLO/telemetry path needs the registry fed even when tracing is
    off)."""
    global _METRICS_ON
    _METRICS_ON = bool(on)


def metrics_enabled() -> bool:
    """True when instrumented call sites should push into the registry:
    either tracing is live or ``enable_metrics(True)`` was called."""
    return _METRICS_ON or _get_tracer().enabled


def percentile(xs: Sequence[float], q: float) -> float:
    """np.percentile that returns 0.0 (not IndexError) on empty input.

    The single shared implementation behind `ContinuousStats`,
    `QueueStats`, and every histogram summary here.
    """
    xs = np.asarray(list(xs), dtype=np.float64)
    if xs.size == 0:
        return 0.0
    return float(np.percentile(xs, q))


class Counter:
    """Monotonic count."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n
        return self


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)
        return self


class Histogram:
    """count/sum plus a bounded reservoir of recent observations.

    ``max``/``min`` are *running* extrema tracked outside the
    reservoir: after the 4096-entry buffer starts evicting, the
    percentiles are recent-window estimates but the extrema still
    cover every observation ever made."""
    __slots__ = ("count", "sum", "max", "min", "_buf")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self.min = 0.0
        self._buf = deque(maxlen=_RESERVOIR)

    def observe(self, v):
        v = float(v)
        if self.count:
            self.max = v if v > self.max else self.max
            self.min = v if v < self.min else self.min
        else:
            self.max = self.min = v
        self.count += 1
        self.sum += v
        self._buf.append(v)
        return self

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def recent(self, n: int) -> List[float]:
        """The last ``n`` observations still in the reservoir (fewer if
        the reservoir evicted them) — the time-series store's pull."""
        k = len(self._buf)
        if n >= k:
            return list(self._buf)
        return list(itertools.islice(self._buf, k - n, k))

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "p50": percentile(self._buf, 50),
                "p95": percentile(self._buf, 95),
                "p99": percentile(self._buf, 99),
                "max": self.max, "min": self.min}


def escape_label(value: object) -> str:
    """Escape ``\\``/``=``/``,``/``}`` in a label value so registry keys
    stay unambiguous (and Prometheus exposition lines stay parseable
    after `obs.export` unescapes them)."""
    s = str(value)
    if "\\" in s:
        s = s.replace("\\", "\\\\")
    for ch in ("=", ",", "}"):
        if ch in s:
            s = s.replace(ch, "\\" + ch)
    return s


def unescape_label(value: str) -> str:
    """Inverse of :func:`escape_label`."""
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            out.append(value[i + 1])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _key(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={escape_label(labels[k])}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def metric_key(name: str, **labels) -> str:
    """Public form of the registry's key encoding — SLO objectives and
    exposition use it so labeled lookups can never drift from the
    registry's own keys."""
    return _key(name, labels)


class MetricsRegistry:
    """get-or-create instruments keyed by (name, sorted labels)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name, labels):
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"{key} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict freeze: numbers for counters/gauges, summary
        dicts for histograms."""
        out = {}
        for key, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[key] = m.summary()
            else:
                out[key] = m.value
        return out

    def delta(self, prev: Optional[Dict[str, object]]) -> Dict[str, object]:
        """snapshot() diffed against a previous snapshot: counters and
        histogram count/sum become increments, gauges stay
        current-valued but are *suppressed when unchanged* (a hundred
        static per-node gauges would otherwise bloat every
        ``--metrics-every`` rollup).  Unchanged zero entries drop out."""
        cur = self.snapshot()
        prev = prev or {}
        out = {}
        for key, val in cur.items():
            old = prev.get(key)
            if isinstance(val, dict):
                d = dict(val)
                if isinstance(old, dict):
                    d["count"] = val["count"] - old.get("count", 0)
                    d["sum"] = val["sum"] - old.get("sum", 0.0)
                if d["count"]:
                    out[key] = d
            else:
                m = self._metrics[key]
                if isinstance(m, Counter):
                    dv = val - (old if isinstance(old, (int, float)) else 0)
                    if dv:
                        out[key] = dv
                elif old is None or val != old:  # gauge: only when moved
                    out[key] = val
        return out

    def instruments(self) -> List[Tuple[str, object]]:
        """(key, instrument) pairs — raw access for the time-series
        store, which needs histogram reservoirs, not just summaries."""
        return list(self._metrics.items())

    def reset(self):
        self._metrics.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY
