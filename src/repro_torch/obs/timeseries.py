"""Time-series rollups over the metrics registry.

A copy of ``repro/obs/timeseries.py``; the port imports nothing of the
reference.

``MetricsRegistry.snapshot()`` is a point-in-time freeze; this module
adds the *time* axis.  A ``TimeSeriesStore`` periodically ``sample()``s
the registry into a bounded ring of ``(t, snapshot)`` points and, for
histograms, pulls the observations that arrived since the previous
sample into per-key windowed deques.  Derived views are then true
windowed statistics, not lifetime aggregates:

  ``rate(key)``      counter increments per second over the window
  ``summary(key)``   count/mean/p50/p95/p99/max/min of the *window's*
                     histogram observations (the registry's own
                     percentiles are reservoir-lifetime)
  ``ewma(key)``      exponentially-weighted moving average of a gauge
  ``rollup()``       all of the above for every known key

Everything takes an explicit ``t``/``now`` (seconds, any monotonic
clock) so tests and replays can drive synthetic timelines; live
callers just omit it and get ``time.monotonic()``.  The store is the
substrate the SLO burn-rate monitors (``obs/slo.py``) evaluate against
(and the reference's live dashboard, not ported yet).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import (Gauge, Histogram, MetricsRegistry,
                               percentile, registry)

# per-key bound on retained (t, value) histogram observations — matches
# the registry's reservoir so a window can never need more
_OBS_CAP = 4096


class TimeSeriesStore:
    """Bounded ring of registry snapshots + windowed derivations."""

    def __init__(self, reg: Optional[MetricsRegistry] = None, *,
                 window_s: float = 60.0, max_points: int = 512,
                 ewma_alpha: float = 0.3):
        self.reg = reg if reg is not None else registry()
        self.window_s = float(window_s)
        self.max_points = int(max_points)
        self.ewma_alpha = float(ewma_alpha)
        self._points: deque = deque(maxlen=self.max_points)  # (t, snap)
        self._obs: Dict[str, deque] = {}      # hist key -> (t, value)
        self._seen: Dict[str, int] = {}       # hist key -> count at pull
        self._ewma: Dict[str, float] = {}     # gauge key -> ewma

    # ------------------------------------------------------------ sampling

    def sample(self, t: Optional[float] = None) -> Dict[str, object]:
        """Freeze the registry into the ring; pull new histogram
        observations and fold gauges into their EWMAs.  Returns the
        snapshot taken."""
        t = time.monotonic() if t is None else float(t)
        snap = self.reg.snapshot()
        a = self.ewma_alpha
        for key, m in self.reg.instruments():
            if isinstance(m, Histogram):
                new = m.count - self._seen.get(key, 0)
                self._seen[key] = m.count
                if new > 0:
                    buf = self._obs.setdefault(key, deque(maxlen=_OBS_CAP))
                    for v in m.recent(new):
                        buf.append((t, v))
            elif isinstance(m, Gauge):
                prev = self._ewma.get(key)
                self._ewma[key] = m.value if prev is None \
                    else a * m.value + (1.0 - a) * prev
        self._points.append((t, snap))
        self._evict(t)
        return snap

    def _evict(self, now: float) -> None:
        cut = now - self.window_s
        for buf in self._obs.values():
            while buf and buf[0][0] < cut:
                buf.popleft()

    # ---------------------------------------------------------- raw access

    def __len__(self) -> int:
        return len(self._points)

    def latest(self) -> Tuple[Optional[float], Dict[str, object]]:
        return self._points[-1] if self._points else (None, {})

    def series(self, key: str, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """(t, scalar) points for a counter/gauge key inside the window
        (histogram keys yield their cumulative count)."""
        pts = self._window_points(window_s, now)
        out = []
        for t, snap in pts:
            if key in snap:
                v = snap[key]
                out.append((t, float(v["count"]) if isinstance(v, dict)
                            else float(v)))
        return out

    def _window_points(self, window_s: Optional[float],
                       now: Optional[float]) -> List[Tuple[float, Dict]]:
        if not self._points:
            return []
        w = self.window_s if window_s is None else float(window_s)
        t_now = self._points[-1][0] if now is None else float(now)
        cut = t_now - w
        return [(t, s) for t, s in self._points if t >= cut]

    # --------------------------------------------------------- derivations

    def rate(self, key: str, window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        """Counter increments / second across the window's samples
        (first-to-last inside the window; 0.0 with fewer than two
        points).  Histogram keys rate their cumulative ``count``."""
        pts = self.series(key, window_s, now)
        if len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        dt = t1 - t0
        return (v1 - v0) / dt if dt > 0 else 0.0

    def increment(self, key: str, window_s: Optional[float] = None,
                  now: Optional[float] = None) -> float:
        """Counter increase across the window (0.0 with < 2 points)."""
        pts = self.series(key, window_s, now)
        if len(pts) < 2:
            return 0.0
        return pts[-1][1] - pts[0][1]

    def summary(self, key: str, window_s: Optional[float] = None,
                now: Optional[float] = None) -> Dict[str, float]:
        """Windowed histogram summary over the *individual*
        observations pulled at sample time (empty -> zeros)."""
        buf = self._obs.get(key)
        if not buf:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0, "max": 0.0, "min": 0.0}
        w = self.window_s if window_s is None else float(window_s)
        t_now = buf[-1][0] if now is None else float(now)
        xs = [v for t, v in buf if t >= t_now - w]
        if not xs:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0, "max": 0.0, "min": 0.0}
        return {"count": len(xs), "mean": sum(xs) / len(xs),
                "p50": percentile(xs, 50), "p95": percentile(xs, 95),
                "p99": percentile(xs, 99), "max": max(xs), "min": min(xs)}

    def ewma(self, key: str, default: float = 0.0) -> float:
        """Exponentially-weighted moving average of a gauge (folded at
        each ``sample()``; ``ewma_alpha`` weights the newest value)."""
        return self._ewma.get(key, default)

    def rollup(self, window_s: Optional[float] = None
               ) -> Dict[str, Dict[str, float]]:
        """Everything derived, keyed like the registry: counters get
        ``{rate, increment}``, gauges ``{last, ewma}``, histograms the
        windowed summary plus an observation ``rate``."""
        t, snap = self.latest()
        if t is None:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        kinds = {k: m for k, m in self.reg.instruments()}
        for key, val in snap.items():
            if isinstance(val, dict):
                d = self.summary(key, window_s, now=t)
                d["rate"] = self.rate(key, window_s, now=t)
                out[key] = d
            elif isinstance(kinds.get(key), Gauge):
                out[key] = {"last": float(val), "ewma": self.ewma(key)}
            else:
                out[key] = {"rate": self.rate(key, window_s, now=t),
                            "increment": self.increment(key, window_s,
                                                        now=t)}
        return out
