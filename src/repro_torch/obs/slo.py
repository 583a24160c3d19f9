"""Declarative SLO objectives with multi-window error-budget burn rates.

A copy of ``repro/obs/slo.py``; the port imports nothing of the
reference.

An :class:`Objective` states what fraction of requests may be *bad*
(the error budget) and how badness is measured:

* ``kind="quantile"`` — an observation of histogram ``metric`` is bad
  when it exceeds ``threshold`` (e.g. per-request latency above the
  SLO).  Bad fraction = violations / observations in the window.
* ``kind="ratio"`` — bad fraction = windowed increment of counter
  ``metric`` over windowed increment of counter ``total`` (e.g.
  ``node_drops`` / ``node_queries``).

The **burn rate** of a window is ``bad_fraction / budget`` — how many
times faster than sustainable the error budget is being spent.  An
objective FIREs only when *every* configured window burns at or above
its threshold (the classic short-AND-long multi-window rule: the short
window reacts fast, the long window keeps one bad slot from paging),
and returns to OK after the *shortest* window's burn stays below 1.0
for ``clear_evals`` consecutive evaluations (hysteresis).

:class:`SLOMonitor` evaluates a set of objectives against a
``TimeSeriesStore`` and exposes ``firing()`` / ``health()`` — that
verdict is what ``ClusterRuntime`` feeds back into inter-node routing
(capacity penalty for firing nodes) and into ``ContinuousQueue``
admission (shed hint), and what the ``/health`` endpoint serves.

``node_objectives()`` builds the default per-node objective set
(ttft_p95, latency_p99, drop rate, shed rate, KV-pool exhaustion rate)
against the metric names ``cluster/node.py`` pushes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import metric_key
from repro_torch.obs.timeseries import TimeSeriesStore

OK = "OK"
FIRING = "FIRING"

# (window seconds, burn-rate threshold) — short window must burn hotter
DEFAULT_WINDOWS = ((10.0, 2.0), (60.0, 1.0))


@dataclass
class Objective:
    """One SLO statement, e.g. 'p99 latency under the SLO, 1% budget'."""
    name: str
    kind: str                      # "quantile" | "ratio"
    metric: str                    # histogram key | numerator counter key
    threshold: float = 0.0         # per-observation bound (quantile kind)
    budget: float = 0.05           # allowed bad fraction of the window
    total: str = ""                # denominator counter key (ratio kind)
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS
    min_count: int = 4             # observations needed before judging

    def __post_init__(self):
        if self.kind not in ("quantile", "ratio"):
            raise ValueError(f"kind={self.kind!r} (quantile|ratio)")
        if self.kind == "ratio" and not self.total:
            raise ValueError(f"objective {self.name!r}: ratio kind needs "
                             "a total= denominator counter")
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(f"objective {self.name!r}: budget must be "
                             f"in (0, 1], got {self.budget}")

    def burn(self, store: TimeSeriesStore, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Error-budget burn rate over one window, or None when there
        is not enough data to judge."""
        if self.kind == "quantile":
            buf = store._obs.get(self.metric)
            if not buf:
                return None
            t_now = buf[-1][0] if now is None else float(now)
            xs = [v for t, v in buf if t >= t_now - window_s]
            if len(xs) < self.min_count:
                return None
            bad = sum(1 for v in xs if v > self.threshold) / len(xs)
            return bad / self.budget
        total = store.increment(self.total, window_s, now)
        if total < self.min_count:
            return None
        bad = store.increment(self.metric, window_s, now) / total
        return bad / self.budget


@dataclass
class ObjectiveState:
    status: str = OK
    burns: Dict[float, Optional[float]] = field(default_factory=dict)
    since: float = 0.0             # time of the last transition
    transitions: int = 0           # OK->FIRING edges seen
    _ok_streak: int = 0


class SLOMonitor:
    """FIRING/OK state machine over a set of objectives."""

    def __init__(self, store: TimeSeriesStore,
                 objectives: Sequence[Objective], *, clear_evals: int = 2):
        self.store = store
        self.objectives = {o.name: o for o in objectives}
        self.clear_evals = int(clear_evals)
        self.states: Dict[str, ObjectiveState] = {
            name: ObjectiveState() for name in self.objectives}

    def evaluate(self, now: Optional[float] = None
                 ) -> Dict[str, ObjectiveState]:
        """Recompute every objective's burn rates and step its state
        machine.  Call once per scheduling slot, after ``store.sample()``."""
        t = time.monotonic() if now is None else float(now)
        for name, obj in self.objectives.items():
            st = self.states[name]
            # anchor every window at the evaluation time, not at the
            # last observation: a node routing is avoiding must have its
            # stale bad observations age OUT of the window to recover
            burns = {w: obj.burn(self.store, w, now=t)
                     for w, _ in obj.windows}
            st.burns = burns
            over = [burns[w] is not None and burns[w] >= thresh
                    for w, thresh in obj.windows]
            if st.status == OK:
                if over and all(over):
                    st.status = FIRING
                    st.since = t
                    st.transitions += 1
                    st._ok_streak = 0
            else:
                short_w = min(w for w, _ in obj.windows)
                b = burns.get(short_w)
                # no data in the short window counts as recovery: the
                # budget is not burning while no requests arrive
                if b is None or b < 1.0:
                    st._ok_streak += 1
                    if st._ok_streak >= self.clear_evals:
                        st.status = OK
                        st.since = t
                        st._ok_streak = 0
                else:
                    st._ok_streak = 0
        return self.states

    # ------------------------------------------------------------ verdicts

    def firing(self) -> List[str]:
        return [n for n, s in self.states.items() if s.status == FIRING]

    def ok(self) -> bool:
        return not self.firing()

    def health(self) -> Dict[str, object]:
        """JSON-ready verdict for the ``/health`` endpoint."""
        objectives = {}
        for name, st in self.states.items():
            obj = self.objectives[name]
            objectives[name] = {
                "status": st.status,
                "budget": obj.budget,
                "burns": {f"{w:g}s": (None if b is None else round(b, 4))
                          for w, b in st.burns.items()},
                "transitions": st.transitions,
            }
        return {"status": "ok" if self.ok() else "firing",
                "firing": self.firing(), "objectives": objectives}


def node_objectives(node_id, slo_s: float, *,
                    windows: Tuple[Tuple[float, float], ...]
                    = DEFAULT_WINDOWS,
                    ttft_frac: float = 0.5,
                    drop_budget: float = 0.05,
                    shed_budget: float = 0.20,
                    exhaustion_budget: float = 0.25) -> List[Objective]:
    """The default per-node objective set, keyed to the metrics
    ``cluster/node.py`` pushes each slot."""
    n = str(node_id)
    queries = metric_key("node_queries", node=n)
    return [
        Objective("ttft_p95", "quantile",
                  metric_key("node_ttft_s", node=n),
                  threshold=ttft_frac * slo_s, budget=0.05,
                  windows=windows),
        Objective("latency_p99", "quantile",
                  metric_key("node_latency_s", node=n),
                  threshold=slo_s, budget=0.01, windows=windows),
        Objective("drop_rate", "ratio",
                  metric_key("node_drops", node=n), total=queries,
                  budget=drop_budget, windows=windows),
        Objective("shed_rate", "ratio",
                  metric_key("node_shed", node=n), total=queries,
                  budget=shed_budget, windows=windows),
        Objective("kv_exhaustion", "ratio",
                  metric_key("node_kv_exhaustions", node=n), total=queries,
                  budget=exhaustion_budget, windows=windows),
    ]
