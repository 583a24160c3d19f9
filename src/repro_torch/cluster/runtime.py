"""Cluster slot loop over live nodes: the Coordinator with measurements.

The port of ``repro/cluster/runtime.py``.

``ClusterRuntime`` adapts ``core.coordinator.Coordinator`` to measured
execution: the routing layer (PPO identify -> Algorithm 1 with
capacities profiled from real throughput) is inherited unchanged, while
the per-slot metrics are extended with measured latency percentiles and
token counts, and the PPO feedback consumes *measured* composite
quality (ROUGE-L + BERTScore against the reference answer) instead of
oracle draws.  Works with any ``SchedulableNode``, including the
simulated ``core.cluster.EdgeNode`` (whose latencies are 0.0).

When metrics are enabled (``obs.enable_metrics`` or live tracing) the
runtime also closes the telemetry loop the paper calls "synergizing
historical performance analytics with real-time resource thresholds":
after every slot it samples the registry into a ``TimeSeriesStore`` and
evaluates per-node ``SLOMonitor``s (ttft/latency/drop/shed/KV-pool
burn rates against ``slo_s``).  A FIRING node is penalized in the very
routing Algorithm 1 runs — its capacity is scaled by ``slo_penalty``
so overflow spills to healthy nodes — and handed a shed hint so its
``ContinuousQueue`` drops the tail of its backlog instead of serving
it late.  ``--no-slo-feedback`` (``slo_feedback=False``) keeps the
monitors (so ``/health`` still reports the episode) but severs the
feedback into routing and admission, which is the ablation the docs
compare against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import Query
from repro_torch.core.coordinator import Coordinator, SlotMetrics
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.slo import DEFAULT_WINDOWS, SLOMonitor, node_objectives
from repro_torch.obs.timeseries import TimeSeriesStore


@dataclass
class ClusterSlotMetrics(SlotMetrics):
    latency_p50: float = 0.0
    latency_p95: float = 0.0
    latency_mean: float = 0.0
    load_imbalance: float = 0.0       # max node share / mean share
    ppo_updates: int = 0              # identifier updates so far
    slo_firing: int = 0               # nodes with a FIRING objective


class ClusterRuntime(Coordinator):
    """Slot loop: encode -> identify -> inter-node schedule -> dispatch
    to live nodes -> collect measured results -> PPO feedback, with the
    SLO monitors feeding back into routing and admission."""

    def __init__(self, nodes, identifier, *, use_inter_node: bool = True,
                 seed: int = 0, node_schedulers=None,
                 slo_feedback: bool = True, slo_penalty: float = 0.25,
                 slo_windows: Tuple[Tuple[float, float], ...]
                 = DEFAULT_WINDOWS,
                 shed_fraction: float = 0.25,
                 store: Optional[TimeSeriesStore] = None):
        super().__init__(nodes, identifier, use_inter_node=use_inter_node,
                         seed=seed, node_schedulers=node_schedulers)
        self.slo_feedback = bool(slo_feedback)
        self.slo_penalty = float(slo_penalty)
        self.slo_windows = tuple(slo_windows)
        self.shed_fraction = float(shed_fraction)
        self.store = store
        self.monitors: Dict[object, SLOMonitor] = {}

    def initialize(self, calib_queries: int = 0) -> None:
        """Profile every node's capacity from measured throughput (also
        warms each engine's jit cache before the first slot)."""
        for node in self.nodes:
            node.profile(calib_queries)

    # ----------------------------------------------------------- telemetry

    def _node_id(self, n: int):
        return getattr(self.nodes[n], "node_id", n)

    def _ensure_telemetry(self, slo_s: float) -> None:
        """Lazily build the store + one monitor per node the first slot
        that runs with metrics enabled (the SLO windows need ``slo_s``,
        which only arrives at run_slot time)."""
        if self.monitors:
            return
        if self.store is None:
            self.store = TimeSeriesStore(
                window_s=max(w for w, _ in self.slo_windows))
        for n in range(len(self.nodes)):
            nid = self._node_id(n)
            self.monitors[nid] = SLOMonitor(
                self.store, node_objectives(nid, slo_s,
                                            windows=self.slo_windows))

    def _capacities(self, slo_s: float) -> np.ndarray:
        """Profiled capacities, with FIRING nodes penalized so
        Algorithm 1 spills their overflow to healthy nodes."""
        caps = super()._capacities(slo_s)
        if self.slo_feedback and self.monitors:
            for n in range(len(self.nodes)):
                mon = self.monitors.get(self._node_id(n))
                if mon is not None and mon.firing():
                    caps[n] *= self.slo_penalty
        return caps

    def _apply_shed_hints(self) -> None:
        """Hand each FIRING node its shed fraction before dispatch (the
        node forwards it to its ContinuousQueue per slot)."""
        for n in range(len(self.nodes)):
            node = self.nodes[n]
            if not hasattr(node, "shed_fraction"):
                continue
            mon = self.monitors.get(self._node_id(n))
            node.shed_fraction = self.shed_fraction \
                if (self.slo_feedback and mon is not None
                    and mon.firing()) else 0.0

    def _evaluate_slos(self) -> int:
        """Sample the registry, step every monitor, publish per-node
        firing gauges.  Returns the number of firing nodes."""
        self.store.sample()
        reg = obs_metrics.registry()
        firing_nodes = 0
        for nid, mon in self.monitors.items():
            mon.evaluate()
            firing = bool(mon.firing())
            firing_nodes += int(firing)
            reg.gauge("node_slo_firing", node=str(nid)).set(float(firing))
        return firing_nodes

    def close(self) -> None:
        """Drain and release every node's standing session (no-op for
        per-slot queue kinds).  Call after the last slot — a standing
        node may still hold mid-decode rows and KV blocks."""
        for node in self.nodes:
            close = getattr(node, "close", None)
            if callable(close):
                close()

    def health(self) -> Dict[str, object]:
        """Cluster verdict for the ``/health`` endpoint: degraded while
        any node has a FIRING objective."""
        nodes = {str(nid): mon.health()
                 for nid, mon in self.monitors.items()}
        firing = sorted(nid for nid, h in nodes.items()
                        if h["status"] != "ok")
        return {"status": "ok" if not firing else "degraded",
                "slo_feedback": self.slo_feedback,
                "firing_nodes": firing, "nodes": nodes}

    # ------------------------------------------------------------ slot loop

    def run_slot(self, queries: Sequence[Query], slo_s: float
                 ) -> ClusterSlotMetrics:
        if not queries:
            return ClusterSlotMetrics(0.0, 0.0, np.zeros(len(self.nodes)),
                                      0)
        telemetry = obs_metrics.metrics_enabled()
        if telemetry:
            self._ensure_telemetry(slo_s)
            self._apply_shed_hints()
        # measured-quality feedback closes the PPO loop (dropped -> 0);
        # the shared pipeline also carries the per-query request spans
        props, results, _ = self._slot_pipeline(queries, slo_s)
        slo_firing = self._evaluate_slos() if telemetry else 0
        lat = np.array([r.latency_s for r in results])
        served = [r.quality for r in results if not r.dropped]
        m = ClusterSlotMetrics(
            quality_mean=float(np.mean(served)) if served else 0.0,
            drop_rate=float(np.mean([r.dropped for r in results])),
            per_node_load=props,
            n_queries=len(queries),
            latency_p50=float(np.percentile(lat, 50)),
            latency_p95=float(np.percentile(lat, 95)),
            latency_mean=float(lat.mean()),
            load_imbalance=float(props.max() * len(self.nodes)),
            ppo_updates=getattr(self.identifier, "updates_done", 0),
            slo_firing=slo_firing,
        )
        self.history.append(m)
        return m
