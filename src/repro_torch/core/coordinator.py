"""Global coordinator: the CoEdge-RAG slot loop (paper Fig. 4).

The port of ``repro/core/coordinator.py``.  Per slot: encode queries ->
online identifier -> probability vectors -> inter-node scheduling
(Algorithm 1, capacity-aware) -> per-node intra-node scheduling +
execution -> quality feedback -> PPO update.  With tracing on, each query's trace is rooted in a
``request`` span over the slot body, with ``identify`` and ``route``
inside it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import Query, QueryResult
from repro_torch.core.inter_node import inter_node_schedule
from repro_torch.core.protocols import QueryRouter, SchedulableNode
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclass
class SlotMetrics:
    quality_mean: float
    drop_rate: float
    per_node_load: np.ndarray
    n_queries: int


class Coordinator:
    """Drives any ``SchedulableNode`` sequence — the oracle-driven
    ``EdgeNode`` simulator here, or ``cluster.node.LiveEdgeNode`` via
    the ``ClusterRuntime`` subclass (same routing, measured execution).
    """

    def __init__(self, nodes: Sequence[SchedulableNode],
                 identifier: QueryRouter,
                 *, use_inter_node: bool = True, seed: int = 0,
                 node_schedulers: Optional[Dict[int, object]] = None):
        self.nodes = nodes
        self.identifier = identifier
        self.use_inter_node = use_inter_node
        self.node_schedulers = node_schedulers or {}
        self._rng = np.random.default_rng(seed)
        self.history: List[SlotMetrics] = []

    def initialize(self, levels=tuple(range(5, 61, 5))) -> None:
        """Offline capacity profiling (paper's initialization phase)."""
        for node in self.nodes:
            node.profile(levels)

    def _capacities(self, slo_s: float) -> np.ndarray:
        caps = []
        for node in self.nodes:
            caps.append(node.capacity(slo_s) if node.capacity else 1e9)
        return np.asarray(caps)

    def _route(self, probs: np.ndarray, slo_s: float):
        """Queries -> node assignment: capacity-aware Algorithm 1, or pure
        identifier sampling under the ``--no-inter-node`` ablation."""
        if self.use_inter_node:
            return inter_node_schedule(
                probs, self._capacities(slo_s), self._rng)
        cum = probs.cumsum(1)
        r = self._rng.random((len(probs), 1))
        assign = (r > cum).sum(1).clip(0, len(self.nodes) - 1)
        props = np.bincount(assign, minlength=len(self.nodes)) / len(probs)
        return assign, props

    def _dispatch(self, queries: Sequence[Query], assign: np.ndarray,
                  slo_s: float) -> List[QueryResult]:
        results: List[QueryResult] = []
        for n, node in enumerate(self.nodes):
            idx = np.where(assign == n)[0]
            results += node.process_slot(
                [queries[i] for i in idx], slo_s,
                scheduler=self.node_schedulers.get(n))
        return results

    def _feedback(self, embs: np.ndarray, assign: np.ndarray,
                  queries: Sequence[Query], results: Sequence[QueryResult]
                  ) -> np.ndarray:
        """Realized composite quality per query (dropped -> 0) into the
        identifier's buffer; triggers a PPO update when due."""
        by_qid = {r.qid: r for r in results}
        scores = np.array([by_qid[q.qid].quality for q in queries])
        self.identifier.feedback(embs, assign, scores)
        self.identifier.maybe_update()
        return scores

    def _slot_pipeline(self, queries: Sequence[Query], slo_s: float):
        """The shared (simulated + live) slot body, instrumented: one
        ``request`` root span per query wraps encode -> identify ->
        route -> dispatch -> feedback, so every downstream stage
        (retrieve, prefill, decode, ...) nests under each query's
        trace.  -> (props, results, scores)."""
        tr = obs_trace.get_tracer()
        traces = [obs_trace.query_trace(q.qid) for q in queries] \
            if tr.enabled else None
        embs = np.stack([q.embedding for q in queries])
        with tr.span("request", traces=traces, queries=len(queries),
                     slo_s=slo_s):
            with tr.span("identify", traces=traces):
                probs = self.identifier.identify(embs)
            with tr.span("route", traces=traces, nodes=len(self.nodes)):
                assign, props = self._route(probs, slo_s)
            results = self._dispatch(queries, assign, slo_s)
            scores = self._feedback(embs, assign, queries, results)
        if obs_metrics.metrics_enabled():
            self._push_metrics(props, scores, slo_s)
        return props, results, scores

    def _push_metrics(self, props: np.ndarray, scores: np.ndarray,
                      slo_s: float) -> None:
        """Slot-level rollup: PPO reward trajectory + per-node assigned
        load vs. profiled capacity (host-side, post-dispatch)."""
        reg = obs_metrics.registry()
        h = reg.histogram("ppo_reward")
        for s in scores:
            h.observe(float(s))
        reg.gauge("ppo_updates").set(
            getattr(self.identifier, "updates_done", 0))
        caps = self._capacities(slo_s)
        for n, node in enumerate(self.nodes):
            nid = str(getattr(node, "node_id", n))
            reg.gauge("node_assigned_share", node=nid).set(float(props[n]))
            reg.gauge("node_capacity_queries", node=nid).set(float(caps[n]))

    def run_slot(self, queries: Sequence[Query], slo_s: float
                 ) -> SlotMetrics:
        if not queries:
            return SlotMetrics(0.0, 0.0, np.zeros(len(self.nodes)), 0)
        props, results, _ = self._slot_pipeline(queries, slo_s)
        qual = float(np.mean([r.quality for r in results if not r.dropped])
                     ) if any(not r.dropped for r in results) else 0.0
        drop = float(np.mean([r.dropped for r in results]))
        m = SlotMetrics(qual, drop, props, len(queries))
        self.history.append(m)
        return m
