"""Simulated collaborative edge cluster (paper §V testbed), and the
query and result records that the simulated and live paths share.

A copy of ``repro/core/cluster.py``: numpy and float64, the same
arithmetic in the same order and the same generator draws, so results
equal the reference's bit for bit (the port imports nothing of it).

Four heterogeneous nodes (two 1-GPU, two 2-GPU), each hosting one model
series (LLaMA / Qwen / Falcon pools) and a private multi-domain corpus.
Execution is driven by the calibrated latency/quality oracles
(latency_model.py / quality_model.py); the live path
(``repro_torch.cluster.node.LiveEdgeNode``) plugs the same interfaces
with real models.

Per-slot node execution:
  1. intra-node scheduler picks deployment/(p,R) for its assigned load,
  2. the pool manager applies the transition (real TL_k, Eq. 24),
  3. queries are apportioned to models by p (largest remainder),
  4. per GPU, makespan = Σ_m oracle_latency(q_m, R_m) + TL_k; if it
     exceeds the budget the overflow fraction of queries is DROPPED
     (quality 0 — the paper's invalid-query rule),
  5. completed queries realize quality = Q_m^base · match(domain, node).

The simulator is host numpy throughout; the only device work on its path
is the online identifier's (``core.identifier``).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.edge_pool import PAPER_TESTBED, pool_for_family
from repro_torch.core.inter_node import CapacityFunction, profile_capacity
from repro_torch.core.intra_node import Allocation, IntraNodeScheduler
from repro_torch.core.latency_model import LatencyOracle, fit_quadratic
from repro_torch.core.quality_model import (QualityOracle,
                                            static_open_book_quality)
from repro_torch.serving.pool import ModelPoolManager


@dataclass
class Query:
    domain: int
    embedding: np.ndarray
    qid: int = 0
    # live-path payload (empty for the oracle-driven simulator)
    question: str = ""
    reference: str = ""


@dataclass
class QueryResult:
    qid: int
    node: int
    model: str
    quality: float
    dropped: bool
    # live-path measurements (0/"" for the oracle-driven simulator)
    latency_s: float = 0.0
    answer: str = ""


def _apportion(n: int, weights: np.ndarray) -> np.ndarray:
    """Largest-remainder apportionment of n items by weights."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    if w.sum() <= 1e-12 or n == 0:
        out = np.zeros(len(w), np.int64)
        return out
    quota = w / w.sum() * n
    base = np.floor(quota).astype(np.int64)
    rem = n - base.sum()
    order = np.argsort(-(quota - base))
    base[order[:rem]] += 1
    return base


class EdgeNode:
    def __init__(self, node_id: int, family: str, num_gpus: int,
                 quality_oracle: QualityOracle,
                 latency_oracle: Optional[LatencyOracle] = None,
                 *, search_time_s: float = 0.15, seed: int = 0):
        self.node_id = node_id
        self.family = family
        self.num_gpus = num_gpus
        self.pool = pool_for_family(family)
        self.qual = quality_oracle
        self.lat = latency_oracle or LatencyOracle(seed=seed)
        self.search_time = search_time_s          # TS_n
        self.mgr = ModelPoolManager(self.pool, num_gpus)
        # offline phases: latency fits (Table I) + open-book Q_mn
        self.predictors = {s.name: fit_quadratic(self.lat, s, seed=seed + 1)
                           for s in self.pool}
        self.Q_mn = static_open_book_quality(quality_oracle, self.pool,
                                             node_id)
        self.scheduler = IntraNodeScheduler(
            node_id, self.pool, num_gpus, self.predictors, self.Q_mn,
            self.mgr)
        self.capacity: Optional[CapacityFunction] = None
        self._rng = np.random.default_rng(seed + 17)

    # ------------------------------------------------------------ execution

    def _execute(self, queries: Sequence[Query], alloc: Allocation,
                 budget: float, tl: List[float]) -> List[QueryResult]:
        keys = list(alloc.p.keys())
        counts = _apportion(len(queries),
                            np.array([alloc.p[k] for k in keys]))
        # drop mass never assigned to any model (Σp < 1 under overload)
        assigned = counts.sum()
        results: List[QueryResult] = []
        order = self._rng.permutation(len(queries))
        pos = 0
        per_gpu_time = [tl[k] if k < len(tl) else 0.0
                        for k in range(self.num_gpus)]
        slices: List[Tuple[Tuple[str, int], List[Query]]] = []
        for key, cnt in zip(keys, counts):
            qs = [queries[order[pos + j]] for j in range(cnt)]
            pos += cnt
            slices.append((key, qs))
            m, k = key
            spec = self.mgr.specs[m]
            per_gpu_time[k] += float(self.lat.latency(
                spec, len(qs), alloc.R[key]))
        # completion fraction per GPU
        frac = [1.0 if per_gpu_time[k] <= budget + self.search_time * 0 else
                max(0.0, (budget) / max(per_gpu_time[k], 1e-9))
                for k in range(self.num_gpus)]
        for (m, k), qs in slices:
            spec = self.mgr.specs[m]
            n_ok = int(np.floor(frac[k] * len(qs)))
            for j, q in enumerate(qs):
                if j < n_ok:
                    results.append(QueryResult(
                        q.qid, self.node_id, m,
                        self.qual.realized(spec, q.domain, self.node_id),
                        False))
                else:
                    results.append(QueryResult(q.qid, self.node_id, m,
                                               0.0, True))
        # unassigned overflow queries are dropped
        for j in range(pos, len(queries)):
            results.append(QueryResult(queries[order[j]].qid, self.node_id,
                                       "-", 0.0, True))
        return results

    def process_slot(self, queries: Sequence[Query], slo_s: float,
                     scheduler=None) -> List[QueryResult]:
        """Full intra-node step: schedule -> reconfigure -> execute."""
        if not queries:
            return []
        budget = slo_s - self.search_time
        sched = scheduler or self.scheduler
        alloc = sched.schedule(len(queries), budget)
        if not alloc.p:
            return [QueryResult(q.qid, self.node_id, "-", 0.0, True)
                    for q in queries]
        report = self.mgr.apply(alloc.r_alloc())
        return self._execute(queries, alloc, budget, report.tl_per_gpu)

    # ------------------------------------------------------------ profiling

    def burst_drop_rate(self, n_queries: int, slo_s: float) -> float:
        """Dry-run a burst (steady-state: no reconfig cost, no mutation)."""
        budget = slo_s - self.search_time
        mgr_backup = copy.deepcopy(self.mgr.R)
        alloc = self.scheduler.schedule(n_queries, budget)
        self.mgr.R = mgr_backup
        if not alloc.p:
            return 1.0
        dummy = [Query(0, np.zeros(1), i) for i in range(n_queries)]
        res = self._execute(dummy, alloc, budget,
                            [0.0] * self.num_gpus)
        return sum(r.dropped for r in res) / max(len(res), 1)

    def profile(self, levels=tuple(range(5, 61, 5))) -> CapacityFunction:
        self.capacity = profile_capacity(self.burst_drop_rate, levels)
        return self.capacity


def make_paper_testbed(n_domains: int = 6, *, primary_share: float = 0.6,
                       overlap: float = 0.4, seed: int = 0
                       ) -> Tuple[List[EdgeNode], QualityOracle, np.ndarray]:
    """Four-node cluster with §II-style corpora: each node is primary for
    1-2 domains (60% share) with the rest spread across other domains."""
    rng = np.random.default_rng(seed)
    n_nodes = len(PAPER_TESTBED)
    w = np.zeros((n_nodes, n_domains))
    for n in range(n_nodes):
        primaries = [(2 * n) % n_domains, (2 * n + 1) % n_domains]
        w[n, primaries] = primary_share / len(primaries)
        others = [d for d in range(n_domains) if d not in primaries]
        w[n, others] = (1 - primary_share) / len(others)
    # controlled cross-node overlap: blend towards uniform
    w = (1 - overlap * 0.5) * w + overlap * 0.5 / n_domains
    qual = QualityOracle(w, seed=seed)
    nodes = [EdgeNode(i, fam, g, qual, LatencyOracle(seed=seed + i),
                      seed=seed + 100 * i)
             for i, (fam, g) in enumerate(PAPER_TESTBED)]
    return nodes, qual, w
