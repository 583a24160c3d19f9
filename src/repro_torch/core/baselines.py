"""Baselines from the paper's evaluation.

A copy of ``repro/core/baselines.py``: numpy and float64, the same
arithmetic in the same order and the same generator draws, so results
equal the reference's bit for bit (the port imports nothing of it).

Query-allocation baselines (§V-B, Table II):
  Random  — semantic-blind uniform routing.
  Domain  — fixed primary-domain routing (motivation §II).
  MAB     — LinUCB contextual bandit over query embeddings.
  Oracle  — perfect corpus knowledge: route to argmax_n coverage.

Intra-node deployment baselines (§V-B, Table III):
  Small-Param / Mid-Param      — fixed single-class deployments.
  Mixed-Param.1                — small+mid per GPU, fixed p and R.
  Mixed-Param.2                — small+mid on single-GPU nodes; dual-GPU
                                 nodes give one GPU to small/mid and the
                                 other to the large model.
Queries are split evenly among deployed models (the paper's rule).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.edge_pool import EdgeModelSpec
from repro_torch.core.cluster import EdgeNode
from repro_torch.core.intra_node import Allocation
from repro_torch.core.quality_model import QualityOracle


# --------------------------------------------------------------------------
# inter-node allocation baselines


class RandomAllocator:
    def __init__(self, n_nodes: int, seed: int = 0):
        self.n = n_nodes
        self._rng = np.random.default_rng(seed)

    def identify(self, embeddings: np.ndarray) -> np.ndarray:
        return np.full((len(embeddings), self.n), 1.0 / self.n)

    def feedback(self, *a, **k):
        pass

    def maybe_update(self):
        return None


class DomainAllocator:
    """Routes to the node whose PRIMARY domain matches (no latent
    cross-domain knowledge — the paper's suboptimal static heuristic)."""

    def __init__(self, primary_of_domain: Dict[int, int], n_nodes: int):
        self.primary = primary_of_domain
        self.n = n_nodes

    def probs_for_domains(self, domains: Sequence[int]) -> np.ndarray:
        p = np.full((len(domains), self.n), 1e-6)
        for i, d in enumerate(domains):
            p[i, self.primary[d]] = 1.0
        return p / p.sum(1, keepdims=True)


class OracleAllocator:
    """Perfect knowledge of corpus coverage (paper's Oracle)."""

    def __init__(self, qual: QualityOracle):
        self.qual = qual

    def probs_for_domains(self, domains: Sequence[int]) -> np.ndarray:
        n = self.qual.w.shape[0]
        p = np.full((len(domains), n), 1e-6)
        for i, d in enumerate(domains):
            p[i, self.qual.best_node(d)] = 1.0
        return p / p.sum(1, keepdims=True)


class LinUCBAllocator:
    """LinUCB contextual bandit [Li et al. 2010] — one ridge model per
    node-arm over query embeddings."""

    def __init__(self, embed_dim: int, n_nodes: int, alpha: float = 0.5,
                 seed: int = 0):
        self.n = n_nodes
        self.d = embed_dim
        self.alpha = alpha
        self.A = [np.eye(embed_dim) for _ in range(n_nodes)]
        self.Ainv = [np.eye(embed_dim) for _ in range(n_nodes)]
        self.b = [np.zeros(embed_dim) for _ in range(n_nodes)]
        self._rng = np.random.default_rng(seed)

    def identify(self, embeddings: np.ndarray) -> np.ndarray:
        """UCB scores -> (near-)greedy probability vectors."""
        E = np.asarray(embeddings, np.float64)
        scores = np.zeros((len(E), self.n))
        for a in range(self.n):
            theta = self.Ainv[a] @ self.b[a]
            mu = E @ theta
            sig = np.sqrt(np.einsum("bd,dk,bk->b", E, self.Ainv[a], E))
            scores[:, a] = mu + self.alpha * sig
        # soft-greedy: nearly deterministic argmax with light exploration
        p = np.full_like(scores, 0.02 / (self.n - 1))
        p[np.arange(len(E)), scores.argmax(1)] = 0.98
        return p

    def feedback(self, embeddings: np.ndarray, actions: np.ndarray,
                 rewards: np.ndarray) -> None:
        for e, a, r in zip(embeddings, actions, rewards):
            e = np.asarray(e, np.float64)
            self.A[a] += np.outer(e, e)
            self.b[a] += r * e
        for a in set(int(x) for x in actions):
            self.Ainv[a] = np.linalg.inv(self.A[a])

    def maybe_update(self):
        return None


# --------------------------------------------------------------------------
# intra-node deployment baselines


class FixedDeploymentScheduler:
    """Fixed deployment + even query split + fixed memory (paper's
    Small/Mid/Mixed-Param baselines)."""

    def __init__(self, node: EdgeNode, kind: str):
        self.node = node
        self.kind = kind

    def _deployment(self) -> List[tuple]:
        pool = {s.size_class: s for s in self.node.pool}
        gpus = self.node.num_gpus
        dep: List[tuple] = []
        if self.kind == "small":
            dep = [(pool["small"].name, k) for k in range(gpus)]
        elif self.kind == "mid":
            dep = [(pool["mid"].name, k) for k in range(gpus)]
        elif self.kind == "mixed1":
            for k in range(gpus):
                dep += [(pool["small"].name, k), (pool["mid"].name, k)]
        elif self.kind == "mixed2":
            if gpus == 1:
                dep = [(pool["small"].name, 0), (pool["mid"].name, 0)]
            else:
                dep = [(pool["small"].name, 0), (pool["mid"].name, 0),
                       (pool["large"].name, 1)]
        else:
            raise ValueError(self.kind)
        return dep

    def schedule(self, n_queries: int, budget_s: float) -> Allocation:
        dep = self._deployment()
        alloc = Allocation(feasible=True)
        per_gpu: Dict[int, List[str]] = {}
        for m, k in dep:
            per_gpu.setdefault(k, []).append(m)
        for m, k in dep:
            alloc.p[(m, k)] = 1.0 / len(dep)          # even split
            share = 1.0 / len(per_gpu[k])
            spec = self.node.mgr.specs[m]
            alloc.R[(m, k)] = max(share, spec.min_mem_frac)
        # normalize any over-committed GPU memory
        for k, models in per_gpu.items():
            tot = sum(alloc.R[(m, k)] for m in models)
            if tot > 1.0:
                for m in models:
                    alloc.R[(m, k)] /= tot
        alloc.predicted_gpu_latency = [0.0] * self.node.num_gpus
        return alloc
