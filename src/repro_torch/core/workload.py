"""Synthetic query workloads: domain-prototype embeddings + Dirichlet
per-slot domain skew (paper §V-A: ECW trace-style dynamics with
Dirichlet-sampled per-slot domain bias).

A copy of ``repro/core/workload.py`` (numpy; embeddings float32, as the
reference's), drawing the same queries from the same seed."""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.cluster import Query


class QueryGenerator:
    def __init__(self, n_domains: int = 6, embed_dim: int = 64,
                 *, noise: float = 0.35, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self.n_domains = n_domains
        self.embed_dim = embed_dim
        self.noise = noise
        proto = self._rng.standard_normal((n_domains, embed_dim))
        self.prototypes = proto / np.linalg.norm(proto, axis=1, keepdims=True)
        self._qid = 0

    def sample(self, n: int, domain_probs: Optional[Sequence[float]] = None
               ) -> List[Query]:
        p = (np.full(self.n_domains, 1.0 / self.n_domains)
             if domain_probs is None else np.asarray(domain_probs))
        p = p / p.sum()
        domains = self._rng.choice(self.n_domains, n, p=p)
        embs = (self.prototypes[domains]
                + self.noise * self._rng.standard_normal(
                    (n, self.embed_dim)))
        embs /= np.linalg.norm(embs, axis=1, keepdims=True)
        out = []
        for d, e in zip(domains, embs):
            out.append(Query(int(d), e.astype(np.float32), self._qid))
            self._qid += 1
        return out

    def dirichlet_slots(self, n_slots: int, queries_per_slot: int,
                        alpha: float = 1.0) -> Iterator[List[Query]]:
        """Per-slot domain bias via Dirichlet(alpha) (skewed for small
        alpha) — the paper's synthetic domain-bias emulation."""
        for _ in range(n_slots):
            p = self._rng.dirichlet(np.full(self.n_domains, alpha))
            yield self.sample(queries_per_slot, p)

    def skewed(self, n: int, primary_domain: int, share: float
               ) -> List[Query]:
        """Fig. 5-style controlled skew: `share` of queries from one
        domain, rest uniform."""
        p = np.full(self.n_domains, (1 - share) / (self.n_domains - 1))
        p[primary_domain] = share
        return self.sample(n, p)
