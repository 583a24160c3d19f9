"""Generation-quality model (paper §IV-C).

A copy of ``repro/core/quality_model.py``: numpy and float64, the same
arithmetic in the same order and the same generator draws, so results
equal the reference's bit for bit (the port imports nothing of it).

Two pieces:

1. ``QualityOracle`` — the simulation's ground truth: the realized
   quality of answering query i (domain d_i) on node n with model m is

       qual = Q_m^base * match(d_i, n) + noise

   where match in [low, 1] is the node's *relative* corpus coverage of
   the query's domain (the RAG principle: response quality reflects
   query<->corpus alignment).  This is what produces the paper's
   Fig. 1 Random-vs-Domain-vs-Oracle gaps.

2. ``static_open_book_quality`` — the paper's offline "open-book
   examination": evaluate each model on node-local data WITH the
   ground-truth context, isolating intrinsic model capability from
   retrieval noise.  The result Q_mn is the constant the intra-node
   scheduler maximizes (reducing Q^t_mnk(.) to Q_mn).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.configs.edge_pool import EdgeModelSpec


class QualityOracle:
    def __init__(self, corpus_weights: np.ndarray, *, match_floor: float = 0.55,
                 noise: float = 0.02, seed: int = 0):
        """corpus_weights: [N_nodes, N_domains] document-share matrix
        (rows need not sum to 1 — relative coverage is what matters)."""
        self.w = np.asarray(corpus_weights, np.float64)
        self.match_floor = match_floor
        self.noise = noise
        self._rng = np.random.default_rng(seed)

    def match(self, domain: int, node: int) -> float:
        col = self.w[:, domain]
        rel = self.w[node, domain] / max(col.max(), 1e-9)
        return self.match_floor + (1.0 - self.match_floor) * rel

    def best_node(self, domain: int) -> int:
        return int(self.w[:, domain].argmax())

    def realized(self, spec: EdgeModelSpec, domain: int, node: int) -> float:
        q = spec.base_quality * self.match(domain, node) \
            + self.noise * self._rng.standard_normal()
        return float(np.clip(q, 0.0, 1.0))

    def open_book(self, spec: EdgeModelSpec, node: int,
                  n_samples: int = 64) -> float:
        """Offline 'open-book' eval: queries paired with ground-truth
        context — match factor pinned to 1, only intrinsic capability
        (plus sampling noise) shows through."""
        samples = spec.base_quality \
            + self.noise * self._rng.standard_normal(n_samples)
        return float(np.clip(samples.mean(), 0.0, 1.0))


def static_open_book_quality(oracle: QualityOracle,
                             pool: Sequence[EdgeModelSpec],
                             node: int) -> Dict[str, float]:
    """Q_mn for every model in a node's pool."""
    return {s.name: oracle.open_book(s, node) for s in pool}
