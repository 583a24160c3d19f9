"""Edge-data partition (paper §V-A, SCAFFOLD-style dual distribution).

A copy of ``repro/data/partition.py`` (pure numpy), kept in the port so
it imports nothing of the reference.

s% of each node's documents are i.i.d. across all domains; the rest is
non-i.i.d. from the node's 2-3 designated domains.  An overlap factor
scales controlled intersections between nodes' corpora (the same
document may live on several nodes — cross-node knowledge sharing).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.data.corpus import Document


def partition_edge_data(docs: Sequence[Document], n_nodes: int,
                        primary_domains: Sequence[Sequence[int]],
                        *, iid_share: float = 0.2, overlap: float = 0.2,
                        seed: int = 0) -> List[List[Document]]:
    """Returns per-node document lists."""
    rng = np.random.default_rng(seed)
    by_domain: Dict[int, List[Document]] = {}
    for d in docs:
        by_domain.setdefault(d.domain, []).append(d)
    node_docs: List[List[Document]] = [[] for _ in range(n_nodes)]
    for n in range(n_nodes):
        prim = list(primary_domains[n])
        # non-iid: big share of the node's primary domains
        for dom in prim:
            pool = by_domain.get(dom, [])
            take = int(len(pool) * (1 - iid_share))
            idx = rng.choice(len(pool), size=take, replace=False)
            node_docs[n] += [pool[i] for i in idx]
        # iid slice over all domains
        for dom, pool in by_domain.items():
            take = max(1, int(len(pool) * iid_share / n_nodes * 2))
            idx = rng.choice(len(pool), size=min(take, len(pool)),
                             replace=False)
            node_docs[n] += [pool[i] for i in idx]
        # overlap: borrow extra docs from other nodes' primaries
        if overlap > 0:
            for dom, pool in by_domain.items():
                if dom in prim:
                    continue
                take = int(len(pool) * overlap * 0.5)
                if take:
                    idx = rng.choice(len(pool), size=take, replace=False)
                    node_docs[n] += [pool[i] for i in idx]
        # dedup
        seen, uniq = set(), []
        for d in node_docs[n]:
            if d.doc_id not in seen:
                seen.add(d.doc_id)
                uniq.append(d)
        node_docs[n] = uniq
    return node_docs


def coverage_matrix(node_docs: List[List[Document]], n_domains: int
                    ) -> np.ndarray:
    """[N_nodes, N_domains] share of each domain's docs held per node."""
    w = np.zeros((len(node_docs), n_domains))
    totals = np.zeros(n_domains)
    all_ids: Dict[int, int] = {}
    for nd in node_docs:
        for d in nd:
            all_ids[d.doc_id] = d.domain
    for _, dom in all_ids.items():
        totals[dom] += 1
    for n, nd in enumerate(node_docs):
        for d in nd:
            w[n, d.domain] += 1
    return w / np.maximum(totals, 1)
