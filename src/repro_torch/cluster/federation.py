"""Privacy-preserving cross-node federated retrieval.

Counterpart of ``repro/cluster/federation.py``.  Every shard publishes
only a ``CentroidSketch`` (k-means centroids of its embeddings and
per-centroid counts, via ``VectorIndex.sketch``); the retriever scores a
query embedding against every sketch (best-centroid similarity), probes
the query's origin shard plus the ``fanout - 1`` most promising remote
shards, and merges their partial top-k into one global context set,
deduplicated by text.  Documents leave a node only as retrieved context
for a specific query.  The reference's ``federate`` trace span is left
out with the rest of its tracing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.retrieval.index import VectorIndex


@runtime_checkable
class ShardHost(Protocol):
    """Anything that owns a searchable shard: a ``LiveEdgeNode`` or a bare
    (node_id, index) holder."""

    node_id: int
    index: VectorIndex


@dataclass
class CentroidSketch:
    """A node's shareable shard summary: centroids, counts, no docs."""
    node_id: int
    centroids: np.ndarray        # [m, dim]
    sizes: np.ndarray            # [m] docs per centroid

    def affinity(self, embs: np.ndarray) -> np.ndarray:
        """Best-centroid inner product per query, [Nq]."""
        if len(self.centroids) == 0:
            return np.full(len(embs), -np.inf)
        return (embs @ self.centroids.T).max(axis=1)


@dataclass
class FederationStats:
    queries: int = 0
    shard_probes: int = 0        # (query, shard) probes issued
    remote_probes: int = 0       # ... of which left the origin node
    remote_contexts: int = 0     # merged contexts served by a remote shard
    probes_per_node: Dict[int, int] = field(default_factory=dict)


class FederatedRetriever:
    """Sketch-routed cross-shard retrieval with partial top-k merge."""

    def __init__(self, nodes: Sequence[ShardHost], *, fanout: int = 2,
                 n_centroids: int = 8, seed: int = 0):
        self.nodes: Dict[int, ShardHost] = {n.node_id: n for n in nodes}
        self.fanout = max(1, min(fanout, len(self.nodes)))
        self.n_centroids = n_centroids
        self.seed = seed
        self.sketches: Dict[int, CentroidSketch] = {}
        self.stats = FederationStats()
        for nid in self.nodes:
            self.refresh(nid)

    def refresh(self, node_id: int) -> CentroidSketch:
        """(Re)publish one node's sketch, after its corpus grows."""
        node = self.nodes[node_id]
        cents, sizes = node.index.sketch(self.n_centroids,
                                         seed=self.seed + node_id)
        self.sketches[node_id] = CentroidSketch(node_id, cents, sizes)
        return self.sketches[node_id]

    # --------------------------------------------------------------- routing

    def route(self, origin_id: int, embs: np.ndarray) -> List[List[int]]:
        """Per-query probe sets: the origin shard plus the best
        ``fanout - 1`` remote shards by sketch affinity."""
        nids = [n for n in self.sketches if n != origin_id]
        if not nids or self.fanout == 1:
            return [[origin_id]] * len(embs)
        aff = np.stack([self.sketches[n].affinity(embs) for n in nids],
                       axis=1)                          # [Nq, n_remote]
        order = np.argsort(-aff, axis=1)[:, :self.fanout - 1]
        return [[origin_id] + [nids[j] for j in row] for row in order]

    # --------------------------------------------------------------- merge

    def retrieve(self, origin_id: int, embs: np.ndarray, k: int
                 ) -> Tuple[List[List[str]], List[List[int]]]:
        """-> (contexts [Nq][<=k] chunk texts, sources [Nq][<=k] node
        ids), globally score-ordered across the probed shards."""
        embs = np.asarray(embs, np.float32)
        nq = len(embs)
        probe_sets = self.route(origin_id, embs)
        partials: List[List[Tuple[float, str, int]]] = [[] for _ in
                                                        range(nq)]
        by_node: Dict[int, List[int]] = {}
        for qi, nids in enumerate(probe_sets):
            for nid in nids:
                by_node.setdefault(nid, []).append(qi)
        for nid, qidx in by_node.items():
            index = self.nodes[nid].index
            scores, ids = index.search(embs[qidx], k)
            for row, (srow, irow) in enumerate(zip(scores, ids)):
                qi = qidx[row]
                texts = index.payloads(irow)            # skips -1 fill
                for s, t in zip(srow, texts):
                    partials[qi].append((float(s), str(t), nid))
            self.stats.shard_probes += len(qidx)
            self.stats.probes_per_node[nid] = \
                self.stats.probes_per_node.get(nid, 0) + len(qidx)
            if nid != origin_id:
                self.stats.remote_probes += len(qidx)
        self.stats.queries += nq
        contexts: List[List[str]] = []
        sources: List[List[int]] = []
        for qi in range(nq):
            # overlap partitions replicate docs across shards: dedup by
            # text, keeping the copy from the highest-scoring shard
            best: List[Tuple[float, str, int]] = []
            seen = set()
            for s, t, nid in sorted(partials[qi], key=lambda x: -x[0]):
                if t in seen:
                    continue
                seen.add(t)
                best.append((s, t, nid))
                if len(best) == k:
                    break
            contexts.append([t for _, t, _ in best])
            sources.append([nid for _, _, nid in best])
            self.stats.remote_contexts += sum(
                1 for _, _, nid in best if nid != origin_id)
        return contexts, sources


def enable_federation(nodes: Sequence[ShardHost], *, fanout: int = 2,
                      n_centroids: int = 8, seed: int = 0
                      ) -> FederatedRetriever:
    """Build one retriever over all shards and attach it to every node
    that dispatches retrieval through ``node.federation``."""
    fed = FederatedRetriever(nodes, fanout=fanout, n_centroids=n_centroids,
                             seed=seed)
    for node in nodes:
        if hasattr(node, "federation"):
            node.federation = fed
    return fed
