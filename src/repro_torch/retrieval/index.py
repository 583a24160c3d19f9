"""Vector-index protocol + the exact flat index, on torch tensors.

Counterpart of ``repro/retrieval/index.py``.  ``FlatIndex`` keeps the
document embeddings on its device and searches through the exact top-k
kernel (``kernels.ops.retrieval_topk``); on the CPU the same wrapper runs
the plain version.  ``build_index`` also builds the ANN backend
``ivf.IVFIndex``.  ``sketch`` publishes a k-means centroid summary of
the shard (centroids and counts, never documents), the one thing a node
shares for federated routing (``repro_torch.cluster.federation``).
"""
from __future__ import annotations

from typing import (List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.retrieval.ivf import IVFIndex, kmeans


@runtime_checkable
class VectorIndex(Protocol):
    """What retrieval consumers (RAG pipeline, live nodes, federation)
    need from an index backend."""

    dim: int

    def __len__(self) -> int:
        ...

    def add(self, embeddings: np.ndarray,
            payloads: Sequence[object]) -> None:
        ...

    def search(self, queries: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        ...

    def payloads(self, idx: Sequence[int]) -> List[object]:
        ...

    def sketch(self, n_centroids: int = 8, *, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
        ...


class FlatIndex:
    def __init__(self, dim: int, device: DeviceLike = "cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        self._emb: Optional[torch.Tensor] = None
        self._payloads: List[object] = []

    def __len__(self) -> int:
        return len(self._payloads)

    def add(self, embeddings: np.ndarray, payloads: Sequence[object]) -> None:
        emb = torch.as_tensor(np.asarray(embeddings, np.float32),
                              device=self.device)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"embeddings {tuple(emb.shape)} are not "
                             f"[n, {self.dim}]")
        self._emb = emb if self._emb is None else torch.cat([self._emb, emb])
        self._payloads += list(payloads)

    def search(self, queries: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """[Nq, dim] -> (scores [Nq,k'], indices [Nq,k'] int32) with
        k' = min(k, index size); an empty index (or k <= 0) yields
        [Nq, 0] results."""
        queries = np.asarray(queries, np.float32)
        k = min(k, len(self._payloads))
        if self._emb is None or k <= 0:
            nq = queries.shape[0]
            return (np.zeros((nq, 0), np.float32),
                    np.zeros((nq, 0), np.int32))
        q = torch.as_tensor(queries, device=self.device)
        s, i = ops.retrieval_topk(q, self._emb, k)
        return s.cpu().numpy(), i.cpu().numpy().astype(np.int32)

    def payloads(self, idx: Sequence[int]) -> List[object]:
        """Negative ids are top-k fill slots and are skipped."""
        return [self._payloads[int(i)] for i in idx if int(i) >= 0]

    def sketch(self, n_centroids: int = 8, *, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(centroids [m, dim], per-centroid doc counts [m]): a shareable
        summary of the shard that reveals no documents."""
        if self._emb is None:
            return np.zeros((0, self.dim), np.float32), np.zeros(0)
        cents, assign = kmeans(self._emb, n_centroids, seed=seed)
        return cents.cpu().numpy(), np.bincount(
            assign.cpu().numpy(), minlength=len(cents)).astype(np.float64)


def build_index(dim: int, kind: str = "flat", **kw) -> VectorIndex:
    """Index factory: ``flat`` (exact) or ``ivf`` (ANN, k-means coarse
    quantizer + probed-list top-k).  Extra kwargs go to the backend."""
    if kind == "flat":
        return FlatIndex(dim, **kw)
    if kind == "ivf":
        return IVFIndex(dim, **kw)
    raise ValueError(f"unknown index kind {kind!r} (flat|ivf)")
