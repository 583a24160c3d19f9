"""IVF ANN index on torch tensors: k-means coarse quantizer + probed-list
top-k.

Counterpart of ``repro/retrieval/ivf.py``.  Documents are bucketed into
``n_lists`` inverted lists by a spherical k-means quantizer trained on
the shard's own embeddings, on the index's device; a query scores only
the ``nprobe`` lists whose centroids it is closest to.  The packed lists
live on the device and the probe runs through
``kernels.ops.ivf_retrieval_topk``: the CUDA kernel on the card, its
plain version on the CPU.  Routing (centroid scores and the
top-``nprobe`` lists per query) stays on the host in numpy, as in the
reference, so a carried quantizer routes bit for bit as it does there.

``last_scored_frac`` reports the fraction of the corpus scored by the
most recent ``search``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

ArrayLike = Union[np.ndarray, torch.Tensor]


def kmeans(x: ArrayLike, n_clusters: int, *, iters: int = 10, seed: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means under inner-product similarity (spherical k-means
    on unit-norm inputs), step for step the reference's: numpy-seeded
    init rows, then ``iters`` rounds of assign -> mean -> renormalise.
    Empty clusters keep their previous centroid.  Runs where ``x`` lives
    (numpy on the CPU).  Returns (centroids [C, d] f32, assignment [N]
    int64) there."""
    xs = torch.as_tensor(x, dtype=torch.float32)
    n = xs.shape[0]
    n_clusters = max(1, min(n_clusters, n))
    rng = np.random.default_rng(seed)
    init = rng.choice(n, size=n_clusters, replace=False)
    cents = xs[torch.as_tensor(init, device=xs.device)]
    for _ in range(iters):
        assign = torch.argmax(xs @ cents.T, dim=1)
        # one-hot product, not a scatter-add: the same sums on every run
        onehot = torch.nn.functional.one_hot(assign, n_clusters).float()
        sums = onehot.T @ xs
        counts = onehot.sum(0)[:, None]
        new = torch.where(counts > 0, sums / counts.clamp(min=1.0), cents)
        norm = torch.linalg.norm(new, dim=1, keepdim=True)
        cents = new / norm.clamp(min=1e-9)
    return cents, torch.argmax(xs @ cents.T, dim=1)


class IVFIndex:
    """Inverted-file index over unit-norm embeddings.

    ``n_lists`` defaults to ~sqrt(N) (at most 256, re-derived whenever
    the corpus grows); ``nprobe`` to ~20% of the lists.  The quantizer
    retrains lazily on the first search after an ``add``."""

    def __init__(self, dim: int, *, n_lists: Optional[int] = None,
                 nprobe: Optional[int] = None, train_iters: int = 10,
                 seed: int = 0, device: DeviceLike = "cuda"):
        self.dim = dim
        self.device = resolve_device(device)
        self.train_iters = train_iters
        self.seed = seed
        self._n_lists_arg = n_lists
        self._nprobe_arg = nprobe
        self._emb: Optional[torch.Tensor] = None
        self._payloads: List[object] = []
        self._dirty = True
        self._centroids: Optional[np.ndarray] = None      # [n_lists, d]
        self._list_emb: Optional[torch.Tensor] = None     # [n_lists, L, d]
        self._list_ids: Optional[torch.Tensor] = None     # [n_lists, L]
        self._list_sizes: Optional[np.ndarray] = None     # [n_lists]
        self.last_scored_frac = 0.0

    def __len__(self) -> int:
        return len(self._payloads)

    @property
    def n_lists(self) -> int:
        if self._n_lists_arg:
            return max(1, min(self._n_lists_arg, len(self) or 1))
        return max(1, min(int(math.sqrt(len(self) or 1)), 256))

    @property
    def nprobe(self) -> int:
        if self._nprobe_arg:
            return max(1, min(self._nprobe_arg, self.n_lists))
        return max(1, round(0.2 * self.n_lists))

    def add(self, embeddings: ArrayLike, payloads: Sequence[object]) -> None:
        """Append [n, dim] embeddings (numpy, or a tensor already on the
        device) and their payloads."""
        emb = torch.as_tensor(embeddings, dtype=torch.float32,
                              device=self.device)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"embeddings {tuple(emb.shape)} are not "
                             f"[n, {self.dim}]")
        self._emb = emb if self._emb is None else torch.cat([self._emb, emb])
        self._payloads += list(payloads)
        self._dirty = True

    # ------------------------------------------------------------- training

    def train(self) -> None:
        """(Re)fit the quantizer and pack the inverted lists on the device
        into [n_lists, L] arrays (id -1 padding), each list's documents in
        ascending id order."""
        assert self._emb is not None
        cents, assign = kmeans(self._emb, self.n_lists,
                               iters=self.train_iters, seed=self.seed)
        n_lists = cents.shape[0]
        sizes = torch.bincount(assign, minlength=n_lists)
        L = max(1, int(sizes.max()))
        order = torch.sort(assign, stable=True).indices
        lists = assign[order]
        slot = (torch.arange(len(order), device=self.device)
                - (torch.cumsum(sizes, 0) - sizes)[lists])
        list_emb = torch.zeros((n_lists, L, self.dim), dtype=torch.float32,
                               device=self.device)
        list_ids = torch.full((n_lists, L), -1, dtype=torch.int32,
                              device=self.device)
        list_emb[lists, slot] = self._emb[order]
        list_ids[lists, slot] = order.to(torch.int32)
        self._centroids = cents.cpu().numpy()
        self._list_emb, self._list_ids = list_emb, list_ids
        self._list_sizes = sizes.cpu().numpy()
        self._dirty = False
        assert int(self._list_sizes.sum()) == len(self._emb)

    # -------------------------------------------------------------- search

    def search(self, queries: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """[Nq, dim] -> (scores [Nq,k'], global ids [Nq,k'] int32) with
        k' = min(k, index size).  Rows whose probed lists hold fewer
        than k' documents are filled with (-1e30, -1), which ``payloads``
        skips.  Empty index / k <= 0 -> [Nq, 0]."""
        queries = np.asarray(queries, np.float32)
        k = min(k, len(self))
        if self._emb is None or k <= 0:
            nq = queries.shape[0]
            return (np.zeros((nq, 0), np.float32),
                    np.zeros((nq, 0), np.int32))
        if self._dirty:
            self.train()
        n_lists, L = self._list_ids.shape
        # coarse routing: top-nprobe centroid lists per query (enough
        # probed slots to hold k results even under heavy imbalance)
        nprobe = min(max(self.nprobe, math.ceil(k / L)), n_lists)
        cs = queries @ self._centroids.T                 # [Nq, n_lists]
        probe = np.argsort(-cs, axis=1)[:, :nprobe].astype(np.int32)
        self.last_scored_frac = float(
            self._list_sizes[probe].sum(axis=1).mean() / len(self))
        s, i = ops.ivf_retrieval_topk(
            torch.as_tensor(queries, device=self.device), self._list_emb,
            self._list_ids, torch.as_tensor(probe, device=self.device), k)
        return s.cpu().numpy(), i.cpu().numpy().astype(np.int32)

    def payloads(self, idx: Sequence[int]) -> List[object]:
        return [self._payloads[int(i)] for i in idx if int(i) >= 0]

    def sketch(self, n_centroids: int = 8, *, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Reuses the trained quantizer when it is at least as coarse as
        requested; otherwise refits a smaller k-means."""
        if self._emb is None:
            return np.zeros((0, self.dim), np.float32), np.zeros(0)
        if self._dirty:
            self.train()
        if len(self._centroids) <= n_centroids:
            return self._centroids, self._list_sizes.astype(np.float64)
        cents, assign = kmeans(self._emb, n_centroids, seed=seed)
        return cents.cpu().numpy(), np.bincount(
            assign.cpu().numpy(), minlength=len(cents)).astype(np.float64)
