"""Embedding-keyed semantic query cache.

A copy of ``repro/retrieval/cache.py`` (pure numpy), kept in the port so
it imports nothing of the reference.

Trace workloads repeat: diurnal traces re-ask the same QA pairs and
near-duplicate phrasings of them.  Since retrieval is a pure function
of the query embedding (for a fixed shard), a cosine-similarity cache
in front of the index skips the probe entirely for repeats — the
cheapest retrieval is the one never issued.

Keys are unit-norm embeddings, so similarity is a single [n, d] @ [d]
product; a hit is the best-matching entry at or above ``threshold``
(1.0 = exact repeats only).  Eviction is LRU via a monotonic use tick.
Values are opaque to the cache (the live node stores its retrieved
(contexts, source-node) pair).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class SemanticQueryCache:
    def __init__(self, capacity: int = 1024, threshold: float = 0.98,
                 dim: Optional[int] = None):
        assert capacity > 0
        self.capacity = capacity
        self.threshold = threshold
        self.dim = dim
        self._embs: Optional[np.ndarray] = None      # [n, d], unit-norm
        self._values: List[object] = []
        self._used: List[int] = []                   # last-use tick (LRU)
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0            # capacity-miss LRU replacements

    def __len__(self) -> int:
        return len(self._values)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @staticmethod
    def _unit(emb: np.ndarray) -> np.ndarray:
        emb = np.asarray(emb, np.float32).ravel()
        return emb / max(float(np.linalg.norm(emb)), 1e-9)

    def lookup(self, emb: np.ndarray) -> Optional[object]:
        """Best cached value with cosine >= threshold, else None."""
        self._tick += 1
        if not self._values:
            self.misses += 1
            return None
        sims = self._embs @ self._unit(emb)
        j = int(np.argmax(sims))
        if sims[j] >= self.threshold:
            self.hits += 1
            self._used[j] = self._tick
            return self._values[j]
        self.misses += 1
        return None

    def insert(self, emb: np.ndarray, value: object) -> None:
        emb = self._unit(emb)
        self._tick += 1
        if self._embs is None:
            self._embs = emb[None, :]
            self._values, self._used = [value], [self._tick]
            return
        # dedup: a near-duplicate of a cached query updates that entry in
        # place instead of accumulating copies that LRU-evict distinct
        # queries (hot queries used to crowd out the rest of the cache)
        sims = self._embs @ emb
        j = int(np.argmax(sims))
        if sims[j] >= self.threshold:
            self._embs[j] = emb
            self._values[j] = value
            self._used[j] = self._tick
            return
        if len(self._values) >= self.capacity:
            j = int(np.argmin(self._used))            # evict LRU
            self.evictions += 1
            self._embs[j] = emb
            self._values[j] = value
            self._used[j] = self._tick
            return
        self._embs = np.concatenate([self._embs, emb[None, :]])
        self._values.append(value)
        self._used.append(self._tick)

    def clear(self) -> None:
        self._embs = None
        self._values, self._used = [], []
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
