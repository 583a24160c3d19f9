"""Deterministic text encoder: hashed n-gram features + random projection.

Stands in for the paper's BGE encoder: maps text to a unit-norm dense
vector such that lexically/semantically (domain-vocabulary) similar
texts are close.  Pure numpy, no pretrained weights; the projection
matrix is seeded so every node computes identical embeddings.
"""
from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

from repro_torch.data.tokenizer import words


def _hash(token: str, dim: int, salt: int) -> int:
    h = hashlib.blake2s(f"{salt}:{token}".encode(), digest_size=4).digest()
    return int.from_bytes(h, "little") % dim


class TextEncoder:
    def __init__(self, dim: int = 256, hash_dim: int = 4096,
                 seed: int = 0):
        self.dim = dim
        self.hash_dim = hash_dim
        rng = np.random.default_rng(seed)
        self.proj = rng.standard_normal((hash_dim, dim)).astype(np.float32) \
            / np.sqrt(hash_dim)

    def _features(self, text: str) -> np.ndarray:
        v = np.zeros(self.hash_dim, np.float32)
        ws = words(text)
        for w in ws:
            v[_hash(w, self.hash_dim, 1)] += 1.0
        for a, b in zip(ws, ws[1:]):                    # bigrams
            v[_hash(a + "_" + b, self.hash_dim, 2)] += 0.5
        n = np.linalg.norm(v)
        return v / n if n else v

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        feats = np.stack([self._features(t) for t in texts])
        emb = feats @ self.proj
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        return emb / np.maximum(norms, 1e-9)

    def token_embeddings(self, text: str) -> np.ndarray:
        """Per-token embeddings (for BERTScore-style metrics)."""
        ws = words(text) or ["<empty>"]
        rows = np.zeros((len(ws), self.hash_dim), np.float32)
        for i, w in enumerate(ws):
            rows[i, _hash(w, self.hash_dim, 1)] = 1.0
            if i > 0:   # context flavour: neighbouring-bigram feature
                rows[i, _hash(ws[i - 1] + "_" + w, self.hash_dim, 2)] = 0.5
        emb = rows @ self.proj
        n = np.linalg.norm(emb, axis=1, keepdims=True)
        return emb / np.maximum(n, 1e-9)
