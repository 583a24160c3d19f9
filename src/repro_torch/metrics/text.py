"""Text-generation metrics from scratch: ROUGE-1/2/L, BLEU-4, METEOR,
BERTScore (the paper's evaluation suite, §V-A).

A copy of ``repro/metrics/text.py``, so the port imports nothing of the
reference; the live node scores answers with ``composite_quality``.
ROUGE-L follows the paper's normalization, LCS / max(len(ref),
len(gen)), with ``paper_norm=True``; the F-measure variant is kept too.
BERTScore uses
the deterministic hashed-feature token embeddings of
``repro_torch.retrieval.encoder`` (its own ``TextEncoder(seed=1234)``):
greedy max-cosine matching in both directions, harmonic mean.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Optional

from repro_torch.data.tokenizer import words


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(generated: str, reference: str, paper_norm: bool = True
            ) -> float:
    g, r = words(generated), words(reference)
    lcs = _lcs_len(g, r)
    if paper_norm:
        denom = max(len(g), len(r))
        return lcs / denom if denom else 0.0
    # F1 variant
    if not g or not r or lcs == 0:
        return 0.0
    p, rec = lcs / len(g), lcs / len(r)
    return 2 * p * rec / (p + rec)


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def rouge_n(generated: str, reference: str, n: int = 1) -> float:
    g, r = _ngrams(words(generated), n), _ngrams(words(reference), n)
    if not r:
        return 0.0
    overlap = sum((g & r).values())
    return overlap / max(sum(r.values()), 1)


def bleu4(generated: str, reference: str) -> float:
    g, r = words(generated), words(reference)
    if not g:
        return 0.0
    logp = 0.0
    orders = 0
    for n in range(1, 5):
        gn, rn = _ngrams(g, n), _ngrams(r, n)
        total = sum(gn.values())
        if total == 0:                     # text shorter than n: skip order
            continue
        match = sum((gn & rn).values())
        p = match / total
        if p == 0:
            p = 1.0 / (2 * total)          # smoothed
        logp += math.log(p)
        orders += 1
    if orders == 0:
        return 0.0
    logp /= orders
    bp = 1.0 if len(g) > len(r) else math.exp(1 - len(r) / max(len(g), 1))
    return bp * math.exp(logp)


_SUFFIXES = ("ing", "ed", "es", "s", "ly")


def _stem(w: str) -> str:
    for s in _SUFFIXES:
        if w.endswith(s) and len(w) - len(s) >= 3:
            return w[:-len(s)]
    return w


def meteor(generated: str, reference: str, *, alpha: float = 0.9,
           beta: float = 3.0, gamma: float = 0.5) -> float:
    """Exact + stem matching, fragmentation penalty."""
    g, r = words(generated), words(reference)
    if not g or not r:
        return 0.0
    used_r = [False] * len(r)
    match_pos = []                          # (gen_idx, ref_idx)
    for stage in ("exact", "stem"):
        for i, gw in enumerate(g):
            if any(mp[0] == i for mp in match_pos):
                continue
            for j, rw in enumerate(r):
                if used_r[j]:
                    continue
                ok = gw == rw if stage == "exact" else _stem(gw) == _stem(rw)
                if ok:
                    used_r[j] = True
                    match_pos.append((i, j))
                    break
    m = len(match_pos)
    if m == 0:
        return 0.0
    p, rec = m / len(g), m / len(r)
    f = p * rec / (alpha * p + (1 - alpha) * rec)
    # chunks: contiguous in both
    match_pos.sort()
    chunks = 1
    for (i1, j1), (i2, j2) in zip(match_pos, match_pos[1:]):
        if not (i2 == i1 + 1 and j2 == j1 + 1):
            chunks += 1
    penalty = gamma * (chunks / m) ** beta
    return f * (1 - penalty)


_ENCODER = None


def _encoder():
    global _ENCODER
    if _ENCODER is None:
        from repro_torch.retrieval.encoder import TextEncoder
        _ENCODER = TextEncoder(seed=1234)
    return _ENCODER


def bertscore(generated: str, reference: str,
              encoder: Optional[object] = None) -> float:
    """Greedy max-cosine matching both ways, harmonic mean (paper Eq.)."""
    enc = encoder or _encoder()
    eg = enc.token_embeddings(generated)
    er = enc.token_embeddings(reference)
    sim = eg @ er.T
    prec = float(sim.max(axis=1).mean())
    rec = float(sim.max(axis=0).mean())
    if prec + rec <= 0:
        return 0.0
    return 2 * prec * rec / (prec + rec)


def composite_quality(generated: str, reference: str,
                      alpha1: float = 1.0, alpha2: float = 0.5) -> float:
    """Paper Eq. 9: f_i = α1·ROUGE-L + α2·BERTScore (α=(1, 0.5))."""
    return alpha1 * rouge_l(generated, reference) \
        + alpha2 * bertscore(generated, reference)
