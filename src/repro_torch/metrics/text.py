"""Answer quality as the live node scores it: ROUGE-L and BERTScore.

The part of ``repro/metrics/text.py`` that ``composite_quality`` reaches,
copied so the port imports nothing of the reference.  ROUGE-L follows
the paper's normalization, LCS / max(len(ref), len(gen)), with
``paper_norm=True``; the F-measure variant is kept too.  BERTScore uses
the deterministic hashed-feature token embeddings of
``repro_torch.retrieval.encoder`` (its own ``TextEncoder(seed=1234)``):
greedy max-cosine matching in both directions, harmonic mean.
"""
from __future__ import annotations

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
