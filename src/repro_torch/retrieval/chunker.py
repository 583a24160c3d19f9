"""Fixed-length document chunking (the paper fixes chunk length and
retrieval count to keep the latency predictor linear in both).

Counterpart of ``repro/retrieval/chunker.py``."""
from __future__ import annotations

from typing import List

from repro_torch.data.tokenizer import words


def chunk_text(text: str, chunk_words: int = 48, stride: int = 40
               ) -> List[str]:
    """Windows of ``chunk_words`` words every ``stride`` words (the last
    one ends at the text's end); a text of at most ``chunk_words`` words
    is one chunk."""
    ws = words(text)
    if len(ws) <= chunk_words:
        return [" ".join(ws)]
    out = []
    for start in range(0, len(ws) - chunk_words + stride, stride):
        piece = ws[start:start + chunk_words]
        if piece:
            out.append(" ".join(piece))
        if start + chunk_words >= len(ws):
            break
    return out
