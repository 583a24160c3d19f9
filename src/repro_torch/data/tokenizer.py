"""Word-level tokenizer with special tokens (self-contained, no deps)."""
from __future__ import annotations

import re
from typing import Dict, Iterable, List

_WORD = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

PAD, UNK, BOS, EOS, SEP = 0, 1, 2, 3, 4
SPECIALS = ["<pad>", "<unk>", "<bos>", "<eos>", "<sep>"]


def words(text: str) -> List[str]:
    return _WORD.findall(text.lower())


class Tokenizer:
    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        self.inv = {i: w for w, i in vocab.items()}

    @classmethod
    def build(cls, texts: Iterable[str], max_vocab: int = 8192
              ) -> "Tokenizer":
        from collections import Counter
        counts = Counter()
        for t in texts:
            counts.update(words(t))
        vocab = {w: i for i, w in enumerate(SPECIALS)}
        for w, _ in counts.most_common(max_vocab - len(SPECIALS)):
            vocab[w] = len(vocab)
        return cls(vocab)

    def __len__(self) -> int:
        return len(self.vocab)

    def encode(self, text: str, bos: bool = False, eos: bool = False
               ) -> List[int]:
        ids = [self.vocab.get(w, UNK) for w in words(text)]
        return ([BOS] if bos else []) + ids + ([EOS] if eos else [])

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.inv.get(int(i), "<unk>") for i in ids]
        return " ".join(t for t in toks if t not in ("<pad>", "<bos>",
                                                     "<eos>"))
