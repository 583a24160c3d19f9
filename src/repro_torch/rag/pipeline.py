"""RAG pipeline: retrieve -> augment -> generate.

Counterpart of ``repro/rag/pipeline.py`` for the continuous path: the
prompt is ``context : <top-k chunks> <sep> question : <q> <sep> answer :``
with its retrieved-context prefix marked, so a paged engine forks a
repeated context out of its prefix cache instead of prefilling it again.
The semantic query cache and the synchronous-wave path are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenizer import EOS, Tokenizer
from repro_torch.retrieval.encoder import TextEncoder
from repro_torch.retrieval.index import VectorIndex
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sampling import GenerationParams
from repro_torch.serving.scheduler import ContinuousQueue


@dataclass
class RAGResult:
    question: str
    answer: str
    contexts: List[str]
    scores: np.ndarray          # per-retrieved-chunk index scores, [top_k]


def build_prompt(question: str, contexts: Sequence[str]) -> str:
    ctx = " ".join(contexts)
    return f"context : {ctx} <sep> question : {question} <sep> answer :"


def split_prompt(question: str, contexts: Sequence[str], tok: Tokenizer,
                 *, cap: Optional[int] = None) -> Tuple[List[int], int]:
    """Tokenize a RAG prompt as (tokens, prefix_len): the prefix is the
    shared retrieved-context part (``context : ... <sep>``, BOS included),
    the prefix-cache key.  When ``cap`` bounds the prompt length, whole
    lowest-ranked documents are dropped, never split."""
    contexts = list(contexts)
    suffix = tok.encode(f"question : {question} <sep> answer :")
    while True:
        prefix = tok.encode(f"context : {' '.join(contexts)} <sep>",
                            bos=True)
        if cap is None or len(prefix) + len(suffix) <= cap or not contexts:
            break
        contexts = contexts[:-1]
    return prefix + suffix, len(prefix)


class RAGPipeline:
    def __init__(self, encoder: TextEncoder, index: VectorIndex,
                 engine: ServeEngine, tokenizer: Tokenizer,
                 *, top_k: int = 5, max_new_tokens: int = 24,
                 admission: str = "fifo"):
        self.encoder = encoder
        self.index = index
        self.engine = engine
        self.tok = tokenizer
        self.top_k = top_k
        self.max_new_tokens = max_new_tokens
        self.admission = admission
        self.last_stats = None      # scheduler stats from the last answer()

    def retrieve(self, questions: Sequence[str]
                 ) -> Tuple[List[List[str]], np.ndarray]:
        """(contexts per question, index scores [Nq, top_k])."""
        q_emb = self.encoder.encode(list(questions))
        scores = np.full((len(questions), self.top_k), -1e30, np.float32)
        s, idx = self.index.search(q_emb, self.top_k)
        contexts = []
        for row in range(len(questions)):
            contexts.append([str(p) for p in self.index.payloads(idx[row])])
            scores[row, :s.shape[1]] = s[row]
        return contexts, scores

    def answer(self, questions: Sequence[str]) -> List[RAGResult]:
        contexts, scores = self.retrieve(questions)
        gp = GenerationParams(max_new_tokens=self.max_new_tokens, eos_id=EOS)
        queue = ContinuousQueue(self.engine, gp, policy=self.admission)
        cap = self.engine.cont_max_prompt_len(gp.max_new_tokens)
        rids = []
        for q, c in zip(questions, contexts):
            toks, plen = split_prompt(q, c, self.tok, cap=cap)
            rids.append(queue.submit(toks, prefix_len=plen))
        outs = queue.run()
        self.last_stats = queue.stats
        return [RAGResult(q, self.tok.decode(outs[rid]), contexts[i],
                          scores[i])
                for i, (q, rid) in enumerate(zip(questions, rids))]
