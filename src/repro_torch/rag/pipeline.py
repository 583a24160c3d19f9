"""RAG pipeline: retrieve -> augment -> generate.

Counterpart of ``repro/rag/pipeline.py``.  The prompt is ``context :
<top-k chunks> <sep> question : <q> <sep> answer :``.  On an engine
built with ``prefill_chunk`` the questions run through a
``ContinuousQueue`` with their retrieved-context prefix marked, so a
paged engine forks a repeated context out of its prefix cache instead of
prefilling it again; otherwise through ``RequestQueue`` waves.  An
optional semantic query cache serves near-duplicate questions without
touching the index.  With tracing on, each question gets a ``request``
trace with ``retrieve`` and ``detokenize`` spans (and ``semantic_cache``
events).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenizer import EOS, Tokenizer
from repro_torch.obs import trace as obs_trace
from repro_torch.retrieval.cache import SemanticQueryCache
from repro_torch.retrieval.encoder import TextEncoder
from repro_torch.retrieval.index import VectorIndex
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sampling import GenerationParams
from repro_torch.serving.scheduler import ContinuousQueue, RequestQueue


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
                 cache: Optional[SemanticQueryCache] = None,
                 admission: str = "fifo"):
        self.encoder = encoder
        self.index = index
        self.engine = engine
        self.tok = tokenizer
        self.top_k = top_k
        self.max_new_tokens = max_new_tokens
        self.cache = cache
        self.admission = admission
        self.last_stats = None      # scheduler stats from the last answer()

    def retrieve(self, questions: Sequence[str], traces=None
                 ) -> Tuple[List[List[str]], np.ndarray]:
        """(contexts per question, index scores [Nq, top_k]);
        near-duplicate questions are served from the semantic cache
        without touching the index.  ``traces`` (optional, [Nq])
        attaches the probe to each question's trace."""
        tr = obs_trace.get_tracer()
        with tr.span("retrieve", traces=traces, queries=len(questions)):
            q_emb = self.encoder.encode(list(questions))
            contexts: List[Optional[List[str]]] = [None] * len(questions)
            scores = np.full((len(questions), self.top_k), -1e30,
                             np.float32)
            misses = []
            for t, emb in enumerate(q_emb):
                hit = self.cache.lookup(emb) if self.cache is not None \
                    else None
                if tr.enabled and self.cache is not None and traces:
                    tr.event("semantic_cache", traces[t],
                             hit=hit is not None)
                if hit is not None:
                    contexts[t], scores[t, :len(hit[1])] = hit[0], hit[1]
                else:
                    misses.append(t)
            if misses:
                s, idx = self.index.search(q_emb[misses], self.top_k)
                for row, t in enumerate(misses):
                    contexts[t] = [str(p) for p in
                                   self.index.payloads(idx[row])]
                    scores[t, :s.shape[1]] = s[row]
                    if self.cache is not None:
                        self.cache.insert(q_emb[t], (contexts[t], s[row]))
            return contexts, scores

    def answer(self, questions: Sequence[str]) -> List[RAGResult]:
        tr = obs_trace.get_tracer()
        traces = [tr.new_trace("rag") for _ in questions] \
            if tr.enabled else None
        with tr.span("request", traces=traces, queries=len(questions)):
            contexts, scores = self.retrieve(questions, traces=traces)
            gp = GenerationParams(max_new_tokens=self.max_new_tokens,
                                  eos_id=EOS)
            if self.engine.prefill_chunk is not None:
                # continuous batching: submit (tokens, prefix_len) so a
                # paged engine forks repeated retrieved-context prefixes
                # out of the session's PrefixCache instead of re-
                # prefilling them
                queue = ContinuousQueue(self.engine, gp,
                                        policy=self.admission)
                cap = self.engine.cont_max_prompt_len(gp.max_new_tokens)
                rids = []
                for i, (q, c) in enumerate(zip(questions, contexts)):
                    toks, plen = split_prompt(q, c, self.tok, cap=cap)
                    rids.append(queue.submit(
                        toks, prefix_len=plen,
                        trace=traces[i] if traces else None))
            else:
                queue = RequestQueue(self.engine, gp)
                rids = queue.submit_all(
                    self.tok.encode(build_prompt(q, c), bos=True)
                    for q, c in zip(questions, contexts))
            outs = queue.run()
            self.last_stats = queue.stats
            results = []
            for i, (q, rid) in enumerate(zip(questions, rids)):
                with tr.span("detokenize",
                             trace=traces[i] if traces else None,
                             tokens=len(outs[rid])):
                    answer = self.tok.decode(outs[rid])
                results.append(RAGResult(q, answer, contexts[i],
                                         scores[i]))
        return results
