"""A live edge node: real retrieval and real decoding, measured.

Counterpart of ``repro/cluster/node.py`` for the paged continuous path.
A ``LiveEdgeNode`` owns

  * a paged, chunk-prefilling ``ServeEngine`` on its device, for any
    architecture the port's ``Model`` serves (attention layers in a
    paged KV pool, xLSTM layers with per-row recurrent state),
  * a private domain-partitioned corpus behind a ``VectorIndex``
    backend (exact ``flat`` scan or ``ivf`` ANN probe) on the same device,
  * optionally a ``SemanticQueryCache`` (repeat queries skip the probe)
    and a ``FederatedRetriever`` handle (sketch-routed cross-node
    retrieval, ``cluster.federation``),
  * a fresh ``ContinuousQueue`` per scheduler slot (``queue=
    "continuous"``): per-slot refill the moment a row finishes, and
    retrieved-context prefixes forked out of the session's prefix cache.

``process_slot`` measures the wall-clock path per query (retrieval, then
generation until that query's completion, queue wait included), scores
answers with ``metrics.text.composite_quality`` against the reference,
and drops queries whose latency exceeds the SLO (quality 0, the paper's
invalid-query rule).  Per-slot queue stats are ``delta``s of a snapshot.
``profile`` measures throughput into a linear ``CapacityFunction``.

When metrics are enabled (``obs.enable_metrics``) each slot pushes its
rollup into the metrics registry: the ``node_*`` series the SLO
objectives read (``obs/slo.py``).

Sampling is greedy; the reference's PRNG key becomes an explicit integer
seed.  Not ported yet (they raise ``NotImplementedError``): the standing
queue (``queue="standing"``), the wave scheduler (``queue="wave"``), a
non-paged engine (``paged=False``) and ``reconfigure``; nor are the
reference's trace spans, nor the standing queue's gauges.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import Query, QueryResult
from repro_torch.core.inter_node import CapacityFunction
from repro_torch.data.corpus import Document
from repro_torch.data.tokenizer import EOS, Tokenizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.metrics.text import composite_quality
from repro_torch.obs import metrics as obs_metrics
from repro_torch.rag.pipeline import build_prompt, split_prompt
from repro_torch.retrieval.cache import SemanticQueryCache
from repro_torch.retrieval.encoder import TextEncoder
from repro_torch.retrieval.index import build_index
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sampling import GenerationParams
from repro_torch.serving.scheduler import ContinuousQueue


@dataclass
class LiveNodeStats:
    slots: int = 0
    waves: int = 0                    # engine rounds (frames)
    refills: int = 0                  # continuous per-slot swaps
    queries: int = 0
    drops: int = 0
    shed: int = 0                     # dropped up-front by the SLO shed hint
    kv_exhaustions: int = 0           # paged KV-pool exhaustion waits
    tokens_out: int = 0
    retrieval_s: float = 0.0
    generate_s: float = 0.0
    cache_hits: int = 0               # retrievals served by the cache
    prefix_hits: int = 0              # paged shared-prefix cache hits
    prefix_misses: int = 0            # ... and misses (prefix prefills)
    prefix_evictions: int = 0         # ... and LRU evictions for space
    remote_contexts: int = 0          # contexts fetched from other shards
    remote_gold: int = 0              # ... that contained the gold answer
    ttft_s: List[float] = field(default_factory=list)  # per request,
    # node-anchored: retrieval + queue wait + prefill (submit -> token 1)

    @property
    def queries_per_s(self) -> float:
        busy = self.retrieval_s + self.generate_s
        return self.queries / busy if busy > 0 else 0.0

    @property
    def ttft_mean(self) -> float:
        return float(np.mean(self.ttft_s)) if self.ttft_s else 0.0


class LiveEdgeNode:
    """One edge node serving real tokens from its private corpus shard."""

    def __init__(self, node_id: int, arch: str, cfg, params,
                 docs: Sequence[Document], tokenizer: Tokenizer,
                 encoder: TextEncoder, *, batch_size: int = 4,
                 max_len: int = 256, top_k: int = 2,
                 max_new_tokens: int = 8, seed: int = 0,
                 index_kind: str = "flat", nprobe: Optional[int] = None,
                 cache: Optional[SemanticQueryCache] = None,
                 queue: str = "continuous", prefill_chunk: int = 32,
                 paged: bool = False, block_size: int = 16,
                 admission: str = "fifo", device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if queue not in ("continuous", "standing", "wave"):
            raise ValueError(f"queue={queue!r} (continuous|standing|wave)")
        if queue != "continuous" or not paged:
            raise NotImplementedError(
                "the port's live node serves queue='continuous' over a "
                "paged engine only so far (paged=True)")
        self.node_id = node_id
        self.arch = arch
        self.docs = list(docs)
        self.tok = tokenizer
        self.encoder = encoder
        self.top_k = top_k
        self.queue_kind = queue
        self.admission = admission
        self.seed = seed
        # chunk must leave decode room; shrink for tiny test caches
        chunk = min(prefill_chunk, max(1, (max_len - max_new_tokens) // 2))
        self.engine = ServeEngine(
            cfg, params, max_len=max_len, batch_size=batch_size,
            prefill_chunk=chunk, paged=True, block_size=block_size,
            device=self.device)
        self.gen = GenerationParams(max_new_tokens=max_new_tokens,
                                    eos_id=EOS)
        index_kw = {"nprobe": nprobe} if index_kind == "ivf" else {}
        self.index = build_index(encoder.dim, index_kind,
                                 device=self.device, **index_kw)
        if self.docs:
            self.index.add(encoder.encode([d.text for d in self.docs]),
                           [d.text for d in self.docs])
        self.cache = cache
        self.federation = None        # set by federation.enable_federation
        self.capacity: Optional[CapacityFunction] = None
        self.shed_fraction = 0.0      # SLO shed hint
        self.stats = LiveNodeStats()
        self.last_contexts: Dict[int, List[str]] = {}
        self.last_sources: Dict[int, List[int]] = {}

    # ------------------------------------------------------------ retrieval

    def _retrieve(self, queries: Sequence[Query]
                  ) -> Tuple[List[List[str]], List[List[int]]]:
        """Per query: top-k chunk texts + the shard each came from.
        Cache hits skip the probe; with a federation handle the probe
        spans the sketch-routed remote shards, otherwise it is the node's
        own index (queries arrive with coordinator-computed embeddings;
        doc and query embeddings share one seeded encoder)."""
        n = len(queries)
        contexts: List[Optional[List[str]]] = [None] * n
        sources: List[Optional[List[int]]] = [None] * n
        misses = []
        for t, q in enumerate(queries):
            if self.cache is not None:
                hit = self.cache.lookup(q.embedding)
                if hit is not None:
                    contexts[t], sources[t] = hit
                    self.stats.cache_hits += 1
                    continue
            misses.append(t)
        if misses:
            embs = np.stack([queries[t].embedding for t in misses])
            if self.federation is not None:
                ctxs, srcs = self.federation.retrieve(self.node_id, embs,
                                                      self.top_k)
            elif len(self.index):
                _, idx = self.index.search(embs, self.top_k)
                ctxs = [[str(p) for p in self.index.payloads(row)]
                        for row in idx]
                srcs = [[self.node_id] * len(c) for c in ctxs]
            else:
                ctxs = [[] for _ in misses]
                srcs = [[] for _ in misses]
            for t, c, s in zip(misses, ctxs, srcs):
                contexts[t], sources[t] = c, s
                if self.cache is not None:
                    self.cache.insert(queries[t].embedding, (c, s))
                # remote-shard accounting only for real probes (cache
                # hits replay stored contexts without fetching anything)
                gold = queries[t].reference.rstrip(" .")
                for text, src in zip(c, s):
                    if src != self.node_id:
                        self.stats.remote_contexts += 1
                        if gold and gold in text:
                            self.stats.remote_gold += 1
        return contexts, sources

    # ------------------------------------------------------------ execution

    def _slot_seed(self) -> int:
        """The sampling seed of the current slot, folded from the node's
        seed and its slot count (greedy decoding does not read it)."""
        return int(np.random.SeedSequence(
            [self.seed, self.stats.slots]).generate_state(1)[0])

    def process_slot(self, queries: Sequence[Query], slo_s: float,
                     scheduler=None) -> List[QueryResult]:
        """Retrieve, queue, decode, and measure.  ``scheduler`` is
        accepted for interface parity with the simulated node and
        ignored."""
        if not queries:
            return []
        self.stats.slots += 1
        t0 = time.perf_counter()
        contexts, sources = self._retrieve(queries)
        t_retrieval = time.perf_counter() - t0
        self.stats.retrieval_s += t_retrieval

        # (tokens, prefix_len) submission: the paged engine forks the
        # shared retrieved-context prefix instead of re-prefilling it
        queue = ContinuousQueue(self.engine, self.gen,
                                seed=self._slot_seed(),
                                policy=self.admission)
        base = queue.stats.snapshot()
        queue.set_shed(self.shed_fraction)
        cap = self.engine.cont_max_prompt_len(self.gen.max_new_tokens)
        rids = []
        for q, c in zip(queries, contexts):
            toks, plen = split_prompt(q.question, c, self.tok, cap=cap)
            rids.append(queue.submit(toks, prefix_len=plen))
        t0 = time.perf_counter()
        queue.run()
        self.stats.generate_s += time.perf_counter() - t0
        delta = queue.stats.delta(base)
        self.stats.waves += delta.frames
        self.stats.refills += delta.refills
        self.stats.prefix_hits += delta.prefix_hits
        self.stats.prefix_misses += delta.prefix_misses
        self.stats.prefix_evictions += delta.prefix_evictions
        self.stats.shed += delta.shed_hint_drops
        self.stats.kv_exhaustions += delta.kv_exhaustions
        self.stats.tokens_out += delta.tokens_out
        self.stats.ttft_s.extend(t_retrieval + v for v in delta.ttft_s)
        comps = {rid: queue.pop_result(rid) for rid in rids}

        results: List[QueryResult] = []
        self.last_contexts = {}
        self.last_sources = {}
        for q, rid, ctx, src in zip(queries, rids, contexts, sources):
            comp = comps[rid]
            latency = t_retrieval + comp.done_s
            answer = self.tok.decode(comp.tokens)
            # a shed request never ran: it is a drop by decision, not by
            # the SLO clock
            dropped = comp.shed or latency > slo_s
            quality = 0.0 if dropped else composite_quality(answer,
                                                            q.reference)
            self.last_contexts[q.qid] = ctx
            self.last_sources[q.qid] = src
            self.stats.queries += 1
            self.stats.drops += int(dropped)
            results.append(QueryResult(q.qid, self.node_id, self.arch,
                                       quality, dropped,
                                       latency_s=latency, answer=answer))
        if obs_metrics.metrics_enabled():
            self._push_metrics(delta, t_retrieval, results)
        return results

    def _push_metrics(self, delta, t_retrieval: float,
                      results: List[QueryResult]) -> None:
        """Per-slot rollup into the global metrics registry (host-side,
        after the slot's queue has drained).  ``delta`` is this slot's
        ContinuousStats diff."""
        reg = obs_metrics.registry()
        node = str(self.node_id)
        reg.counter("node_queries", node=node).inc(len(results))
        reg.counter("node_drops", node=node).inc(
            sum(r.dropped for r in results))
        reg.counter("node_tokens_out", node=node).inc(delta.tokens_out)
        reg.counter("node_shed", node=node).inc(delta.shed_hint_drops)
        reg.counter("node_kv_exhaustions", node=node).inc(
            delta.kv_exhaustions)
        reg.histogram("node_retrieval_s", node=node).observe(t_retrieval)
        h = reg.histogram("node_latency_s", node=node)
        for r in results:
            h.observe(r.latency_s)
        h = reg.histogram("node_ttft_s", node=node)
        for v in delta.ttft_s:
            # queue TTFT is arrival-anchored (submit -> first token);
            # the node's request clock starts at retrieval
            h.observe(t_retrieval + v)
        if self.cache is not None:
            reg.gauge("semantic_cache_hit_rate", node=node).set(
                self.cache.hit_rate)

    # ------------------------------------------------------------ lifecycle

    def unfinished(self) -> int:
        """Requests admitted but not finished: always 0 here, since each
        slot's queue drains before ``process_slot`` returns."""
        return 0

    def close(self) -> None:
        """Nothing to drain: per-slot queues release their session."""

    def reconfigure(self, *, batch_size: Optional[int] = None,
                    prefill_chunk: Optional[int] = None) -> None:
        raise NotImplementedError("reconfigure (standing-engine autoscale) "
                                  "is not ported yet")

    # ------------------------------------------------------------ profiling

    def profile(self, calib_queries: int = 0) -> CapacityFunction:
        """Measured-throughput capacity: serve a calibration burst of
        varied-length prompts through a fresh queue, after one warm-up
        pass, and extrapolate C(L) = qps * L."""
        n = calib_queries or 2 * self.engine.batch_size
        texts = [d.text for d in self.docs] or ["profile warm up prompt"]
        prompts = []
        for i in range(n):
            ws = texts[i % len(texts)].split()
            ctx = " ".join(ws[:max(8, len(ws) - 3 * (i % 5))])
            n_ctx = max(1, 1 + i % max(self.top_k, 1))
            prompts.append(self.tok.encode(
                build_prompt("what is this ?", [ctx] * n_ctx), bos=True))
        warm = ContinuousQueue(self.engine, self.gen, policy=self.admission)
        warm.submit_all(prompts[:self.engine.batch_size])
        warm.run()
        t0 = time.perf_counter()
        queue = ContinuousQueue(self.engine, self.gen, policy=self.admission)
        queue.submit_all(prompts)
        queue.run()
        elapsed = max(time.perf_counter() - t0, 1e-6)
        qps = n / elapsed
        self.capacity = CapacityFunction(k=qps, b=0.0,
                                         levels=[(elapsed, float(n))])
        return self.capacity
