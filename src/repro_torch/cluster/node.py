"""A live edge node: real retrieval and real decoding, measured.

Counterpart of ``repro/cluster/node.py``.  A ``LiveEdgeNode`` owns

  * a ``ServeEngine`` on its device, for any architecture the port's
    ``Model`` serves (attention layers in a contiguous or, with
    ``paged=True``, a paged KV cache; xLSTM layers with per-row
    recurrent state),
  * a private domain-partitioned corpus behind a ``VectorIndex``
    backend (exact ``flat`` scan or ``ivf`` ANN probe) on the same device,
  * optionally a ``SemanticQueryCache`` (repeat queries skip the probe)
    and a ``FederatedRetriever`` handle (sketch-routed cross-node
    retrieval, ``cluster.federation``),
  * a request scheduler: a fresh ``ContinuousQueue`` per scheduler slot
    (``queue="continuous"``), or ONE standing queue for the node's
    lifetime whose frame stays warm across slots (``queue="standing"``),
    either of which refills a row the moment it finishes (and, paged,
    forks retrieved-context prefixes out of the session's prefix cache);
    or the synchronous ``RequestQueue`` waves (``queue="wave"``), where a
    query's generation latency is its wave's finish time.

With a standing queue the node is a *standing engine*: each slot's
queries stream into the live session (refills instead of a cold frame),
per-slot stats are deltas of the queue's monotone counters, and SLO shed
hints act at the next refill.  ``close()`` drains and releases the
session; ``reconfigure`` rebuilds the engine with new batch and chunk
knobs (``cluster.replay.autoscale_knobs``).

``process_slot`` measures the wall-clock path per query (retrieval, then
generation until that query's completion, queue wait included), scores
answers with ``metrics.text.composite_quality`` against the reference,
and drops queries whose latency exceeds the SLO (quality 0, the paper's
invalid-query rule).  Per-slot queue stats are ``delta``s of a snapshot.
``profile`` measures throughput into a linear ``CapacityFunction``.

When metrics are enabled (``obs.enable_metrics`` or live tracing) each
slot pushes its rollup into the metrics registry: the ``node_*`` series
the SLO objectives read (``obs/slo.py``).  With tracing on, each query's
trace gets a ``retrieve`` span (and ``semantic_cache`` events) and a
``detokenize`` span.

Sampling is greedy; the reference's PRNG key becomes an explicit integer
seed, folded with the slot count for each slot's queue.
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
from repro_torch.obs import trace as obs_trace
from repro_torch.rag.pipeline import build_prompt, split_prompt
from repro_torch.retrieval.cache import SemanticQueryCache
from repro_torch.retrieval.encoder import TextEncoder
from repro_torch.retrieval.index import build_index
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sampling import GenerationParams, fold_seed
from repro_torch.serving.scheduler import ContinuousQueue, RequestQueue


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
        self.node_id = node_id
        self.arch = arch
        self.docs = list(docs)
        self.tok = tokenizer
        self.encoder = encoder
        self.top_k = top_k
        self.queue_kind = queue
        self.admission = admission
        self.seed = seed
        chunked = queue in ("continuous", "standing")
        # chunk must leave decode room; shrink for tiny test caches
        chunk = min(prefill_chunk, max(1, (max_len - max_new_tokens) // 2))
        self.engine = ServeEngine(
            cfg, params, max_len=max_len, batch_size=batch_size,
            prefill_chunk=chunk if chunked else None,
            paged=paged and chunked, block_size=block_size,
            device=self.device)
        self.gen = GenerationParams(max_new_tokens=max_new_tokens,
                                    eos_id=EOS)
        self._standing_queue: Optional[ContinuousQueue] = None
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
        tr = obs_trace.get_tracer()
        n = len(queries)
        tids = [obs_trace.query_trace(q.qid) for q in queries] \
            if tr.enabled else [None] * n
        contexts: List[Optional[List[str]]] = [None] * n
        sources: List[Optional[List[int]]] = [None] * n
        misses = []
        for t, q in enumerate(queries):
            if self.cache is not None:
                hit = self.cache.lookup(q.embedding)
                if tr.enabled:
                    tr.event("semantic_cache", tids[t],
                             hit=hit is not None)
                if hit is not None:
                    contexts[t], sources[t] = hit
                    self.stats.cache_hits += 1
                    continue
            misses.append(t)
        if misses:
            embs = np.stack([queries[t].embedding for t in misses])
            if self.federation is not None:
                ctxs, srcs = self.federation.retrieve(
                    self.node_id, embs, self.top_k,
                    traces=[tids[t] for t in misses])
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
        return fold_seed(self.seed, self.stats.slots)

    def process_slot(self, queries: Sequence[Query], slo_s: float,
                     scheduler=None) -> List[QueryResult]:
        """Retrieve, queue, decode, and measure.  ``scheduler`` is
        accepted for interface parity with the simulated node and
        ignored."""
        if not queries:
            return []
        tr = obs_trace.get_tracer()
        tids = [obs_trace.query_trace(q.qid) for q in queries] \
            if tr.enabled else [None] * len(queries)
        self.stats.slots += 1
        t0 = time.perf_counter()
        with tr.span("retrieve", traces=tids, node=self.node_id,
                     queries=len(queries),
                     federated=self.federation is not None):
            contexts, sources = self._retrieve(queries)
        t_retrieval = time.perf_counter() - t0
        self.stats.retrieval_s += t_retrieval

        comps: Dict[int, object] = {}      # rid -> completion
        done_s: Dict[int, float] = {}      # rid -> generate-path latency
        delta = None                       # this slot's ContinuousStats
        if self.queue_kind == "wave":
            queue = RequestQueue(self.engine, self.gen,
                                 seed=self._slot_seed())
            rids = queue.submit_all(
                self.tok.encode(build_prompt(q.question, c), bos=True)
                for q, c in zip(queries, contexts))
            wave_elapsed: List[float] = []
            t0 = time.perf_counter()
            while queue.pending():
                queue.step()
                wave_elapsed.append(time.perf_counter() - t0)
            self.stats.generate_s += wave_elapsed[-1] if wave_elapsed \
                else 0.0
            self.stats.waves += queue.stats.waves
            self.stats.tokens_out += queue.stats.tokens_out
            for rid in rids:
                comps[rid] = queue.result(rid)
                done_s[rid] = wave_elapsed[comps[rid].wave]
        else:
            # (tokens, prefix_len) submission: a paged engine forks the
            # shared retrieved-context prefix instead of re-prefilling it
            if self.queue_kind == "standing":
                queue = self._ensure_standing_queue()
            else:
                queue = ContinuousQueue(self.engine, self.gen,
                                        seed=self._slot_seed(),
                                        policy=self.admission)
            # per-slot stats are deltas of the queue's monotone counters
            # (a fresh queue's delta equals its totals, so both kinds
            # share it)
            base = queue.stats.snapshot()
            queue.set_shed(self.shed_fraction)
            cap = self.engine.cont_max_prompt_len(self.gen.max_new_tokens)
            rids = []
            for q, c, tid in zip(queries, contexts, tids):
                toks, plen = split_prompt(q.question, c, self.tok, cap=cap)
                rids.append(queue.submit(toks, prefix_len=plen, trace=tid))
            t0 = time.perf_counter()
            if queue.standing:
                # stream this slot into the live session and return the
                # moment its requests finish: other rows may straddle
                # into the next slot mid-decode
                queue.run(wait_for=rids)
            else:
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
            for rid in rids:
                comps[rid] = queue.pop_result(rid)
                done_s[rid] = comps[rid].done_s

        results: List[QueryResult] = []
        self.last_contexts = {}
        self.last_sources = {}
        for q, rid, ctx, src, tid in zip(queries, rids, contexts, sources,
                                         tids):
            comp = comps[rid]
            latency = t_retrieval + done_s[rid]
            with tr.span("detokenize", trace=tid,
                         tokens=len(comp.tokens)):
                answer = self.tok.decode(comp.tokens)
            # a shed request never ran: it is a drop by decision, not by
            # the SLO clock
            dropped = getattr(comp, "shed", False) or latency > slo_s
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
            self._push_metrics(queue, delta, t_retrieval, results)
        return results

    def _push_metrics(self, queue, delta, t_retrieval: float,
                      results: List[QueryResult]) -> None:
        """Per-slot rollup into the global metrics registry (host-side,
        after the slot's requests finished).  ``delta`` is this slot's
        ContinuousStats diff (None on the wave path): a standing queue's
        counters are monotone for the node's lifetime, so the slot's share
        is a snapshot diff."""
        reg = obs_metrics.registry()
        node = str(self.node_id)
        reg.counter("node_queries", node=node).inc(len(results))
        reg.counter("node_drops", node=node).inc(
            sum(r.dropped for r in results))
        reg.counter("node_tokens_out", node=node).inc(
            delta.tokens_out if delta is not None
            else queue.stats.tokens_out)
        reg.counter("node_shed", node=node).inc(
            delta.shed_hint_drops if delta is not None else 0)
        reg.counter("node_kv_exhaustions", node=node).inc(
            delta.kv_exhaustions if delta is not None else 0)
        reg.histogram("node_retrieval_s", node=node).observe(t_retrieval)
        h = reg.histogram("node_latency_s", node=node)
        for r in results:
            h.observe(r.latency_s)
        h = reg.histogram("node_ttft_s", node=node)
        for v in (delta.ttft_s if delta is not None else []):
            # queue TTFT is arrival-anchored (submit -> first token);
            # the node's request clock starts at retrieval
            h.observe(t_retrieval + v)
        if self.queue_kind == "standing":
            reg.gauge("node_queue_depth", node=node).set(
                float(queue.depth()))
            reg.gauge("node_queue_oldest_wait_s", node=node).set(
                queue.oldest_wait_s())
        if self.cache is not None:
            reg.gauge("semantic_cache_hit_rate", node=node).set(
                self.cache.hit_rate)

    # ------------------------------------------------------------ lifecycle

    def _ensure_standing_queue(self) -> ContinuousQueue:
        if self._standing_queue is None:
            self._standing_queue = ContinuousQueue(
                self.engine, self.gen, seed=self.seed,
                policy=self.admission, standing=True)
        return self._standing_queue

    def unfinished(self) -> int:
        """Requests admitted to the standing queue but not finished: the
        zero-lost invariant checked at exit (0 for per-slot queues, which
        drain before ``process_slot`` returns)."""
        q = self._standing_queue
        return len(q.unfinished()) if q is not None else 0

    def close(self) -> None:
        """Drain and release the standing session; no-op for per-slot
        queues."""
        if self._standing_queue is not None:
            self._standing_queue.close()
            self._standing_queue = None

    def reconfigure(self, *, batch_size: Optional[int] = None,
                    prefill_chunk: Optional[int] = None) -> None:
        """Rebuild the engine with new batch and chunk knobs (the
        saturation harness autoscales both from the node's measured
        capacity profile, ``cluster.replay.autoscale_knobs``).  Drains
        the standing session first; the old engine's pool goes with it."""
        if batch_size is None and prefill_chunk is None:
            return
        self.close()
        eng = self.engine
        chunk = eng.prefill_chunk
        if chunk is not None and prefill_chunk is not None:
            chunk = min(prefill_chunk, max(
                1, (eng.max_len - self.gen.max_new_tokens) // 2))
        self.engine = ServeEngine(
            eng.cfg, eng.params, max_len=eng.max_len,
            batch_size=batch_size or eng.batch_size,
            prefill_chunk=chunk, paged=eng.paged, block_size=eng.block_size,
            device=self.device)

    # ------------------------------------------------------------ profiling

    def _make_queue(self):
        """A fresh per-run queue of the node's kind: profiling must not
        disturb (or be skewed by) the standing session's frame."""
        if self.queue_kind in ("continuous", "standing"):
            return ContinuousQueue(self.engine, self.gen,
                                   policy=self.admission)
        return RequestQueue(self.engine, self.gen)

    def profile(self, calib_queries: int = 0) -> CapacityFunction:
        """Measured-throughput capacity: serve a calibration burst of
        varied-length prompts through the scheduler the slots use, after
        one warm-up pass, and extrapolate C(L) = qps * L."""
        n = calib_queries or 2 * self.engine.batch_size
        texts = [d.text for d in self.docs] or ["profile warm up prompt"]
        prompts = []
        for i in range(n):
            ws = texts[i % len(texts)].split()
            ctx = " ".join(ws[:max(8, len(ws) - 3 * (i % 5))])
            n_ctx = max(1, 1 + i % max(self.top_k, 1))
            prompts.append(self.tok.encode(
                build_prompt("what is this ?", [ctx] * n_ctx), bos=True))
        warm = self._make_queue()
        warm.submit_all(prompts[:self.engine.batch_size])
        warm.run()
        t0 = time.perf_counter()
        queue = self._make_queue()
        queue.submit_all(prompts)
        queue.run()
        elapsed = max(time.perf_counter() - t0, 1e-6)
        qps = n / elapsed
        self.capacity = CapacityFunction(k=qps, b=0.0,
                                         levels=[(elapsed, float(n))])
        return self.capacity
