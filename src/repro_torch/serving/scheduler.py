"""Continuous-batching request scheduler over a paged ServeEngine.

Counterpart of ``ContinuousQueue`` in ``repro/serving/scheduler.py``:
FIFO-with-skip or shortest-prefill-first (SJF) admission, per-request
``max_new_tokens`` budgets, retrieved-context ``prefix_len`` marks that
let paged sessions fork cached prefixes, and arrival-anchored TTFT and
latency, the SLO shed hint (``set_shed``), and per-interval stats as
``snapshot()`` / ``delta()`` of monotone counters.  The reference's
tracing and metric pushes are left out, and so are ``standing=True``
and the wave scheduler ``RequestQueue``.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import ContinuousSession, ServeEngine
from repro_torch.serving.sampling import GenerationParams


def percentile(xs: Sequence[float], q: float) -> float:
    """np.percentile that returns 0.0 (not IndexError) on empty input."""
    xs = np.asarray(list(xs), dtype=np.float64)
    if xs.size == 0:
        return 0.0
    return float(np.percentile(xs, q))


class RequestQueue:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("RequestQueue (synchronous waves) is not "
                                  "ported yet; use ContinuousQueue")


@dataclass
class ContinuousCompletion:
    rid: int
    tokens: List[int]
    prompt_len: int
    budget: int                   # per-request max_new_tokens
    slot: int                     # engine batch row it decoded in
    frame: int                    # session frame it was admitted into
    ttft_s: float                 # submit -> first token
    done_s: float                 # submit -> last token
    shed: bool = False            # dropped at run() start by a shed hint


@dataclass
class ContinuousStats:
    requests: int = 0
    tokens_out: int = 0
    frames: int = 0               # full batch (re)starts
    segments: int = 0             # decode segments run
    refills: int = 0              # mid-frame per-slot admissions
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_evictions: int = 0
    admission_skips: int = 0      # pending requests passed over (no fit)
    shed: int = 0                 # requests truncated at intake to fit
    shed_hint_drops: int = 0      # requests dropped by the SLO shed hint
    cow_forks: int = 0            # paged copy-on-write block forks
    kv_exhaustions: int = 0       # paged pool-exhaustion waits
    ttft_s: List[float] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)

    # Every scalar above is a monotone counter for the queue's lifetime;
    # per-interval numbers are a snapshot() before the interval diffed
    # by delta() after it.
    COUNTERS = ("requests", "tokens_out", "frames", "segments", "refills",
                "prefix_hits", "prefix_misses", "prefix_evictions",
                "admission_skips", "shed", "shed_hint_drops",
                "cow_forks", "kv_exhaustions")

    def snapshot(self) -> Dict[str, int]:
        """Point-in-time copy of the monotone counters (plus the lengths
        of the per-request sample lists)."""
        snap = {k: getattr(self, k) for k in self.COUNTERS}
        snap["ttft_n"] = len(self.ttft_s)
        snap["latency_n"] = len(self.latency_s)
        return snap

    def delta(self, base: Dict[str, int]) -> "ContinuousStats":
        """Stats accumulated since ``base`` (an earlier snapshot()) as a
        fresh ContinuousStats."""
        d = ContinuousStats()
        for k in self.COUNTERS:
            setattr(d, k, getattr(self, k) - base[k])
        d.ttft_s = self.ttft_s[base["ttft_n"]:]
        d.latency_s = self.latency_s[base["latency_n"]:]
        return d

    @property
    def ttft_mean(self) -> float:
        return float(np.mean(self.ttft_s)) if self.ttft_s else 0.0

    @property
    def ttft_p50(self) -> float:
        return percentile(self.ttft_s, 50)

    @property
    def ttft_p95(self) -> float:
        return percentile(self.ttft_s, 95)

    @property
    def latency_mean(self) -> float:
        return float(np.mean(self.latency_s)) if self.latency_s else 0.0

    @property
    def latency_p50(self) -> float:
        return percentile(self.latency_s, 50)

    @property
    def latency_p95(self) -> float:
        return percentile(self.latency_s, 95)


@dataclass
class _ContRequest:
    rid: int
    prompt: List[int]
    budget: int
    prefix_len: int = 0           # retrieved-context prefix (0 = none)
    t_submit: float = 0.0         # perf_counter at submit (TTFT anchor)


class ContinuousQueue:
    """Continuous-batching scheduler with pluggable admission policy.

    ``policy="fifo"`` admits the first pending request that fits a free
    row; ``policy="sjf"`` admits the fitting request with the fewest
    prefill chunks (a cached prefix makes a long prompt cheap).  Each
    ``run()`` drains every submitted request through one session and
    returns {rid: tokens}."""

    def __init__(self, engine: ServeEngine,
                 gen: Optional[GenerationParams] = None, *, seed: int = 0,
                 policy: str = "fifo", prefix_capacity: int = 8,
                 standing: bool = False):
        if standing:
            raise NotImplementedError("standing queues are not ported yet "
                                      "(ROADMAP queue A)")
        self.engine = engine
        self.gen = gen or GenerationParams()
        if policy not in ("fifo", "sjf"):
            raise ValueError(f"unknown admission policy {policy!r}; "
                             "expected 'fifo' or 'sjf'")
        if self.gen.max_new_tokens < 1 \
                or self.gen.max_new_tokens >= engine.max_len \
                or engine.cont_max_prompt_len(self.gen.max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens={self.gen.max_new_tokens} and "
                f"prefill_chunk={engine.prefill_chunk} do not fit the "
                f"engine cache (max_len={engine.max_len})")
        self.policy = policy
        self.prefix_capacity = prefix_capacity
        self.seed = seed
        self._pending: List[_ContRequest] = []
        self._done: Dict[int, ContinuousCompletion] = {}
        self._next_rid = 0
        self._shed_fraction = 0.0
        self.stats = ContinuousStats()

    # -------------------------------------------------------------- intake

    def set_shed(self, fraction: float) -> None:
        """SLO shed hint: drop this fraction of the pending queue (the
        most recently submitted requests) at the next ``run()`` instead
        of serving them late; 0.0 disables."""
        self._shed_fraction = min(max(float(fraction), 0.0), 1.0)

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               prefix_len: Optional[int] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        budget = self.gen.max_new_tokens if max_new_tokens is None \
            else min(max_new_tokens, self.gen.max_new_tokens)
        budget = max(1, budget)
        prompt = list(prompt)
        self.stats.requests += 1
        if not prompt:
            # an empty prompt conditions on nothing -> empty completion
            self._done[rid] = ContinuousCompletion(
                rid, [], 0, budget, -1, -1, 0.0, 0.0)
            return rid
        prefix_len = max(0, min(prefix_len or 0, len(prompt) - 1))
        cap = self.engine.cont_max_prompt_len(self.gen.max_new_tokens)
        if len(prompt) > cap:
            prompt, prefix_len = self._truncate(prompt, prefix_len, cap)
            self.stats.shed += 1
        self._check_block_span(prompt, prefix_len, budget)
        self._pending.append(_ContRequest(rid, prompt, budget, prefix_len,
                                          t_submit=time.perf_counter()))
        return rid

    def _truncate(self, prompt: List[int], prefix_len: int,
                  cap: int) -> tuple:
        """Truncate-left an over-long prompt, keeping the prefix length a
        chunk multiple so every question against the same context keeps
        the same prefix tokens (one prefix-cache key)."""
        n = len(prompt)
        q = n - prefix_len
        keep_p = (cap - min(q, cap)) // self.engine.prefill_chunk \
            * self.engine.prefill_chunk if prefix_len else 0
        if keep_p >= 1:
            warnings.warn(
                f"prompt of {n} tokens exceeds the continuous frame "
                f"capacity ({cap}); truncated-left to {keep_p + q} tokens "
                f"at a chunk boundary (prefix {prefix_len} -> {keep_p})",
                stacklevel=3)
            return prompt[prefix_len - keep_p:], keep_p
        warnings.warn(
            f"prompt of {n} tokens exceeds the continuous frame capacity "
            f"({cap}); truncated-left to {cap} tokens", stacklevel=3)
        return prompt[-cap:], 0

    def _check_block_span(self, prompt: List[int], prefix_len: int,
                          budget: int) -> None:
        """Reject a request whose block run cannot fit even an empty
        pool (it would never become admissible)."""
        C, bs = self.engine.prefill_chunk, self.engine.block_size
        padded = -(-len(prompt) // C) * C
        need = -(-(padded + budget) // bs)
        if prefix_len:
            L0 = prefix_len + (-prefix_len) % C
            tot = -(-(L0 + len(prompt) - prefix_len + budget) // bs)
            need = max(need, -(-L0 // bs) + tot - L0 // bs)
        if need > self.engine.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks (prompt {len(prompt)}, "
                f"budget {budget}) but the pool only has "
                f"{self.engine.num_blocks}")

    def submit_all(self, prompts: Iterable[Sequence[int]],
                   max_new_tokens: Optional[Iterable[int]] = None,
                   prefix_lens: Optional[Iterable[int]] = None
                   ) -> List[int]:
        budgets = list(max_new_tokens) if max_new_tokens is not None \
            else None
        plens = list(prefix_lens) if prefix_lens is not None else None
        return [self.submit(p, budgets[i] if budgets else None,
                            plens[i] if plens else None)
                for i, p in enumerate(list(prompts))]

    def pending(self) -> int:
        return len(self._pending)

    # ----------------------------------------------------------- scheduling

    def _admissible(self, session: ContinuousSession
                    ) -> Optional[_ContRequest]:
        """Next pending request that fits: first fit (FIFO-with-skip) or
        cheapest prefill among the fits (SJF)."""
        def fits(r):
            ok = session.can_refill(len(r.prompt), r.budget,
                                    r.prefix_len or None, r.prompt)
            if not ok:
                self.stats.admission_skips += 1
            return ok
        if self.policy == "fifo":
            for r in self._pending:
                if fits(r):
                    return r
            return None
        best = None
        for r in self._pending:
            if fits(r):
                cost = session.admission_cost(
                    len(r.prompt), r.budget, r.prefix_len or None, r.prompt)
                if best is None or cost < best[0]:
                    best = (cost, r)
        return best[1] if best else None

    def run(self) -> Dict[int, List[int]]:
        """Serve every pending request; returns {rid: generated tokens}
        for every completed request so far.  TTFT and latency are
        measured from each request's ``submit()``."""
        if self._shed_fraction > 0.0 and self._pending:
            # shed the tail (latest arrivals): the oldest requests have
            # waited longest and would be the first SLO misses
            n_shed = int(len(self._pending) * self._shed_fraction)
            for r in self._pending[len(self._pending) - n_shed:]:
                self._done[r.rid] = ContinuousCompletion(
                    r.rid, [], len(r.prompt), r.budget, -1, -1, 0.0, 0.0,
                    shed=True)
            if n_shed:
                del self._pending[len(self._pending) - n_shed:]
                self.stats.shed_hint_drops += n_shed
        session = ContinuousSession(self.engine, self.gen, seed=self.seed,
                                    prefix_cache=self.prefix_capacity)
        owner: Dict[int, _ContRequest] = {}

        def admit(slot: int, r: _ContRequest) -> None:
            owner[slot] = r
            ttft = time.perf_counter() - r.t_submit
            self.stats.ttft_s.append(ttft)
            self._done[r.rid] = ContinuousCompletion(
                r.rid, [], len(r.prompt), r.budget, slot, session.frames,
                ttft, ttft)

        try:
            while self._pending or session.active():
                if session.active():
                    for slot, tokens in session.run_segment(
                            drain=not self._pending):
                        r = owner.pop(slot)
                        c = self._done[r.rid]
                        c.tokens = tokens
                        c.done_s = time.perf_counter() - r.t_submit
                        self.stats.tokens_out += len(tokens)
                        self.stats.latency_s.append(c.done_s)
                admitted = 0
                if session.cache is not None:
                    for slot in session.free_slots():
                        r = self._admissible(session)
                        if r is None:
                            break
                        self._pending.remove(r)
                        session.refill(slot, r.prompt, r.budget,
                                       prefix_len=r.prefix_len or None)
                        admitted += 1
                        admit(slot, r)
                if self._pending and not admitted and not session.active():
                    if session.cache is not None:
                        raise RuntimeError(
                            "paged admission stalled: a pending request "
                            "cannot be scheduled even into an idle frame")
                    # open the session's one frame; the pool persists, so
                    # later admissions go through refill above
                    n = max(1, session.frame_capacity(
                        [(len(r.prompt), r.budget) for r in self._pending]))
                    if any(r.prefix_len for r in self._pending):
                        # frame rows are packed left-padded, not in the
                        # canonical prefix layout: open with one row so the
                        # rest admit through prefix-aware refill
                        n = 1
                    batch = self._pending[:n]
                    del self._pending[:len(batch)]
                    session.begin_frame([r.prompt for r in batch],
                                        [r.budget for r in batch])
                    for slot, r in enumerate(batch):
                        admit(slot, r)
        finally:
            st = self.stats
            st.frames += session.frames
            st.segments += session.segments
            st.refills += session.refills
            st.cow_forks += session.allocator.forks
            st.kv_exhaustions += session.allocator.exhaustions
            pc = session.prefix_cache
            st.prefix_hits += pc.hits
            st.prefix_misses += pc.misses
            st.prefix_evictions += pc.evictions
            session.release()
        return {rid: c.tokens for rid, c in self._done.items()}

    def result(self, rid: int) -> ContinuousCompletion:
        return self._done[rid]

    def pop_result(self, rid: int) -> ContinuousCompletion:
        """``result()`` that releases the stored completion."""
        return self._done.pop(rid)
