"""Request-level schedulers over a ServeEngine: synchronous waves and
continuous batching.

Counterpart of ``repro/serving/scheduler.py``.  One submit / run /
result contract, two policies:

``RequestQueue`` runs synchronous *waves*: requests are grouped by
prompt bucket (``engine.prompt_bucket``), each ``step()`` runs the
fullest bucket's first ``batch_size`` requests through one
``engine.generate`` call (the wave's seed folded from the queue's seed
and the wave index), and a wave runs to its slowest row.

``ContinuousQueue`` (an engine built with ``prefill_chunk=``, paged or
not): FIFO-with-skip or shortest-prefill-first (SJF) admission, per-request
``max_new_tokens`` budgets, retrieved-context ``prefix_len`` marks that
let paged sessions fork cached prefixes, arrival-anchored TTFT and
latency, the SLO shed hint (``set_shed``), per-interval stats as
``snapshot()`` / ``delta()`` of monotone counters, the standing mode
(``standing=True``: one session across ``run(wait_for=...)`` rounds),
the request spans (``shed``, ``queue_wait``, ``prefill``, ``decode``)
and the ``queue_*`` / ``kv_pool_*`` / ``prefix_cache_*`` metric pushes
(the pool and prefix series for paged engines only).  A non-paged
session opens a new frame whenever nothing pending fits the drained one.
"""
from __future__ import annotations

import time
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.engine import ContinuousSession, ServeEngine
from repro_torch.serving.sampling import GenerationParams, fold_seed


def percentile(xs: Sequence[float], q: float) -> float:
    """np.percentile that returns 0.0 (not IndexError) on empty input."""
    xs = np.asarray(list(xs), dtype=np.float64)
    if xs.size == 0:
        return 0.0
    return float(np.percentile(xs, q))


@dataclass
class Request:
    rid: int
    prompt: List[int]


@dataclass
class Completion:
    rid: int
    tokens: List[int]
    prompt_len: int
    bucket: int
    wave: int


@dataclass
class QueueStats:
    waves: int = 0
    requests: int = 0
    tokens_out: int = 0
    slots_run: int = 0        # batch slots dispatched (idle padding too)
    slots_used: int = 0       # slots that held a real request
    # per request: its wave's wall time (a wave's requests finish together)
    latency_s: List[float] = field(default_factory=list)

    @property
    def slot_utilization(self) -> float:
        return self.slots_used / self.slots_run if self.slots_run else 0.0

    @property
    def latency_mean(self) -> float:
        return float(np.mean(self.latency_s)) if self.latency_s else 0.0

    @property
    def latency_p50(self) -> float:
        return percentile(self.latency_s, 50)

    @property
    def latency_p95(self) -> float:
        return percentile(self.latency_s, 95)

    @property
    def latency_p99(self) -> float:
        return percentile(self.latency_s, 99)


class RequestQueue:
    """Packs submitted requests into engine waves; results keep their
    request ids (submission order) however the waves were packed."""

    def __init__(self, engine: ServeEngine,
                 gen: Optional[GenerationParams] = None, *, seed: int = 0):
        self.engine = engine
        self.gen = gen or GenerationParams()
        if self.gen.max_new_tokens >= engine.max_len:
            # reject the impossible (engine, gen) pair up front instead of
            # accepting requests that can never run
            raise ValueError(
                f"max_new_tokens={self.gen.max_new_tokens} does not fit "
                f"the engine cache (max_len={engine.max_len})")
        self.seed = seed
        self._pending: List[Request] = []
        self._done: Dict[int, Completion] = {}
        self._next_rid = 0
        self.stats = QueueStats()

    def submit(self, prompt: Sequence[int]) -> int:
        rid = self._next_rid
        self._next_rid += 1
        # clip at intake so bucketing and waves see the served length
        prompt, = self.engine.clip_prompts([list(prompt)],
                                           self.gen.max_new_tokens)
        self._pending.append(Request(rid, prompt))
        return rid

    def submit_all(self, prompts: Iterable[Sequence[int]]) -> List[int]:
        return [self.submit(p) for p in prompts]

    def pending(self) -> int:
        return len(self._pending)

    def _pick_wave(self) -> List[Request]:
        """Fullest bucket first (ties to the smaller bucket), its first
        ``batch_size`` requests in submission order."""
        by_bucket: Dict[int, List[Request]] = defaultdict(list)
        for r in self._pending:
            b = self.engine.prompt_bucket(len(r.prompt),
                                          self.gen.max_new_tokens)
            by_bucket[b].append(r)
        bucket = max(by_bucket, key=lambda b: (len(by_bucket[b]), -b))
        return by_bucket[bucket][:self.engine.batch_size]

    def step(self) -> List[Completion]:
        """Pack and run one wave; returns its completions (none when
        nothing is pending)."""
        if not self._pending:
            return []
        wave = self._pick_wave()
        taken = {r.rid for r in wave}
        self._pending = [r for r in self._pending if r.rid not in taken]
        t0 = time.perf_counter()
        outs = self.engine.generate([r.prompt for r in wave], gen=self.gen,
                                    seed=fold_seed(self.seed,
                                                   self.stats.waves))
        elapsed = time.perf_counter() - t0
        bucket = self.engine.prompt_bucket(
            max(len(r.prompt) for r in wave), self.gen.max_new_tokens)
        completions = []
        for r, toks in zip(wave, outs):
            c = Completion(r.rid, toks, len(r.prompt), bucket,
                           self.stats.waves)
            self._done[r.rid] = c
            completions.append(c)
        self.stats.waves += 1
        self.stats.requests += len(wave)
        self.stats.tokens_out += sum(len(t) for t in outs)
        self.stats.slots_run += self.engine.batch_size
        self.stats.slots_used += len(wave)
        self.stats.latency_s.extend([elapsed] * len(wave))
        return completions

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; {rid: generated tokens} for every completed
        request (earlier steps' included)."""
        self.engine.start_profile()
        try:
            while self._pending:
                self.step()
        finally:
            self.engine.stop_profile()
        return {rid: c.tokens for rid, c in self._done.items()}

    def result(self, rid: int) -> Completion:
        return self._done[rid]


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
    trace: Optional[str] = None   # obs trace id (None = untraced)
    t_submit: float = 0.0         # perf_counter at submit (TTFT anchor)
    t_admit: float = 0.0          # perf_counter at admission


class ContinuousQueue:
    """Continuous-batching scheduler with pluggable admission policy.

    ``policy="fifo"`` admits the first pending request that fits a free
    row; ``policy="sjf"`` admits the fitting request with the fewest
    prefill chunks (a cached prefix makes a long prompt cheap).  Each
    ``run()`` returns {rid: tokens} for every completed request so far.

    ``standing=True`` makes the queue a *standing engine*: one
    long-lived session persists across ``run()`` calls, so a stream of
    ``submit()`` + ``run(wait_for=...)`` rounds (one per scheduler
    slot) admits into the live frame instead of opening a cold one,
    requests may straddle a round mid-decode (their KV blocks, prefix
    entries and recurrent state stay in the session), and ``set_shed``
    hints take effect at the next refill.  ``close()`` drains and
    releases the frame and KV pool."""

    def __init__(self, engine: ServeEngine,
                 gen: Optional[GenerationParams] = None, *, seed: int = 0,
                 policy: str = "fifo", prefix_capacity: int = 8,
                 standing: bool = False):
        self.engine = engine
        self.gen = gen or GenerationParams()
        if engine.prefill_chunk is None:
            raise ValueError("ContinuousQueue needs an engine built with "
                             "prefill_chunk=...; use RequestQueue for "
                             "synchronous waves")
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
        self.standing = bool(standing)
        self.seed = seed
        self._pending: List[_ContRequest] = []
        self._done: Dict[int, ContinuousCompletion] = {}
        self._next_rid = 0
        self._shed_fraction = 0.0
        self._session: Optional[ContinuousSession] = None
        self._owner: Dict[int, _ContRequest] = {}   # slot -> live request
        self._finished: set = set()                 # rids with final tokens
        self.stats = ContinuousStats()

    # -------------------------------------------------------------- intake

    def set_shed(self, fraction: float) -> None:
        """SLO shed hint: drop this fraction of the pending queue (the
        most recently submitted requests) at the next ``run()`` instead
        of serving them late; 0.0 disables."""
        self._shed_fraction = min(max(float(fraction), 0.0), 1.0)

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               prefix_len: Optional[int] = None,
               trace: Optional[str] = None) -> int:
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
            self._finished.add(rid)
            return rid
        prefix_len = max(0, min(prefix_len or 0, len(prompt) - 1))
        cap = self.engine.cont_max_prompt_len(self.gen.max_new_tokens)
        if len(prompt) > cap:
            prompt, prefix_len = self._truncate(prompt, prefix_len, cap)
            self.stats.shed += 1
        if self.engine.paged:
            self._check_block_span(prompt, prefix_len, budget)
        self._pending.append(_ContRequest(rid, prompt, budget, prefix_len,
                                          trace=trace,
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

    def depth(self) -> int:
        """Standing-queue depth: pending + live (admitted, still
        decoding) requests."""
        return len(self._pending) + len(self._owner)

    def oldest_wait_s(self) -> float:
        """Age of the oldest still-pending (not yet admitted) request;
        0.0 when nothing waits."""
        if not self._pending:
            return 0.0
        return time.perf_counter() - min(r.t_submit for r in self._pending)

    def unfinished(self) -> List[int]:
        """Rids submitted but not finished: pending plus mid-decode."""
        return [r.rid for r in self._pending] \
            + [r.rid for r in self._owner.values()]

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

    def _ensure_session(self) -> ContinuousSession:
        """The live session: standing queues keep one for their whole
        lifetime; per-run queues get a fresh one each ``run()`` (the
        previous was released at run exit)."""
        if self._session is None:
            self._session = ContinuousSession(
                self.engine, self.gen, seed=self.seed,
                prefix_cache=self.prefix_capacity if self.engine.paged
                else None)
        return self._session

    @staticmethod
    def _session_base(session: ContinuousSession) -> Dict[str, int]:
        """Snapshot of the session/allocator/prefix-cache counters at
        run() entry: a standing session outlives the run, so only the
        run's deltas roll into ``self.stats``."""
        base = {"frames": session.frames, "segments": session.segments,
                "refills": session.refills, "forks": 0, "exhaustions": 0,
                "prefix_hits": 0, "prefix_misses": 0, "prefix_evictions": 0}
        if session.paged:
            base["forks"] = session.allocator.forks
            base["exhaustions"] = session.allocator.exhaustions
        pc = session.prefix_cache
        if pc is not None:
            base.update(prefix_hits=pc.hits, prefix_misses=pc.misses,
                        prefix_evictions=pc.evictions)
        return base

    def run(self, wait_for: Optional[Iterable[int]] = None
            ) -> Dict[int, List[int]]:
        """Pump the engine until the target requests finish; returns
        {rid: generated tokens} for every completed request so far.

        By default every submitted request is drained.  A standing
        queue may pass ``wait_for=<rids>``: the call returns as soon as
        those requests finish, leaving other live rows mid-decode for
        the next ``run()``.  TTFT and latency are measured from each
        request's ``submit()``, so they compose across runs."""
        if wait_for is not None and not self.standing:
            raise ValueError("run(wait_for=...) needs standing=True: a "
                             "per-run queue releases its session at run "
                             "exit and would drop mid-decode rows")
        tr = obs_trace.get_tracer()
        paged = self.engine.paged
        base = self.stats.snapshot()
        if self._shed_fraction > 0.0 and self._pending:
            # shed the tail (latest arrivals): the oldest requests have
            # waited longest and would be the first SLO misses
            n_shed = int(len(self._pending) * self._shed_fraction)
            for r in self._pending[len(self._pending) - n_shed:]:
                self._done[r.rid] = ContinuousCompletion(
                    r.rid, [], len(r.prompt), r.budget, -1, -1, 0.0, 0.0,
                    shed=True)
                self._finished.add(r.rid)
                if tr.enabled and r.trace is not None:
                    # terminal span: a shed trace never reaches decode,
                    # so this is what makes its causal tree complete
                    tr.emit("shed", r.trace, r.t_submit,
                            time.perf_counter(), reason="slo_hint")
            if n_shed:
                del self._pending[len(self._pending) - n_shed:]
                self.stats.shed_hint_drops += n_shed
        session = self._ensure_session()
        sbase = self._session_base(session)
        owner = self._owner
        targets = set(wait_for) if wait_for is not None else \
            {r.rid for r in self._pending} | {r.rid for r in owner.values()}

        def admit(slot: int, r: _ContRequest) -> None:
            owner[slot] = r
            abs_now = time.perf_counter()
            if tr.enabled:
                session.traces[slot] = r.trace
                if r.trace is not None:
                    # queue wait becomes a retroactive span: admission is
                    # the only point where both endpoints are known
                    tr.emit("queue_wait", r.trace, r.t_submit, abs_now,
                            slot=slot)
            r.t_admit = abs_now
            ttft = abs_now - r.t_submit
            self.stats.ttft_s.append(ttft)
            self._done[r.rid] = ContinuousCompletion(
                r.rid, [], len(r.prompt), r.budget, slot, session.frames,
                ttft, ttft)

        self.engine.start_profile()
        try:
            while not targets <= self._finished:
                if session.active():
                    # drain (run to the last row) only when every live
                    # row is waited for: a straddling row keeps its slot
                    # and resumes in the next run()
                    live = {r.rid for r in owner.values()}
                    for slot, tokens in session.run_segment(
                            drain=not self._pending and live <= targets):
                        r = owner.pop(slot)
                        abs_now = time.perf_counter()
                        c = self._done[r.rid]
                        c.tokens = tokens
                        c.done_s = abs_now - r.t_submit
                        self._finished.add(r.rid)
                        self.stats.tokens_out += len(tokens)
                        self.stats.latency_s.append(c.done_s)
                        if tr.enabled:
                            session.traces.pop(slot, None)
                            if r.trace is not None and r.t_admit:
                                tr.emit("decode", r.trace, r.t_admit,
                                        abs_now, tokens=len(tokens),
                                        slot=slot)
                    if paged and obs_metrics.metrics_enabled():
                        obs_metrics.registry().gauge(
                            "kv_pool_fragmentation").set(
                                session.pool_fragmentation())
                    if targets <= self._finished:
                        break
                admitted = 0
                if session.cache is not None:
                    # refill first: a live (or drained but warm) frame
                    # admits at its position instead of opening a new one
                    for slot in session.free_slots():
                        r = self._admissible(session)
                        if r is None:
                            break
                        self._pending.remove(r)
                        if tr.enabled:
                            session.traces[slot] = r.trace
                        with tr.span("prefill", trace=r.trace,
                                     mode="refill", slot=slot,
                                     prompt_len=len(r.prompt),
                                     prefix_len=r.prefix_len):
                            session.refill(slot, r.prompt, r.budget,
                                           prefix_len=r.prefix_len or None)
                        admitted += 1
                        admit(slot, r)
                if self._pending and not admitted and not session.active():
                    if paged and session.cache is not None:
                        raise RuntimeError(
                            "paged admission stalled: a pending request "
                            "cannot be scheduled even into an idle frame")
                    # open a frame: the session's first, or a non-paged
                    # restart after a drain left nothing refillable (a
                    # paged session opens one frame: its pool persists,
                    # so later admissions go through refill above)
                    n = max(1, session.frame_capacity(
                        [(len(r.prompt), r.budget) for r in self._pending])) \
                        if paged else session.B
                    if paged and any(r.prefix_len for r in self._pending):
                        # frame rows are packed left-padded, not in the
                        # canonical prefix layout: open with one row so
                        # the rest admit through prefix-aware refill
                        n = 1
                    batch = self._pending[:n]
                    del self._pending[:len(batch)]
                    if tr.enabled:
                        for slot, r in enumerate(batch):
                            session.traces[slot] = r.trace
                    with tr.span("prefill", traces=[r.trace for r in batch],
                                 mode="frame", rows=len(batch)):
                        session.begin_frame([r.prompt for r in batch],
                                            [r.budget for r in batch])
                    for slot, r in enumerate(batch):
                        admit(slot, r)
                if not self._pending and not session.active():
                    break   # wait_for named rids this queue never saw
        finally:
            self.engine.stop_profile()
            if not self.standing and targets - self._finished:
                # aborted mid-run (a paged stall): a per-run queue
                # cannot resume a half-drained session on the next run
                session.release()
                self._session = None
                self._owner.clear()
        s, st = session, self.stats
        st.frames += s.frames - sbase["frames"]
        st.segments += s.segments - sbase["segments"]
        st.refills += s.refills - sbase["refills"]
        if paged:
            st.cow_forks += s.allocator.forks - sbase["forks"]
            st.kv_exhaustions += \
                s.allocator.exhaustions - sbase["exhaustions"]
        pc = s.prefix_cache
        if pc is not None:
            st.prefix_hits += pc.hits - sbase["prefix_hits"]
            st.prefix_misses += pc.misses - sbase["prefix_misses"]
            st.prefix_evictions += pc.evictions - sbase["prefix_evictions"]
        if obs_metrics.metrics_enabled():
            self._push_metrics(session, base)
        if not self.standing:
            session.release()
            self._session = None
        return {rid: c.tokens for rid, c in self._done.items()}

    def close(self, drain: bool = True) -> None:
        """Retire a standing queue: finish every unfinished request
        (``drain=True``) or abandon them, then release the session's
        frame and KV pool.  Safe to call twice; the queue stays usable
        (a later submit()+run() opens a fresh session)."""
        if drain and self.unfinished():
            self.run()
        if self._session is not None:
            self._session.release()
            self._session = None
        self._owner.clear()
        self._pending.clear()

    def _push_metrics(self, session: ContinuousSession,
                      base: Dict[str, int]) -> None:
        """Roll this run's deltas into the global metrics registry
        (host-side, after the run's segments).  ``base`` is the stats
        snapshot taken at run() entry; the counters are monotone, so the
        diff is exactly this run's contribution."""
        reg = obs_metrics.registry()
        d = self.stats.delta(base)
        reg.counter("queue_requests_admitted", policy=self.policy).inc(
            len(d.ttft_s))
        reg.counter("queue_admission_skips").inc(d.admission_skips)
        reg.counter("queue_shed").inc(d.shed)
        reg.counter("queue_shed_hint_drops").inc(d.shed_hint_drops)
        reg.counter("queue_tokens_out").inc(d.tokens_out)
        h = reg.histogram("queue_ttft_s")
        for v in d.ttft_s:
            h.observe(v)
        h = reg.histogram("queue_latency_s")
        for v in d.latency_s:
            h.observe(v)
        reg.gauge("queue_depth").set(float(self.depth()))
        reg.gauge("queue_oldest_wait_s").set(self.oldest_wait_s())
        if not session.paged:
            return
        alloc = session.allocator
        reg.gauge("kv_pool_utilization").set(alloc.utilization())
        reg.gauge("kv_pool_high_watermark").set(alloc.high_watermark)
        reg.counter("kv_pool_cow_forks").inc(d.cow_forks)
        reg.counter("kv_pool_exhaustion_waits").inc(d.kv_exhaustions)
        reg.counter("prefix_cache_hits").inc(d.prefix_hits)
        reg.counter("prefix_cache_misses").inc(d.prefix_misses)
        reg.counter("prefix_cache_evictions").inc(d.prefix_evictions)

    def result(self, rid: int) -> ContinuousCompletion:
        return self._done[rid]

    def pop_result(self, rid: int) -> ContinuousCompletion:
        """``result()`` that releases the stored completion: standing
        queues live for the node's lifetime, so per-slot consumers pop to
        keep the done-map bounded."""
        return self._done.pop(rid)
