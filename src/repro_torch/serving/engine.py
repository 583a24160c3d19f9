"""Serving engine on torch tensors: the non-paged engine (``generate``,
``generate_reference`` and a continuous session over a contiguous cache)
and the paged continuous engine.

Counterpart of ``repro/serving/engine.py``.

``generate`` serves up to ``batch_size`` prompts as one wave: prompts
are left-padded on the host to a power-of-two *bucket* (from 8; the
batch's exact longest length for recurrent architectures, whose state
would absorb the pads' embeddings), prefilled at ABSOLUTE positions
``0 .. L-1`` (-1 before each row's first token) into a fresh contiguous
``Cache``, and decoded at the shared absolute position with buffer slots
left of ``first`` masked and the read capped at ``kv_cap`` = bucket +
budget (no cap for recurrent architectures).  So a left-padded prompt's
RoPE phases depend on its bucket, exactly as in the reference.  The
tokens and done flags stay on the device and are read back once at the
end; with ``eos_id`` set, one flag (all rows done) is read per step for
the early exit.  ``generate_reference`` is the per-token host loop (one
read of the sampled tokens per step) the reference keeps as its
semantics baseline.

Sampling: the draw that samples decode position ``t`` (0 = the token
after the prompt) uses a fresh ``torch.Generator`` seeded with
``fold_seed(seed, t)``, in both ``generate`` and ``generate_reference``,
so the two agree token for token for one ``seed`` (the reference folds
the step into its PRNG key the same way); ``RequestQueue`` folds the
wave index into its seed for each wave.  Greedy decoding draws nothing.

Continuous batching (``prefill_chunk`` set): prompts are absorbed C
tokens at a time (``Model.prefill_chunk``, per-row RELATIVE positions)
and ``ContinuousSession`` admits a request into a finished row the
moment one frees up, decoding in segments that return to the host
whenever a row finishes.
  * Non-paged (``paged=False``): a frame's rows share one absolute
    position.  A refill chunk-prefills the request into a one-row
    staging cache whose chunks end at that shared position, then
    ``insert_row``s the row (a request fits iff its padded chunks fit
    below the position and its budget above it); when nothing pending
    fits, the frame drains and the next one starts at position 0.  The
    decode read is capped at ``_cont_kv_cap``.
  * Paged (``paged=True``): K/V live in a shared block pool and rows
    keep their own lengths, so admission continues as long as the block
    allocator can hand out a row's block run (plain refill from zero
    state, or a fork of a cached retrieved-context prefix: its blocks
    with a copy-on-write tail block, and a copy of its recurrent-state
    snapshot).

The reference compiles each step into a donated XLA program and runs a
decode segment as one device ``while_loop`` with one summary transfer.
Here PyTorch runs eagerly: caches are updated in place, and a decode
segment is a host loop that reads the sampled tokens back once per step
(the EOS exit needs them).  Exit conditions, admission geometry and
block accounting follow the reference step for step, so schedules
(refills, forks, frames) come out the same.

An encoder-decoder model (whisper-base) is served text-only, as the
reference serves it: every prefill and every chunk (frames, refills,
prefix prefills) feeds the stub frontend's zero frames [B, Se, D] (f32,
on the engine's device), and the model encodes them again each time.

With tracing on (``repro_torch.obs.enable``), a decode segment is one
batched ``decode_segment`` span over the live rows' traces
(``ContinuousSession.traces``, set by the scheduler at admission) and a
prefix fork marks a ``prefix_cache`` event; with it off neither reads
the clock.  ``ServeEngine(profile=logdir)`` brackets each scheduler run
with a ``torch.profiler`` trace into ``logdir``.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cache as cache_lib
from repro_torch.models.model import Model, torch_dtype
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.prefix_cache import PrefixCache, PrefixEntry
from repro_torch.serving.sampling import (GenerationParams, sample_token,
                                         step_generator)

_RECURRENT_KINDS = ("mlstm", "slstm", "hymba")
_MIN_BUCKET = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *, max_len: int = 512,
                 batch_size: int = 8, pad_id: int = 0,
                 prefill_chunk: Optional[int] = None, paged: bool = False,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 moe_capacity_factor: Optional[float] = None,
                 profile: Optional[str] = None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        if paged:
            if prefill_chunk is None:
                raise ValueError("paged=True rides the continuous path; "
                                 "build the engine with prefill_chunk=...")
            if block_size < 1:
                raise ValueError(f"block_size={block_size} must be >= 1")
        emb_dev = params["embed"].device
        if emb_dev.type != self.device.type:
            raise ValueError(f"params live on {emb_dev}, engine on "
                             f"{self.device}")
        cf = moe_capacity_factor
        if cf is None and cfg.moe is not None:
            cf = float(cfg.moe.num_experts)   # dropless at serving sizes
        self.model = Model(cfg, moe_capacity_factor=cf or 1.25)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.prefill_chunk = prefill_chunk
        # paged KV: "attn" K/V live in a shared pool of ``num_blocks``
        # blocks of ``block_size`` tokens addressed through per-row block
        # tables; rows then carry independent lengths
        self.paged = bool(paged)
        self.block_size = int(block_size)
        if self.paged:
            self.nb_total = cache_lib.num_row_blocks(max_len, block_size)
            # default pool: every row can hold a full-length context
            self.num_blocks = int(num_blocks) if num_blocks is not None \
                else batch_size * self.nb_total
        # recurrent state absorbs pad embeddings -> exact-length padding
        self._exact_length = any(kind in _RECURRENT_KINDS
                                 for kind in self.model.kinds)
        # torch.profiler hook: with profile=<logdir> set, the schedulers
        # bracket their runs with start_profile()/stop_profile() so
        # device traces align with host spans
        self.profile_dir = profile

    # ---------------------------------------------------------------- batching

    def max_prompt_len(self, max_new_tokens: int = 0) -> int:
        """Longest prompt the cache can hold while leaving room for
        ``max_new_tokens`` decode steps."""
        return max(1, self.max_len - max(0, max_new_tokens))

    def clip_prompts(self, prompts: List[List[int]], max_new_tokens: int
                     ) -> List[List[int]]:
        """Truncate-left any prompt longer than the cache allows (keeps
        the question-side suffix of RAG prompts) with a warning."""
        cap = self.max_prompt_len(max_new_tokens)
        out, clipped = [], 0
        for p in prompts:
            if len(p) > cap:
                out.append(list(p)[-cap:])
                clipped += 1
            else:
                out.append(p)
        if clipped:
            warnings.warn(
                f"{clipped} prompt(s) exceeded max_len={self.max_len} - "
                f"max_new_tokens={max_new_tokens}; truncated-left to "
                f"{cap} tokens", stacklevel=3)
        return out

    def prompt_bucket(self, prompt_len: int, max_new_tokens: int = 0) -> int:
        """Padded prompt length of a request: the smallest power-of-two
        bucket (from 8) >= prompt_len that still leaves room for
        ``max_new_tokens`` decode steps.  Exact length for recurrent
        architectures (pads would perturb their state), never 0."""
        if self._exact_length:
            return max(1, prompt_len)
        cap = max(prompt_len, self.max_len - max_new_tokens)
        b = _MIN_BUCKET
        while b < prompt_len:
            b *= 2
        return min(b, cap)

    def _pad_batch(self, prompts: List[List[int]], pad_to: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Left-pad to ``pad_to`` on the host: int32 (tokens [B, L],
        first valid position [B]); unused rows are all pads."""
        B = self.batch_size
        if len(prompts) > B:
            raise ValueError(f"{len(prompts)} prompts for batch {B}")
        L = max(1, pad_to, max(len(p) for p in prompts))
        toks = np.full((B, L), self.pad_id, np.int32)
        first = np.full((B,), L, np.int32)
        for i, p in enumerate(prompts):
            toks[i, L - len(p):] = p
            first[i] = L - len(p)
        return toks, first

    # ------------------------------------------------------------ generate

    def _route_empty_prompts(self, prompts, gen: GenerationParams,
                             seed: int, generate_fn: Callable
                             ) -> Optional[List[List[int]]]:
        """Empty prompts condition on nothing, so they get empty
        completions; the rest run as a smaller wave.  None when every
        prompt is non-empty."""
        keep = [i for i, p in enumerate(prompts) if len(p)]
        if len(keep) == len(prompts):
            return None
        outs: List[List[int]] = [[] for _ in prompts]
        if keep:
            sub = generate_fn([prompts[i] for i in keep], seed=seed, gen=gen)
            for i, o in zip(keep, sub):
                outs[i] = o
        return outs

    def _start(self, prompts, gen: GenerationParams, seed: int):
        """Pad, prefill, sample token 0.  Returns (token [B, 1], cache,
        kv_cap): ``kv_cap`` bounds the absolute positions this batch can
        reach (padded prompt length + budget), None for recurrent
        architectures."""
        if gen.max_new_tokens >= self.max_len:
            raise ValueError(
                f"max_new_tokens={gen.max_new_tokens} does not fit the "
                f"engine cache (max_len={self.max_len}); raise max_len or "
                f"lower max_new_tokens")
        prompts = self.clip_prompts(prompts, gen.max_new_tokens)
        bucket = self.prompt_bucket(max(len(p) for p in prompts),
                                    gen.max_new_tokens)
        toks, first = self._pad_batch(prompts, bucket)
        B, L = toks.shape
        pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
        pos = np.where(pos >= first[:, None], pos, -1)
        cache = self.model.init_cache(B, self.max_len, self.device)
        cache.first = self._tensor(first)
        logits = self.model.prefill(self.params, self._tensor(toks),
                                    self._tensor(pos), cache,
                                    encoder_frames=self._frames(B))
        tok = sample_token(logits, gen,
                           step_generator(gen, seed, 0, self.device))
        kv_cap = None if self._exact_length else \
            min(self.max_len, L + gen.max_new_tokens)
        return tok, cache, kv_cap

    def _decode_next(self, tok, cache, kv_cap, gen: GenerationParams,
                     seed: int, t: int) -> torch.Tensor:
        """One decode step at the shared absolute position; samples the
        token of decode position ``t``."""
        logits = self.model.decode_step(self.params, tok, cache,
                                        kv_cap=kv_cap)
        return sample_token(logits, gen,
                            step_generator(gen, seed, t, self.device))

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 gen: Optional[GenerationParams] = None
                 ) -> List[List[int]]:
        """Completions for up to ``batch_size`` prompts.

        Either pass a ``GenerationParams`` via ``gen`` or the
        (max_new_tokens, temperature, eos_id) scalars.  Returns one token
        list per prompt (empty input -> empty output); an emitted EOS is
        the row's last token.  The loop skips the trailing decode once
        the output is full or every row has hit EOS."""
        if gen is None:
            gen = GenerationParams(max_new_tokens=max_new_tokens,
                                   temperature=temperature, eos_id=eos_id)
        if not prompts or gen.max_new_tokens <= 0:
            return [[] for _ in prompts]
        empties = self._route_empty_prompts(prompts, gen, seed, self.generate)
        if empties is not None:
            return empties
        tok, cache, kv_cap = self._start(prompts, gen, seed)
        B, max_new = self.batch_size, gen.max_new_tokens
        dev = self.device
        out = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
        done = torch.arange(B, device=dev) >= len(prompts)  # idle rows
        count = torch.zeros(B, dtype=torch.int32, device=dev)
        for t in range(max_new):
            out[:, t] = torch.where(done, torch.zeros_like(tok[:, 0]),
                                    tok[:, 0])
            count += (~done).to(torch.int32)
            if t + 1 == max_new:
                break
            if gen.eos_id is not None:
                done = done | (tok[:, 0] == gen.eos_id)
                if bool(done.all()):        # the one flag read a step
                    break
            tok = self._decode_next(tok, cache, kv_cap, gen, seed, t + 1)
        out, count = out.cpu().numpy(), count.cpu().numpy()  # one transfer
        return [out[i, :count[i]].tolist() for i in range(len(prompts))]

    def generate_reference(self, prompts: List[List[int]],
                           max_new_tokens: int = 32,
                           temperature: float = 0.0, seed: int = 0,
                           eos_id: Optional[int] = None,
                           gen: Optional[GenerationParams] = None
                           ) -> List[List[int]]:
        """The per-token host loop (one read of the sampled tokens per
        step), the reference's semantics baseline: the same tokens as
        ``generate`` for the same ``seed``."""
        if gen is None:
            gen = GenerationParams(max_new_tokens=max_new_tokens,
                                   temperature=temperature, eos_id=eos_id)
        if not prompts or gen.max_new_tokens <= 0:
            return [[] for _ in prompts]
        empties = self._route_empty_prompts(prompts, gen, seed,
                                            self.generate_reference)
        if empties is not None:
            return empties
        tok, cache, kv_cap = self._start(prompts, gen, seed)
        n = len(prompts)
        outs: List[List[int]] = [[] for _ in range(n)]
        done = [False] * n
        for t in range(gen.max_new_tokens):
            col = tok[:, 0].tolist()                 # per-token host sync
            for i in range(n):
                if not done[i]:
                    outs[i].append(col[i])
                    if gen.eos_id is not None and col[i] == gen.eos_id:
                        done[i] = True
            if all(done):
                break
            tok = self._decode_next(tok, cache, kv_cap, gen, seed, t + 1)
        return outs

    # ------------------------------------------------------------- profiling

    def start_profile(self) -> bool:
        """Begin a ``torch.profiler`` trace into ``profile_dir`` (no-op
        unless the engine was built with ``profile=...`` and no trace is
        already live)."""
        if not self.profile_dir:
            return False
        return obs_recorder.start_device_profile(self.profile_dir,
                                                 self.device)

    def stop_profile(self) -> bool:
        if not self.profile_dir:
            return False
        return obs_recorder.stop_device_profile()

    # ------------------------------------------------------- device steps

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _frames(self, batch: int) -> Optional[torch.Tensor]:
        """The stub audio frontend's frames of an encoder-decoder model:
        zeros [batch, Se, D] f32 (None for a decoder-only model)."""
        if not self.cfg.is_encoder_decoder:
            return None
        return torch.zeros((batch, self.cfg.encoder_seq_len,
                            self.cfg.d_model), dtype=torch.float32,
                           device=self.device)

    def _fresh_cache(self, first: np.ndarray, length0: int
                     ) -> cache_lib.Cache:
        """A zeroed contiguous cache at shared position ``length0`` with
        per-row first positions ``first``: a non-paged session's frame
        (batch) or staging (one-row) cache."""
        cache = self.model.init_cache(first.shape[0], self.max_len,
                                      self.device)
        cache.first = self._tensor(first)
        cache.length = int(length0)
        return cache

    def _paged_fresh_cache(self, first: np.ndarray, lengths: np.ndarray,
                           tables: np.ndarray) -> cache_lib.PagedCache:
        """A zeroed pool with per-row first positions, lengths and block
        tables: the pool a paged session lives in."""
        cache = self.model.init_paged_cache(first.shape[0], self.max_len,
                                            self.block_size, self.num_blocks,
                                            self.device)
        cache.first = self._tensor(first)
        cache.length = self._tensor(lengths)
        cache.block_tables = self._tensor(tables)
        return cache

    def _chunk_step(self, toks: np.ndarray, cache, l_end=None
                    ) -> torch.Tensor:
        """One [B, C] chunk: relative positions (-1 at left pads and, with
        ``l_end``, at columns at/after the prompt end) at the cache's
        current offset (per row in a paged cache, shared in a contiguous
        one), then ``Model.prefill_chunk``.  With ``l_end`` (paged caches:
        per-row lengths, right-padded chunk tails) the logits are read at
        each row's last real column, else at the last column."""
        B, C = toks.shape
        first, length = cache.first, cache.length
        cols = torch.arange(C, dtype=torch.int32, device=self.device)[None]
        if isinstance(length, torch.Tensor):
            length = length[:, None]
        abs_pos = length + cols
        valid = abs_pos >= first[:, None]
        last_col = None
        if l_end is not None:
            valid = valid & (abs_pos < l_end)
            last_col = (l_end - 1 - cache.length).clamp(0, C - 1)
        pos = torch.where(valid, abs_pos - first[:, None],
                          torch.full_like(abs_pos, -1))
        return self.model.prefill_chunk(self.params, self._tensor(toks), pos,
                                        cache, last_col=last_col,
                                        encoder_frames=self._frames(B))

    def _scan_chunks(self, toks: np.ndarray, staging, l_end=None
                     ) -> torch.Tensor:
        """Chunk-prefill ``toks`` [1, k*C] through a staging row; returns
        the last chunk's logits (f32)."""
        C = self.prefill_chunk
        logits = None
        for j in range(toks.shape[1] // C):
            logits = self._chunk_step(toks[:, j * C:(j + 1) * C], staging,
                                      l_end)
        return logits.float()

    def _zero_row_state(self) -> cache_lib.RowState:
        """Zeroed one-row state (recurrent cells, a hymba layer's Mamba
        state and rolling K/V, cross-attention K/V): what a plain refill
        and a prefix prefill start from."""
        return cache_lib.init_row_state(self.cfg, 1, self.max_len,
                                        torch_dtype(self.cfg), self.device)

    @staticmethod
    def _copy_block(cache: cache_lib.PagedCache, src: int, dst: int) -> None:
        """Copy pool block ``src`` into ``dst`` in every "attn" layer (none
        in a model without one): the copy-on-write step when a fork's
        prefix ends mid-block."""
        cache.k[:, dst] = cache.k[:, src]
        cache.v[:, dst] = cache.v[:, src]

    # ----------------------------------------------------------- geometry

    def _cont_nb_cap(self, high: int) -> int:
        """Block-table width a decode segment reads: enough blocks for the
        highest position the segment can reach, rounded up to 4 blocks
        (the reference bounds its compiled variants the same way)."""
        bs = self.block_size
        nb = -(-min(high, self.nb_total * bs) // bs)
        nb = -(-nb // 4) * 4
        return max(1, min(self.nb_total, nb))

    def _cont_kv_cap(self, high: int) -> Optional[int]:
        """Decode-read cap of a non-paged segment: the highest position
        the segment can reach, rounded up to 32 slots (the reference
        bounds its compiled variants the same way); None for recurrent
        architectures."""
        if self._exact_length:
            return None
        cap = -(-min(self.max_len, high) // 32) * 32
        return min(self.max_len, max(cap, _MIN_BUCKET))

    def cont_max_prompt_len(self, max_new_tokens: int) -> int:
        """Longest prompt a continuous session can serve: its chunk
        frames plus the decode budget must fit ``max_len``."""
        if self.prefill_chunk is None:
            raise ValueError("the engine was built without "
                             "prefill_chunk=..., which continuous batching "
                             "requires")
        return max(0, self.max_len - max_new_tokens) \
            // self.prefill_chunk * self.prefill_chunk


class ContinuousSession:
    """Host-side state machine for continuous batching on one engine.

    A session opens a frame (``begin_frame``: up to ``batch_size`` prompts
    left-padded to a shared chunk multiple), then decodes in segments
    that stop whenever a row that was live at entry finishes; the
    scheduler refills freed rows (``refill``) and resumes.

    Non-paged: the frame's rows share one absolute position ``length``; a
    request fits a freed row iff its padded chunks fit below ``length``
    and its budget above it (``can_refill``), and when nothing pending
    fits the frame drains and the scheduler opens the next one.  Paged:
    rows keep independent lengths, so admission continues for as long as
    the block allocator can hand out a row's block run, and a
    ``PrefixCache`` (an int capacity or an instance) lets requests that
    share a retrieved-context prefix fork its prefilled blocks instead of
    prefilling them again.  All positions the model sees are per-row
    relative, so a request's numerics match a solo run wherever it is
    admitted."""

    def __init__(self, engine: ServeEngine, gen: GenerationParams, *,
                 seed: int = 0, prefix_cache=None):
        if engine.prefill_chunk is None:
            raise ValueError("engine was built without prefill_chunk=..., "
                             "which continuous batching requires")
        if gen.max_new_tokens < 1:
            raise ValueError("continuous batching needs max_new_tokens >= 1")
        if engine.cont_max_prompt_len(gen.max_new_tokens) < 1:
            raise ValueError(
                f"prefill_chunk={engine.prefill_chunk} + "
                f"max_new_tokens={gen.max_new_tokens} do not fit the "
                f"engine cache (max_len={engine.max_len})")
        self.eng = engine
        self.gen = gen
        self.C = engine.prefill_chunk
        self.B = engine.batch_size
        self.generator = torch.Generator(device=engine.device)
        self.generator.manual_seed(seed)
        self.cache = None             # Cache or PagedCache of the frame
        self.tok: Optional[torch.Tensor] = None        # [B, 1] on device
        # host state: outputs, cursors, budgets, done flags
        self.out = np.zeros((self.B, gen.max_new_tokens), np.int32)
        self.done = np.ones(self.B, bool)
        self.idx = np.zeros(self.B, np.int32)
        self._budget = np.zeros(self.B, np.int32)
        self._remaining = np.zeros(self.B, np.int32)
        self.tstep = 0                # decode loop iterations this frame
        self.length = 0               # non-paged: the shared position
        self.frames = 0
        self.segments = 0
        self.refills = 0
        # slot -> request trace id (set by the scheduler at admission);
        # decode-segment spans and prefix-cache events attribute to it
        self.traces: Dict[int, Optional[str]] = {}
        # paged block bookkeeping: ``lengths`` mirrors cache.length,
        # ``_tables`` the rows' block tables, so freed rows can return
        # their blocks
        self.paged = engine.paged
        self.prefix_cache = None
        if not self.paged:
            return
        self.allocator = cache_lib.BlockAllocator(engine.num_blocks)
        self.lengths = np.zeros(self.B, np.int64)
        self._tables = np.full((self.B, engine.nb_total), -1, np.int32)
        if prefix_cache is not None:
            if isinstance(prefix_cache, int):
                prefix_cache = PrefixCache(capacity=prefix_cache)
            # an evicted entry returns its block refcounts; blocks forked
            # into live rows survive through the rows' own refs
            prefix_cache.on_evict = \
                lambda e: self.allocator.free(e.block_ids)
            self.prefix_cache = prefix_cache

    # ------------------------------------------------------------- geometry

    def _padded(self, prompt_len: int) -> int:
        return -(-max(1, prompt_len) // self.C) * self.C

    def free_slots(self) -> List[int]:
        return [i for i in range(self.B) if self.done[i]]

    def active(self) -> bool:
        return bool((~self.done).any())

    def can_refill(self, prompt_len: int, budget: int,
                   prefix_len: Optional[int] = None,
                   prompt: Optional[Sequence[int]] = None) -> bool:
        """Non-paged: a request fits iff its padded chunks fit below the
        shared position (its tokens occupy [length - padded, length)) and
        its budget above it.  Paged: iff the allocator can hand out its
        block run (LRU prefix entries are evicted to make room)."""
        if not self.paged:
            return (self.cache is not None
                    and self._padded(prompt_len) <= self.length
                    and self.length + budget <= self.eng.max_len)
        if self.cache is None:
            return False
        prefix = self._prefix_parts(prompt, prefix_len)
        while True:
            need = self._plan_blocks(prompt_len, budget, prefix)
            if need is None:
                return False
            if self.allocator.can_alloc(need):
                return True
            if self.prefix_cache is None or not self.prefix_cache.evict_lru():
                return False

    def _prefix_parts(self, prompt, prefix_len) -> Optional[tuple]:
        """The shareable context-prefix tokens of a request, or None for
        the plain path (always on a non-paged session).  At least one token
        stays on the question side."""
        if self.prefix_cache is None or not prefix_len or prompt is None:
            return None
        prefix_len = min(int(prefix_len), len(prompt) - 1)
        if prefix_len <= 0:
            return None
        return tuple(prompt[:prefix_len])

    def _plan_blocks(self, prompt_len: int, budget: int,
                     prefix: Optional[tuple]) -> Optional[int]:
        """Pool blocks a refill would newly allocate, or None when the
        request's span can never fit one row (> max_len)."""
        bs = self.eng.block_size
        if prefix is None:
            span = self._padded(prompt_len) + budget
            if span > self.eng.max_len:
                return None
            return -(-span // bs)
        p = len(prefix)
        L0 = p + (-p) % self.C
        span = L0 + (prompt_len - p) + budget
        if span > self.eng.max_len:
            return None
        tot = -(-span // bs)
        fork_new = tot - L0 // bs       # COW tail + fresh decode blocks
        if self.prefix_cache.peek(prefix) is not None:
            return fork_new
        return -(-L0 // bs) + fork_new  # prefix prefill allocates too

    def frame_capacity(self, requests: Sequence[Tuple[int, int]]) -> int:
        """How many of the first ``requests`` [(prompt_len, budget)] fit
        one frame: bounded by the batch size only when non-paged; paged
        frames also need a block run per row (the prefix cache is cleared
        at frame start, so its blocks count as free)."""
        n = min(len(requests), self.B)
        if not self.paged:
            return n
        bs = self.eng.block_size
        avail = self.allocator.available
        if self.prefix_cache is not None:
            avail += self.prefix_cache.held_blocks()
        fit = 0
        for k in range(1, n + 1):
            frame_len = self._padded(max(pl for pl, _ in requests[:k]))
            if frame_len + max(b for _, b in requests[:k]) > self.eng.max_len:
                break
            need = sum(-(-(frame_len + b) // bs) for _, b in requests[:k])
            if need > avail:
                break
            fit = k
        return fit

    def admission_cost(self, prompt_len: int, budget: int,
                       prefix_len: Optional[int] = None,
                       prompt: Optional[Sequence[int]] = None) -> int:
        """Prefill chunks admitting this request would run (the SJF key);
        a cached prefix skips its own chunks."""
        prefix = self._prefix_parts(prompt, prefix_len)
        if prefix is not None:
            p = len(prefix)
            L0 = p + (-p) % self.C
            q_chunks = -(-(prompt_len - p) // self.C)
            if self.prefix_cache.peek(prefix) is not None:
                return q_chunks
            return L0 // self.C + q_chunks
        return self._padded(prompt_len) // self.C

    def _release_slot(self, slot: int) -> None:
        """Return a row's pool blocks to the allocator (idempotent)."""
        if not self.paged:
            return
        ids = self._tables[slot][self._tables[slot] >= 0]
        if ids.size:
            self.allocator.free(ids.tolist())
        self._tables[slot] = -1

    def release(self) -> None:
        """Free every pool block held by rows and prefix entries; after
        this ``allocator.available == num_blocks`` (the leak check)."""
        self.traces.clear()
        if not self.paged:
            return
        for i in range(self.B):
            self._release_slot(i)
        if self.prefix_cache is not None:
            self.prefix_cache.clear()

    def pool_fragmentation(self) -> float:
        """Internal fragmentation of the live rows: the fraction of
        allocated pool capacity (blocks x block_size tokens) not yet
        holding live tokens; 0.0 for a non-paged session."""
        if not self.paged:
            return 0.0
        nblk = int((self._tables >= 0).sum())
        if nblk == 0:
            return 0.0
        used = int(self.lengths[~self.done].sum())
        return max(0.0, 1.0 - used / (nblk * self.eng.block_size))

    # ------------------------------------------------------------ admission

    def begin_frame(self, prompts: Sequence[Sequence[int]],
                    budgets: Sequence[int]) -> None:
        """Drop the previous frame and admit up to ``batch_size`` prompts
        at position 0 through the shared [B, C] chunk step.  ``budgets``
        are the rows' decode budgets (a paged frame allocates each row's
        block run from them)."""
        if not prompts or len(prompts) > self.B:
            raise ValueError(f"a frame takes 1..{self.B} prompts")
        if not all(len(p) for p in prompts) or self.active():
            raise ValueError("begin_frame needs non-empty prompts and an "
                             "idle session")
        frame_len = self._padded(max(len(p) for p in prompts))
        toks = np.full((self.B, frame_len), self.eng.pad_id, np.int32)
        first = np.full((self.B,), frame_len, np.int32)
        for i, p in enumerate(prompts):
            toks[i, frame_len - len(p):] = p
            first[i] = frame_len - len(p)
        if self.paged:
            # a fresh frame rebuilds the pool, invalidating cached prefixes
            if self.prefix_cache is not None:
                self.prefix_cache.clear()
            for i in range(self.B):
                self._release_slot(i)
            bs = self.eng.block_size
            tables = np.full((self.B, self.eng.nb_total), -1, np.int32)
            for i in range(len(prompts)):
                ids = self.allocator.alloc(-(-(frame_len + budgets[i]) // bs))
                tables[i, :len(ids)] = ids
            cache = self.eng._paged_fresh_cache(
                first, np.zeros(self.B, np.int32), tables)
            l_end = frame_len
        else:
            cache = self.eng._fresh_cache(first, 0)
            l_end = None
        logits = None
        for j in range(frame_len // self.C):
            logits = self.eng._chunk_step(
                toks[:, j * self.C:(j + 1) * self.C], cache, l_end)
        self.cache = cache
        if self.paged:
            self._tables = tables
            self.lengths = np.full(self.B, frame_len, np.int64)
        self.length = frame_len
        self.tok = sample_token(logits, self.gen, self.generator)
        self.out[:] = 0
        self.done = np.arange(self.B) >= len(prompts)
        self.idx = np.zeros(self.B, np.int32)
        self._remaining = np.zeros(self.B, np.int32)
        self._remaining[:len(prompts)] = budgets
        self._budget = self._remaining.copy()
        self.tstep = 0
        self.frames += 1
        _sync(self.eng.device)      # the frame's first tokens exist now

    def refill(self, slot: int, prompt: Sequence[int], budget: int,
               prefix_len: Optional[int] = None) -> None:
        """Admit ``prompt`` into finished row ``slot`` and sample its first
        token.  Non-paged: chunk-prefill it into a one-row staging cache
        whose chunks end at the shared position, then ``insert_row`` the
        staging row into the slot.  Paged: allocate its block run and
        chunk-prefill it through a one-row staging view of the pool; with
        ``prefix_len`` marking a retrieved-context prefix, the prefix's
        blocks are forked from the ``PrefixCache`` (copy-on-write on a
        mid-block tail) and only the question suffix prefills."""
        p = len(prompt)
        if not self.done[slot] or not self.can_refill(p, budget, prefix_len,
                                                      prompt):
            raise ValueError(f"slot {slot} cannot take a {p}-token prompt "
                             f"with budget {budget} now")
        self._release_slot(slot)
        prefix = self._prefix_parts(prompt, prefix_len)
        if not self.paged:
            self._refill_staged(slot, prompt)
        elif prefix is not None:
            self._refill_fork(slot, prompt, budget, prefix)
        else:
            self._refill_plain(slot, prompt, budget)
        self.done[slot] = False
        self.idx[slot] = 0
        self._budget[slot] = budget
        self._remaining[slot] = budget
        self.refills += 1
        _sync(self.eng.device)      # the row's first token exists now

    def _refill_staged(self, slot: int, prompt: Sequence[int]) -> None:
        """The non-paged refill: a fresh one-row cache whose left-padded
        chunks end at the frame's shared position, its row swapped into
        ``slot`` (K/V buffers, recurrent state, ``first``)."""
        p = len(prompt)
        padded = self._padded(p)
        toks = np.full((1, padded), self.eng.pad_id, np.int32)
        toks[0, padded - p:] = list(prompt)
        d = self.length
        staging = self.eng._fresh_cache(np.asarray([d - p], np.int32),
                                        d - padded)
        logits = self.eng._scan_chunks(toks, staging)
        self.tok[slot] = sample_token(logits, self.gen, self.generator)[0]
        cache_lib.insert_row(self.cache, staging, slot)

    def _admit_row(self, toks, slot, table_row, length0, l_end, first0,
                   row_state: cache_lib.RowState) -> None:
        """Prefill ``toks`` into ``slot`` through a staging row that shares
        the pool and starts from ``row_state`` (the staging row consumes
        it), sample its first token, swap the staging row's recurrent
        state into the slot and point the row at its blocks."""
        cache = self.cache
        row = self.eng._tensor(table_row)
        staging = cache.staging_row(row, length0, first0, row_state)
        logits = self.eng._scan_chunks(toks, staging, l_end)
        self.tok[slot] = sample_token(logits, self.gen, self.generator)[0]
        cache_lib.insert_row(cache.state, staging.state, slot)
        cache.first[slot] = first0
        cache.length[slot] = l_end
        cache.block_tables[slot] = row
        self._tables[slot] = table_row
        self.lengths[slot] = l_end

    def _refill_plain(self, slot: int, prompt: Sequence[int],
                      budget: int) -> None:
        bs = self.eng.block_size
        p = len(prompt)
        padded = self._padded(p)
        ids = self.allocator.alloc(-(-(padded + budget) // bs))
        table_row = np.full(self.eng.nb_total, -1, np.int32)
        table_row[:len(ids)] = ids
        toks = np.full((1, padded), self.eng.pad_id, np.int32)
        toks[0, padded - p:] = list(prompt)
        self._admit_row(toks, slot, table_row, 0, padded, padded - p,
                        self.eng._zero_row_state())

    def _refill_fork(self, slot: int, prompt: Sequence[int], budget: int,
                     prefix: tuple) -> None:
        bs = self.eng.block_size
        entry = self.prefix_cache.get(prefix)
        tr = obs_trace.get_tracer()
        if tr.enabled:
            tr.event("prefix_cache", self.traces.get(slot),
                     hit=entry is not None, prefix_len=len(prefix))
        if entry is None:
            entry = self._prefill_prefix(prefix)
            self.prefix_cache.put(prefix, entry)
        suffix = list(prompt[len(prefix):])
        q = len(suffix)
        L0 = entry.length
        tot = -(-(L0 + q + budget) // bs)
        nfull = L0 // bs
        row_ids = self.allocator.fork(entry.block_ids[:nfull])
        if len(entry.block_ids) > nfull:
            # the prefix ends mid-block: the fork gets a private copy of
            # the tail block so its suffix writes never touch the entry
            cow = self.allocator.alloc(1)
            self.eng._copy_block(self.cache, entry.block_ids[nfull], cow[0])
            row_ids += cow
        row_ids += self.allocator.alloc(tot - len(row_ids))
        table_row = np.full(self.eng.nb_total, -1, np.int32)
        table_row[:tot] = row_ids
        kq = -(-q // self.C)
        toks = np.full((1, kq * self.C), self.eng.pad_id, np.int32)
        toks[0, :q] = suffix
        # resume from a private copy of the snapshot: the entry forks
        # into more rows, and the suffix chunks replace the state
        self._admit_row(toks, slot, table_row, L0, L0 + q, entry.pad,
                        cache_lib.extract_row(entry.row_state, 0))

    def _prefill_prefix(self, prefix: tuple) -> PrefixEntry:
        """Prefill a canonical prefix run (left-padded to a chunk multiple
        so relative positions are admission-invariant) into its own
        blocks.  The entry keeps the staging row's recurrent state at the
        prefix end (empty for a model of "attn" layers only): the
        snapshot every fork of the prefix resumes from."""
        bs = self.eng.block_size
        p = len(prefix)
        pad0 = (-p) % self.C
        L0 = p + pad0
        ids = self.allocator.alloc(-(-L0 // bs))
        table_row = np.full(self.eng.nb_total, -1, np.int32)
        table_row[:len(ids)] = ids
        toks = np.full((1, L0), self.eng.pad_id, np.int32)
        toks[0, pad0:] = list(prefix)
        staging = self.cache.staging_row(self.eng._tensor(table_row), 0,
                                         pad0, self.eng._zero_row_state())
        self.eng._scan_chunks(toks, staging, L0)
        return PrefixEntry(block_ids=list(ids), length=L0, pad=pad0,
                           row_state=staging.state)

    # ------------------------------------------------------------- decoding

    def run_segment(self, drain: bool = False) -> List[Tuple[int, List[int]]]:
        """Decode until some row that was live at entry finishes (budget
        or EOS); with ``drain=True`` run until every row has finished.
        Returns the newly finished [(slot, tokens)].  Each step reads the
        sampled tokens back to the host once."""
        if not self.active():
            raise ValueError("run_segment needs a live row")
        live = ~self.done
        # batched multi-trace span: one wall-clock interval, one event
        # per live request.  Guarded on tr.enabled so the disabled path
        # makes zero clock reads (NULL_SPAN)
        tr = obs_trace.get_tracer()
        sp = obs_trace.NULL_SPAN
        if tr.enabled:
            tif = int(self.lengths[live].sum()) if self.paged \
                else int(live.sum()) * self.length
            sp = tr.span("decode_segment",
                         traces=[self.traces.get(int(i))
                                 for i in np.nonzero(live)[0]],
                         rows=int(live.sum()), tokens_in_flight=tif,
                         drain=bool(drain))
        with sp:
            events = self._segment(live, drain)
            sp.set(finished=len(events), tstep=self.tstep)
        return events

    def _segment(self, live: np.ndarray, drain: bool
                 ) -> List[Tuple[int, List[int]]]:
        eng, gen = self.eng, self.gen
        rem = self._budget[live] - self.idx[live]
        if self.paged:
            nb_cap = eng._cont_nb_cap(
                int((self.lengths[live] + rem).max()) + 2)
        else:
            kv_cap = eng._cont_kv_cap(self.length + int(rem.max()) + 2)
        done0 = self.done.copy()
        done = self.done.copy()
        while not done.all() and (drain or not (done & ~done0).any()):
            self.tstep += 1
            act = ~done
            tok_h = self.tok[:, 0].cpu().numpy()
            rows = np.nonzero(act)[0]
            self.out[rows, self.idx[rows]] = tok_h[rows]
            self.idx[rows] += 1
            self._remaining[rows] -= 1
            done |= self._remaining <= 0
            if gen.eos_id is not None:
                done |= act & (tok_h == gen.eos_id)
            if not done.all() and not self.paged:
                # every row steps at the shared position (a finished
                # row's buffers are replaced when it is refilled)
                logits = eng.model.decode_step(
                    eng.params, self.tok, self.cache, kv_cap=kv_cap,
                    relative=True)
                self.tok = sample_token(logits, gen, self.generator)
                self.length += 1
            elif not done.all():
                # finished rows must not touch the pool: their table
                # entries may point at blocks already handed to live rows
                step_rows = ~done
                logits = eng.model.decode_step(
                    eng.params, self.tok, self.cache, nb_cap=nb_cap,
                    active=torch.as_tensor(step_rows, device=eng.device))
                self.tok = sample_token(logits, gen, self.generator)
                self.lengths[step_rows] += 1
        newly = np.nonzero(done & ~done0)[0]
        events = [(int(i), self.out[i, :self.idx[i]].tolist()) for i in newly]
        for i in newly:
            # a finished row's blocks go straight back to the pool
            self._release_slot(int(i))
        self.done = done
        self.segments += 1
        return events
