"""KV caches: the contiguous cache, the paged cache (block allocator,
pool layout, scatter writes, gathers), and the per-row state beside
either: recurrent state and the rolling K/V of the "local" and hymba
layers.

Counterpart of ``repro/models/cache.py`` for the "attn", "local",
"hymba", "mlstm" and "slstm" slot kinds and the encoder-decoder's
cross-attention K/V (the reference's ``cache["enc"]``).

Contiguous layout (``Cache``, the non-paged engine): per-row full K/V
buffers ``[La, B, max_len, KV, hd]`` for the La "attn" layers, slot index
== absolute position, every row at one shared absolute ``length`` (a
host int, as the frames of the non-paged engine advance in lockstep),
per-row ``first`` [B], and the same per-row ``state`` as the paged
cache.  ``write_seq`` / ``write_token`` write at the shared position in
place; ``extract_row`` / ``insert_row`` move a whole row (its K/V
buffers, its state and its ``first``), the slot swap behind a non-paged
refill.

Layout (``PagedCache``): K/V pools ``[La, P, bs, KV, hd]`` for the La
"attn" layers only (``paged_slot_names`` in the reference), per-row
``length`` [B], ``first`` [B] and ``block_tables`` [B, NB] (-1 =
unallocated).  Row r's absolute position p lives in pool block
``block_tables[r, p // bs]`` at offset ``p % bs``.  Every other layer
keeps per-row state ``state[layer]``, a dict of [B, ...] tensors: mLSTM
``C``/``n``/``m``, sLSTM ``c``/``n``/``h``/``m`` (f32), a "local"
(sliding-window attention) layer its K/V ``k``/``v`` [B, Lw, KV, hd] in
a rolling buffer of ``Lw = min(window, max_len)`` slots, where slot j
holds the latest position p with p % Lw == j (``rolling_kv_positions``),
and a hymba layer the same K/V beside its Mamba ``h`` (f32) and ``conv``
(model dtype).  In an encoder-decoder model every layer's state holds
its cross-attention K/V over the encoder's frames, ``xk`` / ``xv`` [B,
Se, KV, hd] (model dtype), written by a prefill or chunk and read by a
decode step.  Rolling and cross-attention K/V are not pooled in either
cache: they are part of the row, so refills, forks and prefix entries
copy them with the rest of the row's state.  A model without "attn" layers has
empty pools (La = 0): the block allocator, the block tables and the
copy-on-write decisions run all the same.  The reference consumes
donated caches inside compiled programs; here the pools are
preallocated and written in place, and a layer's recurrent state is
replaced by the new tensors its cell returns.

Invalid writes (pad tokens, finished rows, unallocated blocks) must
write nowhere.  The reference routes them to a positive out-of-bounds
index dropped by ``mode="drop"``; torch's ``index_copy_`` raises on an
out-of-bounds index and wraps negative ones, so ``pool_write_plan``
and ``rolling_write_plan`` select the valid (destination, source) pairs
explicitly, once per call, and every layer reuses the plan.
``pool_write_plan`` + ``paged_write`` take the place of the reference's
``paged_write_token`` (one token per row, decode) and
``paged_write_seq`` (a chunk per row, prefill); ``rolling_write_plan`` +
``rolling_write`` that of ``rolling_write_seq``, and
``rolling_write_token`` (no plan: a frozen row rewrites its slot's old
contents) that of the reference's function of that name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm

RowState = Dict[int, Dict[str, torch.Tensor]]   # layer -> name -> [B, ...]


def full_kv_positions(length: torch.Tensor, s_max: int) -> torch.Tensor:
    """Absolute positions of ``s_max`` buffer slots, -1 where unwritten:
    ``length`` [B, 1] (per-row) -> [B, s_max]."""
    i = torch.arange(s_max, dtype=torch.int32, device=length.device)[None]
    return torch.where(i < length, i, torch.full_like(i, -1))


def shared_kv_positions(length: int, s_max: int, device) -> torch.Tensor:
    """The same for a buffer every row fills to one shared ``length``:
    [s_max] positions, -1 at and beyond ``length``."""
    i = torch.arange(s_max, dtype=torch.int32, device=device)
    return torch.where(i < length, i, torch.full_like(i, -1))


def rolling_kv_positions(length, window: int, device=None) -> torch.Tensor:
    """Absolute position held by each slot of a rolling buffer of
    ``window`` slots after ``length`` tokens (negative = empty): the
    largest p < length with p % window == j.  ``length`` [B, 1] gives
    [B, window]; a host int (one shared length) gives [window].  On a
    buffer that has not wrapped (length <= window) these are the full
    buffer's positions, negative in the empty slots."""
    if not isinstance(length, torch.Tensor):
        length = torch.tensor(length, dtype=torch.int32, device=device)
    j = torch.arange(window, dtype=torch.int32, device=length.device)
    if length.dim():
        j = j[None]
    return j + window * torch.div(length - 1 - j, window,
                                  rounding_mode="floor")


def rolling_len(cfg: ModelConfig, max_len: int) -> int:
    """Slots of a "local" or hymba layer's rolling K/V buffer:
    min(window, max_len)."""
    return min(cfg.sliding_window or max_len, max_len)


class BlockAllocator:
    """Host-side fixed-size KV-block allocator with reference counts.

    Only decides which pool blocks are live; block contents live in the
    device pools.  ``fork`` adds an owner for prefix sharing; a block
    returns to the free list when its refcount reaches zero.
    ``utilization()``, ``high_watermark``, ``forks`` and ``exhaustions``
    (failed ``can_alloc`` probes) are what the schedulers report."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks={num_blocks} must be >= 1")
        self.num_blocks = int(num_blocks)
        self.refcount = np.zeros((self.num_blocks,), np.int32)
        # stack: pop() hands out low ids first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self.high_watermark = 0
        self.forks = 0
        self.exhaustions = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def utilization(self) -> float:
        """Live blocks / pool size, in [0, 1]."""
        return self.in_use / self.num_blocks

    def can_alloc(self, n: int) -> bool:
        if n > len(self._free):
            self.exhaustions += 1
            return False
        return True

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n} blocks, "
                f"{len(self._free)}/{self.num_blocks} free")
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self.refcount[i] = 1
        self.high_watermark = max(self.high_watermark, self.in_use)
        return ids

    def free(self, ids: Sequence[int]) -> None:
        for i in ids:
            i = int(i)
            if self.refcount[i] <= 0:
                raise ValueError(f"double free of block {i}")
            self.refcount[i] -= 1
            if self.refcount[i] == 0:
                self._free.append(i)

    def fork(self, ids: Sequence[int]) -> List[int]:
        """Share ``ids`` with one more owner (copy-on-write fork)."""
        out = []
        for i in ids:
            i = int(i)
            if self.refcount[i] <= 0:
                raise ValueError(f"fork of free block {i}")
            self.refcount[i] += 1
            out.append(i)
        self.forks += len(out)
        return out


def num_row_blocks(max_len: int, block_size: int) -> int:
    return -(-max_len // block_size)


def init_row_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device, kv_heads: Optional[int] = None,
                   rolling: Optional[int] = None) -> RowState:
    """Zeroed per-row state, batch ``batch``: recurrent cells, a "local"
    layer's rolling K/V buffer (``rolling_len`` slots, ``dtype``), for a
    hymba layer the same buffer beside its Mamba state, and in an
    encoder-decoder model (whose layers are "attn") each layer's
    cross-attention K/V ``xk`` / ``xv`` [B, Se, KV, hd] (``dtype``).  A
    plain refill starts from ``init_row_state(cfg, 1, max_len, dtype,
    dev)``.  A tensor-parallel rank's part: ``kv_heads`` KV heads in the
    buffers and ``rolling`` slots in a rolling one."""
    out: RowState = {}
    kv = cfg.num_kv_heads if kv_heads is None else kv_heads
    shape = (batch, rolling_len(cfg, max_len) if rolling is None
             else rolling, kv, cfg.resolved_head_dim)
    enc_shape = (batch, cfg.encoder_seq_len, kv, cfg.resolved_head_dim)
    for i in range(cfg.num_layers):
        kind = cfg.pattern_for_layer(i)
        if cfg.is_encoder_decoder:
            out[i] = {n: torch.zeros(enc_shape, dtype=dtype, device=device)
                      for n in ("xk", "xv")}
        elif kind == "mlstm":
            out[i] = ssm.mlstm_init_state(cfg, batch, device)
        elif kind == "slstm":
            out[i] = ssm.slstm_init_state(cfg, batch, device)
        elif kind in ("local", "hymba"):
            out[i] = {} if kind == "local" else \
                ssm.mamba_init_state(cfg, batch, dtype, device)
            out[i].update(k=torch.zeros(shape, dtype=dtype, device=device),
                          v=torch.zeros(shape, dtype=dtype, device=device))
    return out


def extract_row(x, row: int):
    """A copy of batch row ``row`` (kept as a size-1 batch) of a
    ``RowState`` (the snapshot a prefix entry keeps, the private copy a
    fork resumes from) or of a contiguous ``Cache`` (its K/V buffers,
    recurrent state and ``first``; ``length`` is shared and kept)."""
    if isinstance(x, Cache):
        return Cache(length=x.length, first=x.first[row:row + 1].clone(),
                     k=x.k[:, row:row + 1].clone(),
                     v=x.v[:, row:row + 1].clone(),
                     state=extract_row(x.state, row))
    return {i: {k: a[row:row + 1].clone() for k, a in st.items()}
            for i, st in x.items()}


def insert_row(dst, src, row: int) -> None:
    """Copy the one row of ``src`` into row ``row`` of ``dst`` in place,
    both ``RowState`` (the recurrent-state swap of a paged refill) or
    both contiguous ``Cache`` (every per-row leaf: K/V buffers, state
    and ``first``; the caller keeps both at the same shared ``length``,
    the slot swap of a non-paged refill)."""
    if isinstance(dst, Cache):
        dst.k[:, row] = src.k[:, 0]
        dst.v[:, row] = src.v[:, 0]
        dst.first[row] = src.first[0]
        insert_row(dst.state, src.state, row)
        return
    for i, st in dst.items():
        for k, a in st.items():
            a[row] = src[i][k][0]


@dataclass
class Cache:
    length: int                   # shared absolute position (host int)
    first: torch.Tensor           # [B] int32 first valid abs position
    k: torch.Tensor               # [La, B, max_len, KV, hd] ("attn")
    v: torch.Tensor               # [La, B, max_len, KV, hd]
    state: RowState               # per-row state: [B, ...]
    # a tensor-parallel rank's part of the buffers
    # (``distributed.tensor_parallel.CacheLayout``); None: whole
    layout: Optional[object] = None


def paged_layers(cfg: ModelConfig) -> List[int]:
    """The layers whose K/V go through the pools (the reference's
    ``paged_slot_names``): full attention only.  The rolling K/V of a
    "local" or hymba layer stays in its row's state, its live span
    already O(window)."""
    return [i for i in range(cfg.num_layers)
            if cfg.pattern_for_layer(i) == "attn"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> Cache:
    """Zeroed full K/V buffers for each "attn" layer and zeroed recurrent
    state, at length 0 with every ``first`` 0."""
    shape = (len(paged_layers(cfg)), batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return Cache(length=0,
                 first=torch.zeros(batch, dtype=torch.int32, device=device),
                 k=torch.zeros(shape, dtype=dtype, device=device),
                 v=torch.zeros(shape, dtype=dtype, device=device),
                 state=init_row_state(cfg, batch, max_len, dtype, device))


def _buffer_slots(L: int, start: int, S: int, device):
    """Buffer slots of positions ``start .. start+S-1``: a slice when they
    do not wrap, else the reference's ``(start + arange) % L`` (a segment
    longer than the buffer keeps its last L tokens)."""
    if start + S <= L:
        return slice(start, start + S), slice(None)
    if S >= L:
        return (start + S - L + torch.arange(L, device=device)) % L, \
            slice(S - L, None)
    return (start + torch.arange(S, device=device)) % L, slice(None)


def write_seq(k_buf: torch.Tensor, v_buf: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, start: int) -> None:
    """Write a [B,S,KV,hd] segment at shared position ``start`` into
    [B,L,KV,hd] buffers (an "attn" layer's full ones or a "local" or
    hymba layer's rolling ones), in place."""
    slots, seg = _buffer_slots(k_buf.shape[1], start, k.shape[1], k.device)
    k_buf[:, slots] = k[:, seg].to(k_buf.dtype)
    v_buf[:, slots] = v[:, seg].to(v_buf.dtype)


def write_token(k_buf: torch.Tensor, v_buf: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, pos: int) -> None:
    """Write one [B,1,KV,hd] token at shared position ``pos`` into
    [B,L,KV,hd] buffers (slot ``pos % L``), in place."""
    s = pos % k_buf.shape[1]
    k_buf[:, s] = k[:, 0].to(k_buf.dtype)
    v_buf[:, s] = v[:, 0].to(v_buf.dtype)


def rolling_write_plan(abs_pos: torch.Tensor, window: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Valid per-row writes of tokens at absolute positions ``abs_pos``
    [B, S] (-1 = invalid) into rolling buffers of ``window`` slots: (row
    [n], slot [n], source token [n] into the flattened [B*S] tokens).  A
    row that carries more than ``window`` valid tokens keeps only its
    last ``window`` (so no slot is written twice).  One host
    synchronisation (the count n)."""
    pos = abs_pos.long()
    last = torch.where(pos >= 0, pos, torch.full_like(pos, -1)
                       ).amax(dim=1, keepdim=True)
    valid = (pos >= 0) & (pos > last - window)
    src = torch.nonzero(valid.reshape(-1), as_tuple=True)[0]
    S = pos.shape[1]
    return src // S, pos.reshape(-1)[src] % window, src


def rolling_write(k_buf: torch.Tensor, v_buf: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, plan) -> None:
    """Scatter [B,S,KV,hd] tokens into per-row rolling buffers
    [B,W,KV,hd] in place, as ``plan`` (``rolling_write_plan``) selects."""
    rows, slots, src = plan
    KV, hd = k.shape[2:]
    for buf, x in ((k_buf, k), (v_buf, v)):
        buf[rows, slots] = x.reshape(-1, KV, hd)[src].to(buf.dtype)


def rolling_write_token(k_buf: torch.Tensor, v_buf: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                        active: Optional[torch.Tensor] = None) -> None:
    """Write one [B,1,KV,hd] token per row at per-row absolute position
    ``pos`` [B] into slot ``pos % W`` of per-row rolling buffers
    [B,W,KV,hd], in place.  A row with ``active`` False rewrites the
    slot's old contents (no host synchronisation)."""
    B, W = k_buf.shape[:2]
    rows = torch.arange(B, device=k_buf.device)
    slot = pos.long() % W
    for buf, x in ((k_buf, k), (v_buf, v)):
        new = x[:, 0].to(buf.dtype)
        if active is not None:
            new = torch.where(active[:, None, None], new, buf[rows, slot])
        buf[rows, slot] = new


@dataclass
class PagedCache:
    length: torch.Tensor          # [B] int32 tokens absorbed per row
    first: torch.Tensor           # [B] int32 first valid abs position
    block_tables: torch.Tensor    # [B, NB] int32 pool block ids, -1 free
    k: torch.Tensor               # [La, P, bs, KV, hd] ("attn" layers)
    v: torch.Tensor               # [La, P, bs, KV, hd]
    state: RowState               # per-row state: [B, ...]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    def staging_row(self, table_row: torch.Tensor, length0: int,
                    first0: int, row_state: RowState) -> "PagedCache":
        """A one-row cache over the SAME pools: chunk writes through
        ``table_row`` land directly in the shared pool, while the
        recurrent layers run on ``row_state`` (zeros, or a copy of a
        prefix snapshot), which the chunks replace as they go."""
        dev = self.length.device
        return PagedCache(
            length=torch.tensor([length0], dtype=torch.int32, device=dev),
            first=torch.tensor([first0], dtype=torch.int32, device=dev),
            block_tables=table_row.reshape(1, -1).to(torch.int32),
            k=self.k, v=self.v, state=row_state)


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int,
                     block_size: int, num_blocks: int, dtype,
                     device) -> PagedCache:
    """Zeroed pools of ``num_blocks`` blocks for each "attn" layer, zeroed
    recurrent state, all rows empty."""
    NB = num_row_blocks(max_len, block_size)
    shape = (len(paged_layers(cfg)), num_blocks, block_size,
             cfg.num_kv_heads, cfg.resolved_head_dim)
    return PagedCache(
        length=torch.zeros(batch, dtype=torch.int32, device=device),
        first=torch.zeros(batch, dtype=torch.int32, device=device),
        block_tables=torch.full((batch, NB), -1, dtype=torch.int32,
                                device=device),
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        state=init_row_state(cfg, batch, max_len, dtype, device))


def pool_write_plan(table: torch.Tensor, abs_pos: torch.Tensor,
                    block_size: int, pool_blocks: int,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Valid writes of tokens at absolute positions ``abs_pos`` [B, S]
    (-1 = pad) through ``table`` [B, NB]: (flat pool slot [n], source
    token [n] into the flattened [B*S] tokens).  Positions beyond the
    table, in unallocated blocks, or in rows with ``active`` [B] False
    are left out.  One host synchronisation (the count n)."""
    NB = table.shape[1]
    pos = abs_pos.long()
    col = (pos // block_size).clamp(0, NB - 1)
    blk = torch.gather(table.long(), 1, col)
    valid = (pos >= 0) & (pos < NB * block_size) & (blk >= 0) \
        & (blk < pool_blocks)
    if active is not None:
        valid = valid & active[:, None]
    src = torch.nonzero(valid.reshape(-1), as_tuple=True)[0]
    dst = (blk * block_size + pos % block_size).reshape(-1)[src]
    return dst, src


def paged_write(k_pool: torch.Tensor, v_pool: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, plan: Tuple[torch.Tensor, torch.Tensor]
                ) -> None:
    """Scatter [B, S, KV, hd] tokens into one layer's pools [P, bs, KV,
    hd] in place, as ``plan`` (``pool_write_plan``) selects."""
    dst, src = plan
    P, bs, KV, hd = k_pool.shape
    for pool, x in ((k_pool, k), (v_pool, v)):
        rows = x.reshape(-1, KV, hd)[src].to(pool.dtype)
        pool.view(P * bs, KV, hd).index_copy_(0, dst, rows)


def paged_gather_kv(k_pool: torch.Tensor, v_pool: torch.Tensor,
                    table: torch.Tensor, nb_cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``nb_cap`` table columns of every row, gathered out of
    one layer's pools -> (k, v) each [B, nb_cap*bs, KV, hd].  Unallocated
    entries gather block 0; callers mask them by position."""
    P, bs, KV, hd = k_pool.shape
    tbl = table[:, :nb_cap].long().clamp(0, P - 1)
    B = tbl.shape[0]
    return (k_pool[tbl].reshape(B, nb_cap * bs, KV, hd),
            v_pool[tbl].reshape(B, nb_cap * bs, KV, hd))
