"""Plain PyTorch versions of the port's three kernels.

Each function computes exactly what its CUDA kernel computes (same
masking, the same finite ``-1e30`` sentinel, f32 softmax / f32 scores)
by the straightforward unblocked route.  The wrappers in ``ops`` run
these for CPU tensors; ``chip_smoke.py`` holds each CUDA kernel against
its plain version on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


def paged_attention_ref(
    q: torch.Tensor,              # [B, H, hd] one query per row
    k_pool: torch.Tensor,         # [P, bs, KV, hd] block pool
    v_pool: torch.Tensor,         # [P, bs, KV, hd]
    block_tables: torch.Tensor,   # [B, nb] pool ids; -1 unallocated
    first: torch.Tensor,          # [B] first valid absolute position
    last: torch.Tensor,           # [B] last valid absolute position
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Gather each row's blocks, mask slots outside ``first <= pos <=
    last`` or in unallocated blocks, f32 softmax, GQA broadcast.
    -> [B, H, hd] in q.dtype."""
    B, H, hd = q.shape
    P, bs, KV, _ = k_pool.shape
    nb = block_tables.shape[1]
    G = H // KV
    tbl = block_tables.long().clamp(0, P - 1)
    k = k_pool[tbl].reshape(B, nb * bs, KV, hd).float()
    v = v_pool[tbl].reshape(B, nb * bs, KV, hd).float()
    qf = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, k) / math.sqrt(hd)
    s = _softcap(s, softcap)
    pos = torch.arange(nb * bs, device=q.device)[None]
    ok = (block_tables >= 0).repeat_interleave(bs, dim=1)
    mask = (pos >= first[:, None]) & (pos <= last[:, None]) & ok
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v)
    return o.reshape(B, H, hd).to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,              # [B, Sq, H, hd]
    k: torch.Tensor,              # [B, Sk, KV, hd]
    v: torch.Tensor,              # [B, Sk, KV, hd]
    q_pos: torch.Tensor,          # [B, Sq] int absolute positions
    kv_pos: torch.Tensor,         # [B, Sk] int; < 0 = invalid slot
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Position-masked attention, the semantics of the JAX model's
    ``layers.flash_attention``: a key counts iff ``kv_pos >= 0`` and (if
    causal) ``kv_pos <= q_pos`` and (with a window) ``q_pos - kv_pos <
    window``.  A query with no valid key gets an unspecified finite row.
    -> [B, Sq, H, hd] in q.dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kf) / math.sqrt(hd)
    s = _softcap(s, softcap)
    qp = q_pos[:, None, :, None]
    kp = kv_pos[:, None, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (qp - kp < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqs,bshd->bqhd", p, vf)
    return o.to(q.dtype)


def topk_ref(queries: torch.Tensor, docs: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact inner-product top-k: (scores [Nq,k] f32, idx [Nq,k] int32).
    Ties go to the lower doc index (a stable descending sort; torch.topk
    promises no tie order); when k > Nd the tail is (-1e30, -1)."""
    scores = queries.float() @ docs.float().T
    nq, nd = scores.shape
    srt, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    kk = min(k, nd)
    out_s = torch.full((nq, k), NEG_INF, dtype=torch.float32,
                       device=queries.device)
    out_i = torch.full((nq, k), -1, dtype=torch.int32, device=queries.device)
    out_s[:, :kk] = srt[:, :kk]
    out_i[:, :kk] = idx[:, :kk].to(torch.int32)
    return out_s, out_i
