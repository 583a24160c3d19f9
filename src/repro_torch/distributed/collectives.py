"""Collective patterns over a mesh axis, on ``torch.distributed``.

Counterpart of ``repro/distributed/collectives.py``: the two cross-node
operations of CoEdge-RAG, each rank running its own part (the reference's
``shard_map`` body) and the parts merged with the axis's collectives
(``_compat``; nothing is issued on an axis of size 1).

1. ``distributed_topk``: the paper's per-node search plus the
   coordinator's merge.  Each rank on ``axis`` holds one contiguous,
   equal-length corpus shard, in rank order (the reference's
   ``P(axis, None)``); the queries are replicated.  A local exact top-k
   (``kernels.ops.retrieval_topk``: the hand-written CUDA kernel on the
   card), ids made global, one ``all_gather`` of the candidates, a
   second top-k over them.  The merge is exact: the top-k of a union is
   the top-k of the per-shard top-ks.
2. ``flash_decode_seq_sharded``: one-token attention over a KV cache
   whose SEQUENCE dim is split over ``axis`` (the long_500k layout).
   Each rank attends to its span; the (numerator, denominator) partials
   merge after a max all-reduce, so the softmax is exact without
   gathering the cache.  The reference computes this in plain einsums,
   outside any Pallas kernel, and so does this: PyTorch operators.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed._compat import (all_gather, all_reduce,
                                             axes_rank, axis_rank,
                                             axis_size)
from repro_torch.kernels import ops, ref


def topk_merge(scores: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of candidate lists [Nq, n]: a STABLE descending sort, so
    equal scores keep their order in the list.  Lists concatenated in
    rank order, each ordered with ties to the lower id, therefore give
    ties to the lower global id, as one top-k over the whole corpus."""
    s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], torch.gather(ids, 1, pos[:, :k])


def distributed_topk(queries: torch.Tensor, corpus_shard: torch.Tensor,
                     k: int, mesh, axis: str = "data",
                     use_kernel: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Nq, D] (replicated), this rank's corpus shard [Nd/P, D]
    (rank r holds rows ``r*Nd/P .. (r+1)*Nd/P - 1``) -> global (scores
    [Nq, k] f32, ids [Nq, k] int32) into the whole corpus, equal on every
    rank of ``axis``.  Ties go to the lower id; slots beyond the corpus
    are (-1e30, -1), as the exact top-k's.  ``use_kernel`` False runs the
    kernel's plain version (``kernels.ref.topk_ref``) on any device, as
    the reference's non-Pallas path scores with ``lax.top_k``."""
    shard_len = corpus_shard.shape[0]
    if use_kernel:
        s, i = ops.retrieval_topk(queries, corpus_shard, k)
    else:
        s, i = ref.topk_ref(queries, corpus_shard, k)
    # globalize the ids (the fill's -1 stays -1)
    i = torch.where(i >= 0, i + axis_rank(mesh, axis) * shard_len, i)
    if axis_size(mesh, axis) == 1:
        return s, i
    s_all = all_gather(s, mesh, axis, dim=1)         # [Nq, P*k], rank order
    i_all = all_gather(i, mesh, axis, dim=1)
    return topk_merge(s_all, i_all, k)


def flash_decode_seq_sharded(q: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor,
                             q_position: torch.Tensor, mesh,
                             axis="data",
                             softcap: Optional[float] = None,
                             kv_positions: Optional[torch.Tensor] = None,
                             window: Optional[int] = None
                             ) -> torch.Tensor:
    """Exact one-token attention over a sequence-sharded cache.

    q [B, 1, H, hd] (replicated), this rank's cache span k_shard /
    v_shard [B, S/P, KV, hd], q_position [B] -> [B, 1, H, hd] in q's
    dtype, equal on every rank.  ``axis`` is a mesh axis or a tuple of
    them, the sequence split over all of them in row-major order: rank r
    holds positions ``r*S/P ..``, unless ``kv_positions`` [B, S/P] gives
    each slot's position (-1 = empty; a rolling buffer's chunk).  Key j
    counts iff 0 <= its position <= q_position (and, with ``window``,
    q_position - its position < window); scores are f32, softcapped
    before the mask, and masked to -1e30, as the reference's."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    B, _, H, hd = q.shape
    shard_len, KV = k_shard.shape[1], k_shard.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    if kv_positions is None:
        kpos = (axes_rank(mesh, axes)[0] * shard_len + torch.arange(
            shard_len, device=q.device))[None]
    else:
        kpos = kv_positions
    qh = q[:, 0].reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qh, k_shard.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = q_position.to(kpos.dtype)[:, None]
    mask = (kpos >= 0) & (kpos <= qp)
    if window:
        mask = mask & (qp - kpos < window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -1e30))
    m = s.amax(-1)                                   # local max
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_shard.float())
    # merge the partials: rescale by the global max, sum the numerators
    # and the denominators
    m_g = m.clone()
    for a in axes:
        all_reduce(m_g, "max", mesh, a)
    corr = torch.exp(m - m_g)
    o = o * corr[..., None]
    l = l * corr
    for a in axes:
        all_reduce(o, "sum", mesh, a)
        all_reduce(l, "sum", mesh, a)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)
