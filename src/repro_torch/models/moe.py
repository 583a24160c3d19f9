"""Mixture-of-Experts layer: top-k routing, per-row capacity, routed
SwiGLU experts and a sigmoid-gated shared expert.

Counterpart of ``repro/models/moe.py``: the same function, not its
buffers.  The reference scatters each batch row's assignments into a
dense [E, C, D] buffer and runs every expert over every slot of it; here
only the routed rows are computed:

  * few assignments (``B*S*k <= MOE_GATHER_MAX``, a decode step): each
    assignment's expert weights are gathered and one ``bmm`` per
    projection runs all of them, with no host synchronisation;
  * more (a prefill chunk): the kept assignments are sorted by expert
    into an [E, width, D] buffer, ``width`` the busiest expert's rows
    (one host read of the per-expert counts), and one ``bmm`` per
    projection runs every expert over its rows (zero rows past an
    expert's count).

Semantics held to the reference:
  * router logits ``x @ router`` in x's dtype, then f32; the top-k of
    them with ties to the lower expert id (as ``lax.top_k``; a stable
    descending sort, since ``torch.topk`` promises no tie order); gates
    the softmax of the top-k logits, cast back to x's dtype;
  * capacity per batch row ``C = min(S*k, ceil(S*k/E*cf))``: a row's
    assignments, in (token, rank) order, are sorted stably by expert id
    and those past position C within their expert are dropped;
  * combine: each token sums ``gate * expert_out`` (0 where dropped) in
    x's dtype, starting from zero, in increasing expert id; the
    reference's scatter-add visits the sorted assignments in that order,
    though XLA does not promise an order for duplicate indices.  No
    atomics: the sum is a fixed sequence of adds;
  * the shared expert's sigmoid gate is computed in f32 and cast to x's
    dtype.
With ``return_aux`` the layer also returns the Switch load-balance
loss: (mean router probability · fraction of top-1 choices) summed over
experts, times E and ``router_aux_loss_coef``, as the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

MOE_GATHER_MAX = 16        # assignments up to which weights are gathered


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    m = cfg.moe
    d = cfg.d_model

    def expert_stack(d_in, d_out):
        w = torch.randn((m.num_experts, d_in, d_out), generator=gen,
                        device=device, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(d_in))).to(dtype)

    p = {"router": dense_init(gen, d, m.num_experts, dtype, device),
         "wi": expert_stack(d, m.expert_d_ff),
         "wg": expert_stack(d, m.expert_d_ff),
         "wo": expert_stack(m.expert_d_ff, d)}
    if m.num_shared_experts:
        f = m.shared_expert_d_ff
        p["shared"] = {"wi": dense_init(gen, d, f, dtype, device),
                       "wg": dense_init(gen, d, f, dtype, device),
                       "wo": dense_init(gen, f, d, dtype, device),
                       "gate": dense_init(gen, d, 1, dtype, device)}
    return p


def capacity(S: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert in one batch row of S tokens."""
    return min(S * k, max(1, math.ceil(S * k / E * capacity_factor)))


def route(params, x: torch.Tensor, k: int):
    """(top_idx [B,S,k] int64, gates [B,S,k] in x's dtype): the top-k
    router logits, ties to the lower expert id."""
    return _route(params, x, k)[:2]


def _route(params, x: torch.Tensor, k: int):
    """``route``'s (top_idx, gates) and the f32 router logits [B,S,E]."""
    logits = (x @ params["router"]).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[..., :k], dim=-1).to(x.dtype)
    return idx[..., :k], gates, logits


def load_balance_loss(logits: torch.Tensor, top_idx: torch.Tensor,
                      coef: float) -> torch.Tensor:
    """The Switch auxiliary loss (f32 scalar) of router logits [B,S,E]
    and the top-k choices [B,S,k]: the mean router probability of each
    expert times the fraction of tokens whose top-1 choice it is, summed,
    times E and ``coef``."""
    E = logits.shape[-1]
    me = torch.softmax(logits, dim=-1).mean((0, 1))
    ce = F.one_hot(top_idx[..., 0], E).float().mean((0, 1))
    return (me * ce).sum() * E * coef


def capacity_keep(top_idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """[B,S,k] bool: the assignment keeps its slot.  Per batch row, the
    (token, rank)-ordered assignments are sorted stably by expert id;
    those at position >= C within their expert drop."""
    B, S, k = top_idx.shape
    e = top_idx.reshape(B, S * k)
    se, order = torch.sort(e, dim=1, stable=True)
    start = torch.searchsorted(se.contiguous(), se.contiguous(), right=False)
    pos = torch.arange(S * k, device=e.device)[None] - start
    keep = torch.empty_like(e, dtype=torch.bool)
    keep.scatter_(1, order, pos < C)
    return keep.reshape(B, S, k)


def _swiglu(x, wg, wi, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def _experts_gathered(params, xa: torch.Tensor, e: torch.Tensor
                      ) -> torch.Tensor:
    """xa [n, D] through expert e[n] each: gathered weights, bmm."""
    xa = xa[:, None]
    h = F.silu(torch.bmm(xa, params["wg"][e])) \
        * torch.bmm(xa, params["wi"][e])
    return torch.bmm(h, params["wo"][e])[:, 0]


def _experts_grouped(params, xa: torch.Tensor, e: torch.Tensor,
                     keep: torch.Tensor) -> torch.Tensor:
    """xa [n, D] through expert e[n] each, kept rows only (others 0):
    the kept rows sorted by expert into an [E, width, D] buffer (width:
    the busiest expert's rows, read back once), one ``bmm`` per
    projection over it, the rows scattered back."""
    E = params["wg"].shape[0]
    key = torch.where(keep, e, torch.full_like(e, E))
    key_s, order = torch.sort(key, stable=True)
    counts = torch.bincount(key_s, minlength=E + 1)[:E]
    host = counts.tolist()                  # the one host read
    nk, width = sum(host), max(host)
    out = torch.zeros_like(xa)
    if nk == 0:
        return out
    ex, src = key_s[:nk], order[:nk]
    rank = torch.arange(nk, device=xa.device) - (torch.cumsum(counts, 0)
                                                 - counts)[ex]
    xs = xa.new_zeros((E, width, xa.shape[1]))
    xs[ex, rank] = xa[src]
    h = F.silu(torch.bmm(xs, params["wg"])) * torch.bmm(xs, params["wi"])
    out[src] = torch.bmm(h, params["wo"])[ex, rank]
    return out


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25, return_aux: bool = False):
    """x [B,S,D] -> y [B,S,D] (routed experts + shared expert), or with
    ``return_aux`` (y, the load-balance loss, an f32 scalar)."""
    m = cfg.moe
    B, S, D = x.shape
    k, E = m.num_experts_per_tok, m.num_experts
    top_idx, gates, logits = _route(params, x, k)
    keep = capacity_keep(top_idx, E, capacity(S, k, E, capacity_factor))
    n = B * S * k
    xa = x[:, :, None].expand(B, S, k, D).reshape(n, D)
    e = top_idx.reshape(n)
    if n <= MOE_GATHER_MAX:
        ye = _experts_gathered(params, xa, e)
    else:
        ye = _experts_grouped(params, xa, e, keep.reshape(n))
    ye = ye.reshape(B, S, k, D)
    contrib = torch.where(keep[..., None], ye, torch.zeros_like(ye)) \
        * gates[..., None]
    # each token's sum in increasing expert id, from zero, in x's dtype
    perm = torch.argsort(top_idx, dim=-1)
    contrib = torch.gather(contrib, 2, perm[..., None].expand(-1, -1, -1, D))
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + contrib[:, :, j]
    if m.num_shared_experts:
        sp = params["shared"]
        gate = torch.sigmoid((x @ sp["gate"]).float()).to(x.dtype)
        y = y + _swiglu(x, sp["wg"], sp["wi"], sp["wo"]) * gate
    if return_aux:
        return y, load_balance_loss(logits, top_idx, m.router_aux_loss_coef)
    return y
