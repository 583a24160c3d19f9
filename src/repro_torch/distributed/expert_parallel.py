"""Expert-parallel MoE: each rank of a mesh axis runs the assignments
routed to its own whole experts, then one all-reduce of the output.

Counterpart of ``repro/distributed/expert_parallel.py``.  Layout: the
expert stacks ``wi``, ``wg`` and ``wo`` split on the EXPERT dim over
``axis`` (rank r holds experts ``r*E/P .. (r+1)*E/P - 1`` at full FFN
width); the router, the shared expert and the activations are whole on
every rank.  Each rank routes every token (the same router, the same
top-k), keeps the assignments of its experts, runs them and combines
locally; one sum of the compact [B, S, D] output over ``axis`` replaces
tensor parallelism's all-reduce of the padded dispatch buffer.  Needs
``num_experts % P == 0``.

It runs forward only.  Its sum over ``axis`` is not differentiated: a
gradient would also need the replicated router's, shared expert's and
input's gradients summed over ``axis``.  So a call that would build a
graph raises.  Training runs the experts whole (the data-parallel step),
as the reference's ``build_step`` keeps expert parallelism out of
training.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed._compat import (all_reduce, axis_rank,
                                             axis_size)
from repro_torch.models import moe


def expert_range(cfg: ModelConfig, mesh, axis: str = "model"
                 ) -> Tuple[int, int]:
    """[lo, hi): the experts this rank of ``axis`` holds."""
    E, P = cfg.moe.num_experts, axis_size(mesh, axis)
    if E % P:
        raise ValueError(f"{E} experts do not split over {P} ranks of "
                         f"{axis!r}")
    lo = axis_rank(mesh, axis) * (E // P)
    return lo, lo + E // P


def local_experts(params: dict, cfg: ModelConfig, mesh,
                  axis: str = "model") -> dict:
    """This rank's MoE params from a dict holding every expert: its
    slice of the expert stacks (copied, so the whole stacks can be
    freed), the router and shared expert as given."""
    lo, hi = expert_range(cfg, mesh, axis)
    out = dict(params)
    for name in ("wi", "wg", "wo"):
        out[name] = params[name][lo:hi].clone()
    return out


def local_model_params(params: dict, cfg: ModelConfig, mesh,
                       axis: str = "model") -> dict:
    """A whole model's params with every layer's MoE stacks cut to this
    rank's experts (``local_experts``): the tree ``Model(ep_mesh=)``
    runs.  The other leaves are shared, not copied."""
    out = dict(params)
    out["blocks"] = [dict(b, moe=local_experts(b["moe"], cfg, mesh, axis))
                     if "moe" in b else b for b in params["blocks"]]
    return out


def moe_tensors(params: dict) -> list:
    """Every tensor of a MoE param dict (the shared expert's too)."""
    return [t for v in params.values()
            for t in (v.values() if isinstance(v, dict) else [v])]


def apply_moe_expert_parallel(params: dict, x: torch.Tensor,
                              cfg: ModelConfig, mesh, axis: str = "model",
                              capacity_factor: float = 1.25,
                              batch_mesh=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``models.moe.apply_moe(..., return_aux=True)`` with the experts
    split over ``axis``: x [B, S, D] -> (y [B, S, D], the load-balance
    loss).  ``params`` holds this rank's experts only
    (``local_experts``).  ``batch_mesh``: as in ``apply_moe``."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in moe_tensors(params))):
        raise NotImplementedError(
            "expert-parallel MoE runs forward only: call it under "
            "torch.no_grad() or on tensors that need no gradient")
    m = cfg.moe
    S = x.shape[1]
    k, E = m.num_experts_per_tok, m.num_experts
    lo, hi = expert_range(cfg, mesh, axis)
    if params["wi"].shape[0] != hi - lo:
        raise ValueError(f"moe/wi holds {params['wi'].shape[0]} experts: "
                         f"this rank's {hi - lo} expected (local_experts)")
    top_idx, gates, logits = moe._route(params, x, k)
    # Capacity is counted from the GLOBAL expert count, and the kept set
    # is apply_moe's: a rank sees its experts' assignments in the same
    # (token, rank) order as the whole layer does, so an assignment
    # keeps its slot here iff it keeps it in apply_moe
    C = moe.capacity(S, k, E, capacity_factor)
    keep = moe.capacity_keep(top_idx, E, C)
    keep = keep & (top_idx >= lo) & (top_idx < hi)
    y = moe.routed(params, x, top_idx, gates, keep, lo, capacity=C)
    # ONE sum of the compact output over the axis, in f32 (for two ranks
    # bitwise the sum in x's dtype), then the shared expert
    y = all_reduce(y.float(), "sum", mesh, axis).to(x.dtype)
    y = y + moe.shared_expert(params, x) if m.num_shared_experts else y
    return y, moe.load_balance_loss(logits, top_idx, m.router_aux_loss_coef,
                                    batch_mesh)
