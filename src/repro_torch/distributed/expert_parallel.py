"""Expert-parallel MoE: each rank of `model` runs the assignments routed
to its own whole experts.

Counterpart of ``repro/distributed/expert_parallel.py``.  Layout (the
reference's ``param_specs(moe_ep=True)``, which ``TensorParallel(
moe_ep=True)`` cuts): the expert stacks ``wi``, ``wg`` and ``wo`` split
on the EXPERT dim over `model` (rank r holds experts ``r*E/P ..
(r+1)*E/P - 1`` at full FFN width); the router whole on every rank, the
shared expert cut by its FFN columns.  Each rank routes every token (the
same router, the same top-k), keeps the assignments of its experts and
runs them (``routed``); ``models.moe.apply_moe(tp=)`` then sums the
compact [B, S, D] routed output and the shared expert's partial output
over `model` in one reduce.  Needs ``num_experts % P == 0``.

It runs forward only: the reference's ``build_step`` keeps expert
parallelism out of training, which cuts the experts by their FFN dim
instead.  A call that would build a graph raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed._compat import axis_rank, axis_size


def expert_range(cfg: ModelConfig, mesh, axis: str = "model"
                 ) -> Tuple[int, int]:
    """[lo, hi): the experts this rank of ``axis`` holds."""
    E, P = cfg.moe.num_experts, axis_size(mesh, axis)
    if E % P:
        raise ValueError(f"{E} experts do not split over {P} ranks of "
                         f"{axis!r}")
    lo = axis_rank(mesh, axis) * (E // P)
    return lo, lo + E // P


def moe_tensors(params: dict) -> list:
    """Every tensor of a MoE param dict (the shared expert's too)."""
    return [t for v in params.values()
            for t in (v.values() if isinstance(v, dict) else [v])]


def forward_only(params: dict, x: torch.Tensor) -> None:
    """Raise when a call would build a graph: expert parallelism is not
    differentiated."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in moe_tensors(params))):
        raise NotImplementedError(
            "expert-parallel MoE runs forward only: call it under "
            "torch.no_grad() or on tensors that need no gradient")


def routed(params: dict, x: torch.Tensor, top_idx: torch.Tensor,
           gates: torch.Tensor, keep: torch.Tensor, cfg: ModelConfig,
           mesh, capacity: Optional[int] = None) -> torch.Tensor:
    """This rank's share of ``models.moe.routed`` [B, S, D]: the kept
    assignments (``keep``, the whole layer's) to its own experts, which
    ``params`` holds.  Capacity counts the GLOBAL expert count, so a rank
    sees its experts' assignments in the same (token, rank) order as the
    whole layer does: an assignment keeps its slot here iff it keeps it
    in the whole layer."""
    from repro_torch.models import moe
    forward_only(params, x)
    lo, hi = expert_range(cfg, mesh)
    if params["wi"].shape[0] != hi - lo:
        raise ValueError(f"moe/wi holds {params['wi'].shape[0]} experts: "
                         f"this rank's {hi - lo} expected (shard_params("
                         "moe_ep=True))")
    keep = keep & (top_idx >= lo) & (top_idx < hi)
    return moe.routed(params, x, top_idx, gates, keep, lo,
                      capacity=capacity)
