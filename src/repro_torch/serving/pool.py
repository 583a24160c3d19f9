"""Model-pool manager: deployment state + reconfiguration-cost accounting.

A copy of ``repro/serving/pool.py``: numpy and float64, the same
arithmetic in the same order and the same generator draws, so results
equal the reference's bit for bit (the port imports nothing of it).

Implements the paper's GPU model lifecycle exactly (§III-B / §IV-C):

  d_mk   in {0,1}  deployment status of model m on GPU k        (paper d^t_mnk)
  ULD    = (1-d^t)*d^{t-1}                  unloading   (Eq. 1, ~free)
  LD     = d^t*(1-d^{t-1})                  fresh load  (Eq. 19, costs l_m)
  RLD    = deployed & resource changed      reload      (Eq. 20-23, costs l_m)
  TL_k   = sum_m (LD+RLD)*l_m               serialized per-GPU load time (Eq. 24)

Loads are serialized per GPU (the paper's contention rule), so the slot's
reconfiguration latency is max_k TL_k.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.configs.edge_pool import EdgeModelSpec


@dataclass
class ReconfigReport:
    tl_per_gpu: List[float]               # TL_k seconds
    loads: List[Tuple[str, int]]          # (model, gpu) freshly loaded
    reloads: List[Tuple[str, int]]        # resource-changed reloads
    unloads: List[Tuple[str, int]]

    @property
    def max_tl(self) -> float:
        return max(self.tl_per_gpu) if self.tl_per_gpu else 0.0


class ModelPoolManager:
    """Tracks (d_mk, R_mk) across slots for one edge node."""

    def __init__(self, specs: List[EdgeModelSpec], num_gpus: int,
                 gpu_mem: float = 1.0, eps: float = 0.01):
        self.specs = {s.name: s for s in specs}
        self.num_gpus = num_gpus
        self.gpu_mem = gpu_mem
        self.eps = eps                    # epsilon_1: significant-change bar
        # R[k][model] — current memory fraction (0 = undeployed)
        self.R: List[Dict[str, float]] = [dict() for _ in range(num_gpus)]

    def deployed(self, k: int) -> Dict[str, float]:
        return {m: r for m, r in self.R[k].items() if r > 0}

    def validate(self, alloc: Dict[Tuple[str, int], float]) -> None:
        per_gpu = [0.0] * self.num_gpus
        for (m, k), r in alloc.items():
            spec = self.specs[m]
            if r > 0:
                assert r >= spec.min_mem_frac - 1e-9, \
                    f"{m}@gpu{k}: R={r:.3f} < r_m={spec.min_mem_frac:.3f}"
                per_gpu[k] += r
        for k, tot in enumerate(per_gpu):
            assert tot <= self.gpu_mem + 1e-9, f"gpu{k} over memory: {tot:.3f}"

    def apply(self, alloc: Dict[Tuple[str, int], float]) -> ReconfigReport:
        """Transition to a new allocation; returns the reconfig report."""
        self.validate(alloc)
        tl = [0.0] * self.num_gpus
        loads, reloads, unloads = [], [], []
        new_R: List[Dict[str, float]] = [dict() for _ in range(self.num_gpus)]
        for k in range(self.num_gpus):
            names = set(self.R[k]) | {m for (m, kk) in alloc if kk == k}
            for m in names:
                r_prev = self.R[k].get(m, 0.0)
                r_new = alloc.get((m, k), 0.0)
                d_prev, d_new = r_prev > 0, r_new > 0
                changed = abs(r_new - r_prev) > self.eps       # RC (Eq.14-17)
                uld = (not d_new) and d_prev                   # Eq. 1
                ld = d_new and not d_prev                      # Eq. 19
                rld = changed and d_new and d_prev and not uld  # Eq. 20-23
                if uld:
                    unloads.append((m, k))                     # ~free
                if ld:
                    loads.append((m, k))
                    tl[k] += self.specs[m].load_time_s
                elif rld:
                    reloads.append((m, k))
                    tl[k] += self.specs[m].load_time_s
                if d_new:
                    new_R[k][m] = r_new
        self.R = new_R
        return ReconfigReport(tl, loads, reloads, unloads)
