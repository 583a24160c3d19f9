"""Adaptive intra-node scheduling (paper §IV-C).

A copy of ``repro/core/intra_node.py``: numpy and float64, the same
arithmetic in the same order and the same generator draws, so results
equal the reference's bit for bit (the port imports nothing of it).

Per slot, each edge node solves

    max  Σ_{m,k} p_mk · Q_mn                                (Eq. 25)
    s.t. Σ_{m∈k} L̃_m(p_mk·B, R_mk) + TL_k ≤ L - TS          (Eq. 26)
         Σ_m R_mk ≤ R_k,  R_mk ≥ d_mk·r_m,  Σ p ≤ 1          (Eq. 27-29)

where L̃ is the fitted quadratic predictor (Eq. 13) and TL_k the
serialized model-(re)loading time (Eq. 24, LD/RLD/ULD states from the
pool manager).  Deployment sets d are enumerated (pools are small:
<= 2^|pool| per GPU); for each set the continuous (p, R) subproblem is
convex-ish and solved by projected gradient ascent with dual (penalty)
updates on the latency constraints — the online-convex-optimization
step, no external solver needed.

Loading-time handling (the paper's Eq. 14-23 big-M linearization,
adapted to the gradient solver): fresh loads always pay l_m; persistent
models pay l_m only if their new R differs by more than ε₁ — after the
continuous solve we SNAP near-unchanged R back to the previous value,
which both avoids the reload and keeps the transition feasible.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.edge_pool import EdgeModelSpec
from repro_torch.core.latency_model import FittedLatency
from repro_torch.serving.pool import ModelPoolManager


@dataclass
class Allocation:
    """(p, R) per (model, gpu) + predicted latencies."""
    p: Dict[Tuple[str, int], float] = field(default_factory=dict)
    R: Dict[Tuple[str, int], float] = field(default_factory=dict)
    tl_per_gpu: List[float] = field(default_factory=list)
    predicted_gpu_latency: List[float] = field(default_factory=list)
    objective: float = 0.0
    feasible: bool = False

    def r_alloc(self) -> Dict[Tuple[str, int], float]:
        return dict(self.R)


def _project_capped_simplex(v: np.ndarray, cap: float) -> np.ndarray:
    """Project onto {x >= 0, sum x <= cap}."""
    v = np.maximum(v, 0.0)
    s = v.sum()
    if s <= cap or v.size == 0:
        return v
    # project onto the simplex of size cap
    u = np.sort(v)[::-1]
    css = np.cumsum(u) - cap
    idx = np.arange(1, v.size + 1)
    cond = u - css / idx > 0
    rho = idx[cond][-1]
    theta = css[rho - 1] / rho
    return np.maximum(v - theta, 0.0)


def _project_R(R: np.ndarray, rmin: np.ndarray, cap: float = 1.0
               ) -> np.ndarray:
    """Project onto {R >= rmin, sum R <= cap} (shifted capped simplex)."""
    shifted = _project_capped_simplex(R - rmin, cap - rmin.sum())
    return rmin + shifted


class IntraNodeScheduler:
    def __init__(self, node_id: int, pool: Sequence[EdgeModelSpec],
                 num_gpus: int, predictors: Dict[str, FittedLatency],
                 quality: Dict[str, float], pool_mgr: ModelPoolManager,
                 *, iters: int = 200, lr: float = 0.05):
        self.node_id = node_id
        self.pool = list(pool)
        self.num_gpus = num_gpus
        self.pred = predictors
        self.Q = quality
        self.mgr = pool_mgr
        self.gpu_cap = pool_mgr.gpu_mem
        self.iters = iters
        self.lr = lr

    # ------------------------------------------------------------- internals

    def _quad_batch(self, W: np.ndarray, qs: np.ndarray, dT: np.ndarray,
                    pB: np.ndarray, R: np.ndarray):
        """Vectorized quadratic predictor over deployed models.
        W [n,6] weights, qs [n] q_scale, dT [n] ΔT."""
        qn = pB / qs
        lat = W[:, 0] + W[:, 1] * qn + W[:, 2] * R + W[:, 3] * qn * qn \
            + W[:, 4] * qn * R + W[:, 5] * R * R
        dq = np.where(lat > 0, (W[:, 1] + 2 * W[:, 3] * qn + W[:, 4] * R)
                      / qs, 0.0)
        dR = np.where(lat > 0, W[:, 2] + W[:, 4] * qn + 2 * W[:, 5] * R, 0.0)
        return np.maximum(lat, 0.0) + dT, dq, dR

    def _solve_continuous(self, deploy: List[Tuple[str, int]], B: int,
                          budget_per_gpu: np.ndarray
                          ) -> Optional[Allocation]:
        """Projected-gradient + dual ascent for fixed deployment set."""
        if not deploy or B <= 0:
            return None
        n = len(deploy)
        specs = [self.mgr.specs[m] for m, _ in deploy]
        gpus = np.array([k for _, k in deploy])
        gpu_onehot = np.eye(self.num_gpus)[gpus]          # [n, K]
        rmin = np.array([s.min_mem_frac for s in specs])
        Q = np.array([self.Q[m] for m, _ in deploy])
        W = np.stack([self.pred[m].weights for m, _ in deploy])
        qs = np.array([self.pred[m].q_scale for m, _ in deploy])
        dT = np.array([self.pred[m].delta_t for m, _ in deploy])
        # per-GPU feasibility of min memory
        if (gpu_onehot.T @ rmin > 1.0 + 1e-9).any():
            return None
        p = np.full(n, 1.0 / n)
        R = rmin + gpu_onehot @ (
            (1.0 - gpu_onehot.T @ rmin) / np.maximum(gpu_onehot.sum(0), 1))
        lam = np.full(self.num_gpus, 1.0)
        for it in range(self.iters):
            lat, dq, dR = self._quad_batch(W, qs, dT, p * B, R)
            gpu_lat = gpu_onehot.T @ lat
            viol = gpu_lat - budget_per_gpu
            gp = Q - lam[gpus] * dq * B
            gR = -lam[gpus] * dR
            p = _project_capped_simplex(p + self.lr * gp, 1.0)
            R_new = R + self.lr * gR
            for k in range(self.num_gpus):
                idx = gpus == k
                if idx.any():
                    R_new[idx] = _project_R(R_new[idx], rmin[idx], 1.0)
            R = R_new
            lam = np.clip(lam * np.exp(2.0 * np.clip(viol, -0.5, 0.5)),
                          1e-3, 50.0)
        # final feasibility trim: shrink p uniformly until latency fits
        for _ in range(60):
            lat, _, _ = self._quad_batch(W, qs, dT, p * B, R)
            gpu_lat = gpu_onehot.T @ lat
            over = gpu_lat > budget_per_gpu + 1e-9
            if not over.any():
                break
            scale = np.where(
                over[gpus],
                np.maximum(0.0, budget_per_gpu / np.maximum(gpu_lat, 1e-9)
                           )[gpus] * 0.97,
                1.0)
            p = p * scale
        # greedy fill: the dual phase can undershoot (or collapse p under
        # tight budgets) — pour remaining query mass into the highest-Q
        # models while the latency budgets hold
        order = np.argsort(-Q)
        step = 0.02
        for _ in range(120):
            if p.sum() >= 1.0 - 1e-9:
                break
            grew = False
            for i in order:
                if p.sum() >= 1.0 - 1e-9:
                    break
                trial = p.copy()
                trial[i] += min(step, 1.0 - p.sum())
                lat, _, _ = self._quad_batch(W, qs, dT, trial * B, R)
                if ((gpu_onehot.T @ lat) <= budget_per_gpu + 1e-9).all():
                    p = trial
                    grew = True
                    break
            if not grew:
                break
        lat, _, _ = self._quad_batch(W, qs, dT, p * B, R)  # final latencies
        alloc = Allocation(feasible=True)
        for i, (m, k) in enumerate(deploy):
            alloc.p[(m, k)] = float(p[i])
            alloc.R[(m, k)] = float(R[i])
        alloc.predicted_gpu_latency = [
            float(lat[gpus == k].sum()) for k in range(self.num_gpus)]
        alloc.objective = float((p * Q).sum())
        return alloc

    def _transition_tl(self, deploy: List[Tuple[str, int]],
                       R: Dict[Tuple[str, int], float],
                       snap_eps: float = 0.02
                       ) -> Tuple[List[float], Dict[Tuple[str, int], float]]:
        """Eq. 19-24: loading time per GPU for this transition; snaps
        near-unchanged persistent R to the previous value (no reload)."""
        tl = [0.0] * self.num_gpus
        R = dict(R)
        for (m, k) in deploy:
            prev = self.mgr.R[k].get(m, 0.0)
            if prev == 0.0:                       # LD: fresh load
                tl[k] += self.mgr.specs[m].load_time_s
            elif abs(R[(m, k)] - prev) <= snap_eps:
                # snap -> no RLD, unless it would break the GPU budget
                others = sum(v for (mm, kk), v in R.items()
                             if kk == k and mm != m)
                if others + prev <= self.gpu_cap + 1e-9:
                    R[(m, k)] = prev
                else:
                    tl[k] += self.mgr.specs[m].load_time_s
            else:                                 # RLD: resource change
                tl[k] += self.mgr.specs[m].load_time_s
        return tl, R

    # ----------------------------------------------------------------- API

    def schedule(self, n_queries: int, budget_s: float) -> Allocation:
        """Pick deployment + (p, R) maximizing Σ p·Q within the budget."""
        best: Optional[Allocation] = None
        names = [s.name for s in self.pool]
        per_gpu_sets = []
        for k in range(self.num_gpus):
            subsets = []
            for r in range(len(names) + 1):
                subsets += [list(c) for c in itertools.combinations(names, r)]
            per_gpu_sets.append(subsets)
        for combo in itertools.product(*per_gpu_sets):
            deploy = [(m, k) for k, models in enumerate(combo)
                      for m in models]
            if not deploy:
                continue
            # rough TL lower bound (fresh loads only) to prune hopeless sets
            tl0 = [0.0] * self.num_gpus
            for m, k in deploy:
                if self.mgr.R[k].get(m, 0.0) == 0.0:
                    tl0[k] += self.mgr.specs[m].load_time_s
            budgets = np.array([budget_s - t for t in tl0])
            if (budgets <= 0).all():
                continue
            alloc = self._solve_continuous(deploy, n_queries,
                                           np.maximum(budgets, 1e-3))
            if alloc is None:
                continue
            tl, snapped_R = self._transition_tl(deploy, alloc.R)
            alloc.R = snapped_R
            alloc.tl_per_gpu = tl
            # re-verify with exact TL (may differ from tl0 via RLD snaps)
            ok = True
            for k in range(self.num_gpus):
                if alloc.predicted_gpu_latency[k] + tl[k] > budget_s + 1e-6:
                    ok = False
            alloc.feasible = ok
            score = alloc.objective if ok else alloc.objective - 10.0
            if best is None or score > (best.objective if best.feasible
                                        else best.objective - 10.0):
                best = alloc
        return best if best is not None else Allocation()
