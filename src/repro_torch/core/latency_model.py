"""Latency oracle + predictor fitting (paper §IV-C, Table I).

A copy of ``repro/core/latency_model.py``: numpy and float64, the same
arithmetic in the same order and the same generator draws, so results
equal the reference's bit for bit (the port imports nothing of it).

``LatencyOracle`` is the simulation's ground truth for edge-GPU serving
time — a saturating-throughput model: a model with memory fraction R
(R >= r_m, its weights floor) serves queries at rate proportional to
s(R) (extra memory -> bigger KV batches -> better utilization, with
diminishing returns), plus a mild superlinear contention term and
measurement noise.  Calibrated so a 1B model serves ~80 q/s at full
GPU — the paper's 10-30 ms/query regime.

``fit_latency_models`` reproduces the paper's Table I methodology:
measure latency over a (q, R) grid, fit linear / quadratic /
exponential / cubic candidate forms, report held-out RMSE.  The
quadratic (the paper's Eq. 13 form) is what the intra-node scheduler
then uses, via ``QuadraticLatencyPredictor``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.edge_pool import EdgeModelSpec


class LatencyOracle:
    """Ground-truth edge-GPU latency simulator (seconds)."""

    def __init__(self, *, sec_per_query_per_b: float = 0.012,
                 contention: float = 2e-6, noise: float = 0.03,
                 seed: int = 0):
        self.kappa = sec_per_query_per_b
        self.contention = contention
        self.noise = noise
        self._rng = np.random.default_rng(seed)

    def saturation(self, spec: EdgeModelSpec, R) -> np.ndarray:
        """Throughput efficiency s(R) in (0, 1]: KV-batch headroom grows
        ~linearly with memory beyond the weights floor, with a small
        always-available baseline (batch=1 serving)."""
        R = np.asarray(R, np.float64)
        headroom = np.clip((R - spec.min_mem_frac)
                           / max(1.0 - spec.min_mem_frac, 1e-6), 0.0, 1.0)
        return 0.3 + 0.7 * headroom

    def latency(self, spec: EdgeModelSpec, n_queries, R,
                noisy: bool = True) -> np.ndarray:
        """Serving time for n_queries on one GPU slice of fraction R."""
        q = np.asarray(n_queries, np.float64)
        t_m = spec.params_b * self.kappa
        lat = q * t_m / self.saturation(spec, R) \
            + self.contention * spec.params_b * q ** 2
        if noisy:
            lat = lat * (1.0 + self.noise * self._rng.standard_normal(lat.shape
                                                                      if lat.shape else None))
        return np.maximum(lat, 0.0)


# ---------------------------------------------------------------------------
# candidate-form fitting (Table I)


def _features(q, R, form: str) -> np.ndarray:
    q = np.atleast_1d(np.asarray(q, np.float64))
    R = np.broadcast_to(np.asarray(R, np.float64), q.shape)
    one = np.ones_like(q)
    if form == "linear":
        cols = [one, q, R]
    elif form == "quadratic":        # general quadratic — includes Eq. 13
        cols = [one, q, R, q * q, q * R, R * R]
    elif form == "cubic":
        cols = [one, q, R, q * q, q * R, R * R, q ** 3, q * q * R,
                q * R * R, R ** 3]
    elif form == "exponential":      # w0 + w1 q + w2 exp(-kR) + w3 q exp(-kR)
        e = np.exp(-3.0 * R)
        cols = [one, q, e, q * e]
    else:
        raise ValueError(form)
    return np.stack(cols, axis=1)


@dataclass
class FittedLatency:
    form: str
    weights: np.ndarray
    rmse: float
    q_scale: float
    delta_t: float = 0.0             # ΔT robustness offset (Eq. 13)

    def predict(self, n_queries, R):
        scalar = np.isscalar(n_queries) or np.ndim(n_queries) == 0
        q = np.asarray(n_queries, np.float64) / self.q_scale
        X = _features(q, R, self.form)
        out = np.maximum(X @ self.weights, 0.0) + self.delta_t
        return float(out[0]) if scalar else out


def fit_latency_models(oracle: LatencyOracle, spec: EdgeModelSpec,
                       *, q_max: int = 800, n_train: int = 400,
                       n_test: int = 200, seed: int = 1,
                       delta_t: float = 0.05
                       ) -> Tuple[Dict[str, FittedLatency], Dict[str, float]]:
    """Measure a (q, R) grid, fit all four candidate forms, return
    (fits, rmse-per-form). RMSE computed on a held-out split."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, q_max, n_train + n_test).astype(np.float64)
    R = rng.uniform(spec.min_mem_frac, 1.0, n_train + n_test)
    y = oracle.latency(spec, q, R, noisy=True)
    q_scale = float(q_max)
    qn = q / q_scale
    fits, rmses = {}, {}
    for form in ("linear", "quadratic", "exponential", "cubic"):
        Xtr = _features(qn[:n_train], R[:n_train], form)
        w, *_ = np.linalg.lstsq(Xtr, y[:n_train], rcond=None)
        Xte = _features(qn[n_train:], R[n_train:], form)
        resid = Xte @ w - y[n_train:]
        rmse = float(np.sqrt((resid ** 2).mean()))
        fits[form] = FittedLatency(form, w, rmse, q_scale, delta_t)
        rmses[form] = rmse
    return fits, rmses


def fit_quadratic(oracle: LatencyOracle, spec: EdgeModelSpec,
                  **kw) -> FittedLatency:
    fits, _ = fit_latency_models(oracle, spec, **kw)
    return fits["quadratic"]
