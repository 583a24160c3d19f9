"""Load-balancing inter-node scheduling (paper §IV-B, Algorithm 1).

A copy of ``repro/core/inter_node.py`` (numpy; the port imports nothing
of the reference).

Initialization: profile each node's maximum sustainable throughput
E_{n,L} across latency levels L = 5..60 s (5 s steps) by increasing the
query burst until the drop rate passes a threshold (1%), then fit the
linear capacity function C_n(L) = k_n L + b_n (Eq. 12).

Runtime (Algorithm 1): sample each query's node from its probability
vector s_i; when the sampled node is at capacity, resample from the
renormalized distribution over nodes with residual capacity; when total
demand exceeds ΣC_n, proportionally inflate all capacities.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import numpy as np


@dataclass
class CapacityFunction:
    k: float
    b: float
    levels: List[Tuple[float, float]]     # (L, E_nL) profile points

    def __call__(self, L: float) -> float:
        return max(1.0, self.k * L + self.b)


def profile_capacity(serve_fn: Callable[[int, float], float],
                     levels: Sequence[float] = tuple(range(5, 61, 5)),
                     drop_threshold: float = 0.01) -> CapacityFunction:
    """serve_fn(n_queries, L) -> drop rate; implements the paper's
    controlled query-burst profiling.

    Starts at L=5 s with load 1 and grows until the drop rate passes the
    threshold (doubling then +E_{n,5} linear steps, as in the paper);
    for each later L, starts from (L/5)·E_{n,5} and increments by
    E_{n,5}.
    """
    points: List[Tuple[float, float]] = []
    e5 = None
    for L in levels:
        # initial bracket: from scratch at the first level (doubling),
        # warm-started at (L/L0)*E_{n,L0} for later levels (the paper's
        # progressive initialization)
        lo = 1
        if e5 is None:
            hi = 2
            while serve_fn(hi, L) <= drop_threshold and hi < 2 ** 20:
                lo, hi = hi, hi * 2
        else:
            guess = max(1, int(L / levels[0] * e5))
            if serve_fn(guess, L) <= drop_threshold:
                lo, hi = guess, guess * 2
                while serve_fn(hi, L) <= drop_threshold and hi < 2 ** 20:
                    lo, hi = hi, hi * 2
            else:
                hi = guess
        # bisect the drop-rate threshold crossing
        while hi - lo > max(1, lo // 64):
            mid = (lo + hi) // 2
            if serve_fn(mid, L) <= drop_threshold:
                lo = mid
            else:
                hi = mid
        cap = lo
        if e5 is None:
            e5 = cap
        points.append((float(L), float(cap)))
    Ls = np.array([p[0] for p in points])
    Es = np.array([p[1] for p in points])
    A = np.stack([Ls, np.ones_like(Ls)], axis=1)
    (k, b), *_ = np.linalg.lstsq(A, Es, rcond=None)
    return CapacityFunction(float(k), float(b), points)


def inter_node_schedule(probs: np.ndarray, capacities: np.ndarray,
                        rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Algorithm 1.  probs: S^t [B, N]; capacities: C_n [N].
    Returns (assignment a_i [B] int, proportions p_j [N])."""
    B, N = probs.shape
    C = capacities.astype(np.float64).copy()
    total = C.sum()
    if B > total:                                   # lines 5-8: inflate
        C = C + C / max(total, 1e-9) * (B - total)
    q = np.zeros(N)
    a = np.full(B, -1, np.int64)
    # vectorized first-pass sampling (line 10)
    r = rng.random(B)
    cum = probs.cumsum(axis=1)
    first = (r[:, None] > cum).sum(axis=1).clip(0, N - 1)
    for i in range(B):
        n = first[i]
        if q[n] >= C[n]:                            # lines 11-15: reassign
            avail = np.where(q < C)[0]
            if avail.size == 0:
                n = int(q.argmin())
            else:
                pr = probs[i, avail]
                s = pr.sum()
                if s <= 1e-12:
                    n = int(rng.choice(avail))
                else:
                    n = int(rng.choice(avail, p=pr / s))
        a[i] = n
        q[n] += 1
    return a, q / max(B, 1)
