"""Node capacity functions for inter-node scheduling (paper §IV-B).

``CapacityFunction`` C_n(L) = k_n L + b_n (Eq. 12) of
``repro/core/inter_node.py``, copied so the port imports nothing of the
reference.  Profiling sweeps and Algorithm 1 are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class CapacityFunction:
    k: float
    b: float
    levels: List[Tuple[float, float]]     # (L, E_nL) profile points

    def __call__(self, L: float) -> float:
        return max(1.0, self.k * L + self.b)
