"""Arrival traces: ECW-style diurnal volume + Dirichlet domain skew.

A copy of ``repro/data/traces.py`` (numpy)."""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np


def diurnal_volume_trace(n_slots: int, base: int = 300, *,
                         amplitude: float = 0.5, burst_prob: float = 0.08,
                         burst_scale: float = 2.0, seed: int = 0
                         ) -> List[int]:
    """Sinusoidal daily load with random bursts (ECW-New-App style)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_slots)
    vol = base * (1 + amplitude * np.sin(2 * np.pi * t / max(n_slots, 1)))
    vol *= 1 + 0.1 * rng.standard_normal(n_slots)
    bursts = rng.random(n_slots) < burst_prob
    vol[bursts] *= burst_scale
    return [max(1, int(v)) for v in vol]


def spike_volume_trace(n_slots: int, base: int = 300, *,
                       spike_slot: Optional[int] = None,
                       magnitude: float = 4.0,
                       width: int = 2, seed: int = 0) -> List[int]:
    """Steady open-loop arrivals with one spike: ``width`` slots at
    ``magnitude`` x base centered on ``spike_slot`` (default: middle).
    The saturation harness uses it to drive a standing engine past its
    steady-state capacity and watch the SLO feedback loop recover."""
    rng = np.random.default_rng(seed)
    if spike_slot is None:
        spike_slot = n_slots // 2
    vol = base * (1 + 0.05 * rng.standard_normal(n_slots))
    lo = max(0, spike_slot - (width - 1) // 2)
    vol[lo:lo + max(1, width)] *= magnitude
    return [max(1, int(v)) for v in vol]


def ramp_volume_trace(n_slots: int, base: int = 300, *,
                      peak: float = 4.0, seed: int = 0) -> List[int]:
    """Linear arrival-rate ramp from ``base`` to ``peak * base`` —
    sweeps a throughput-vs-SLO frontier in one replay."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_slots)
    scale = 1 + (peak - 1) * t / max(n_slots - 1, 1)
    vol = base * scale * (1 + 0.05 * rng.standard_normal(n_slots))
    return [max(1, int(v)) for v in vol]


def dirichlet_domain_trace(n_slots: int, n_domains: int, alpha: float = 1.0,
                           seed: int = 0) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    for _ in range(n_slots):
        yield rng.dirichlet(np.full(n_domains, alpha))
