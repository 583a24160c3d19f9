"""Trace-driven workload replay over the live cluster runtime.

Wires ``data.traces`` (diurnal volume + Dirichlet domain skew) into
``ClusterRuntime``: each slot samples a query count from the volume
trace and a domain mix from the Dirichlet trace, draws QA pairs from
those domains, encodes the questions once with the shared encoder, and
feeds the batch through the runtime.  Returns per-slot measured metrics
(p50/p95 latency, drop rate, quality, per-node load) plus an aggregate
summary.  A copy of ``repro/cluster/replay.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.runtime import ClusterRuntime, ClusterSlotMetrics
from repro_torch.core.cluster import Query
from repro_torch.data.corpus import QAPair
from repro_torch.data.traces import (dirichlet_domain_trace,
                                     diurnal_volume_trace, ramp_volume_trace,
                                     spike_volume_trace)
from repro_torch.retrieval.encoder import TextEncoder


class LiveWorkload:
    """Samples real QA queries per slot from a domain-skewed trace."""

    def __init__(self, qas: Sequence[QAPair], encoder: TextEncoder,
                 *, seed: int = 0):
        self.encoder = encoder
        self.by_domain: Dict[int, List[QAPair]] = {}
        for qa in qas:
            self.by_domain.setdefault(qa.domain, []).append(qa)
        self.domains = sorted(self.by_domain)
        self._rng = np.random.default_rng(seed)
        self._next_qid = 0

    def slot_queries(self, volume: int, domain_mix: np.ndarray
                     ) -> List[Query]:
        mix = np.asarray(domain_mix, np.float64)[:len(self.domains)]
        mix = mix / mix.sum() if mix.sum() > 0 else \
            np.full(len(self.domains), 1.0 / len(self.domains))
        doms = self._rng.choice(self.domains, size=volume, p=mix)
        qas = [self.by_domain[d][self._rng.integers(
            len(self.by_domain[d]))] for d in doms]
        embs = self.encoder.encode([qa.question for qa in qas])
        out = []
        for qa, emb in zip(qas, embs):
            out.append(Query(qa.domain, emb, qid=self._next_qid,
                             question=qa.question, reference=qa.answer))
            self._next_qid += 1
        return out


@dataclass
class ReplayReport:
    slots: List[ClusterSlotMetrics] = field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        served = [m for m in self.slots if m.n_queries]
        if not served:
            return {"slots": len(self.slots), "queries": 0}
        w = np.array([m.n_queries for m in served], np.float64)
        w = w / w.sum() if w.sum() else w
        return {
            "slots": len(self.slots),
            "queries": int(sum(m.n_queries for m in self.slots)),
            "quality_mean": float(np.average(
                [m.quality_mean for m in served], weights=w)),
            "drop_rate": float(np.average(
                [m.drop_rate for m in served], weights=w)),
            "latency_p50_s": float(np.median(
                [m.latency_p50 for m in served])),
            "latency_p95_s": float(max(m.latency_p95 for m in served)),
            "load_imbalance": float(np.mean(
                [m.load_imbalance for m in served])),
            "ppo_updates": int(served[-1].ppo_updates),
        }


def autoscale_knobs(measured_qps: float, batch_size: int,
                    arrival_qps: float, mean_prompt_len: float, *,
                    max_batch: int = 16, max_chunk: int = 64
                    ) -> Dict[str, int]:
    """Size a node's batch/chunk knobs for an open-loop arrival rate
    from its measured capacity profile (``CapacityFunction.k`` is the
    profiled throughput in queries/s at ``batch_size``).

    Little's law: a request occupies a batch row for about
    ``batch_size / measured_qps`` seconds, so absorbing ``arrival_qps``
    needs ``arrival_qps * batch_size / measured_qps`` rows in flight.
    The batch is the next power of two covering that concurrency; the
    prefill chunk targets ~2 chunks per typical prompt, balancing
    admission granularity against per-chunk dispatch overhead.  Feed
    the result to ``LiveEdgeNode.reconfigure``."""
    def pow2_clamp(x: float, lo: int, hi: int) -> int:
        p = 1 << max(0, int(np.ceil(np.log2(max(float(x), 1.0)))))
        return int(min(max(p, lo), hi))

    concurrency = arrival_qps * batch_size / max(measured_qps, 1e-9)
    return {"batch_size": pow2_clamp(concurrency, 1, max_batch),
            "prefill_chunk": pow2_clamp(mean_prompt_len / 2, 8, max_chunk)}


def replay_trace(runtime: ClusterRuntime, workload: LiveWorkload, *,
                 n_slots: int, slo_s: float, base_volume: int = 8,
                 trace: str = "diurnal", alpha: float = 1.5,
                 seed: int = 0, verbose: bool = False,
                 volumes: Optional[Sequence[int]] = None,
                 on_slot=None) -> ReplayReport:
    """Run ``n_slots`` slots of trace-driven load through the runtime.
    ``on_slot(t, metrics)`` is called after each slot (live telemetry
    rollups in ``launch.cluster_serve``).  An explicit per-slot
    ``volumes`` sequence overrides the named ``trace`` (the saturation
    harness sweeps arrival rates this way)."""
    n_domains = len(workload.domains)
    if volumes is not None:
        volumes = list(volumes)[:n_slots]
    elif trace == "diurnal":
        volumes = diurnal_volume_trace(n_slots, base=base_volume, seed=seed)
    elif trace == "uniform":
        volumes = [base_volume] * n_slots
    elif trace == "spike":
        volumes = spike_volume_trace(n_slots, base=base_volume, seed=seed)
    elif trace == "ramp":
        volumes = ramp_volume_trace(n_slots, base=base_volume, seed=seed)
    else:
        raise ValueError(f"unknown trace {trace!r} "
                         "(diurnal|uniform|spike|ramp)")
    mixes = dirichlet_domain_trace(n_slots, n_domains, alpha=alpha,
                                   seed=seed + 1)
    report = ReplayReport()
    for t, (vol, mix) in enumerate(zip(volumes, mixes)):
        queries = workload.slot_queries(vol, mix)
        m = runtime.run_slot(queries, slo_s)
        report.slots.append(m)
        if on_slot is not None:
            on_slot(t, m)
        if verbose:
            load = "/".join(f"{p:.2f}" for p in m.per_node_load)
            print(f"slot {t:3d}: n={m.n_queries:3d} "
                  f"quality={m.quality_mean:.3f} drop={m.drop_rate:.2f} "
                  f"p50={m.latency_p50:.2f}s p95={m.latency_p95:.2f}s "
                  f"load=[{load}] ppo_updates={m.ppo_updates}",
                  flush=True)
    return report
