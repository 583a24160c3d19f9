"""Shared structural interfaces between the simulated and live paths.

A copy of ``repro/core/protocols.py``.

``core.cluster.EdgeNode`` (oracle-driven simulator) and
``cluster.node.LiveEdgeNode`` (real ServeEngine + retrieval, measured
latency/quality) both satisfy ``SchedulableNode``; the ``Coordinator``
and ``cluster.runtime.ClusterRuntime`` slot loops both satisfy
``SlotScheduler``.  Benchmarks and the launchers program against these
protocols, so the two paths are interchangeable.
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, List, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

if TYPE_CHECKING:   # structural types only; avoids import cycles at runtime
    from repro_torch.core.cluster import Query, QueryResult
    from repro_torch.core.inter_node import CapacityFunction


@runtime_checkable
class SchedulableNode(Protocol):
    """What the inter-node layer needs from an edge node: an identity, a
    profiled capacity function, and a per-slot execute step."""

    node_id: int
    capacity: Optional["CapacityFunction"]

    def process_slot(self, queries: Sequence["Query"], slo_s: float,
                     scheduler=None) -> List["QueryResult"]:
        ...

    def profile(self, *args, **kwargs) -> "CapacityFunction":
        ...


@runtime_checkable
class QueryRouter(Protocol):
    """The online identifier interface (PPO policy or a baseline)."""

    def identify(self, embeddings: np.ndarray) -> np.ndarray:
        ...

    def feedback(self, embeddings: np.ndarray, actions: np.ndarray,
                 scores: np.ndarray) -> None:
        ...

    def maybe_update(self) -> Optional[dict]:
        ...


@runtime_checkable
class SlotScheduler(Protocol):
    """A slot loop over nodes: profile capacities, then run slots."""

    def initialize(self, *args, **kwargs) -> None:
        ...

    def run_slot(self, queries: Sequence["Query"], slo_s: float):
        ...
