"""Query and result records of the cluster path.

The ``Query`` / ``QueryResult`` dataclasses of ``repro/core/cluster.py``,
copied so the port imports nothing of the reference.  The simulated,
oracle-driven ``EdgeNode`` is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Query:
    domain: int
    embedding: np.ndarray
    qid: int = 0
    # live-path payload (empty for the oracle-driven simulator)
    question: str = ""
    reference: str = ""


@dataclass
class QueryResult:
    qid: int
    node: int
    model: str
    quality: float
    dropped: bool
    # live-path measurements (0/"" for the oracle-driven simulator)
    latency_s: float = 0.0
    answer: str = ""
