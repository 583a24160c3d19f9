"""Edge-node model pools for the CoEdge-RAG scheduler (paper §V-A).

A copy of ``repro/configs/edge_pool.py``: numpy and float64, the same
arithmetic in the same order and the same generator draws, so results
equal the reference's bit for bit (the port imports nothing of it).

The paper's testbed hosts three open-source model series (LLaMA, Qwen,
Falcon) in 1B/1.5B, 3B and 7B/8B parameter classes.  The hierarchical
scheduler never looks inside the network — it needs, per model:

  * ``params_b``      — parameter count (drives the latency oracle),
  * ``load_time_s``   — l_m, serialized model-loading time (paper Eq. 2),
  * ``min_mem_frac``  — r_m, minimum startup GPU-memory fraction (Eq. 6),
  * ``base_quality``  — intrinsic open-book capability, used only to
                        *synthesize* Q_mn in the simulator (the real
                        pipeline measures Q_mn; see quality_model.py).

Loading times follow the paper's observation that loading dominates
unloading (which costs a few hundred ms) — roughly 2 GB/s from NVMe at
2 bytes/param.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class EdgeModelSpec:
    name: str
    family: str            # llama | qwen | falcon
    size_class: str        # small | mid | large
    params_b: float
    load_time_s: float
    min_mem_frac: float    # r_m
    base_quality: float    # open-book ROUGE-L-like intrinsic score


def _spec(family: str, size_class: str, params_b: float, quality: float) -> EdgeModelSpec:
    return EdgeModelSpec(
        name=f"{family}-{params_b:g}b",
        family=family,
        size_class=size_class,
        params_b=params_b,
        load_time_s=params_b * 2 / 2.0,        # 2B/param over ~2 GB/s
        min_mem_frac=min(0.9, 0.08 + 0.035 * params_b),
        base_quality=quality,
    )


# Base qualities calibrated so that the 1B/3B/8B ladder reproduces the
# paper's Fig.3a regimes (0.506 / 0.547 / 0.584 Rouge-L).
MODEL_SPECS: Dict[str, EdgeModelSpec] = {
    s.name: s
    for s in [
        _spec("llama", "small", 1.0, 0.506),
        _spec("llama", "mid", 3.0, 0.560),
        _spec("llama", "large", 8.0, 0.601),
        _spec("qwen", "small", 1.5, 0.515),
        _spec("qwen", "mid", 3.0, 0.556),
        _spec("qwen", "large", 7.0, 0.592),
        _spec("falcon", "small", 1.0, 0.498),
        _spec("falcon", "mid", 3.0, 0.549),
        _spec("falcon", "large", 7.0, 0.588),
    ]
}


def pool_for_family(family: str) -> List[EdgeModelSpec]:
    return [s for s in MODEL_SPECS.values() if s.family == family]


# Paper testbed: four nodes; two with one RTX-4090-class GPU, two with two.
# Each node hosts one model series (heterogeneous across nodes).
PAPER_TESTBED: Tuple[Tuple[str, int], ...] = (
    ("llama", 1),
    ("qwen", 1),
    ("llama", 2),
    ("falcon", 2),
)
