"""Architecture registry of the PyTorch port: resolves ``--arch <id>`` to a
ModelConfig.  Only the architectures the port serves are registered.

Usage::

    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_config("olmo-1b")
    tiny = get_smoke_config("olmo-1b")     # 2 layers, d_model<=256
    shape_applicable(cfg, INPUT_SHAPES["long_500k"])   # the 500k policy
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

# arch id (public, dashed) -> module name (importable, underscored)
_ARCH_MODULES: Dict[str, str] = {
    "olmo-1b": "olmo_1b",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama3-8b": "llama3_8b",
    "gemma2-9b": "gemma2_9b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-base": "whisper_base",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str, **kw) -> ModelConfig:
    return get_config(arch_id).reduced(**kw)


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """Whether an (arch, input-shape) pair runs, per the long_500k policy:
    ``long_500k`` only for configs that support long context."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
