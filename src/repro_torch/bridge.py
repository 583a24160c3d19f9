"""Parameter conversion between the reference's layout and the port's.

The reference keeps one pytree whose decoder leaves are stacked over
pattern cycles: ``params["blocks"]["s0_attn"][...]`` has a leading
``[num_layers]`` axis for a single-"attn" pattern.  The port keeps a
list of per-layer dicts.  Both use the ``[d_in, d_out]`` matmul layout,
so leaves convert without transposes.  The reference side is handed over
as nested dicts of numpy arrays; nothing here imports the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

_SLOT = "s0_attn"


def _to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: torch reads f32
        return torch.as_tensor(a.astype(np.float32), device=device
                               ).to(torch.bfloat16)
    return torch.as_tensor(a, device=device)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_from_numpy(np_params: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = "cuda") -> dict:
    """Reference-layout numpy parameters -> the port's parameters."""
    if tuple(cfg.layer_pattern) != ("attn",):
        raise NotImplementedError("bridge covers single-'attn' patterns")
    dev = resolve_device(device)
    stacked = np_params["blocks"][_SLOT]
    out = {k: _to_torch(v, dev) for k, v in np_params.items()
           if k != "blocks"}
    out["blocks"] = [_to_torch(_layer(stacked, i), dev)
                     for i in range(cfg.num_layers)]
    return out


def params_to_numpy(params: dict) -> Dict[str, Any]:
    """The port's parameters -> reference-layout numpy parameters."""
    out = {k: _to_numpy(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {_SLOT: _stack([_to_numpy(b) for b in params["blocks"]])}
    return out
