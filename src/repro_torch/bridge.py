"""Parameter conversion between the reference's layout and the port's.

The reference keeps one pytree whose decoder leaves are stacked over
pattern cycles: ``params["blocks"]["s0_attn"][...]`` has a leading
``[num_layers]`` axis for a single-"attn" pattern.  The port keeps a
list of per-layer dicts.  Both use the ``[d_in, d_out]`` matmul layout,
so leaves convert without transposes.  The reference side is handed over
as nested dicts of numpy arrays; nothing here imports the reference.

``ivf_state_from_numpy`` carries a trained IVF quantizer (centroids and
packed lists) into the port's ``IVFIndex`` the same way, so a search can
be held to the reference's independently of k-means.
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


def ivf_state_from_numpy(index, centroids: np.ndarray, list_emb: np.ndarray,
                         list_ids: np.ndarray, list_sizes: np.ndarray) -> None:
    """Install a trained quantizer into ``index`` (a port ``IVFIndex``
    holding the same documents): centroids [n_lists, d], packed
    list_emb [n_lists, L, d], list_ids [n_lists, L] (-1 padding) and
    list_sizes [n_lists].  The index counts as trained until its next
    ``add``."""
    n_lists, L = np.shape(list_ids)
    if np.shape(list_emb) != (n_lists, L, index.dim) \
            or np.shape(centroids) != (n_lists, index.dim) \
            or np.shape(list_sizes) != (n_lists,):
        raise ValueError("IVF state shapes do not match each other or the "
                         f"index dim {index.dim}")
    if int(np.sum(list_sizes)) != len(index):
        raise ValueError(f"lists hold {int(np.sum(list_sizes))} documents, "
                         f"the index {len(index)}")
    index._centroids = np.asarray(centroids, np.float32)
    index._list_emb = torch.as_tensor(np.asarray(list_emb, np.float32),
                                      device=index.device)
    index._list_ids = torch.as_tensor(np.asarray(list_ids, np.int32),
                                      device=index.device)
    index._list_sizes = np.asarray(list_sizes)
    index._dirty = False
