"""Parameter conversion between the reference's layout and the port's.

The reference keeps one pytree whose decoder leaves are stacked over
pattern cycles: ``params["blocks"][f"s{j}_{kind}"]`` holds slot j of the
layer pattern with a leading ``[num_layers // P]`` cycle axis, P being
the pattern's length.  The port keeps a list of per-layer dicts: port
layer i is slot ``i % P`` at cycle ``i // P``.  An encoder-decoder
model's ``params["encoder"]["blocks"]`` is stacked over its encoder
layers in the reference and a list of per-layer dicts in the port; its
``final_norm`` and a learned ``pos_embed`` table pass as they are.  Both
use the ``[d_in, d_out]`` matmul layout, so leaves convert without
transposes.  The
reference side is handed over as nested dicts of numpy arrays; nothing
here imports the reference.

``ivf_state_from_numpy`` carries a trained IVF quantizer (centroids and
packed lists) into the port's ``IVFIndex`` the same way, so a search can
be held to the reference's independently of k-means.

``policy_from_numpy`` / ``policy_to_numpy`` carry the online
identifier's PPO policy (``{"layers": [{w, b, bn_g, bn_b, bn_mu, bn_var,
res}, ...]}``, the last layer ``{w, b}`` only) across, so both packages
compute the same policy.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ppo import Policy
from repro_torch.device import DeviceLike, resolve_device


def _slot(cfg: ModelConfig, i: int) -> str:
    """The reference's slot name of port layer ``i``."""
    return f"s{i % len(cfg.layer_pattern)}_{cfg.pattern_for_layer(i)}"


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
    dev = resolve_device(device)
    P = len(cfg.layer_pattern)
    out = {k: _to_torch(v, dev) for k, v in np_params.items()
           if k not in ("blocks", "encoder")}
    out["blocks"] = [
        _to_torch(_layer(np_params["blocks"][_slot(cfg, i)], i // P), dev)
        for i in range(cfg.num_layers)]
    if "encoder" in np_params:
        enc = np_params["encoder"]
        out["encoder"] = {
            "blocks": [_to_torch(_layer(enc["blocks"], i), dev)
                       for i in range(cfg.num_encoder_layers)],
            "final_norm": _to_torch(enc["final_norm"], dev)}
    return out


def params_to_numpy(params: dict, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameters -> reference-layout numpy parameters."""
    P = len(cfg.layer_pattern)
    out = {k: _to_numpy(v) for k, v in params.items()
           if k not in ("blocks", "encoder")}
    out["blocks"] = {
        _slot(cfg, j): _stack([_to_numpy(b)
                               for b in params["blocks"][j::P]])
        for j in range(P)}
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "blocks": _stack([_to_numpy(b) for b in enc["blocks"]]),
            "final_norm": _to_numpy(enc["final_norm"])}
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


def policy_from_numpy(np_params: Dict[str, Any],
                      device: DeviceLike = "cuda") -> Policy:
    """The reference identifier's policy params -> a port ``Policy``."""
    layers = np_params["layers"]
    widths = [np.shape(layer["w"])[1] for layer in layers]
    policy = Policy(np.shape(layers[0]["w"])[0], widths[-1],
                    hidden=widths[:-1])
    state = {f"layers.{i}.{name}": torch.tensor(
        np.asarray(value, np.float32))
        for i, layer in enumerate(layers) for name, value in layer.items()}
    policy.load_state_dict(state, strict=True)
    return policy.to(resolve_device(device))


def policy_to_numpy(policy: Policy) -> Dict[str, Any]:
    """A port ``Policy`` -> the reference's params layout (numpy)."""
    layers = [{} for _ in policy.layers]
    for key, value in policy.state_dict().items():
        _, i, name = key.split(".")
        layers[int(i)][name] = value.detach().cpu().numpy()
    return {"layers": layers}
