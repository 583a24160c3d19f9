"""Flat-npz checkpoints that the reference reads and writes too.

Counterpart of ``repro/train/checkpoint.py``.  The file is one npz whose
keys are the reference's: its pytree path joined with "/" (dict keys,
list indices), over the reference's parameter layout, into which
``bridge.params_to_numpy`` turns the port's (per-layer blocks stacked
into the reference's pattern slots ``blocks/s<j>_<kind>/...``).  A file
written by either package loads in the other.

numpy has no bfloat16 (without ``ml_dtypes``, which the port does not
need), so a bf16 leaf is written as f32, and ``load`` casts every leaf
to the dtype of ``like``'s, as the reference's ``load`` casts to the
leaf dtype.  ``cfg`` names the layer pattern that maps port layers onto
the reference's slots.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def save(path: str, params: dict, cfg: ModelConfig) -> None:
    """Write the port's ``params`` (model ``cfg``) to ``path`` (numpy
    appends ".npz" when it is missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(bridge.params_to_numpy(params, cfg)))


def _as_f32(arr: np.ndarray) -> np.ndarray:
    """A leaf as f32 numpy; a bf16 leaf written by the reference (2-byte
    ``ml_dtypes`` elements, read as raw 2-byte records without it) is
    widened bit for bit."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return np.asarray(arr, np.float32)


def _restore(data, like, key: str, pick=None):
    """``like``'s tree with each leaf read from ``data(key/...)`` (row
    ``pick`` of a stacked leaf), its shape checked, cast to the leaf's
    dtype and device."""
    if isinstance(like, dict):
        return {k: _restore(data, v, f"{key}/{k}" if key else k, pick)
                for k, v in like.items()}
    arr = data(key)
    if pick is not None:
        n, i = pick
        if arr.shape[:1] != (n,):
            raise ValueError(f"{key}: stacked over {arr.shape[:1]}, the "
                             f"model has {n}")
        arr = arr[i]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)}, "
                         f"model shape {tuple(like.shape)}")
    return torch.as_tensor(np.ascontiguousarray(arr)).to(device=like.device,
                                                         dtype=like.dtype)


def load(path: str, like: dict, cfg: ModelConfig) -> dict:
    """The port's parameters of model ``cfg`` restored from ``path``,
    shaped, typed and placed like ``like``.  A missing key raises
    ``KeyError``, a shape that differs from ``like``'s ``ValueError``."""
    P = len(cfg.layer_pattern)
    L = cfg.num_layers
    with np.load(path) as npz:
        read = {}

        def data(key):   # each key read once (a stacked leaf serves n layers)
            if key not in read:
                read[key] = _as_f32(npz[key])
            return read[key]

        out = {k: _restore(data, v, k) for k, v in like.items()
               if k not in ("blocks", "encoder")}
        out["blocks"] = [
            _restore(data, blk, f"blocks/{bridge._slot(cfg, i)}",
                     (len(range(i % P, L, P)), i // P))
            for i, blk in enumerate(like["blocks"])]
        if "encoder" in like:
            enc = like["encoder"]
            ne = len(enc["blocks"])
            out["encoder"] = {
                "blocks": [_restore(data, blk, "encoder/blocks", (ne, i))
                           for i, blk in enumerate(enc["blocks"])],
                "final_norm": _restore(data, enc["final_norm"],
                                       "encoder/final_norm")}
    return out
