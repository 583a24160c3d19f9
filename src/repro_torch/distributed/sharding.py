"""Divisibility-aware sharding rules for params, activations and caches.

Counterpart of ``repro/distributed/sharding.py``: the same rules, as
functions of config, shapes and mesh.  A tensor dim is sharded on a mesh
axis ONLY if its size is divisible by that axis; otherwise it falls back
to replication.  So every architecture fits the 16x16 (and 2x16x16)
production mesh with no per-arch special cases: kv_heads=5 (hymba) or
vocab=51865 (whisper) replicate the dim that does not divide.

Axis conventions (``launch/mesh.py``):
  pod    pod-level data parallelism (multi-pod mesh only)
  data   batch (data parallel); also long-context KV sequence sharding
  model  tensor parallelism: attention heads / FFN width / vocab

A spec is a ``Spec``: one entry per tensor dim, each None (replicated),
an axis name or a tuple of names (the dim split over all of them, in
order).  ``placements(spec, mesh)`` turns it into DTensor placements
over a ``DeviceMesh`` (``Shard(dim)`` on each named axis, ``Replicate()``
on the others).  ``mesh`` is a ``DeviceMesh`` or a
``launch.mesh.MeshShape``: the rules read only axis names and sizes.

Trees are nested dicts and lists whose leaves have a ``.shape`` (meta or
fake tensors are enough).  ``param_specs`` takes the port's parameters
(``params["blocks"]`` a list of per-layer dicts) or the reference's
layout (``bridge.params_to_numpy``: blocks stacked by pattern slot, a
leading cycle dim); a port layer's leaf is matched on its reference path
(``blocks/s{slot}_{kind}/attn/wq``), and every rule reads dims from the
end, so it gets the stacked leaf's spec without the cycle dim.
``cache_specs`` takes a cache tree in the reference's layout
(``slots/<slot>/k`` [cycles, B, S, KV, hd], ``length``, ``first``, ...).
"""
from __future__ import annotations

import re
from typing import Callable, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed._compat import axis_names, axis_size

class Spec(tuple):
    """An immutable partition spec: one entry per tensor dim.  A tuple
    of one name is stored as the name and an empty tuple as None, as
    ``PartitionSpec`` normalises them."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            ok = e is None or isinstance(e, str) or (
                isinstance(e, tuple) and all(isinstance(a, str) for a in e))
            if not ok:
                raise TypeError(f"spec entry {e!r}: None, an axis name or "
                                "a tuple of names")
            if isinstance(e, tuple) and len(e) <= 1:
                e = e[0] if e else None
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d names that axis, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    used = set()
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not in the mesh "
                                 f"{names}")
            if a in used:
                raise ValueError(f"{spec}: axis {a!r} shards two dims")
            used.add(a)
            out[names.index(a)] = Shard(d)
    return tuple(out)


def _div(n: int, mesh, axis: str) -> bool:
    return axis in axis_names(mesh) and n % axis_size(mesh, axis) == 0


def _maybe(n: int, mesh, axis: str) -> Optional[str]:
    return axis if _div(n, mesh, axis) else None


def batch_axes(mesh, n: int):
    """Shard a batch dim over (pod, data): as much of it as divides."""
    take = []
    for a in ("pod", "data"):
        if a in axis_names(mesh) and n % axis_size(mesh, a) == 0:
            take.append(a)
            n //= axis_size(mesh, a)
    return tuple(take) if take else None


# ---------------------------------------------------------------------------
# trees


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list)) or isinstance(x, Spec)


def _map(fn: Callable, tree, key: Callable = None, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; a path
    joins the keys with "/", ``key(parent_path, k)`` naming a child (None
    leaves it out of the path)."""
    if _is_leaf(tree):
        return fn(path, tree)
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        name = key(path, k) if key is not None else str(k)
        child = path if name is None else (f"{path}/{name}" if path
                                           else name)
        out[k] = _map(fn, v, key, child)
    return out if isinstance(tree, dict) else [out[i] for i in
                                              range(len(tree))]


def leaves(tree) -> list:
    """The leaves in the order ``_map`` visits them (a ``Spec`` is one)."""
    if _is_leaf(tree):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [x for v in vals for x in leaves(v)]


# ---------------------------------------------------------------------------
# parameter rules

_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # path-regex -> per-dim axis wishes (None = replicate), matched on the
    # trailing dims: a stacked leaf's leading cycle dim is never sharded
    (r"embed$", ("model", None)),
    (r"pos_embed$", (None, None)),
    (r"lm_head$", (None, "model")),
    # attention
    (r"attn/wq$", (None, "model")),
    (r"attn/wk$", (None, "model")),
    (r"attn/wv$", (None, "model")),
    (r"attn/wo$", ("model", None)),
    (r"attn/(q_norm|k_norm)$", (None,)),
    (r"xattn/wq$", (None, "model")),
    (r"xattn/wk$", (None, "model")),
    (r"xattn/wv$", (None, "model")),
    (r"xattn/wo$", ("model", None)),
    # dense MLP
    (r"mlp/(wi|wg)$", (None, "model")),
    (r"mlp/wo$", ("model", None)),
    # MoE: experts replicated-dim, FFN dim sharded (any expert count works)
    (r"moe/router$", (None, None)),
    (r"moe/(wi|wg)$", (None, None, "model")),
    (r"moe/wo$", (None, "model", None)),
    (r"moe/shared/(wi|wg)$", (None, "model")),
    (r"moe/shared/wo$", ("model", None)),
    (r"moe/shared/gate$", (None, None)),
    # mamba
    (r"mamba/in_proj$", (None, "model")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    (r"mamba/x_proj$", ("model", None)),
    (r"mamba/dt_proj$", (None, "model")),
    (r"mamba/dt_bias$", ("model",)),
    (r"mamba/A_log$", ("model", None)),
    (r"mamba/D$", ("model",)),
    (r"mamba/out_proj$", ("model", None)),
    # xLSTM cells: head-grouped state math; shard the inner dim where the
    # head count divides the axis, else replicate (cells are small)
    (r"cell/(wq|wk|wv|wog)$", (None, "model")),
    (r"cell/(wi|wf)$", (None, None)),
    (r"cell/out$", ("model", None)),
    (r"cell/w$", (None, "model")),
    (r"cell/r$", ("model",)),
)


def _spec_for(path_s: str, shape, mesh, fsdp: bool) -> Spec:
    """Match the rules; check divisibility per dim; else replicate.

    fsdp: also shard one remaining (not model-sharded, not cycle) dim over
    `data`, the biggest that divides (ZeRO-3 style)."""
    ndim = len(shape)
    for pat, wishes in _PARAM_RULES:
        if re.search(pat, path_s):
            off = ndim - len(wishes)   # leading cycle dim(s) when stacked
            spec = [None] * ndim
            for d, wish in enumerate(wishes):
                if wish is not None and _div(shape[off + d], mesh, wish):
                    spec[off + d] = wish
            if fsdp and ndim - off >= 2:
                cands = [(shape[i], i) for i in range(off, ndim)
                         if spec[i] is None and _div(shape[i], mesh, "data")]
                if cands:
                    spec[max(cands)[1]] = "data"
            return Spec(*spec)
    return Spec(*([None] * ndim))   # norms, biases, unmatched -> replicate


def _slot(cfg: ModelConfig, i: int) -> str:
    """The reference's slot name of port layer ``i`` (as ``bridge``)."""
    return f"s{i % len(cfg.layer_pattern)}_{cfg.pattern_for_layer(i)}"


def _param_key(cfg: ModelConfig) -> Callable:
    """Path names of the port's tree on the reference's paths: layer i of
    ``blocks`` is its slot; an encoder layer's index is left out."""
    def key(parent: str, k) -> Optional[str]:
        if isinstance(k, int) and parent == "blocks":
            return _slot(cfg, k)
        if isinstance(k, int) and parent == "encoder/blocks":
            return None
        return str(k)
    return key


def param_specs(cfg: ModelConfig, params, mesh, fsdp: bool = False,
                moe_ep: bool = False):
    """A ``Spec`` tree matching a param tree.  ``moe_ep`` shards the MoE
    expert stacks' EXPERT dim over `model` (whole experts per rank) when
    the expert count divides it.  Attention and xLSTM projections shard
    over `model` only along whole heads."""
    ax = axis_size(mesh, "model")

    def strip_model(spec, dim_from_end):
        spec = list(spec)
        idx = len(spec) - dim_from_end
        if spec[idx] == "model":
            spec[idx] = None
        return Spec(*spec)

    def one(path_s, leaf):
        shape = tuple(leaf.shape)
        spec = _spec_for(path_s, shape, mesh, fsdp)
        if moe_ep and re.search(r"moe/(wi|wg|wo)$", path_s) \
                and cfg.moe and cfg.moe.num_experts % ax == 0:
            spec = Spec(*([None] * (len(shape) - 3) + ["model", None, None]))
        # HEAD-ALIGNED attention sharding: a dim like KV*hd may divide the
        # axis while splitting single heads; shard whole heads only
        if re.search(r"(attn|xattn)/(wq)$", path_s) and cfg.num_heads % ax:
            spec = strip_model(spec, 1)
        if re.search(r"(attn|xattn)/(wk|wv)$", path_s) \
                and cfg.num_kv_heads % ax:
            spec = strip_model(spec, 1)
        if re.search(r"(attn|xattn)/wo$", path_s) and cfg.num_heads % ax:
            spec = strip_model(spec, 2)
        # xLSTM inner dims are head-major [H*hd]; the same whole-head rule
        if re.search(r"cell/(wq|wk|wv|wog)$", path_s) and cfg.num_heads % ax:
            spec = strip_model(spec, 1)
        if re.search(r"cell/out$", path_s) and cfg.num_heads % ax:
            spec = strip_model(spec, 2)
        return spec

    return _map(one, params, _param_key(cfg))


def param_shardings(cfg: ModelConfig, params, mesh, fsdp: bool = False):
    """The placements tree of ``param_specs`` over ``mesh``."""
    return _map(lambda _, s: placements(s, mesh),
                param_specs(cfg, params, mesh, fsdp=fsdp))


# ---------------------------------------------------------------------------
# activation / input / cache rules


def token_spec(mesh, batch: int, mrope: bool = False) -> Spec:
    b = batch_axes(mesh, batch)
    return Spec(None, b) if mrope else Spec(b)


def batch_specs(cfg: ModelConfig, batch: dict, mesh):
    """Specs of a model-input batch dict (tokens / positions / labels /
    vision_embeds / encoder_frames)."""

    def one(name, leaf):
        shape = tuple(leaf.shape)
        b = batch_axes(mesh, shape[0] if shape else 1)
        if "positions" in name and cfg.use_mrope:
            return Spec(None, batch_axes(mesh, shape[1]), None)
        if len(shape) >= 3:          # vision_embeds / encoder_frames
            return Spec(b, *([None] * (len(shape) - 1)))
        if len(shape) == 2:
            return Spec(b, None)
        return Spec(*([None] * len(shape)))

    return _map(one, batch)


def cache_specs(cfg: ModelConfig, cache, mesh, shard_seq: bool = False):
    """Specs of a decode cache (the reference's layout).

    Default: batch -> (pod, data), kv-heads -> model (when divisible).
    shard_seq (long_500k, batch 1): the KV sequence dim -> (pod, data)
    instead, and -> model too when the kv-heads do not divide it: the
    layout ``collectives.flash_decode_seq_sharded`` attends over."""

    def one(name, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        if ndim == 0:
            return Spec()
        if re.search(r"/(k|v)$", name):
            _, B, S, KV, _ = shape
            b = batch_axes(mesh, B)
            kv_ax = _maybe(KV, mesh, "model")
            s_axes = []
            rem = S
            if shard_seq and b is None:
                for a in ("pod", "data"):
                    if a in axis_names(mesh) \
                            and rem % axis_size(mesh, a) == 0:
                        s_axes.append(a)
                        rem //= axis_size(mesh, a)
            if kv_ax is None and _div(rem, mesh, "model") and S > 1024:
                s_axes.append("model")
            return Spec(None, b, tuple(s_axes) if s_axes else None, kv_ax,
                        None)
        if ndim >= 2:       # [cycles, B, ...]: mamba/h, C, n, m, ...
            return Spec(None, batch_axes(mesh, shape[1]),
                        *([None] * (ndim - 2)))
        return Spec(*([None] * ndim))

    return _map(one, cache)


def logits_spec(cfg: ModelConfig, mesh, batch: int) -> Spec:
    return Spec(batch_axes(mesh, batch), None,
                _maybe(cfg.vocab_size, mesh, "model"))


def maybe_constrain(x, *axes_spec):
    """``x`` laid out as ``axes_spec`` when it is a DTensor on a mesh with
    those axes; otherwise ``x`` unchanged.

    Each entry is an axis name, a tuple of names, or None; names absent
    from the tensor's mesh are dropped, and with none left ``x`` is
    returned as it is.  The port's model code computes on plain tensors,
    which pass through untouched (the reference's constraint is a no-op
    off a mesh in the same way)."""
    import torch.distributed as dist
    if not dist.is_available():
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = set(mesh.mesh_dim_names or ())
    spec = []
    for entry in axes_spec:
        keep = tuple(a for a in _entry_axes(entry) if a in names)
        spec.append(keep if keep else None)
    if all(s is None for s in spec):
        return x
    return x.redistribute(mesh, placements(Spec(*spec), mesh))


def local_bytes(tree, spec_tree, mesh) -> float:
    """Per-rank bytes of a tensor tree under a spec tree."""
    total = 0.0
    for leaf, spec in zip(leaves(tree), leaves(spec_tree)):
        shards = 1
        for entry in spec:
            for a in _entry_axes(entry):
                shards *= axis_size(mesh, a)
        total += leaf.numel() * leaf.element_size() / shards
    return total
