"""Tensor parallelism over `model` and FSDP over `data`: the reference's
sharded program, written out, for all ten archs.

The reference shards every parameter by ``distributed/sharding.py``'s
rules (heads, FFN width, vocab, expert FFN columns, Mamba channels and
sLSTM units over `model`; above a size threshold one more dim over
`data`, ZeRO-3) and GSPMD places the collectives.  Here each rank holds
only its LOCAL shard of every parameter, cut by the same rules
(``sharding.param_specs``): ``shard_params`` cuts a whole tree,
``gather_params`` is its inverse (checkpoints, tests), and the model
(``Model(tp=TensorParallel(...))``) issues the collectives itself, in
Megatron's form:

  * column-parallel q/k/v (self-attention, cross-attention and the
    encoder's), MLP ``wi`` / ``wg``, the experts' ``wi`` / ``wg``, the
    Mamba ``in_proj`` and the cells' input projections:
    ``copy_to_model`` before them (identity forward; the input gradient
    all-reduced over `model` backward);
  * row-parallel attention ``wo``, MLP and expert ``wo``, Mamba
    ``out_proj`` and a cell's ``out``: ``reduce_from_model`` after them
    (all-reduce forward; identity backward).  A MoE layer sums its routed
    experts' and its shared expert's partial outputs in one reduce;
  * vocab-parallel embedding and head where `model` divides the vocab:
    each rank looks up its row range, zeros the other tokens and
    all-reduces; the head gives logits [..., V/model], which
    ``train_step``'s fused cross-entropy reduces over `model` and serving
    gathers (``gather_vocab``).  A vocab that `model` does not divide
    (hymba's 32001, whisper's 51865) leaves both whole: no collective;
  * FSDP: a leaf whose spec names `data` is all-gathered over `data`
    where it is used (``layer`` / ``encoder_layer`` / ``leaf``; inside
    the checkpointed layer, so the remat recompute gathers it again),
    its gradient reduce-scattered over `data` on the way back.

A dim the rules leave whole stays whole.  Query heads that do not divide
`model` leave the attention replicated (no collective): hymba's 25 heads
and whisper's 8 on 16 ranks.  KV heads that do not divide it leave
``wk`` / ``wv`` whole on every rank; each rank projects only the KV heads
its own query heads read (``kv0``, ``kv_local``), so the flash kernel
sees ``H_local % KV_local == 0``, and the gradients of those leaves (and
of qk-norm scales) are partial per rank: ``sync_grads`` sums them over
`model`.

The MoE layer (``models.moe``) routes on every rank from the same
activation and router.  In training, and at inference where the experts
do not divide `model`, each rank runs its FFN columns of every expert;
at inference where they divide (``moe_ep``: qwen3-moe on 16 and 4x4,
qwen2-moe on 4x4) it runs its whole experts (``distributed.
expert_parallel``).  The router reads the copied activation, so its
gradient, and the shared expert's sigmoid ``gate``'s, is a partial sum
per rank (summed by ``sync_grads``); the load-balance loss is computed
whole on every rank, so its gradient is scaled by 1/`model`
(``scale_grad``) before it reaches the router.

Fused layouts: ``mamba/in_proj`` [D, 2 inner] holds x then z, sLSTM
``w`` [D, 4D] and ``r`` [4D] the gates i, f, z, o in turn.  A contiguous
cut would give a rank columns that are not its own channels or units,
so these leaves are cut PERMUTED (``FUSED``): rank r holds the columns
of its own channels (units) in each part, the same local shape and bytes
as the reference's spec; ``gather_params`` undoes the permutation, so a
gathered tree (and a checkpoint) is the reference's leaf by leaf.  The
Mamba branch then runs on the rank's channels: its ``x_proj`` is
row-parallel, so its output is summed over `model` before ``dt_proj``
(and its gradient summed back); ``out_proj`` is reduced before the
branch's norm ``bn_m``.  The mLSTM cells are cut by whole heads where
the heads divide `model` (their whole gate projections ``wi`` / ``wf``
read at the rank's heads: partial gradients), else whole; the sLSTM by
units where `model` divides them, its ``h`` gathered before a whole
``out``.

The decode cache follows ``sharding.cache_specs`` (``cache_layout``):
KV heads over `model` where they divide; else, for a buffer of more
than 1024 slots, the sequence over `model`, and with ``shard_seq``
(long_500k: one row) over (pod, data) first.  A sequence-sharded buffer
holds every KV head of its slots and is read by
``collectives.flash_decode_seq_sharded`` over its axes, the query heads
gathered over `model` first; otherwise the decode read is the flash
kernel at one query on this rank's heads.  The cross-attention K/V are
cut by KV heads where they divide, else whole.  Recurrent state (Mamba
``h`` / ``conv``, mLSTM and sLSTM state) is whole on every rank: a rank
advances its channels, heads or units (``state_local``) and all-gathers
them after every prefill and decode step (``state_whole``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed._compat import (all_gather, all_reduce,
                                             axes_rank, axis_names,
                                             axis_rank, axis_size,
                                             reduce_scatter)

KINDS = ("attn", "local", "hymba", "mlstm", "slstm")
MLPS = ("swiglu", "gelu_glu", "relu2", "gelu", "none")
# the reference's FSDP thresholds (``repro/launch/specs.py``): params and
# AdamW state (2 + 8 bytes a param) a `model` shard for training, bf16
# params a shard for inference
TRAIN_FSDP_BYTES = 8e9
INFER_FSDP_BYTES = 4e9
# leaves whose `model`-split dim holds several parts side by side (path
# suffix -> parts): a rank holds its own columns of each part
FUSED = (("mamba/in_proj", 2), ("cell/w", 4), ("cell/r", 4))


def supported(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` is one this program shards: the layer kinds, MLPs
    and position kinds of the ten archs."""
    return (set(cfg.layer_pattern) <= set(KINDS)
            and cfg.mlp_type in MLPS
            and cfg.pos_embedding in ("rope", "none", "learned")
            and (not cfg.is_encoder_decoder
                 or set(cfg.layer_pattern) == {"attn"}))


def infer_moe_ep(cfg: ModelConfig, mesh) -> bool:
    """The reference's inference rule: whole experts over `model` when
    they divide it (training always cuts the experts' FFN dim)."""
    return cfg.moe is not None and \
        cfg.moe.num_experts % axis_size(mesh, "model") == 0


def fused_parts(path: str) -> int:
    """Parts side by side in the `model`-split dim of the leaf at
    ``path`` (``FUSED``; 1 for every other leaf)."""
    for suffix, n in FUSED:
        if path.endswith(suffix):
            return n
    return 1


def param_template(cfg: ModelConfig):
    """The port's parameter tree of ``cfg`` as fake tensors (no
    storage): what the rules read."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.model import Model
    with FakeTensorMode():
        return Model(cfg).init_params(seed=0, device="cpu")


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg`` (counted on the fake template)."""
    return sum(t.numel() for t in sh.leaves(param_template(cfg)))


def train_fsdp(numel: int, mesh) -> bool:
    """The reference's training rule: FSDP when params and AdamW state
    exceed TRAIN_FSDP_BYTES a `model` shard."""
    return numel * (2 + 8) / axis_size(mesh, "model") > TRAIN_FSDP_BYTES


def infer_fsdp(numel: int, mesh) -> bool:
    """The reference's inference rule: bf16 params over
    INFER_FSDP_BYTES a `model` shard."""
    return numel * 2 / axis_size(mesh, "model") > INFER_FSDP_BYTES


def _axes(entry) -> Tuple[str, ...]:
    return sh._entry_axes(entry)


def cut(t: torch.Tensor, spec, mesh, parts: int = 1) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a copy:
    the whole tensor is not kept alive).  ``parts`` > 1: the dim split
    over `model` holds that many parts side by side, and the rank takes
    its chunk of each (``FUSED``)."""
    out = t
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        idx, n = axes_rank(mesh, axes)
        if parts > 1 and "model" in axes:
            if axes != ("model",):
                raise NotImplementedError(f"a fused dim over {axes}")
            size = t.shape[d] // (parts * n)
            out = out.unflatten(d, (parts, -1)).narrow(
                d + 1, idx * size, size).flatten(d, d + 1)
            continue
        size = t.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out.clone() if out is not t else out


def uncut(t: torch.Tensor, spec, mesh, parts: int = 1) -> torch.Tensor:
    """The whole tensor from every rank's block: ``cut``'s inverse, an
    all-gather over each axis of the spec (innermost first), the fused
    parts put back in order."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            t = all_gather(t, mesh, a, dim=d)
            if a == "model" and parts > 1:
                n = axis_size(mesh, "model")
                t = t.unflatten(d, (n, parts, -1)).transpose(
                    d, d + 1).flatten(d, d + 2)
    return t


def shard_params(params, cfg: ModelConfig, mesh, fsdp: bool = False,
                 moe_ep: bool = False):
    """This rank's local shard of a whole param tree, by
    ``sharding.param_specs(cfg, params, mesh, fsdp, moe_ep)``: the local
    shapes are the reference's."""
    return cut_tree(params, sh.param_specs(cfg, params, mesh, fsdp=fsdp,
                                           moe_ep=moe_ep), mesh)


def cut_tree(tree, specs, mesh):
    """Every leaf of ``tree`` cut by the matching spec of ``specs`` (a
    fused leaf permuted, by its path)."""
    specs = like(tree, specs)
    return sh._map(lambda path, t: cut(t, _at(specs, path), mesh,
                                       fused_parts(path)), tree)


def gather_params(local, cfg: ModelConfig, mesh, fsdp: bool = False,
                  dst: Optional[int] = None, moe_ep: bool = False):
    """The whole param tree from every rank's local shards:
    ``shard_params``'s inverse, on every rank.  With ``dst`` (a global
    rank) the leaves are gathered one at a time and only rank ``dst``
    keeps them, each moved to the host before the next is gathered, so
    that no card ever holds more than one whole leaf; the other ranks
    get None."""
    specs = like(local, TensorParallel(cfg, mesh, fsdp, moe_ep).specs)
    keep = dst is None or dist.get_rank() == dst

    def one(path, t):
        whole = uncut(t, _at(specs, path), mesh, fused_parts(path))
        return whole if dst is None else whole.cpu() if keep else None

    out = sh._map(one, local)
    return out if keep else None


def like(tree, other):
    """``other`` (a tree of the same keys) with its dict keys in
    ``tree``'s order, so that the two trees' leaves pair up."""
    if isinstance(tree, dict):
        return {k: like(v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [like(v, o) for v, o in zip(tree, other)]
    return other


def _unflatten(tree, flat):
    it = iter(flat)
    return sh._map(lambda _, __: next(it), tree)


# ---------------------------------------------------------------------------
# collectives with gradients


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), "sum", ctx.mesh,
                          "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.contiguous().clone(), "sum", mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, "data", dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, "data", ctx.dim), None, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, "model", dim)

    @staticmethod
    def backward(ctx, g):
        n = axis_size(ctx.mesh, "model")
        return g.chunk(n, dim=ctx.dim)[axis_rank(ctx.mesh, "model")
                                       ].contiguous(), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


# ---------------------------------------------------------------------------
# cache layout


@dataclass(frozen=True)
class SeqShard:
    """A K/V buffer of ``full`` slots split into ``n`` contiguous chunks
    over ``axes`` (row-major); this rank holds chunk ``index``.  No axes:
    the whole buffer."""
    axes: Tuple[str, ...]
    n: int
    index: int
    full: int

    @property
    def local(self) -> int:
        return self.full // self.n

    @property
    def off(self) -> int:
        return self.index * self.local


@dataclass(frozen=True)
class CacheLayout:
    """Where this rank's part of a decode cache lies: the "attn" layers'
    full buffers and the "local" layers' rolling buffers (their KV heads
    are this rank's when ``TensorParallel.kv_split``, else all)."""
    attn: SeqShard
    rolling: Optional[SeqShard]


class TensorParallel:
    """The sharded program's plan on one rank of ``mesh``: which
    sublayers are split over `model`, this rank's heads, vocab rows,
    experts, channels and units, the spec of every leaf (``specs``, the
    port's tree), and the collectives the model calls.  ``moe_ep``: the
    inference layout with whole experts over `model` where they divide
    it (``infer_moe_ep``)."""

    def __init__(self, cfg: ModelConfig, mesh, fsdp: bool = False,
                 moe_ep: bool = False):
        if not supported(cfg):
            raise NotImplementedError(
                f"{cfg.name}: tensor parallelism shards the layer kinds "
                f"{KINDS}, the MLPs {MLPS} and RoPE, learned or no "
                "positions")
        self.cfg, self.mesh, self.fsdp = cfg, mesh, bool(fsdp)
        m, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
        self.size, self.rank = m, r
        H, KV, V = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size
        D = cfg.d_model
        self.heads = H % m == 0            # q heads and attention wo split
        self.kv_split = self.heads and KV % m == 0
        self.mlp = cfg.mlp_type != "none" and cfg.d_ff % m == 0
        self.vocab = V % m == 0
        self.h_local = H // m if self.heads else H
        self.h0 = r * self.h_local if self.heads else 0
        G = H // KV
        if self.kv_split:
            self.kv0, self.kv_local = r * (KV // m), KV // m
        elif self.heads:
            # the KV heads this rank's query heads read, in one uniform
            # group map (local head j reads local KV head j // G_local)
            self.kv0 = self.h0 // G
            self.kv_local = (self.h0 + self.h_local - 1) // G - self.kv0 + 1
            g = self.h_local // self.kv_local
            if self.h_local % self.kv_local or any(
                    (self.h0 + j) // G - self.kv0 != j // g
                    for j in range(self.h_local)):
                raise NotImplementedError(
                    f"{cfg.name}: {self.h_local} query heads a rank over "
                    f"{KV} KV heads (G {G}) do not read whole KV groups")
        else:
            self.kv0, self.kv_local = 0, KV
        self.v_local = V // m if self.vocab else V
        self.v0 = r * self.v_local if self.vocab else 0
        kinds = set(cfg.layer_pattern)
        if "hymba" in kinds and self.heads and not self.kv_split:
            raise NotImplementedError(
                f"{cfg.name}: hymba's rolling buffer holds the rank's "
                f"query heads' KV heads only ({H} heads over {KV} KV "
                f"heads on {m} ranks)")
        # MoE: experts whole over `model` (moe_ep), or their FFN columns;
        # ``experts``: the routed output is a partial sum over `model`
        mo = cfg.moe
        self.moe_ep = bool(moe_ep) and infer_moe_ep(cfg, mesh)
        self.moe_ffn = mo is not None and not self.moe_ep \
            and mo.expert_d_ff % m == 0
        self.experts = self.moe_ep or self.moe_ffn
        self.shared = mo is not None and bool(mo.num_shared_experts) \
            and mo.shared_expert_d_ff % m == 0
        if mo is not None and mo.num_shared_experts \
                and self.experts != self.shared:
            raise NotImplementedError(
                f"{cfg.name}: routed experts and shared expert split "
                f"differently over {m} ranks")
        # Mamba channels; mLSTM heads; sLSTM units (and its `out` rows)
        self.mamba = False
        if "hymba" in kinds:
            from repro_torch.models.ssm import mamba_inner_dim
            inner = mamba_inner_dim(cfg)
            self.mamba = inner % m == 0
            if not self.mamba and (2 * inner) % m == 0:
                raise NotImplementedError(
                    f"{cfg.name}: in_proj splits over {m} ranks but its "
                    f"{inner} channels do not")
        self.mlstm = "mlstm" in kinds and self.heads
        self.slstm = "slstm" in kinds and D % m == 0
        if "slstm" in kinds and not self.slstm and (4 * D) % m == 0:
            raise NotImplementedError(
                f"{cfg.name}: the sLSTM gates split over {m} ranks but "
                f"its {D} units do not")
        self.slstm_out = self.slstm and self.heads
        self.specs = sh.param_specs(cfg, param_template(cfg), mesh,
                                    fsdp=self.fsdp, moe_ep=self.moe_ep)
        self.layer_specs = {}
        for i in range(cfg.num_layers):
            self.layer_specs.setdefault(cfg.pattern_for_layer(i),
                                        self.specs["blocks"][i])
        self.enc_specs = self.specs["encoder"]["blocks"][0] \
            if cfg.is_encoder_decoder else None
        if cfg.is_encoder_decoder and not self.kv_split and self.heads:
            raise NotImplementedError(
                f"{cfg.name}: cross-attention K/V over {KV} KV heads on "
                f"{m} ranks")
        # leaves whose gradient is a partial sum per `model` rank
        self.partial = sh._map(self._partial, self.specs,
                               sh._param_key(cfg))

    def _partial(self, path: str, spec) -> bool:
        if self.size == 1:
            return False
        if path.endswith(("moe/router", "moe/shared/gate")):
            # read by the copied activation; the aux loss's share is
            # scaled by 1/model (``scale_grad``)
            return self.experts
        if path.endswith(("cell/wi", "cell/wf")):
            return self.mlstm      # whole, read at the rank's heads
        if not self.heads:
            return False
        if path.endswith(("attn/wk", "attn/wv")):
            return not self.kv_split
        return path.endswith(("attn/q_norm", "attn/k_norm"))

    # ------------------------------------------------------- collectives

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.mesh) if self.size > 1 else x

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self.mesh) if self.size > 1 else x

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` (its gradient:
        this rank's chunk)."""
        if self.size == 1:
            return x
        return _GatherModel.apply(x, self.mesh, dim % x.dim())

    def scale_grad(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, its gradient divided by `model`: a term computed whole
        on every rank whose gradient meets a partial one."""
        if self.size == 1:
            return x
        return _ScaleGrad.apply(x, 1.0 / self.size)

    def attn_in(self, x):
        return self.copy_to_model(x) if self.heads else x

    def attn_out(self, y):
        return self.reduce_from_model(y) if self.heads else y

    def mlp_in(self, x):
        return self.copy_to_model(x) if self.mlp else x

    def mlp_out(self, y):
        return self.reduce_from_model(y) if self.mlp else y

    def vocab_in(self, x):
        return self.copy_to_model(x) if self.vocab else x

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Local logits [..., V/model] -> the whole vocab [..., V]."""
        if not self.vocab or self.size == 1:
            return logits
        return _GatherModel.apply(logits, self.mesh, logits.dim() - 1)

    def gather_heads(self, q: torch.Tensor) -> torch.Tensor:
        """[B, S, H_local, hd] -> every query head [B, S, H, hd]."""
        if not self.heads or self.size == 1:
            return q
        return all_gather(q, self.mesh, "model", dim=2)

    def head_cols(self, w: torch.Tensor) -> torch.Tensor:
        """Of a whole [.., H] per-head projection (the mLSTM gates), the
        columns of this rank's heads."""
        if not self.mlstm:
            return w
        return w[..., self.h0:self.h0 + self.h_local]

    def _unshard(self, t: torch.Tensor, spec) -> torch.Tensor:
        for d, entry in enumerate(spec):
            if "data" in _axes(entry):
                return _GatherData.apply(t, self.mesh, d)
        return t

    def leaf(self, params: dict, name: str) -> torch.Tensor:
        """A top-level leaf (``embed``, ``lm_head``, ``pos_embed``)
        gathered over `data` when FSDP split it."""
        return self._unshard(params[name], self.specs[name])

    def layer(self, kind: str, p: dict) -> dict:
        """A layer's params with its FSDP leaves gathered over `data`."""
        return self._gather_tree(self.layer_specs[kind], p)

    def encoder_layer(self, p: dict) -> dict:
        """An encoder layer's params, its FSDP leaves gathered."""
        return self._gather_tree(self.enc_specs, p)

    def _gather_tree(self, spec, p: dict) -> dict:
        return sh._map(lambda path, t: self._unshard(
            t, _at(spec, path)), p)

    def attn_params(self, pa: dict, store: bool = False) -> dict:
        """A layer's attention params as its projection uses them: with
        ``wk`` / ``wv`` whole on every rank, the columns of the KV heads
        this rank's queries read (``store``: every KV head, what a cache
        that holds every head is written from)."""
        if self.kv_split or not self.heads or store:
            return pa
        hd = self.cfg.resolved_head_dim
        lo, hi = self.kv0 * hd, (self.kv0 + self.kv_local) * hd
        return dict(pa, wk=pa["wk"][:, lo:hi], wv=pa["wv"][:, lo:hi])

    def stores_read_heads(self) -> bool:
        """Whether a cache's KV heads are exactly those this rank's
        queries read (else it holds every head)."""
        return self.kv_split or not self.heads

    # ----------------------------------------------------- recurrent state

    def _state_dims(self, kind: str) -> dict:
        """Of a layer's recurrent state, the dim of each leaf this rank
        advances a part of (empty: the layer runs whole)."""
        if kind == "hymba" and self.mamba:
            return {"h": 1, "conv": 2}
        if kind == "mlstm" and self.mlstm:
            return {"C": 1, "n": 1, "m": 1}
        if kind == "slstm" and self.slstm:
            return {"c": 1, "n": 1, "h": 1, "m": 1}
        return {}

    def state_local(self, kind: str, st: dict) -> dict:
        """This rank's channels, heads or units of a whole recurrent
        state (the other leaves of ``st`` as they are)."""
        out = dict(st)
        for name, d in self._state_dims(kind).items():
            n = st[name].shape[d] // self.size
            out[name] = st[name].narrow(d, self.rank * n, n)
        return out

    def state_whole(self, kind: str, st: dict) -> dict:
        """Every rank's part of a recurrent state gathered over `model`:
        the whole state each rank's cache holds."""
        out = dict(st)
        for name, d in self._state_dims(kind).items():
            out[name] = all_gather(st[name], self.mesh, "model", dim=d)
        return out

    # ------------------------------------------------------------ vocab

    def shards(self, name: str, dim: int) -> int:
        """Over how many ranks the rules split dim ``dim`` of the
        top-level leaf ``name``."""
        return axes_rank(self.mesh, _axes(self.specs[name][dim]))[1]

    def lookup(self, params: dict, name: str, ids: torch.Tensor
               ) -> torch.Tensor:
        """Rows ``ids`` of the table ``params[name]`` (the embedding, or
        whisper's learned positions), gathered over `data` when FSDP
        split it.  A table whose rows the rules split over `model` (a
        vocab-parallel embedding): this rank's rows looked up, the
        others zero, summed over `model`."""
        table = self.leaf(params, name)
        if "model" not in _axes(self.specs[name][0]) or self.size == 1:
            return table[ids.long()]
        n = table.shape[0]
        ids = ids.long() - self.rank * n
        ok = (ids >= 0) & (ids < n)
        x = table[ids.clamp(0, n - 1)] * ok[..., None].to(table.dtype)
        return self.reduce_from_model(x)

    # ------------------------------------------------------------ cache

    def cache_layout(self, max_len: int, shard_seq: bool = False
                     ) -> CacheLayout:
        """The layout ``sharding.cache_specs`` gives a cache of
        ``max_len`` slots (``shard_seq``: long_500k's, one row)."""
        from repro_torch.models import cache as cache_lib
        cfg = self.cfg
        hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
        lens = {"attn": max_len}
        rolling = [k for k in ("local", "hymba") if k in cfg.layer_pattern]
        if rolling:
            lens[rolling[0]] = cache_lib.rolling_len(cfg, max_len)
        ref = {"slots": {f"s0_{kind}": {"k": torch.empty(
            (1, 1, n, KV, hd), device="meta")} for kind, n in lens.items()}}
        specs = sh.cache_specs(cfg, ref, self.mesh, shard_seq=shard_seq)
        out = {}
        for kind, n in lens.items():
            spec = specs["slots"][f"s0_{kind}"]["k"]
            axes = _axes(spec[2])
            idx, cnt = axes_rank(self.mesh, axes)
            out[kind] = SeqShard(axes, cnt, idx, n)
        return CacheLayout(attn=out["attn"],
                           rolling=out[rolling[0]] if rolling else None)

    def init_cache(self, batch: int, max_len: int, dtype, device,
                   shard_seq: bool = False):
        """This rank's zeroed contiguous cache for ``batch`` rows: its
        part of the K/V buffers (``cache_layout``) and of the cross-
        attention K/V (its KV heads where they split), the recurrent
        state whole."""
        from repro_torch.models import cache as cache_lib
        cfg = self.cfg
        lay = self.cache_layout(max_len, shard_seq)
        kv = cfg.num_kv_heads // self.size if self.kv_split \
            else cfg.num_kv_heads
        hd = cfg.resolved_head_dim
        n_attn = len(cache_lib.paged_layers(cfg))
        shape = (n_attn, batch, lay.attn.local, kv, hd)
        state = cache_lib.init_row_state(
            cfg, batch, max_len, dtype, device, kv_heads=kv,
            rolling=None if lay.rolling is None else lay.rolling.local)
        return cache_lib.Cache(
            length=0,
            first=torch.zeros(batch, dtype=torch.int32, device=device),
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            state=state, layout=lay)

    # ------------------------------------------------------------ grads

    def sync_grads(self, grads, loss: torch.Tensor):
        """Gradients and loss of this rank's batch shard -> the whole
        batch's, as the one-process step has them: the partial leaves
        summed over `model`; the FSDP leaves (already summed over `data`
        by their reduce-scatter) summed over `pod`; the others and the
        loss summed over (pod, data); all divided by the batch shards."""
        mesh = self.mesh
        flat = sh.leaves(grads)
        part = sh.leaves(like(grads, self.partial))
        specs = sh.leaves(like(grads, self.specs))
        n = 1
        for a in ("pod", "data"):
            n *= axis_size(mesh, a)
        groups = {"model": [], "fsdp": [], "dp": []}
        for i, (g, p, s) in enumerate(zip(flat, part, specs)):
            if p:
                groups["model"].append(i)
            fsdp = any("data" in _axes(e) for e in s)
            groups["fsdp" if fsdp else "dp"].append(i)
        out = list(flat)
        axes = {"model": ("model",), "fsdp": ("pod",),
                "dp": ("pod", "data")}
        scale = {"model": 1.0, "fsdp": 1.0 / n, "dp": 1.0 / n}
        loss_out = loss
        for name in ("model", "fsdp", "dp"):
            idx = groups[name]
            extra = [loss] if name == "dp" else []
            ts = [out[i] for i in idx] + extra
            if not ts:
                continue
            buf = torch.cat([t.float().reshape(-1) for t in ts])
            for a in axes[name]:
                all_reduce(buf, "sum", mesh, a)
            buf = buf * scale[name]
            at = 0
            for i in idx:
                t = out[i]
                out[i] = buf[at:at + t.numel()].reshape(t.shape).to(t.dtype)
                at += t.numel()
            if extra:
                loss_out = buf[at].to(loss.dtype)
        return _unflatten(grads, out), loss_out

    def grad_sq_norm(self, grads) -> torch.Tensor:
        """The squared global norm of the whole gradient from this rank's
        shards: each leaf's local sum of squares weighted by the share
        of the world holding that shard, summed over every axis."""
        mesh = self.mesh
        world = 1
        for a in axis_names(mesh):
            world *= axis_size(mesh, a)
        tot = None
        for g, s in zip(sh.leaves(grads), sh.leaves(like(grads,
                                                          self.specs))):
            shards = 1
            for e in s:
                for a in _axes(e):
                    shards *= axis_size(mesh, a)
            term = torch.sum(torch.square(g.float())) * (shards / world)
            tot = term if tot is None else tot + term
        for a in axis_names(mesh):
            all_reduce(tot, "sum", mesh, a)
        return tot


def _at(tree, path: str):
    for k in path.split("/") if path else ():
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree
