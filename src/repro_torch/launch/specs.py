"""Input stand-ins and the step of every (architecture x input shape)
pair: the dry-run's contract.

Counterpart of ``repro/launch/specs.py``.  ``input_specs(cfg, shape)``
returns the exact batch the step consumes, key for key with the
reference's shapes and dtypes, as tensors on ``device="meta"`` (or, under
a ``FakeTensorMode``, fake ones on the CPU): nothing is allocated.
Modality frontends are stubs, as in the reference: the VLM takes patch
embeddings [B, Nv, D], the audio model conv-frontend frames [B, 1500, D].

``build_step(cfg, shape, mesh)`` returns ``(step, args, in_specs,
out_specs, meta)``.  ``meta`` follows the reference's rules, key for key:
expert parallelism off training when the experts divide the `model`
axis, the FSDP thresholds (8e9 bytes of params and AdamW state a rank
for training, 4e9 of params for inference), the microbatch doubling
above 4e9 bytes of residuals, ``kv_shards``; its per-rank bytes are
those of the reference's layout under the sharding rules
(``distributed.sharding``), which is what ``in_specs`` and ``out_specs``
describe.

``step`` and ``args`` are what the port runs on one rank of that mesh:
for every arch the reference's sharded program, tensor parallelism over
`model` and, where ``meta["fsdp"]`` says so, FSDP over `data`
(``distributed.tensor_parallel``), with the MoE layers' whole experts
over `model` where ``meta`` turns on expert parallelism
(``TensorParallel(moe_ep=True)``) and their FFN columns elsewhere.
``args`` hold this rank's shard of every param and AdamW moment (and of
the decode cache, laid out as ``cache_specs``, its recurrent state whole
on every rank), so their bytes are ``meta["param_bytes_per_dev"]`` and
``meta["cache_bytes_per_dev"]``.  Training is ``make_train_step(mesh=,
fsdp=meta["fsdp"])``; prefill and decode run ``Model(tp=)`` on the
rank's ``batch_per_dev`` rows and return the last logits over the whole
vocab.  ``args`` holds the global batch for training, as every rank is
handed it; decode starts from a cache at length ``seq_len - 1``, so it
reads the whole context, as the reference's decode over its full buffer
does.  ``args`` are fake
tensors on ``device="cpu"`` (``launch.roofline.analyze`` runs ``step``
on them under their mode); the plain kernel versions run there.
``mesh`` is a ``DeviceMesh`` or a ``launch.mesh.MeshShape``; with a
``MeshShape`` (no process group) ``args`` are rank 0's and ``step``
runs only when every axis has size 1.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed._compat import axis_names, axis_size
from repro_torch.models import ssm
from repro_torch.models.model import Model
from repro_torch.train.train_step import init_opt_state, make_train_step

S32 = torch.int32
BF16 = torch.bfloat16


def input_specs(cfg: ModelConfig, shape: InputShape, rows: int = None,
                device: str = "meta") -> dict:
    """The model inputs of one input shape (``rows`` batch rows, the
    global batch by default) as empty tensors on ``device``."""
    B = shape.global_batch if rows is None else rows
    S = shape.seq_len
    new = lambda *s, dtype=S32: torch.empty(s, dtype=dtype, device=device)
    if shape.mode == "decode":
        return {"tokens": new(B, 1)}
    batch = {"tokens": new(B, S)}
    if cfg.use_mrope:
        S_total = S + cfg.num_vision_tokens
        batch["vision_embeds"] = new(B, cfg.num_vision_tokens, cfg.d_model,
                                     dtype=BF16)
        batch["positions"] = new(3, B, S_total)
    else:
        batch["positions"] = new(B, S)
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = new(B, cfg.encoder_seq_len, cfg.d_model,
                                      dtype=BF16)
    if shape.mode == "train":
        batch["labels"] = new(B, S)
    return batch


def reference_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The reference's decode-cache layout (``repro/models/cache.py``:
    bf16, stacked by pattern slot over the cycles) as meta tensors: what
    ``cache_specs`` reads and ``meta["cache_bytes_per_dev"]`` counts."""
    nc = cfg.num_layers // len(cfg.layer_pattern)
    hd, KV, W = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.sliding_window
    dev = "meta"

    def kv(n):
        return {x: torch.empty((nc, batch, n, KV, hd), dtype=BF16,
                               device=dev) for x in ("k", "v")}

    def stacked(tree):
        return {k: torch.empty((nc,) + tuple(a.shape), dtype=a.dtype,
                               device=dev) for k, a in tree.items()}

    slots = {}
    for i, kind in enumerate(cfg.layer_pattern):
        name = f"s{i}_{kind}"
        if kind == "attn":
            slots[name] = kv(max_len)
        elif kind == "local":
            slots[name] = kv(min(W, max_len))
        elif kind == "hymba":
            slots[name] = dict(kv(min(W or max_len, max_len)),
                               mamba=stacked(ssm.mamba_init_state(
                                   cfg, batch, BF16, dev)))
        elif kind == "mlstm":
            slots[name] = stacked(ssm.mlstm_init_state(cfg, batch, dev))
        elif kind == "slstm":
            slots[name] = stacked(ssm.slstm_init_state(cfg, batch, dev))
        else:
            raise ValueError(kind)
    cache = {"length": torch.empty((), dtype=S32, device=dev),
             "first": torch.empty((batch,), dtype=S32, device=dev),
             "slots": slots}
    if cfg.is_encoder_decoder:
        cache["enc"] = {x: torch.empty((nc, batch, cfg.encoder_seq_len, KV,
                                        hd), dtype=BF16, device=dev)
                        for x in ("k", "v")}
    return cache


def build_step(cfg: ModelConfig, shape: InputShape, mesh
               ) -> Tuple[Callable, tuple, tuple, tuple, dict]:
    """(step, args, in_specs, out_specs, meta): see the module
    docstring.  Nothing is allocated: the params, optimizer state, batch
    and cache in ``args`` are fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    msize = axis_size(mesh, "model")
    # expert parallelism for inference whenever whole experts divide the
    # model axis; training cuts the experts' FFN dim, as the reference does
    moe_ep = tpl.infer_moe_ep(cfg, mesh) and shape.mode != "train"
    B, S = shape.global_batch, shape.seq_len
    max_seq = S + (cfg.num_vision_tokens if cfg.use_mrope else 0)
    batch_spec = sh.batch_specs(cfg, input_specs(cfg, shape), mesh)
    fake = FakeTensorMode()
    with fake:
        params = Model(cfg).init_params(seed=0, device="cpu",
                                        max_seq=max_seq)
    numel = sum(leaf.numel() for leaf in sh.leaves(params))
    vocab_loc = cfg.vocab_size // (msize if cfg.vocab_size % msize == 0
                                   else 1)

    if shape.mode == "train":
        # FSDP only when params + AdamW state exceed the per-rank budget
        # under pure tensor parallelism (the reference's rule)
        fsdp = tpl.train_fsdp(numel, mesh)
        pspec = sh.param_specs(cfg, params, mesh, fsdp=fsdp, moe_ep=moe_ep)
        b_shards = 1
        for a in ("pod", "data"):
            if a in axis_names(mesh) and B % axis_size(mesh, a) == 0:
                b_shards *= axis_size(mesh, a)
        b_loc = max(1, B // b_shards)
        resid_per_seq = (cfg.num_layers // max(1, len(cfg.layer_pattern))
                         * max_seq * cfg.d_model * 2)
        microbatch = 1
        while b_loc // microbatch > 1 and \
                resid_per_seq * (b_loc // microbatch) > 4e9:
            microbatch *= 2
        meta = {
            "param_bytes_per_dev": sh.local_bytes(params, pspec, mesh),
            "batch_per_dev": b_loc,
            "microbatch": microbatch,
            "fsdp": fsdp,
            "vocab_loc": vocab_loc,
            "kv_shards": 1,
        }
        with fake:
            params = tpl.shard_params(params, cfg, mesh, fsdp)
            opt = init_opt_state(params)
            batch = input_specs(cfg, shape, device="cpu")
        step = make_train_step(Model(cfg), lr=3e-4, remat=True,
                               microbatch=microbatch, mesh=mesh,
                               fsdp=fsdp)
        ospec = {"step": sh.Spec(), "mu": pspec, "nu": pspec}
        scalars = {"loss": sh.Spec(), "aux_loss": sh.Spec(),
                   "total_loss": sh.Spec()}
        return (step, (params, opt, batch), (pspec, ospec, batch_spec),
                (pspec, ospec, scalars), meta)

    # inference shapes; ZeRO-inference (extra data-axis param sharding)
    # for very large models
    fsdp_inf = tpl.infer_fsdp(numel, mesh)
    pspec = sh.param_specs(cfg, params, mesh, fsdp=fsdp_inf, moe_ep=moe_ep)
    ref_cache = reference_cache(cfg, B, S)
    cspec = sh.cache_specs(cfg, ref_cache, mesh,
                           shard_seq=(shape.name == "long_500k"))
    b_shards = 1
    for a in (sh.batch_axes(mesh, B) or ()):
        b_shards *= axis_size(mesh, a)
    kv_shards = 1
    if cfg.num_kv_heads % msize == 0 or S % msize == 0:
        kv_shards = msize
    b_loc = max(1, B // b_shards)
    meta = {
        "param_bytes_per_dev": sh.local_bytes(params, pspec, mesh),
        "cache_bytes_per_dev": sh.local_bytes(ref_cache, cspec, mesh),
        "batch_per_dev": b_loc,
        "fsdp": fsdp_inf,
        "vocab_loc": vocab_loc,
        "kv_shards": kv_shards,
    }
    model = Model(cfg, tp=tpl.TensorParallel(cfg, mesh, fsdp_inf, moe_ep))
    with fake:
        params = tpl.shard_params(params, cfg, mesh, fsdp_inf, moe_ep)
        batch = input_specs(cfg, shape, rows=b_loc, device="cpu")
        cache = model.init_cache(b_loc, S, device="cpu",
                                 shard_seq=shape.name == "long_500k")
    # the sharded program gathers the last logits to the whole vocab
    lspec = sh.Spec(sh.batch_axes(mesh, B), None)

    if shape.mode == "prefill":
        def step(params, batch, cache):
            logits = model.prefill(
                params, batch["tokens"], batch["positions"], cache,
                vision_embeds=batch.get("vision_embeds"),
                encoder_frames=batch.get("encoder_frames"))
            return logits, cache
        return (step, (params, batch, cache), (pspec, batch_spec, cspec),
                (lspec, cspec), meta)

    # decode: one token a row after seq_len - 1 cached ones
    cache.length = S - 1

    def step(params, token, cache):
        return model.decode_step(params, token, cache), cache
    tok_spec = sh.Spec(sh.batch_axes(mesh, B), None)
    return (step, (params, batch["tokens"], cache),
            (pspec, tok_spec, cspec), (lspec, cspec), meta)

