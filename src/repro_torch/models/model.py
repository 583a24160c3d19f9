"""Decoder on torch tensors, serving through a contiguous or a paged KV
cache beside per-row state.

Counterpart of the "attn", "local", "hymba", "mlstm" and "slstm" paths
of ``repro/models/model.py``, with dense or MoE MLP sublayers
(``models.moe``).  The reference stacks per-layer parameters by pattern
slot and scans over cycles; here the parameters are a list of per-layer
dicts and the stack is a Python loop that dispatches on the layer's kind
(``cfg.pattern_for_layer``).  Recurrent layers (xLSTM cells,
``models.ssm``) have no MLP sublayer.  An "attn" layer attends to every
earlier position, a "local" layer (Gemma-2's) to the last
``sliding_window`` ones.  A hymba layer runs sliding-window attention
and a Mamba SSM on the same normed input, fuses them as ``0.5 *
(bn_a(attn) + bn_m(mamba))``, then its MLP sublayer.

Entry points (pure functions of the parameter dict, except that the
cache's buffers or pools, per-row state and ``length`` are updated):

  forward(params, tokens, positions, vision_embeds,
          return_aux, remat)                          -> logits [B,S,V]
  prefill(params, tokens, positions, cache,
          vision_embeds)                              -> last logits [B,V]
  prefill_chunk(params, tokens, positions, cache)     -> last logits [B,V]
  decode_step(params, token, cache, kv_cap, relative,
              nb_cap, active)                         -> logits [B,V]

``prefill`` absorbs a whole left-padded prompt batch into a fresh
contiguous ``Cache`` (full-sequence attention; recurrent layers run with
no pad mask, as the reference's prefill mode does).  ``prefill_chunk``
and ``decode_step`` take either cache.  A ``Cache`` keeps every row at
one shared absolute ``length``: chunk positions are per-row RELATIVE
(counted from ``cache.first``, -1 at pads), and decode positions are the
shared absolute ``length`` with slots left of ``first`` masked, or with
``relative=True`` relative like the chunks (continuous batching).  A
``PagedCache`` is always relative, with per-row lengths.  A recurrent
layer treats a -1 chunk position as an identity step.  The K/V of a
"local" or hymba layer lives in its row's rolling buffer
(``cache.state``) in either cache: a chunk reads the buffer, then
writes it; a decode step writes the token, then reads with the window.

Qwen3's qk-norm (``cfg.qk_norm``) runs in ``layers.qkv_project``.  With
``cfg.use_mrope`` (Qwen2-VL), ``forward``, ``prefill`` and
``prefill_chunk`` take positions [B, S] or M-RoPE's t/h/w positions [3,
B, S]: the angles come from all three, masks and cache writes from axis
0, as the reference's ``pos2d``.  The model treats 2-D positions as equal
t/h/w positions, for which M-RoPE is RoPE, so the engines (and
``decode_step``) pass 2-D positions where the reference's broadcast them
to [3, B, L]; serving is text-only in both packages.  ``forward`` and
``prefill`` take the stub vision frontend's patch embeddings
``vision_embeds`` [B, Nv, D], placed before the token embeddings; the
positions then cover Nv + S columns, and ``prefill`` advances ``length``
by Nv + S.

Position embeddings are RoPE, none, a learned table or sinusoidal
(``_embed``).  A learned table (``params["pos_embed"]``, ``max_seq``
rows) is read at each column's position clamped into the table, as the
reference's clip does: a pad (-1) reads row 0.  The engines' frames
therefore decide what a row sees: a wave's prefill and its decode run at
absolute positions (a left-padded row starts at its pad count), the
chunks and the relative decode count from the row's first token.
Sinusoidal rows ``0 .. S-1`` are added whatever the positions, as in the
reference, which is why ``prefill_chunk`` refuses them.

An encoder-decoder config (Whisper's backbone) runs ``encode`` over the
stub frontend's frames ``encoder_frames`` [B, Se, D] (sinusoidal
positions, non-causal attention, a final norm) in ``forward``,
``prefill`` and every ``prefill_chunk``, and each decoder layer adds a
cross-attention sublayer (``lnx`` / ``xattn``, every position 0, so each
query sees every frame) between self-attention and its MLP.  ``prefill``
and the chunks store each layer's cross-attention K/V in the row's state
(``xk`` / ``xv``, ``cache.init_row_state``); a decode step reads them.
Its decoder layers must be "attn" layers, as in the one such config.

``forward`` is differentiable for every kind (the training path,
``repro_torch.train``): with ``return_aux`` it also returns the MoE
layers' summed load-balance loss, and with ``remat`` each decoder layer
runs under ``torch.utils.checkpoint`` (its activations recomputed in the
backward pass).  The serving entry points write caches in place and are
not differentiated.

``batch_mesh`` (set by the train step over a mesh) averages the MoE
load-balance loss's router statistics over the mesh's batch axes.

``Model(tp=TensorParallel(cfg, mesh, fsdp, moe_ep))`` (``distributed.
tensor_parallel``) is one rank of the reference's sharded program, for
every arch: params hold this rank's shards (``init_params`` cuts its
whole draw), and each sublayer runs on the rank's part of it with its
collectives over `model`: attention, cross-attention and the encoder's
attention on its heads (whole where the heads do not divide `model`),
MLPs on their FFN columns, MoE layers on their experts' FFN columns or,
under ``moe_ep`` (inference), their whole experts (``moe.apply_moe(
tp=)``, ``distributed.expert_parallel``), hymba's Mamba branch on its
channels, the mLSTM on its heads, the sLSTM on its units
(``models.ssm``), the embedding and head on their vocab rows where the
vocab divides `model`; FSDP leaves are gathered over `data` inside each
layer.  ``forward``, ``prefill`` and ``decode_step`` (contiguous
cache, from ``init_cache``, which lays the buffers out as
``sharding.cache_specs``; recurrent state whole on every rank, gathered
after each step) run so; logits come back over the whole vocab.
``prefill_chunk`` and the paged cache raise under ``tp``.

Layer kinds other than these five raise ``NotImplementedError``, as does
an encoder-decoder config with other decoder layers.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel
from repro_torch.kernels import ops
from repro_torch.models import cache as cache_lib
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import ssm

KINDS = ("attn", "local", "hymba", "mlstm", "slstm")
POS_KINDS = ("rope", "none", "learned", "sinusoidal")
# kinds whose K/V is a per-row rolling buffer of the window
ROLLING_KINDS = ("local", "hymba")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Model:
    def __init__(self, cfg: ModelConfig, moe_capacity_factor: float = 1.25,
                 batch_mesh=None, tp=None):
        unsupported = []
        if any(kind not in KINDS for kind in cfg.layer_pattern):
            unsupported.append(f"layer_pattern={cfg.layer_pattern}")
        if cfg.is_encoder_decoder and set(cfg.layer_pattern) != {"attn"}:
            unsupported.append("cross-attention beside layers other than "
                               "'attn'")
        if cfg.pos_embedding not in POS_KINDS:
            unsupported.append(f"pos_embedding={cfg.pos_embedding}")
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: the port serves full and sliding-window "
                f"attention, hymba, MoE and xLSTM layers and "
                f"encoder-decoder models of 'attn' layers only "
                f"({', '.join(unsupported)})")
        self.cfg = cfg
        # encoder-decoder: a cross-attention sublayer in every layer
        self.cross = cfg.is_encoder_decoder
        # capacity factor of the MoE dispatch; float(num_experts) is
        # dropless (the serving engine's default)
        self.moe_cf = moe_capacity_factor
        # a DeviceMesh whose (pod, data) axes split the batch into equal
        # row shards (the train step over a mesh): the MoE load-balance
        # loss then averages its router statistics over them
        self.batch_mesh = batch_mesh
        # tensor parallelism (a TensorParallel of this config), or None
        if tp is not None and tp.cfg != cfg:
            raise ValueError(f"a TensorParallel of {tp.cfg.name} given to "
                             f"a model of {cfg.name}")
        self.tp = tp
        self.kinds = [cfg.pattern_for_layer(i) for i in range(cfg.num_layers)]
        # layer -> index into the K/V pools, for the "attn" layers
        self.pool_index = {i: j for j, i in
                           enumerate(cache_lib.paged_layers(cfg))}
        # the layers with a rolling K/V buffer in their row's state
        self.rolling = [i for i, kind in enumerate(self.kinds)
                        if kind in ROLLING_KINDS]

    # ------------------------------------------------------------------ init

    def init_params(self, seed: int = 0, device: DeviceLike = "cuda",
                    max_seq: int = 2048) -> dict:
        """Random parameters at the config's shapes and dtype, drawn from a
        ``torch.Generator`` seeded with ``seed`` on ``device``.  Mamba's
        ``A_log`` and ``D`` are f32 in a bf16 model, as in the
        reference.  A learned position table has ``max_seq`` rows; an
        encoder-decoder model adds ``lnx`` / ``xattn`` to each layer and
        ``params["encoder"]`` = {"blocks": per-layer {ln1, attn, ln2,
        mlp}, "final_norm"}.  With ``tp`` every leaf keeps this rank's
        shard of the whole draw."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, dev)}
        if cfg.pos_embedding == "learned":
            params["pos_embed"] = L.embed_init(gen, max_seq, cfg.d_model,
                                               dtype, dev)
        blocks = []
        for kind in self.kinds:
            blk = {"ln1": L.init_norm(cfg, dtype, dev)}
            if kind == "mlstm":
                blk["cell"] = ssm.init_mlstm(gen, cfg, dtype, dev)
            elif kind == "slstm":
                blk["cell"] = ssm.init_slstm(gen, cfg, dtype, dev)
            else:
                blk["attn"] = L.init_attention(gen, cfg, dtype, dev)
            if kind == "hymba":
                blk["mamba"] = ssm.init_mamba(gen, cfg, dtype, dev)
                blk["bn_a"] = L.init_norm(cfg, dtype, dev)   # branch norms
                blk["bn_m"] = L.init_norm(cfg, dtype, dev)
            if self.cross:
                blk["lnx"] = L.init_norm(cfg, dtype, dev)
                blk["xattn"] = L.init_attention(gen, cfg, dtype, dev)
            if kind in ("attn", "local", "hymba") \
                    and cfg.mlp_type != "none":
                blk["ln2"] = L.init_norm(cfg, dtype, dev)
                if cfg.moe is not None:
                    blk["moe"] = moe.init_moe(gen, cfg, dtype, dev)
                else:
                    blk["mlp"] = L.init_mlp(gen, cfg, dtype, dev)
            if self.tp is not None:     # cut now: one whole layer at most
                blk = tensor_parallel.cut_tree(
                    blk, self.tp.layer_specs[kind], self.tp.mesh)
            blocks.append(blk)
        params["blocks"] = blocks
        params["final_norm"] = L.init_norm(cfg, dtype, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             dtype, dev)
        if self.cross:
            params["encoder"] = {
                "blocks": [{"ln1": L.init_norm(cfg, dtype, dev),
                            "attn": L.init_attention(gen, cfg, dtype, dev),
                            "ln2": L.init_norm(cfg, dtype, dev),
                            "mlp": L.init_mlp(gen, cfg, dtype, dev)}
                           for _ in range(cfg.num_encoder_layers)],
                "final_norm": L.init_norm(cfg, dtype, dev)}
        if self.tp is not None:     # the blocks are cut already
            top = {k: v for k, v in params.items() if k != "blocks"}
            top = tensor_parallel.cut_tree(
                top, {k: self.tp.specs[k] for k in top}, self.tp.mesh)
            params = {k: blocks if k == "blocks" else top[k]
                      for k in params}
        return params

    def init_cache(self, batch: int, max_len: int, device: DeviceLike,
                   shard_seq: bool = False) -> cache_lib.Cache:
        """A zeroed contiguous cache; under ``tp`` this rank's part of it
        (``shard_seq``: long_500k's layout, the sequence over the batch
        axes too)."""
        if self.tp is not None:
            return self.tp.init_cache(batch, max_len, torch_dtype(self.cfg),
                                      resolve_device(device), shard_seq)
        return cache_lib.init_cache(self.cfg, batch, max_len,
                                    torch_dtype(self.cfg),
                                    resolve_device(device))

    def init_paged_cache(self, batch: int, max_len: int, block_size: int,
                         num_blocks: int, device: DeviceLike
                         ) -> cache_lib.PagedCache:
        self._no_tp("the paged cache")
        return cache_lib.init_paged_cache(
            self.cfg, batch, max_len, block_size, num_blocks,
            torch_dtype(self.cfg), resolve_device(device))

    # -------------------------------------------------------------- helpers

    def _no_tp(self, what: str) -> None:
        if self.tp is not None:
            raise NotImplementedError(
                f"{what} under tensor parallelism: the sharded program "
                "runs forward, prefill and decode_step on a contiguous "
                "cache")

    def _embed(self, params, tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               vision_embeds: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Token embeddings (after ``vision_embeds``) plus the position
        embedding at ``positions`` [B, S]: a learned table's rows at the
        positions clamped into it (pads read row 0), or sinusoidal rows
        0 .. S-1 whatever the positions.  RoPE and position-free configs
        need no ``positions`` here."""
        cfg = self.cfg
        tp = self.tp
        x = params["embed"][tokens.long()] if tp is None \
            else tp.lookup(params, "embed", tokens)
        if cfg.scale_embedding:
            x = x * torch.tensor(cfg.d_model, dtype=x.dtype,
                                 device=x.device).sqrt()
        if vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
        if cfg.pos_embedding == "learned":
            rows = positions.long().clamp(0, self._pos_rows(params) - 1)
            x = x + (params["pos_embed"][rows] if tp is None
                     else tp.lookup(params, "pos_embed", rows))
        elif cfg.pos_embedding == "sinusoidal":
            x = x + L.sinusoidal_positions(
                positions.shape[-1], cfg.d_model, x.device).to(x.dtype)[None]
        return x

    def _pos_rows(self, params) -> int:
        """Rows of the learned position table (every rank's, under
        ``tp``)."""
        n = params["pos_embed"].shape[0]
        return n if self.tp is None else n * self.tp.shards(
            "pos_embed", 0)

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over the stub frontend's frames [B, Se, D]: frames
        plus sinusoidal positions, then per layer non-causal attention
        and the MLP, each with its residual, then the final norm ->
        [B, Se, D] in the model's dtype (under ``tp`` every rank's,
        each layer on its heads and FFN columns)."""
        cfg, tp = self.cfg, self.tp
        B, S, _ = frames.shape
        dt = torch_dtype(cfg)
        x = frames.to(dt) + L.sinusoidal_positions(
            S, cfg.d_model, frames.device).to(dt)[None]
        pos = torch.arange(S, dtype=torch.int32, device=frames.device
                           )[None].expand(B, S)
        for p in params["encoder"]["blocks"]:
            if tp is not None:
                p = tp.encoder_layer(p)
            q, k, v = L.qkv_project(p["attn"], L.apply_norm(p["ln1"], x, cfg),
                                    cfg, None, tp=tp)
            a = L.flash_attention(q, k, v, pos, pos, causal=False)
            x = x + L.attention_out(p["attn"], a, tp=tp)
            x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg,
                                tp=tp)
        return L.apply_norm(params["encoder"]["final_norm"], x, cfg)

    def _encoder_out(self, params, frames: Optional[torch.Tensor]
                     ) -> Optional[torch.Tensor]:
        """``encode(frames)`` for an encoder-decoder model, else None."""
        if not self.cross:
            return None
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder model: "
                             "pass encoder_frames [B, Se, D]")
        return self.encode(params, frames)

    def _cross(self, p, x: torch.Tensor, enc_out: Optional[torch.Tensor],
               st: Optional[dict]) -> torch.Tensor:
        """The cross-attention sublayer with its residual: ``x``'s queries
        attend to every encoder frame (all positions 0).  With
        ``enc_out`` the layer's K/V come from the encoder output and,
        with ``st`` (the row state), are stored as ``st["xk"]`` /
        ``st["xv"]``; without, a decode step reads them from ``st``.  One
        query goes through ``decode_attention``, more through non-causal
        flash, as in the reference.  Under ``tp`` on this rank's heads
        (``layers.cross_project``), the stored K/V its KV heads."""
        cfg = self.cfg
        h = L.apply_norm(p["lnx"], x, cfg)
        B, Sq = h.shape[:2]
        q, k, v = L.cross_project(p["xattn"], h, enc_out, cfg, tp=self.tp)
        if enc_out is None:
            k, v = st["xk"], st["xv"]
        elif st is not None:
            st["xk"].copy_(k)
            st["xv"].copy_(v)
        q_pos = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
        kv_pos = torch.zeros((B, k.shape[1]), dtype=torch.int32,
                             device=x.device)
        if Sq == 1:
            a = L.decode_attention(q, k, v, q_pos[:, 0], kv_pos)
        else:
            a = L.flash_attention(q, k, v, q_pos, kv_pos, causal=False)
        return x + L.attention_out(p["xattn"], a, tp=self.tp)

    def _angles(self, positions: torch.Tensor) -> Optional[torch.Tensor]:
        cfg = self.cfg
        if cfg.pos_embedding != "rope":
            return None
        return L.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                             cfg.mrope_sections if cfg.use_mrope else ())

    def _angles_pos2d(self, positions: torch.Tensor):
        """(RoPE angles, the [B, S] positions of masks and cache writes)
        from positions [B, S] or M-RoPE's [3, B, S]."""
        return self._angles(positions), \
            positions if positions.dim() == 2 else positions[0]

    def _mlp(self, p, x: torch.Tensor,
             aux: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """The MLP (or MoE) sublayer with its residual.  A MoE layer
        appends its load-balance loss to ``aux`` when one is given."""
        if "moe" in p:
            h = L.apply_norm(p["ln2"], x, self.cfg)
            out = moe.apply_moe(p["moe"], h, self.cfg,
                                capacity_factor=self.moe_cf,
                                return_aux=aux is not None,
                                batch_mesh=self.batch_mesh, tp=self.tp)
            if aux is None:
                return x + out
            y, a = out
            aux.append(a)
            return x + y
        if "mlp" not in p:
            return x
        return x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, self.cfg),
                               self.cfg, tp=self.tp)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.head(params, L.apply_norm(params["final_norm"], x,
                                              self.cfg))

    def lm_head(self, params) -> torch.Tensor:
        """The LM head [D, V]: the embedding's transpose when tied.  Under
        ``tp`` this rank's columns [D, V/model] (gathered over `data`
        when FSDP split them)."""
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        w = params[name] if self.tp is None else self.tp.leaf(params, name)
        return w.T if self.cfg.tie_embeddings else w

    def head(self, params, feats: torch.Tensor) -> torch.Tensor:
        """Logits of final-normed features (``forward(...,
        return_features=True)``): the LM head (the embedding's transpose
        when tied), then the final softcap in f32 if the config has one.
        Under ``tp`` each rank's vocab columns, gathered to the whole
        vocab."""
        cfg = self.cfg
        if self.tp is not None:
            feats = self.tp.vocab_in(feats)
        logits = feats @ self.lm_head(params)
        if cfg.final_logit_softcap:
            logits = cfg.final_logit_softcap * torch.tanh(
                logits.float() / cfg.final_logit_softcap)
        return logits if self.tp is None else self.tp.gather_vocab(logits)

    def _cell(self, p, kind: str, h: torch.Tensor, state: Optional[dict],
              mask: Optional[torch.Tensor] = None, step: bool = False):
        """A recurrent layer's cell on the normed input ``h``: the chunkwise
        mLSTM or the sLSTM scan over a sequence (identity steps where
        ``mask`` is False), or one decode step.  Returns (y, new state).
        Under ``tp`` the cell advances this rank's heads or units of the
        whole state, which is gathered again (``state_local`` /
        ``state_whole``)."""
        tp = self.tp
        whole = tp is not None and state is not None
        st = tp.state_local(kind, state) if whole else state
        if step:
            fn = ssm.mlstm_step if kind == "mlstm" else ssm.slstm_step
            y, new = fn(p["cell"], h, self.cfg, st, tp=tp)
        else:
            fn = ssm.mlstm_forward_chunked if kind == "mlstm" \
                else ssm.slstm_forward
            y, new = fn(p["cell"], h, self.cfg, st, mask=mask, tp=tp)
        return y, tp.state_whole(kind, new) if whole else new

    def _attention(self, q, k, v, q_pos, kv_pos) -> torch.Tensor:
        return L.flash_attention(q, k, v, q_pos, kv_pos, causal=True,
                                 window=self.cfg.sliding_window,
                                 softcap=self.cfg.attn_logit_softcap)

    def _hymba(self, p, x: torch.Tensor, st: Optional[dict], angles,
               attend, mask: Optional[torch.Tensor] = None,
               step: bool = False, aux: Optional[list] = None
               ) -> Tuple[torch.Tensor, Optional[dict]]:
        """One hymba layer: attention and Mamba branches on the same
        ``ln1`` output, fused as ``0.5 * (bn_a(attn) + bn_m(mamba))``,
        then the MLP sublayer.  ``attend(q, k, v, st)`` reads (and
        writes) the layer's rolling K/V in ``st``; the Mamba branch scans
        the sequence from ``st``'s {h, conv} (zero state when ``st`` is
        None; identity steps where ``mask`` is False), or takes one
        decode step.  Returns (x, the layer's new state)."""
        cfg, tp = self.cfg, self.tp
        h = L.apply_norm(p["ln1"], x, cfg)
        q, k, v = L.qkv_project(p["attn"], h, cfg, angles, tp=tp)
        a = attend(q, k, v, st)
        ms = st if tp is None or st is None else tp.state_local("hymba", st)
        if step:
            mo, mstate = ssm.mamba_step(p["mamba"], h, cfg, ms, tp=tp)
        else:
            mo, mstate = ssm.mamba_forward(p["mamba"], h, cfg, ms, mask,
                                           tp=tp)
        if tp is not None and st is not None:
            mstate = tp.state_whole("hymba", mstate)
        ao = L.attention_out(p["attn"], a, tp=tp)
        x = x + 0.5 * (L.apply_norm(p["bn_a"], ao, cfg)
                       + self._mamba_norm(p, mo))
        new = None if st is None else dict(st, **mstate)
        return self._mlp(p, x, aux), new

    def _mamba_norm(self, p, mo: torch.Tensor) -> torch.Tensor:
        """``bn_m`` of hymba's Mamba branch.  On a rank's channels
        ``mo`` is ``out_proj``'s partial sum: reduced over `model` first,
        since the norm is not linear."""
        if self.tp is not None and self.tp.mamba:
            mo = self.tp.reduce_from_model(mo)
        return L.apply_norm(p["bn_m"], mo, self.cfg)

    def _rolling(self, kind: str, p, x: torch.Tensor, st: Optional[dict],
                 angles, attend, mask: Optional[torch.Tensor] = None,
                 step: bool = False, aux: Optional[list] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
        """A layer whose K/V is a rolling buffer in ``st``: a hymba layer
        (``_hymba``), or a "local" one: windowed attention through
        ``attend(q, k, v, st)`` (which reads and writes ``st``'s buffer),
        then the MLP sublayer (a MoE one appends its load-balance loss to
        ``aux``).  Returns (x, the layer's new state)."""
        if kind == "hymba":
            return self._hymba(p, x, st, angles, attend, mask, step, aux)
        h = L.apply_norm(p["ln1"], x, self.cfg)
        q, k, v = L.qkv_project(p["attn"], h, self.cfg, angles, tp=self.tp,
                                store=st is not None)
        x = x + L.attention_out(p["attn"], attend(q, k, v, st), tp=self.tp)
        return self._mlp(p, x, aux), st

    def _rolling_len(self, cache) -> int:
        """Slots of the rolling K/V buffers in ``cache`` (every rank's,
        under ``tp``)."""
        if getattr(cache, "layout", None) is not None:
            return cache.layout.rolling.full
        return cache.state[self.rolling[0]]["k"].shape[1]

    def _gathered(self, kind: str, p):
        """A layer's params as it uses them: under ``tp`` its FSDP leaves
        gathered over `data`."""
        return p if self.tp is None else self.tp.layer(kind, p)

    def _stored_kv(self, pa, h, angles, k, v):
        """``kv(t0, t1)``: the K/V of a prompt's tokens t0 .. t1-1 in the
        heads the cache holds: ``k`` / ``v`` (the heads this rank's
        queries read) when that is what it holds, else, under ``tp`` with
        ``wk`` / ``wv`` whole, every KV head projected again from ``h``
        for those tokens alone."""
        tp = self.tp
        if tp is None or tp.stores_read_heads():
            return lambda t0, t1: (k[:, t0:t1], v[:, t0:t1])
        pa = tp.attn_params(pa, store=True)
        return lambda t0, t1: L.kv_project(
            pa, h[:, t0:t1], self.cfg,
            None if angles is None else angles[:, t0:t1])

    def _write_seq(self, k_buf, v_buf, start: int, S: int, shard,
                   kv) -> None:
        """``cache_lib.write_seq`` of a segment of S tokens at shared
        position ``start`` (their K/V from ``kv(t0, t1)``) into this
        rank's part of a buffer: the whole buffer (``shard`` None or over
        no axis), or its chunk of a buffer split by sequence, which takes
        only the segment's tokens whose slots are its own."""
        if shard is None or not shard.axes:
            cache_lib.write_seq(k_buf, v_buf, *kv(0, S), start)
            return
        for t0, t1, s0 in _shard_runs(start, S, shard):
            k, v = kv(t0, t1)
            k_buf[:, s0:s0 + t1 - t0] = k.to(k_buf.dtype)
            v_buf[:, s0:s0 + t1 - t0] = v.to(v_buf.dtype)

    def _read_kv(self, k, v):
        """Of K/V in the heads this rank's cache holds (every KV head
        when ``wk`` / ``wv`` are whole on the rank:
        ``TensorParallel.stores_read_heads``), the heads its queries
        read."""
        tp = self.tp
        if tp is None or tp.stores_read_heads():
            return k, v
        heads = slice(tp.kv0, tp.kv0 + tp.kv_local)
        return k[:, :, heads], v[:, :, heads]

    def _decode_read(self, q, k, v, k_buf, v_buf, length: int, pos,
                     kv_pos, shard, window: Optional[int]) -> torch.Tensor:
        """One decode token's write at shared position ``length`` into a
        contiguous buffer and its attention over the buffer (``kv_pos``
        [B, slots]: every slot's position in the query frame).  ``shard``
        None: the whole buffer on this process.  Under ``tp`` the rank
        holding the token's slot writes it; a buffer over no axis is read
        by the flash kernel at one query over the rank's KV heads, one
        split by sequence by ``collectives.flash_decode_seq_sharded`` over
        its axes (every query head when the buffer holds every KV
        head)."""
        cfg, tp = self.cfg, self.tp
        n = k_buf.shape[1]
        full, off = (n, 0) if shard is None else (shard.full, shard.off)
        slot = length % full - off
        if 0 <= slot < n:
            k_buf[:, slot] = k[:, 0].to(k_buf.dtype)
            v_buf[:, slot] = v[:, 0].to(v_buf.dtype)
        kv_pos = kv_pos[:, off:off + n]
        if shard is None or not shard.axes:
            return L.decode_attention(q, *self._read_kv(k_buf, v_buf),
                                      pos[:, 0], kv_pos, window=window,
                                      softcap=cfg.attn_logit_softcap)
        every = not tp.stores_read_heads()
        o = collectives.flash_decode_seq_sharded(
            tp.gather_heads(q) if every else q, k_buf, v_buf, pos[:, 0],
            tp.mesh, axis=shard.axes, softcap=cfg.attn_logit_softcap,
            kv_positions=kv_pos, window=window)
        return o[:, :, tp.h0:tp.h0 + tp.h_local] if every else o

    # ---------------------------------------------------------------- public

    def forward(self, params, tokens: torch.Tensor,
                positions: torch.Tensor,
                return_features: bool = False,
                vision_embeds: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None,
                return_aux: bool = False, remat: bool = False):
        """Full-sequence forward: tokens [B,S] (after ``vision_embeds``
        [B,Nv,D] if given) at positions [B,Nv+S] or [3,B,Nv+S] -> logits
        [B,Nv+S,V] (recurrent layers start from zero state), or with
        ``return_features`` the final-normed features [B,Nv+S,D], which
        ``head`` turns into logits (at the columns a caller needs).  An
        encoder-decoder model attends to ``encoder_frames`` [B,Se,D].
        With ``return_aux`` it returns (that output, the MoE layers'
        summed load-balance loss, an f32 scalar: 0 without MoE layers),
        as the reference's training forward does.  ``remat`` checkpoints
        each decoder layer (``torch.utils.checkpoint``, non-reentrant):
        the same values, activations recomputed in the backward pass."""
        cfg = self.cfg
        angles, positions = self._angles_pos2d(positions)
        x = self._embed(params, tokens, positions, vision_embeds)
        enc_out = self._encoder_out(params, encoder_frames)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, p in zip(self.kinds, params["blocks"]):
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    self._train_layer, kind, p, x, angles, positions,
                    enc_out, use_reentrant=False)
            else:
                x, a = self._train_layer(kind, p, x, angles, positions,
                                         enc_out)
            aux = aux + a
        out = L.apply_norm(params["final_norm"], x, cfg) \
            if return_features else self._logits(params, x)
        return (out, aux) if return_aux else out

    def _train_layer(self, kind: str, p, x: torch.Tensor, angles,
                     positions: torch.Tensor,
                     enc_out: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decoder layer of ``forward`` (no cache): (x, the layer's
        load-balance loss, 0 unless it is a MoE layer)."""
        cfg = self.cfg
        aux: List[torch.Tensor] = []
        p = self._gathered(kind, p)     # inside remat: the recompute too

        def attend(q, k, v, st):
            return self._attention(q, k, v, positions, positions)

        def attend_fill(q, k, v, st):   # pad columns reach the Mamba branch
            return L.fill_pad_queries(attend(q, k, v, st), v, positions)

        if kind in ROLLING_KINDS:
            x, _ = self._rolling(kind, p, x, None, angles,
                                 attend_fill if kind == "hymba" else attend,
                                 aux=aux)
        elif kind != "attn":
            x = x + self._cell(p, kind, L.apply_norm(p["ln1"], x, cfg),
                               None)[0]
        else:
            h = L.apply_norm(p["ln1"], x, cfg)
            q, k, v = L.qkv_project(p["attn"], h, cfg, angles, tp=self.tp)
            a = L.flash_attention(q, k, v, positions, positions, causal=True,
                                  softcap=cfg.attn_logit_softcap)
            x = x + L.attention_out(p["attn"], a, tp=self.tp)
            if self.cross:
                x = self._cross(p, x, enc_out, None)
            x = self._mlp(p, x, aux)
        total = sum(aux) if aux else torch.zeros(
            (), dtype=torch.float32, device=x.device)
        return x, total

    def prefill(self, params, tokens: torch.Tensor,
                positions: torch.Tensor, cache: cache_lib.Cache,
                vision_embeds: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Absorb a [B, S] prompt batch (after ``vision_embeds`` [B,Nv,D]
        if given; absolute ``positions`` [B,Nv+S] or [3,B,Nv+S], -1 at
        left pads) into a contiguous cache at its shared ``length``:
        causal attention over the batch itself, its K/V written to the
        buffers (a "local" or hymba layer's rolling buffer keeps the last
        tokens it holds); recurrent layers (the Mamba branch too) run
        over every column from the cache's state, pads included (no pad
        mask, as in the reference's prefill mode).  An encoder-decoder
        model encodes ``encoder_frames`` and stores each layer's
        cross-attention K/V in the row state.  Advances ``cache.length``
        by Nv + S; returns the last column's logits.

        Under ``tp`` attention runs on this rank's query heads and the KV
        heads they read; the cache is written where this rank holds it
        (``cache.layout``: its KV heads, or every head of its slots when
        the buffer is split by sequence; ``_stored_kv``)."""
        cfg = self.cfg
        start = cache.length
        lay = cache.layout
        angles, positions = self._angles_pos2d(positions)
        x = self._embed(params, tokens, positions, vision_embeds)
        S = x.shape[1]
        enc_out = self._encoder_out(params, encoder_frames)

        def attend_fill(q, k, v, st):
            # hymba's rolling buffer (this rank's part of it); the Mamba
            # branch of the next layer absorbs the pad columns
            a = self._attention(q, k, v, positions, positions)
            self._write_seq(st["k"], st["v"], start, S, lay and lay.rolling,
                            lambda t0, t1: (k[:, t0:t1], v[:, t0:t1]))
            return L.fill_pad_queries(a, v, positions)

        for i, (kind, p) in enumerate(zip(self.kinds, params["blocks"])):
            p = self._gathered(kind, p)
            if kind == "hymba":
                x, cache.state[i] = self._rolling(
                    kind, p, x, cache.state[i], angles, attend_fill)
                continue
            h = L.apply_norm(p["ln1"], x, cfg)
            if kind not in ("attn", "local"):
                y, cache.state[i] = self._cell(p, kind, h, cache.state[i])
                x = x + y
                continue
            q, k, v = L.qkv_project(p["attn"], h, cfg, angles, tp=self.tp)
            a = L.flash_attention(
                q, k, v, positions, positions, causal=True,
                window=cfg.sliding_window if kind == "local" else None,
                softcap=cfg.attn_logit_softcap)
            if kind == "attn":
                j = self.pool_index[i]
                kb, vb, shard = cache.k[j], cache.v[j], lay and lay.attn
            else:
                st = cache.state[i]
                kb, vb, shard = st["k"], st["v"], lay and lay.rolling
            self._write_seq(kb, vb, start, S, shard,
                            self._stored_kv(p["attn"], h, angles, k, v))
            x = x + L.attention_out(p["attn"], a, tp=self.tp)
            if self.cross:
                x = self._cross(p, x, enc_out, cache.state[i])
            x = self._mlp(p, x)
        cache.length = start + S
        return self._logits(params, x[:, -1])

    def prefill_chunk(self, params, tokens: torch.Tensor,
                      positions: torch.Tensor, cache,
                      last_col: Optional[torch.Tensor] = None,
                      encoder_frames: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """Absorb one [B, C] prompt chunk into the cache.

        In an "attn" layer each row's queries attend to its cached past
        plus the chunk itself, then the chunk's K/V are written.  A
        ``PagedCache`` gathers the full block-table width (slots at or
        beyond the row's ``length`` and before ``first`` are masked) and
        scatters the chunk into the row's blocks; a contiguous ``Cache``
        reads its whole buffer (slots at or beyond the shared ``length``
        and before ``first`` are masked) and writes the chunk at
        ``length``.  A "local" or hymba layer does the same over its
        row's rolling buffer (read before the write: a chunk that wraps
        must not read slots it has just overwritten), with the window; a
        row that brings more tokens than the buffer holds keeps its last
        ones.  A recurrent layer (and the Mamba branch) runs over the
        chunk from the row's state, with an identity step at every pad.
        ``positions`` [B, C] or [3, B, C] are relative (-1 at pads, which
        write nowhere and leave the state alone).  An encoder-decoder
        model encodes ``encoder_frames`` again on every chunk, as the
        reference does, and rewrites the cross-attention K/V of the row
        state.  Advances ``cache.length`` by C and returns the logits at
        ``last_col`` [B] (default: the last column).  Sinusoidal
        positions raise ``NotImplementedError``: they ignore the chunk's
        offset."""
        self._no_tp("prefill_chunk")
        cfg = self.cfg
        if cfg.pos_embedding == "sinusoidal":
            raise NotImplementedError(
                "sinusoidal embeddings ignore the chunk offset; chunked "
                "prefill is unsupported for pos_embedding='sinusoidal'")
        B, S = tokens.shape
        angles, positions = self._angles_pos2d(positions)
        paged = isinstance(cache, cache_lib.PagedCache)
        first = cache.first
        start = cache.length
        pos32 = positions.to(torch.int32)
        if paged and (self.pool_index or self.rolling):
            abs_write = torch.where(positions >= 0,
                                    positions + first[:, None],
                                    torch.full_like(positions, -1))
        if self.pool_index and paged:
            tables = cache.block_tables
            bs, P = cache.block_size, cache.num_blocks
            L_buf = tables.shape[1] * bs
            plan = cache_lib.pool_write_plan(tables, abs_write, bs, P)
            past = cache_lib.full_kv_positions(start[:, None], L_buf) \
                - first[:, None]
        elif self.pool_index:
            past = cache_lib.shared_kv_positions(
                start, cache.k.shape[2], tokens.device)[None] \
                - first[:, None]
        if self.pool_index:
            kv_pos = torch.cat([past, pos32], dim=1)
        if self.rolling:
            Lw = self._rolling_len(cache)
            if paged:
                r_past = cache_lib.rolling_kv_positions(start[:, None], Lw)
                r_plan = cache_lib.rolling_write_plan(abs_write, Lw)
            else:
                r_past = cache_lib.rolling_kv_positions(
                    start, Lw, tokens.device)[None]
            r_kv_pos = torch.cat([r_past - first[:, None], pos32], dim=1)
        mask = positions >= 0
        x = self._embed(params, tokens, positions)
        enc_out = self._encoder_out(params, encoder_frames)

        def attend(q, k, v, st):
            k_all = torch.cat([st["k"], k.to(st["k"].dtype)], dim=1)
            v_all = torch.cat([st["v"], v.to(st["v"].dtype)], dim=1)
            if paged:
                cache_lib.rolling_write(st["k"], st["v"], k, v, r_plan)
            else:
                cache_lib.write_seq(st["k"], st["v"], k, v, start)
            return self._attention(q, k_all, v_all, positions, r_kv_pos)

        for i, (kind, p) in enumerate(zip(self.kinds, params["blocks"])):
            if kind in ROLLING_KINDS:
                x, cache.state[i] = self._rolling(kind, p, x, cache.state[i],
                                                  angles, attend, mask)
                continue
            h = L.apply_norm(p["ln1"], x, cfg)
            if kind != "attn":
                y, cache.state[i] = self._cell(p, kind, h, cache.state[i],
                                               mask)
                x = x + y
                continue
            j = self.pool_index[i]
            q, k, v = L.qkv_project(p["attn"], h, cfg, angles)
            if paged:
                k_buf, v_buf = cache_lib.paged_gather_kv(
                    cache.k[j], cache.v[j], tables, tables.shape[1])
                cache_lib.paged_write(cache.k[j], cache.v[j], k, v, plan)
            else:
                k_buf, v_buf = cache.k[j], cache.v[j]
            k_all = torch.cat([k_buf, k.to(k_buf.dtype)], dim=1)
            v_all = torch.cat([v_buf, v.to(v_buf.dtype)], dim=1)
            if not paged:
                cache_lib.write_seq(cache.k[j], cache.v[j], k, v, start)
            a = L.flash_attention(q, k_all, v_all, positions, kv_pos,
                                  causal=True, softcap=cfg.attn_logit_softcap)
            x = x + L.attention_out(p["attn"], a)
            if self.cross:
                x = self._cross(p, x, enc_out, cache.state[i])
            x = self._mlp(p, x)
        cache.length = cache.length + S
        if last_col is None:
            xl = x[:, -1]
        else:
            xl = x[torch.arange(B, device=x.device), last_col.long()]
        return self._logits(params, xl)

    def decode_step(self, params, token: torch.Tensor, cache,
                    kv_cap: Optional[int] = None, relative: bool = False,
                    nb_cap: Optional[int] = None,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """token [B,1] -> next-token logits [B,V].

        Contiguous ``Cache``: every row writes its token at the shared
        absolute position ``length``, then reads its whole buffer through
        ``layers.decode_attention``; slots at or beyond ``kv_cap`` (the
        highest position the caller's loop can reach, exact) and beyond
        ``length`` count as empty.  Positions are the absolute ``length``
        with slots left of ``first`` masked, or with ``relative`` the
        row's live count ``length - first`` (slots before ``first`` go
        negative).  A "local" or hymba layer does the same over its
        rolling buffer (slot ``length % Lw``, the window applied).

        ``PagedCache`` (always relative): each row writes at its own
        ``length`` (rows with ``active`` False write nowhere and keep
        their length), then attends through the first ``nb_cap``
        block-table columns with the paged decode kernel: slots ``first
        <= pos <= length`` count.  The K/V of a "local" or hymba layer is
        not pooled: the row writes into its rolling buffer and reads it
        through the flash kernel at one query.

        A recurrent layer steps every row's state, as the reference does
        (a finished row's state is replaced when the row is refilled)."""
        if isinstance(cache, cache_lib.PagedCache):
            self._no_tp("the paged cache")
            return self._paged_decode(params, token, cache, nb_cap, active)
        cfg = self.cfg
        B = token.shape[0]
        length, first = cache.length, cache.first
        lay = cache.layout
        if relative:
            pos = (length - first)[:, None].to(torch.int32)
        else:
            pos = torch.full((B, 1), length, dtype=torch.int32,
                             device=token.device)

        def frame(kv):          # shared positions -> the query frame
            kv = kv[None]
            if relative:
                return kv - first[:, None]
            return torch.where(kv >= first[:, None], kv,
                               torch.full_like(kv, -1))

        attn = None
        if self.pool_index:
            kv = cache_lib.shared_kv_positions(
                length + 1, cache.k.shape[2] if lay is None
                else lay.attn.full, token.device)
            if kv_cap is not None:
                kv[kv_cap:] = -1
            kv_pos = frame(kv)

            def attn(j, q, k, v):
                return self._decode_read(q, k, v, cache.k[j], cache.v[j],
                                         length, pos, kv_pos,
                                         lay and lay.attn, None)

        if self.rolling:
            r_pos = frame(cache_lib.rolling_kv_positions(
                length + 1, self._rolling_len(cache), token.device))

        def attend(q, k, v, st):
            return self._decode_read(q, k, v, st["k"], st["v"], length, pos,
                                     r_pos, lay and lay.rolling,
                                     cfg.sliding_window)

        return self._decode_layers(params, token, cache, pos, attend, attn,
                                   inc=1)

    def _decode_layers(self, params, token, cache, pos, attend, attn, inc):
        """The decode layer loop shared by both caches at positions ``pos``
        [B, 1]: ``attend`` serves the "local" and hymba layers (their
        rolling buffers), ``attn(j, q, k, v)`` the "attn" layers (pool or
        buffer ``j``), each followed by cross-attention over the stored
        K/V in an encoder-decoder model; recurrent cells step.
        Advances ``cache.length`` by ``inc``."""
        cfg = self.cfg
        x = self._embed(params, token, pos)
        angles = self._angles(pos)
        for i, (kind, p) in enumerate(zip(self.kinds, params["blocks"])):
            p = self._gathered(kind, p)
            if kind in ROLLING_KINDS:
                x, cache.state[i] = self._rolling(kind, p, x, cache.state[i],
                                                  angles, attend, step=True)
                continue
            h = L.apply_norm(p["ln1"], x, cfg)
            if kind != "attn":
                y, cache.state[i] = self._cell(p, kind, h, cache.state[i],
                                               step=True)
                x = x + y
                continue
            q, k, v = L.qkv_project(p["attn"], h, cfg, angles, tp=self.tp,
                                    store=True)
            a = attn(self.pool_index[i], q, k, v)
            x = x + L.attention_out(p["attn"], a, tp=self.tp)
            if self.cross:
                x = self._cross(p, x, None, cache.state[i])
            x = self._mlp(p, x)
        cache.length = cache.length + inc
        return self._logits(params, x[:, 0])

    def _paged_decode(self, params, token: torch.Tensor,
                      cache: cache_lib.PagedCache, nb_cap: Optional[int],
                      active: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        first, start = cache.first, cache.length
        pos = (start - first)[:, None]
        attn = None
        if self.pool_index:
            nb_total = cache.block_tables.shape[1]
            nb = nb_total if nb_cap is None else min(nb_cap, nb_total)
            plan = cache_lib.pool_write_plan(
                cache.block_tables, start[:, None], cache.block_size,
                cache.num_blocks, active)
            tables = cache.block_tables[:, :nb].contiguous()

            def attn(j, q, k, v):
                cache_lib.paged_write(cache.k[j], cache.v[j], k, v, plan)
                a = ops.paged_decode_attention(
                    q[:, 0].contiguous(), cache.k[j], cache.v[j], tables,
                    first, start, softcap=cfg.attn_logit_softcap)
                return a[:, None]

        if self.rolling:
            r_pos = cache_lib.rolling_kv_positions(
                (start + 1)[:, None], self._rolling_len(cache)) \
                - first[:, None]

        def attend(q, k, v, st):
            cache_lib.rolling_write_token(st["k"], st["v"], k, v, start,
                                          active)
            return L.decode_attention(q, st["k"], st["v"], pos[:, 0], r_pos,
                                      window=cfg.sliding_window,
                                      softcap=cfg.attn_logit_softcap)

        inc = 1 if active is None else active.to(torch.int32)
        return self._decode_layers(params, token, cache, pos, attend, attn,
                                   inc)


def _shard_runs(start: int, S: int, shard) -> List[Tuple[int, int, int]]:
    """The runs (first token, end token, first local slot) of a segment of
    S tokens written at shared position ``start`` into a buffer of
    ``shard.full`` slots (slot = position % full; a segment longer than
    the buffer keeps its last tokens) that land in this rank's chunk:
    host arithmetic, at most one run a wrap of the buffer."""
    L_, lo = shard.full, max(0, S - shard.full)
    runs = []
    for wrap in range((start + lo) // L_, (start + S - 1) // L_ + 1):
        base = wrap * L_ + shard.off - start     # token at local slot 0
        t0, t1 = max(lo, base), min(S, base + shard.local)
        if t0 < t1:
            runs.append((t0, t1, t0 - base))
    return runs
