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

  forward(params, tokens, positions, vision_embeds)   -> logits [B,S,V]
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

Layer kinds other than these five, encoder-decoder and position
embeddings other than RoPE or none raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import cache as cache_lib
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import ssm

KINDS = ("attn", "local", "hymba", "mlstm", "slstm")
# kinds whose K/V is a per-row rolling buffer of the window
ROLLING_KINDS = ("local", "hymba")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Model:
    def __init__(self, cfg: ModelConfig, moe_capacity_factor: float = 1.25):
        unsupported = []
        if any(kind not in KINDS for kind in cfg.layer_pattern):
            unsupported.append(f"layer_pattern={cfg.layer_pattern}")
        if cfg.is_encoder_decoder:
            unsupported.append("encoder-decoder")
        if cfg.pos_embedding not in ("rope", "none"):
            unsupported.append(f"pos_embedding={cfg.pos_embedding}")
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: the port serves full and sliding-window "
                f"attention, hymba, MoE and xLSTM layers only so far "
                f"({', '.join(unsupported)})")
        self.cfg = cfg
        # capacity factor of the MoE dispatch; float(num_experts) is
        # dropless (the serving engine's default)
        self.moe_cf = moe_capacity_factor
        self.kinds = [cfg.pattern_for_layer(i) for i in range(cfg.num_layers)]
        # layer -> index into the K/V pools, for the "attn" layers
        self.pool_index = {i: j for j, i in
                           enumerate(cache_lib.paged_layers(cfg))}
        # the layers with a rolling K/V buffer in their row's state
        self.rolling = [i for i, kind in enumerate(self.kinds)
                        if kind in ROLLING_KINDS]

    # ------------------------------------------------------------------ init

    def init_params(self, seed: int = 0, device: DeviceLike = "cuda") -> dict:
        """Random parameters at the config's shapes and dtype, drawn from a
        ``torch.Generator`` seeded with ``seed`` on ``device``.  Mamba's
        ``A_log`` and ``D`` are f32 in a bf16 model, as in the
        reference."""
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = torch_dtype(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, dev)}
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
            if kind in ("attn", "local", "hymba") \
                    and cfg.mlp_type != "none":
                blk["ln2"] = L.init_norm(cfg, dtype, dev)
                if cfg.moe is not None:
                    blk["moe"] = moe.init_moe(gen, cfg, dtype, dev)
                else:
                    blk["mlp"] = L.init_mlp(gen, cfg, dtype, dev)
            blocks.append(blk)
        params["blocks"] = blocks
        params["final_norm"] = L.init_norm(cfg, dtype, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             dtype, dev)
        return params

    def init_cache(self, batch: int, max_len: int, device: DeviceLike
                   ) -> cache_lib.Cache:
        return cache_lib.init_cache(self.cfg, batch, max_len,
                                    torch_dtype(self.cfg),
                                    resolve_device(device))

    def init_paged_cache(self, batch: int, max_len: int, block_size: int,
                         num_blocks: int, device: DeviceLike
                         ) -> cache_lib.PagedCache:
        return cache_lib.init_paged_cache(
            self.cfg, batch, max_len, block_size, num_blocks,
            torch_dtype(self.cfg), resolve_device(device))

    # -------------------------------------------------------------- helpers

    def _embed(self, params, tokens: torch.Tensor,
               vision_embeds: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        x = params["embed"][tokens.long()]
        if self.cfg.scale_embedding:
            x = x * torch.tensor(self.cfg.d_model, dtype=x.dtype,
                                 device=x.device).sqrt()
        if vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
        return x

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

    def _mlp(self, p, x: torch.Tensor) -> torch.Tensor:
        """The MLP (or MoE) sublayer with its residual."""
        if "moe" in p:
            h = L.apply_norm(p["ln2"], x, self.cfg)
            return x + moe.apply_moe(p["moe"], h, self.cfg,
                                     capacity_factor=self.moe_cf)
        if "mlp" not in p:
            return x
        return x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, self.cfg),
                               self.cfg)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.head(params, L.apply_norm(params["final_norm"], x,
                                              self.cfg))

    def head(self, params, feats: torch.Tensor) -> torch.Tensor:
        """Logits of final-normed features (``forward(...,
        return_features=True)``): the LM head (the embedding's transpose
        when tied), then the final softcap in f32 if the config has one."""
        cfg = self.cfg
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = feats @ head
        if cfg.final_logit_softcap:
            logits = cfg.final_logit_softcap * torch.tanh(
                logits.float() / cfg.final_logit_softcap)
        return logits

    def _cell(self, p, kind: str, h: torch.Tensor, state: Optional[dict],
              mask: Optional[torch.Tensor] = None, step: bool = False):
        """A recurrent layer's cell on the normed input ``h``: the chunkwise
        mLSTM or the sLSTM scan over a sequence (identity steps where
        ``mask`` is False), or one decode step.  Returns (y, new state)."""
        if step:
            fn = ssm.mlstm_step if kind == "mlstm" else ssm.slstm_step
            return fn(p["cell"], h, self.cfg, state)
        fn = ssm.mlstm_forward_chunked if kind == "mlstm" \
            else ssm.slstm_forward
        return fn(p["cell"], h, self.cfg, state, mask=mask)

    def _attention(self, q, k, v, q_pos, kv_pos) -> torch.Tensor:
        return L.flash_attention(q, k, v, q_pos, kv_pos, causal=True,
                                 window=self.cfg.sliding_window,
                                 softcap=self.cfg.attn_logit_softcap)

    def _hymba(self, p, x: torch.Tensor, st: Optional[dict], angles,
               attend, mask: Optional[torch.Tensor] = None,
               step: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
        """One hymba layer: attention and Mamba branches on the same
        ``ln1`` output, fused as ``0.5 * (bn_a(attn) + bn_m(mamba))``,
        then the MLP sublayer.  ``attend(q, k, v, st)`` reads (and
        writes) the layer's rolling K/V in ``st``; the Mamba branch scans
        the sequence from ``st``'s {h, conv} (zero state when ``st`` is
        None; identity steps where ``mask`` is False), or takes one
        decode step.  Returns (x, the layer's new state)."""
        cfg = self.cfg
        h = L.apply_norm(p["ln1"], x, cfg)
        q, k, v = L.qkv_project(p["attn"], h, cfg, angles)
        a = attend(q, k, v, st)
        if step:
            mo, mstate = ssm.mamba_step(p["mamba"], h, cfg, st)
        else:
            mo, mstate = ssm.mamba_forward(p["mamba"], h, cfg, st, mask)
        ao = L.attention_out(p["attn"], a)
        x = x + 0.5 * (L.apply_norm(p["bn_a"], ao, cfg)
                       + L.apply_norm(p["bn_m"], mo, cfg))
        new = None if st is None else dict(st, **mstate)
        return self._mlp(p, x), new

    def _rolling(self, kind: str, p, x: torch.Tensor, st: Optional[dict],
                 angles, attend, mask: Optional[torch.Tensor] = None,
                 step: bool = False) -> Tuple[torch.Tensor, Optional[dict]]:
        """A layer whose K/V is a rolling buffer in ``st``: a hymba layer
        (``_hymba``), or a "local" one: windowed attention through
        ``attend(q, k, v, st)`` (which reads and writes ``st``'s buffer),
        then the MLP sublayer.  Returns (x, the layer's new state)."""
        if kind == "hymba":
            return self._hymba(p, x, st, angles, attend, mask, step)
        h = L.apply_norm(p["ln1"], x, self.cfg)
        q, k, v = L.qkv_project(p["attn"], h, self.cfg, angles)
        x = x + L.attention_out(p["attn"], attend(q, k, v, st))
        return self._mlp(p, x), st

    def _rolling_len(self, cache) -> int:
        """Slots of the rolling K/V buffers in ``cache``."""
        return cache.state[self.rolling[0]]["k"].shape[1]

    # ---------------------------------------------------------------- public

    def forward(self, params, tokens: torch.Tensor,
                positions: torch.Tensor,
                return_features: bool = False,
                vision_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Full-sequence forward: tokens [B,S] (after ``vision_embeds``
        [B,Nv,D] if given) at positions [B,Nv+S] or [3,B,Nv+S] -> logits
        [B,Nv+S,V] (recurrent layers start from zero state), or with
        ``return_features`` the final-normed features [B,Nv+S,D], which
        ``head`` turns into logits (at the columns a caller needs)."""
        cfg = self.cfg
        x = self._embed(params, tokens, vision_embeds)
        angles, positions = self._angles_pos2d(positions)

        def attend(q, k, v, st):
            return self._attention(q, k, v, positions, positions)

        def attend_fill(q, k, v, st):   # pad columns reach the Mamba branch
            return L.fill_pad_queries(attend(q, k, v, st), v, positions)

        for kind, p in zip(self.kinds, params["blocks"]):
            if kind in ROLLING_KINDS:
                x, _ = self._rolling(kind, p, x, None, angles,
                                     attend_fill if kind == "hymba"
                                     else attend)
                continue
            h = L.apply_norm(p["ln1"], x, cfg)
            if kind != "attn":
                x = x + self._cell(p, kind, h, None)[0]
                continue
            q, k, v = L.qkv_project(p["attn"], h, cfg, angles)
            a = L.flash_attention(q, k, v, positions, positions, causal=True,
                                  softcap=cfg.attn_logit_softcap)
            x = x + L.attention_out(p["attn"], a)
            x = self._mlp(p, x)
        if return_features:
            return L.apply_norm(params["final_norm"], x, cfg)
        return self._logits(params, x)

    def prefill(self, params, tokens: torch.Tensor,
                positions: torch.Tensor, cache: cache_lib.Cache,
                vision_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Absorb a [B, S] prompt batch (after ``vision_embeds`` [B,Nv,D]
        if given; absolute ``positions`` [B,Nv+S] or [3,B,Nv+S], -1 at
        left pads) into a contiguous cache at its shared ``length``:
        causal attention over the batch itself, its K/V written to the
        buffers (a "local" or hymba layer's rolling buffer keeps the last
        tokens it holds); recurrent layers (the Mamba branch too) run
        over every column from the cache's state, pads included (no pad
        mask, as in the reference's prefill mode).  Advances
        ``cache.length`` by Nv + S; returns the last column's logits."""
        cfg = self.cfg
        start = cache.length
        x = self._embed(params, tokens, vision_embeds)
        S = x.shape[1]
        angles, positions = self._angles_pos2d(positions)

        def attend(q, k, v, st):
            a = self._attention(q, k, v, positions, positions)
            cache_lib.write_seq(st["k"], st["v"], k, v, start)
            return a

        def attend_fill(q, k, v, st):
            # the Mamba branch of the next layer absorbs the pad columns
            return L.fill_pad_queries(attend(q, k, v, st), v, positions)

        for i, (kind, p) in enumerate(zip(self.kinds, params["blocks"])):
            if kind in ROLLING_KINDS:
                x, cache.state[i] = self._rolling(
                    kind, p, x, cache.state[i], angles,
                    attend_fill if kind == "hymba" else attend)
                continue
            h = L.apply_norm(p["ln1"], x, cfg)
            if kind != "attn":
                y, cache.state[i] = self._cell(p, kind, h, cache.state[i])
                x = x + y
                continue
            q, k, v = L.qkv_project(p["attn"], h, cfg, angles)
            a = L.flash_attention(q, k, v, positions, positions, causal=True,
                                  softcap=cfg.attn_logit_softcap)
            j = self.pool_index[i]
            cache_lib.write_seq(cache.k[j], cache.v[j], k, v, start)
            x = x + L.attention_out(p["attn"], a)
            x = self._mlp(p, x)
        cache.length = start + S
        return self._logits(params, x[:, -1])

    def prefill_chunk(self, params, tokens: torch.Tensor,
                      positions: torch.Tensor, cache,
                      last_col: Optional[torch.Tensor] = None
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
        write nowhere and leave the state alone).  Advances
        ``cache.length`` by C and returns the logits at ``last_col`` [B]
        (default: the last column)."""
        cfg = self.cfg
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
        x = self._embed(params, tokens)

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
            return self._paged_decode(params, token, cache, nb_cap, active)
        cfg = self.cfg
        B = token.shape[0]
        length, first = cache.length, cache.first
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
            kv = cache_lib.shared_kv_positions(length + 1, cache.k.shape[2],
                                               token.device)
            if kv_cap is not None:
                kv[kv_cap:] = -1
            kv_pos = frame(kv)

            def attn(j, q, k, v):
                cache_lib.write_token(cache.k[j], cache.v[j], k, v, length)
                return L.decode_attention(q, cache.k[j], cache.v[j],
                                          pos[:, 0], kv_pos,
                                          softcap=cfg.attn_logit_softcap)

        if self.rolling:
            r_pos = frame(cache_lib.rolling_kv_positions(
                length + 1, self._rolling_len(cache), token.device))

        def attend(q, k, v, st):
            cache_lib.write_token(st["k"], st["v"], k, v, length)
            return L.decode_attention(q, st["k"], st["v"], pos[:, 0], r_pos,
                                      window=cfg.sliding_window,
                                      softcap=cfg.attn_logit_softcap)

        return self._decode_layers(params, token, cache, pos, attend, attn,
                                   inc=1)

    def _decode_layers(self, params, token, cache, pos, attend, attn, inc):
        """The decode layer loop shared by both caches: ``attend`` serves
        the "local" and hymba layers (their rolling buffers), ``attn(j,
        q, k, v)`` the "attn" layers (pool or buffer ``j``); recurrent
        cells step.
        Advances ``cache.length`` by ``inc``."""
        cfg = self.cfg
        x = self._embed(params, token)
        angles = self._angles(pos)
        for i, (kind, p) in enumerate(zip(self.kinds, params["blocks"])):
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
            q, k, v = L.qkv_project(p["attn"], h, cfg, angles)
            a = attn(self.pool_index[i], q, k, v)
            x = x + L.attention_out(p["attn"], a)
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
