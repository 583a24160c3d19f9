"""Transformer layers on torch tensors: norms, RoPE, MLPs, attention.

Counterpart of ``repro/models/layers.py``.  Layers are plain functions
over parameter dicts; matmul weights keep the reference's ``[d_in,
d_out]`` layout (``x @ w``), so parameters convert between the two
packages without transposes.  Attention goes through the position-masked
flash kernel (``kernels.ops.flash_attention``), the single-query read of
the non-paged decode (``decode_attention``) included.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# initializers (seeded torch.Generator; a different stream from jax.random)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms


def init_norm(cfg: ModelConfig, dtype, device) -> dict:
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device),
                "bias": torch.zeros(cfg.d_model, dtype=dtype, device=device)}
    return {}  # nonparametric


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    if cfg.norm_type == "rmsnorm":
        x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
        return x32.to(dt) * params["scale"]
    # layernorm / nonparametric layernorm
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    x32 = (x32 - mu) * torch.rsqrt(var + eps)
    if cfg.norm_type == "layernorm":
        x32 = x32 * params["scale"].float() + params["bias"].float()
    return x32.to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings (half-split convention, as in Llama)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """Angles [B, S, head_dim/2] from positions [B, S], or from M-RoPE's
    (Qwen2-VL) t/h/w positions [3, B, S]: frequency section s of
    ``mrope_sections`` (they sum to head_dim/2) takes its angle from axis
    s.  With equal t/h/w positions that is RoPE of the 2-D positions."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    ang = positions[..., None].float() * inv
    if positions.dim() == 2:
        return ang
    assert sum(mrope_sections) == head_dim // 2, (mrope_sections, head_dim)
    return torch.cat([part[i] for i, part in enumerate(
        ang.split(list(mrope_sections), dim=-1))], dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd] rotated by angles [B, S, hd/2]: the pair
    (x[i], x[i + hd/2]) turns by angle i."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """[n, d] f32 sinusoidal position table: row p, column 2i holds
    sin(p / 10000^(2i/d)) and column 2i + 1 the cos of the same angle."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    out = torch.zeros((n, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


# ---------------------------------------------------------------------------
# MLPs


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "gelu_glu"):
        return {"wi": dense_init(gen, d, f, dtype, device),
                "wg": dense_init(gen, d, f, dtype, device),
                "wo": dense_init(gen, f, d, dtype, device)}
    if cfg.mlp_type in ("relu2", "gelu"):
        return {"wi": dense_init(gen, d, f, dtype, device),
                "wo": dense_init(gen, f, d, dtype, device)}
    return {}


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
              tp=None) -> torch.Tensor:
    """The MLP sublayer.  GELU is the tanh form, as ``jax.nn.gelu``'s
    default in the reference (the exact erf form differs by up to 4.7e-4
    on [-6, 6]).  Under tensor parallelism (``tp``, a
    ``distributed.tensor_parallel.TensorParallel``) ``wi`` / ``wg`` are
    this rank's columns and ``wo`` its rows: the input enters through
    ``tp.mlp_in`` and the output leaves through ``tp.mlp_out``."""
    if tp is not None:
        return tp.mlp_out(apply_mlp(params, tp.mlp_in(x), cfg))
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif cfg.mlp_type == "gelu_glu":
        h = F.gelu(x @ params["wg"], approximate="tanh") \
            * (x @ params["wi"])
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(x @ params["wi"]))
    elif cfg.mlp_type == "gelu":
        h = F.gelu(x @ params["wi"], approximate="tanh")
    else:
        return torch.zeros_like(x)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Position-masked attention [B,Sq,H,hd] x [B,Sk,KV,hd]^2 -> [B,Sq,H,hd]
    (a kv slot with position < 0 is invalid), through the flash kernel."""
    return ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        q_positions.to(torch.int32).contiguous(),
        kv_positions.to(torch.int32).contiguous(),
        causal=causal, window=window, softcap=softcap)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_position: torch.Tensor,
                     kv_positions: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Single-query attention over a contiguous KV buffer: q [B,1,H,hd]
    x [B,S,KV,hd]^2 with q_position [B] and kv_positions [B,S] (-1 =
    empty slot) -> [B,1,H,hd].  A slot counts iff 0 <= kv_pos <= q_pos
    (and q_pos - kv_pos < window); f32 softmax, softcapped scores.

    The same function as the flash kernel at Sq 1, so it goes through it
    (``ops.flash_attention``: the plain version on CPU tensors, the CUDA
    kernel on the card).  The kernel skips a key tile whose slots all
    carry -1 before loading it, so callers pass the row's whole buffer
    (a contiguous view, no copy) with -1 beyond the live slots."""
    return flash_attention(q, k_cache, v_cache, q_position[:, None],
                           kv_positions, causal=True, window=window,
                           softcap=softcap)


FLASH_BLOCK = 512   # the reference's largest query and key block


def fill_pad_queries(attn: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """``attn`` [B,S,H,hd], a segment's self-attention (its queries and
    keys at ``positions`` [B,S]), with the rows of pad queries (position
    < 0) set to the reference's value for a query whose keys are all
    masked.

    The reference's blocked attention (blocks of ``min(512, S)`` queries
    and keys, keys padded to a block multiple with zero V at position
    -1) gives such a query a uniform softmax over every key slot of the
    key blocks it visits: the sum of V over those blocks over their slot
    count, each query head reading its KV head.  Its ``causal_skip``
    leaves out key block j for query block i when the smallest position
    of block j over the batch exceeds the largest of block i (query
    columns padded with position 0).  Up to 512 keys this is the mean of
    V over the keys, the plain version's value too; the kernel leaves
    such rows unspecified.  Only a layer that carries pad columns into
    later state needs them: a hymba layer's Mamba branch, one layer on,
    absorbs every column of an unmasked prefill."""
    B, S, H, hd = attn.shape
    KV = v.shape[2]
    blk = min(FLASH_BLOCK, S)
    n = -(-S // blk)
    q_max = F.pad(positions, (0, n * blk - S), value=0) \
        .reshape(B, n, blk).amax(dim=(0, 2))
    k_min = F.pad(positions, (0, n * blk - S), value=-1) \
        .reshape(B, n, blk).amin(dim=(0, 2))
    visit = (k_min[None, :] <= q_max[:, None]).float()       # [n_q, n_k]
    v_sum = F.pad(v.float(), (0, 0, 0, 0, 0, n * blk - S)) \
        .reshape(B, n, blk, KV, hd).sum(dim=2)               # [B,n,KV,hd]
    fill = torch.einsum("ij,bjkd->bikd", visit, v_sum) \
        / (visit.sum(dim=1).clamp(min=1) * blk)[None, :, None, None]
    fill = fill.repeat_interleave(H // KV, dim=2) \
        .repeat_interleave(blk, dim=1)[:, :S]
    pad = (positions < 0)[:, :, None, None]
    return torch.where(pad, fill.to(attn.dtype), attn)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.num_heads * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.num_heads * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


def headwise_rms(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Qwen3's qk-norm: RMS over each head's last axis in f32, times the
    [hd] scale lifted to f32, cast back to x's dtype (the reference's
    ``_headwise_rms``; unlike ``apply_norm`` the scale multiplies before
    the cast)."""
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale.float()).to(x.dtype)


def kv_project(params: dict, x: torch.Tensor, cfg: ModelConfig,
               angles: Optional[torch.Tensor]):
    """x [B,S,D] -> k/v [B,S,KV,hd] (qk-norm, then rope applied); the
    heads are ``wk``'s columns over hd."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    k = (x @ params["wk"]).reshape(B, S, -1, hd)
    v = (x @ params["wv"]).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        k = headwise_rms(k, params["k_norm"])
    if angles is not None:
        k = apply_rope(k, angles)
    return k, v


def qkv_project(params: dict, x: torch.Tensor, cfg: ModelConfig,
                angles: Optional[torch.Tensor], tp=None,
                store: bool = False):
    """x [B,S,D] -> q [B,S,H,hd], k/v [B,S,KV,hd] (qk-norm, then rope
    applied).  Under tensor parallelism (``tp``) the input enters through
    ``tp.attn_in``, q has this rank's heads and k/v the KV heads they
    read (``store``: every KV head the rank's cache holds)."""
    if tp is not None:
        x = tp.attn_in(x)
        params = tp.attn_params(params, store=store)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = headwise_rms(q, params["q_norm"])
    if angles is not None:
        q = apply_rope(q, angles)
    return (q,) + kv_project(params, x, cfg, angles)


def cross_project(params: dict, x: torch.Tensor,
                  enc_out: Optional[torch.Tensor], cfg: ModelConfig,
                  tp=None):
    """The cross-attention's projections: q [B,Sq,H,hd] of the decoder's
    normed ``x`` and k/v [B,Se,KV,hd] of the encoder output ``enc_out``
    [B,Se,D] (None, None without it: a decode step reads them from its
    cache); no positions.  Under tensor parallelism (``tp``) both inputs
    enter through ``tp.attn_in`` and the heads are this rank's."""
    if tp is not None:
        x = tp.attn_in(x)
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(x.shape[:2] + (-1, hd))
    if enc_out is None:
        return q, None, None
    if tp is not None:
        enc_out = tp.attn_in(enc_out)
    shp = enc_out.shape[:2] + (-1, hd)
    return (q, (enc_out @ params["wk"]).reshape(shp),
            (enc_out @ params["wv"]).reshape(shp))


def attention_out(params: dict, attn: torch.Tensor,
                  tp=None) -> torch.Tensor:
    """Heads [B,S,H,hd] through ``wo``; under tensor parallelism this
    rank's heads through its rows of ``wo``, summed over `model`
    (``tp.attn_out``)."""
    B, S = attn.shape[:2]
    out = attn.reshape(B, S, -1) @ params["wo"]
    return out if tp is None else tp.attn_out(out)
