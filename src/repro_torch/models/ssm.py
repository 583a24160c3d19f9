"""Recurrent blocks on torch tensors: the Mamba-style selective SSM
(Hymba's parallel heads) and xLSTM's mLSTM and sLSTM cells.

Counterpart of ``repro/models/ssm.py``.  Each block exposes

  * ``<kind>_forward(params, x, cfg, state=None, mask=None)``: the scan
    over a [B,S,D] sequence used by the full forward and by chunked
    prefill; returns (y, final_state);
  * ``<kind>_step(params, x_t, cfg, state)``: one decode token [B,1,D].

States are fixed-size.  Mamba carries ``h`` [B,inner,N] (f32) and the
causal conv's history ``conv`` [B,W-1,inner] (the model's dtype).  mLSTM
carries ``C`` [B,H,hd,hd], ``n`` [B,H,hd] and ``m`` [B,H]; sLSTM carries
``c``, ``n``, ``h`` and ``m``, each [B,d]; all f32, the stabiliser ``m``
starting at 0.  ``mask`` ([B,S] bool, True = real token) makes a padded
position an exact identity on the state: Mamba zeroes its conv input and
passes ``h`` through (``dA`` = 1, ``dBx`` = 0), mLSTM gives it the gates
log_i = -1e30, log_f = 0 (no insert, no decay), sLSTM carries the old
state through, so a left- or right-padded chunk ends in the same state
as the unpadded one.

Parameters keep the reference's ``[d_in, d_out]`` layout and are drawn
from a seeded ``torch.Generator`` (a different stream from jax.random).

Under tensor parallelism (``tp``, a ``distributed.tensor_parallel.
TensorParallel``) a block runs on this rank's part of it, from and to a
state of that part (``TensorParallel.state_local`` / ``state_whole``):
Mamba on its channels (the input copied to `model`, ``x_proj``'s
row-parallel output summed over `model` before ``dt_proj``; its output,
``out_proj``'s row-parallel partial sum, is the caller's to reduce:
hymba reduces it before the branch norm), the mLSTM on its heads (the whole gate projections read at
them, ``out`` reduced), the sLSTM on its units (``h`` gathered before a
whole ``out``, or ``out``'s rows reduced).  A block the rank holds whole
runs as without ``tp``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import loops
from repro_torch.models.layers import dense_init

# ---------------------------------------------------------------------------
# Mamba-style selective SSM (the hymba block's second branch)

MAMBA_TIME_BLOCK = 128     # steps whose dA / dBx are built at once


def mamba_inner_dim(cfg: ModelConfig) -> int:
    return (cfg.ssm.expand if cfg.ssm else 2) * cfg.d_model


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    inner = mamba_inner_dim(cfg)
    state = cfg.ssm.state_size
    width = cfg.ssm.conv_width
    dt_rank = max(1, math.ceil(d / 16))
    in_proj = dense_init(gen, d, 2 * inner, dtype, device)       # x and z
    conv_w = torch.randn((width, inner), generator=gen, device=device,
                         dtype=torch.float32) / math.sqrt(width)
    x_proj = dense_init(gen, inner, dt_rank + 2 * state, dtype, device)
    dt_proj = dense_init(gen, dt_rank, inner, dtype, device)
    out_proj = dense_init(gen, inner, d, dtype, device)
    a = torch.arange(1, state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(inner, dtype=dtype, device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.full((inner,), -4.6, dtype=dtype,
                              device=device),           # softplus ~ 0.01
        "A_log": torch.log(a).repeat(inner, 1),         # f32 [inner, N]
        "D": torch.ones(inner, dtype=torch.float32, device=device),
        "out_proj": out_proj,
    }


def mamba_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    inner = mamba_inner_dim(cfg)
    return {
        "h": torch.zeros((batch, inner, cfg.ssm.state_size),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, inner),
                            dtype=dtype, device=device),
    }


def _mamba_conv_full(params, xi: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over [B,S,inner] (zero history), in f32 tap
    by tap as the reference sums it, cast back to xi's dtype."""
    w = params["conv_w"].float()                       # [W, inner]
    W, S = w.shape[0], xi.shape[1]
    xpad = F.pad(xi.float(), (0, 0, W - 1, 0))
    out = torch.zeros_like(xpad[:, :S])
    for i in range(W):
        out = out + xpad[:, i:i + S] * w[i]
    return (out + params["conv_b"].float()).to(xi.dtype)


def _split_mamba(tp) -> bool:
    return tp is not None and tp.mamba


def _mamba_ssm_params(params, cfg: ModelConfig, xc: torch.Tensor, tp=None):
    """xc [..., inner] -> (dt [..., inner], B [..., N], C [..., N]), f32.
    On a rank's channels ``x_proj``'s output is a partial sum: summed
    over `model` (and its gradient summed back) before ``dt_proj``."""
    state = cfg.ssm.state_size
    proj = xc @ params["x_proj"]
    if _split_mamba(tp):
        proj = tp.copy_to_model(tp.reduce_from_model(proj))
    dt_rank = proj.shape[-1] - 2 * state
    dt, Bm, Cm = torch.split(proj, [dt_rank, state, state], dim=-1)
    dt = F.softplus(dt @ params["dt_proj"] + params["dt_bias"])
    return dt.float(), Bm.float(), Cm.float()


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict] = None,
                  mask: Optional[torch.Tensor] = None, tp=None
                  ) -> Tuple[torch.Tensor, dict]:
    """x [B,S,D] -> (y [B,S,D], state {h, conv}).

    The scan keeps the reference's per-step f32 order, ``h * dA + dBx``
    then the ``C`` contraction, but builds ``dA`` and ``dBx`` for
    ``MAMBA_TIME_BLOCK`` steps at once and contracts ``C`` once per
    block: only the two-op recurrence runs per step.  A masked step has
    ``dA`` = 1 and ``dBx`` = 0, so ``h`` passes through exactly.  The
    conv history returned ends at the last valid column (a right-padded
    suffix chunk keeps its real tail)."""
    B, S, _ = x.shape
    if _split_mamba(tp):
        x = tp.copy_to_model(x)
    xz = x @ params["in_proj"]
    xi, z = xz.chunk(2, dim=-1)
    if mask is not None:
        xi = torch.where(mask[..., None], xi, torch.zeros_like(xi))
    Wm1 = cfg.ssm.conv_width - 1
    if state is not None:
        prev = state["conv"].to(xi.dtype)
        xc = F.silu(_mamba_conv_full(params, torch.cat([prev, xi], 1)
                                     )[:, prev.shape[1]:])
        h = state["h"]
    else:
        prev = torch.zeros((B, Wm1, xi.shape[-1]), dtype=xi.dtype,
                           device=xi.device)
        xc = F.silu(_mamba_conv_full(params, xi))
        h = torch.zeros((B, xi.shape[-1], cfg.ssm.state_size),
                        dtype=torch.float32, device=x.device)
    dt, Bm, Cm = _mamba_ssm_params(params, cfg, xc, tp)
    A = -torch.exp(params["A_log"])                    # [inner, N]
    x32 = xc.float()
    ys = []
    nb = -(-S // MAMBA_TIME_BLOCK)
    for b in loops.trips(nb, "mamba blocks"):
        sl = slice(b * MAMBA_TIME_BLOCK, min(S, (b + 1) * MAMBA_TIME_BLOCK))
        # time-major [T, B, inner, N]
        dt_b = dt[:, sl].transpose(0, 1)[..., None]
        dA = torch.exp(dt_b * A)
        dBx = dt_b * Bm[:, sl].transpose(0, 1)[:, :, None, :] \
            * x32[:, sl].transpose(0, 1)[..., None]
        if mask is not None:
            m = mask[:, sl].transpose(0, 1)[:, :, None, None]
            dA = torch.where(m, dA, torch.ones_like(dA))
            dBx = torch.where(m, dBx, torch.zeros_like(dBx))
        hs = []
        T = dA.shape[0]
        # out of place: autograd follows it
        for t in loops.trips(T, "mamba steps"):
            h = h * dA[t] + dBx[t]
            hs.append(h)
        ys.append(torch.einsum("tbis,bts->bti",
                               torch.stack(loops.full(hs, T)), Cm[:, sl]))
    y = torch.cat(loops.full(ys, nb), dim=1) + params["D"] * x32
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    # conv history for decode continuation: always [B, W-1, inner]
    ext = torch.cat([prev, xi], dim=1)                 # [B, Wm1+S, inner]
    if mask is None:
        # a copy: a view would keep the whole [B, Wm1+S, inner] alive
        conv = ext[:, ext.shape[1] - Wm1:].clone()
    else:
        # the tail must end at the last *valid* column: right-pad
        # columns are masked zeros, and slicing past them would wipe the
        # real history (prefix-fork suffix chunks are right-padded)
        cols = torch.arange(1, S + 1, device=x.device)[None]
        end = torch.where(mask, cols, torch.zeros_like(cols)).amax(dim=1)
        idx = end[:, None] + torch.arange(Wm1, device=x.device)[None]
        conv = torch.gather(ext, 1, idx[..., None].expand(-1, -1,
                                                           ext.shape[-1]))
    return out, {"h": h, "conv": conv}


def mamba_step(params, x_t: torch.Tensor, cfg: ModelConfig,
               state: dict, tp=None) -> Tuple[torch.Tensor, dict]:
    """One decode token x_t [B,1,D]; state {h [B,inner,N], conv
    [B,W-1,inner]}.  As in the reference, the conv output stays f32
    through the SiLU and the state update (cast only for ``x_proj``)."""
    if _split_mamba(tp):
        x_t = tp.copy_to_model(x_t)
    xz = x_t @ params["in_proj"]
    xi, z = xz.chunk(2, dim=-1)                         # [B,1,inner]
    hist = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)
    w = params["conv_w"].float()
    xc = F.silu((hist.float() * w[None]).sum(1)
                + params["conv_b"].float())            # [B,inner] f32
    dt, Bm, Cm = _mamba_ssm_params(params, cfg, xc.to(x_t.dtype), tp)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A)
    h = state["h"] * dA + dt[..., None] * Bm[:, None, :] * xc[..., None]
    y = torch.einsum("bis,bs->bi", h, Cm) + params["D"] * xc
    out = (y[:, None].to(x_t.dtype) * F.silu(z)) @ params["out_proj"]
    return out, {"h": h, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory)


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    inner = H * hd
    return {
        "wq": dense_init(gen, d, inner, dtype, device),
        "wk": dense_init(gen, d, inner, dtype, device),
        "wv": dense_init(gen, d, inner, dtype, device),
        "wi": dense_init(gen, d, H, dtype, device),
        "wf": dense_init(gen, d, H, dtype, device),
        "wog": dense_init(gen, d, inner, dtype, device),    # output gate
        "out": dense_init(gen, inner, d, dtype, device),
    }


def mlstm_init_state(cfg: ModelConfig, batch: int, device,
                     heads: Optional[int] = None) -> dict:
    H = cfg.num_heads if heads is None else heads
    hd = cfg.resolved_head_dim
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"C": z(batch, H, hd, hd), "n": z(batch, H, hd), "m": z(batch, H)}


def _split_mlstm(tp) -> bool:
    return tp is not None and tp.mlstm


def _mlstm_qkvif(params, x: torch.Tensor, cfg: ModelConfig):
    """q, k, v [..., H, hd] (H from ``wq``'s columns: a rank's heads under
    tensor parallelism) and the log gates [..., H_all] (f32)."""
    hd = cfg.resolved_head_dim
    shp = x.shape[:-1] + (-1, hd)
    q = (x @ params["wq"]).reshape(shp).float() / math.sqrt(hd)
    k = (x @ params["wk"]).reshape(shp).float() / math.sqrt(hd)
    v = (x @ params["wv"]).reshape(shp).float()
    log_i = (x @ params["wi"]).float()                          # [...,H]
    log_f = -F.softplus(-(x @ params["wf"]).float())            # log sigmoid
    return q, k, v, log_i, log_f


def _mlstm_cell(C, n, m, q_t, k_t, v_t, li_t, lf_t):
    """One mLSTM step on [B,H,...] tensors (f32)."""
    m_new = torch.maximum(lf_t + m, li_t)                       # [B,H]
    i_p = torch.exp(li_t - m_new)
    f_p = torch.exp(lf_t + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        k_t[..., :, None] * v_t[..., None, :])                  # [B,H,k,v]
    n = f_p[..., None] * n + i_p[..., None] * k_t
    num = torch.einsum("bhkv,bhk->bhv", C, q_t)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q_t).abs(),
                        torch.exp(-m_new))
    return C, n, m_new, num / den[..., None]


def _mask_gates(li, lf, mask):
    """Identity gates at masked positions: log_i=-1e30 (no insert),
    log_f=0 (no decay), so the carried state passes through untouched."""
    li = torch.where(mask, li, torch.full_like(li, -1e30))
    lf = torch.where(mask, lf, torch.zeros_like(lf))
    return li, lf


def _mlstm_out(params, h: torch.Tensor, x: torch.Tensor,
               tp=None) -> torch.Tensor:
    """Output gate and projection; ``h`` [B,S,H*hd] is cast to the
    activation dtype before the gate, as in the reference (on a rank's
    heads ``x`` is the copied input and the output a partial sum,
    reduced over `model`)."""
    y = h.to(x.dtype) * torch.sigmoid(x @ params["wog"])
    y = y @ params["out"]
    return tp.reduce_from_model(y) if _split_mlstm(tp) else y


def mlstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict] = None,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """The step-by-step scan: x [B,S,D] -> (y [B,S,D], state)."""
    B, S, _ = x.shape
    st = state or mlstm_init_state(cfg, B, x.device)
    q, k, v, li, lf = _mlstm_qkvif(params, x, cfg)
    if mask is not None:
        li, lf = _mask_gates(li, lf, mask[..., None])
    C, n, m = st["C"], st["n"], st["m"]
    hs = []
    for t in range(S):
        C, n, m, h = _mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t],
                                 li[:, t], lf[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, -1)
    return _mlstm_out(params, h, x), {"C": C, "n": n, "m": m}


def mlstm_forward_chunked(params, x: torch.Tensor, cfg: ModelConfig,
                          state: Optional[dict] = None, chunk: int = 128,
                          mask: Optional[torch.Tensor] = None, tp=None
                          ) -> Tuple[torch.Tensor, dict]:
    """Chunkwise-parallel mLSTM: within-chunk attention-like matmuls plus
    the cross-chunk recurrent state; the same stabilised exponential
    gating as ``mlstm_forward``.  The chunk is ``min(chunk, S)``: a short
    sequence runs as one chunk of its own length, a longer one is padded
    to a multiple of ``chunk`` with identity gates (the reference always
    pads to ``chunk``; padded steps add exact zeros either way)."""
    B, S, _ = x.shape
    if _split_mlstm(tp):
        x = tp.copy_to_model(x)
    L = min(chunk, S)
    pad = (-S) % L
    q, k, v, li, lf = _mlstm_qkvif(params, x, cfg)
    H, hd = q.shape[-2:]
    st = state or mlstm_init_state(cfg, B, x.device, heads=H)
    if _split_mlstm(tp):
        li, lf = (tp.head_cols(a) for a in (li, lf))
    if mask is not None:
        li, lf = _mask_gates(li, lf, mask[..., None])
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad), value=0.0)
    nc = (S + pad) // L
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    C, n, m = st["C"], st["n"], st["m"]
    hs = []
    for ci in loops.trips(nc, "mlstm chunks"):
        sl = slice(ci * L, (ci + 1) * L)
        qc, kc, vc = q[:, sl], k[:, sl], v[:, sl]                # [B,L,H,hd]
        lic, lfc = li[:, sl], lf[:, sl]                          # [B,L,H]
        Fc = torch.cumsum(lfc, dim=1)                            # inclusive
        log_inter = Fc + m[:, None, :]                           # [B,L,H]
        log_intra = Fc[:, :, None, :] - Fc[:, None, :, :] \
            + lic[:, None, :, :]                                 # [B,t,s,H]
        log_intra = log_intra.masked_fill(~tri[None, :, :, None],
                                          float("-inf"))
        m_t = torch.maximum(log_inter, log_intra.amax(dim=2))    # [B,L,H]
        w_inter = torch.exp(log_inter - m_t)
        w_intra = torch.exp(log_intra - m_t[:, :, None, :])
        num_inter = torch.einsum("bthk,bhkv->bthv", qc, C) \
            * w_inter[..., None]
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * w_intra
        num = num_inter + torch.einsum("btsh,bshv->bthv", scores, vc)
        den_inter = torch.einsum("bthk,bhk->bth", qc, n) * w_inter
        den_intra = torch.einsum("bthd,bshd,btsh->bth", qc, kc, w_intra)
        den = torch.maximum((den_inter + den_intra).abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])                          # [B,L,H,hd]
        # carry to the end of the chunk
        g = Fc[:, -1:] - Fc + lic                                # [B,L,H]
        m_end = torch.maximum(Fc[:, -1] + m, g.amax(dim=1))
        wC_old = torch.exp(Fc[:, -1] + m - m_end)                # [B,H]
        w_new = torch.exp(g - m_end[:, None, :])                 # [B,L,H]
        C = wC_old[..., None, None] * C + torch.einsum(
            "bshk,bshv,bsh->bhkv", kc, vc, w_new)
        n = wC_old[..., None] * n + torch.einsum("bshk,bsh->bhk", kc, w_new)
        m = m_end
    h = torch.cat(loops.full(hs, nc), dim=1).reshape(
        B, S + pad, H * hd)[:, :S]
    return _mlstm_out(params, h, x, tp), {"C": C, "n": n, "m": m}


def mlstm_step(params, x_t: torch.Tensor, cfg: ModelConfig,
               state: dict, tp=None) -> Tuple[torch.Tensor, dict]:
    """One decode token x_t [B,1,D]."""
    if _split_mlstm(tp):
        x_t = tp.copy_to_model(x_t)
    q, k, v, li, lf = _mlstm_qkvif(params, x_t, cfg)
    if _split_mlstm(tp):
        li, lf = (tp.head_cols(a) for a in (li, lf))
    C, n, m, h = _mlstm_cell(state["C"], state["n"], state["m"],
                             q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0])
    B = x_t.shape[0]
    return _mlstm_out(params, h.reshape(B, 1, -1), x_t, tp), \
        {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory)


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    r = torch.randn((4 * d,), generator=gen, device=device,
                    dtype=torch.float32) * 0.1
    return {
        "w": dense_init(gen, d, 4 * d, dtype, device),    # i,f,z,o pre-acts
        # diagonal recurrent weights (block-diagonal in the paper)
        "r": r.to(dtype),
        "out": dense_init(gen, d, d, dtype, device),
    }


def slstm_init_state(cfg: ModelConfig, batch: int, device,
                     units: Optional[int] = None) -> dict:
    d = cfg.d_model if units is None else units
    z = lambda: torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(), "m": z()}


def _slstm_cell(params, pre: torch.Tensor, state: dict) -> dict:
    """pre: [B,4d] input pre-activations (x@W); adds the diagonal
    recurrence ``r`` on the previous ``h``."""
    d = pre.shape[-1] // 4
    hrec = state["h"].repeat(1, 4) * params["r"].float()[None]
    pre = pre.float() + hrec
    li = pre[:, :d]                                    # log-space input gate
    lf = -F.softplus(-pre[:, d:2 * d])                 # log sigmoid forget
    z = torch.tanh(pre[:, 2 * d:3 * d])
    o = torch.sigmoid(pre[:, 3 * d:])
    m_new = torch.maximum(lf + state["m"], li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + state["m"] - m_new)
    c = f_p * state["c"] + i_p * z
    n = f_p * state["n"] + i_p
    h = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _split_slstm(tp) -> bool:
    return tp is not None and tp.slstm


def _slstm_out(params, h: torch.Tensor, tp) -> torch.Tensor:
    """``h`` [..., d] (a rank's units under ``tp``) through ``out``:
    gathered over `model` first when ``out`` is whole, else this rank's
    rows of it, reduced."""
    if _split_slstm(tp) and not tp.slstm_out:
        h = tp.gather_model(h, -1)
    y = h @ params["out"]
    return tp.reduce_from_model(y) if _split_slstm(tp) and tp.slstm_out \
        else y


def slstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[dict] = None,
                  mask: Optional[torch.Tensor] = None, tp=None
                  ) -> Tuple[torch.Tensor, dict]:
    """The token-by-token scan: x [B,S,D] -> (y [B,S,D], state).  Masked
    steps carry the state through unchanged."""
    B, S, _ = x.shape
    if _split_slstm(tp):
        x = tp.copy_to_model(x)
    pre = x @ params["w"]                              # [B,S,4d]
    st = state or slstm_init_state(cfg, B, x.device,
                                   units=pre.shape[-1] // 4)
    hs = []
    for t in loops.trips(S, "slstm tokens"):
        new = _slstm_cell(params, pre[:, t], st)
        if mask is not None:
            m_t = mask[:, t, None]
            new = {k: torch.where(m_t, a, st[k]) for k, a in new.items()}
        st = new
        hs.append(st["h"])
    h = torch.stack(loops.full(hs, S), dim=1).to(x.dtype)
    return _slstm_out(params, h, tp), st


def slstm_step(params, x_t: torch.Tensor, cfg: ModelConfig,
               state: dict, tp=None) -> Tuple[torch.Tensor, dict]:
    """One decode token x_t [B,1,D]."""
    if _split_slstm(tp):
        x_t = tp.copy_to_model(x_t)
    new = _slstm_cell(params, (x_t @ params["w"])[:, 0], state)
    return _slstm_out(params, new["h"][:, None].to(x_t.dtype), tp), new
