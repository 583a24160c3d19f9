"""Public kernel wrappers: dispatch by the tensor's device.

A CPU tensor runs the plain PyTorch version in ``ref``.  A CUDA tensor
launches the hand-written CUDA kernel (``csrc/``, built on first use by
``build``) after the wrapper checks device, dtype, shape and contiguity,
or raises: there is no fallback from a CUDA tensor to the plain version.
Each wrapper adds one to ``launches[<name>]`` where it launches its
kernel, and nowhere else, so a run can show which kernels it went
through; each route of the two top-k functions counts under its entry
point's name, the name ``topk_route`` and ``ivf_route`` return.

``flash_attention`` is differentiable: on CUDA tensors that need a
gradient (and with grad mode on) it runs the forward kernel through
``FlashAttention``, an autograd function whose backward is
``csrc/flash_attention_bwd.cu`` (counted as ``flash_attention_bwd``);
otherwise it launches exactly what serving launches.  CPU tensors
differentiate the plain version by autograd.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

launches: Dict[str, int] = {"paged_decode_attention": 0,
                            "flash_attention": 0,
                            "flash_attention_bwd": 0,
                            "retrieval_topk": 0,
                            "ivf_retrieval_topk": 0,
                            "retrieval_topk_list": 0,
                            "retrieval_topk_select": 0,
                            "ivf_retrieval_topk_select": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    ("paged_attention", "paged_decode_attention"):
        [_VP] * 9 + [_I] * 8 + [_F, _I, _VP],
    ("flash_attention", "flash_attention"):
        [_VP] * 7 + [_I] * 8 + [_F, _I, _VP],
    ("flash_attention_bwd", "flash_attention_bwd"):
        [_VP] * 12 + [_I] * 8 + [_F, _I, _VP],
    ("topk", "retrieval_topk"): [_VP] * 6 + [_I] * 6 + [_VP],
    ("ivf_topk", "ivf_retrieval_topk"): [_VP] * 8 + [_I] * 9 + [_VP],
    ("topk_list", "retrieval_topk_list"): [_VP] * 8 + [_I] * 8 + [_VP],
    ("topk_select", "retrieval_topk_select"): [_VP] * 7 + [_I] * 9 + [_VP],
    ("ivf_select", "ivf_retrieval_topk_select"): [_VP] * 9 + [_I] * 12 + [_VP],
}
_FNS: Dict[str, object] = {}   # entry point name -> ctypes function


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _fn(lib: str, name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load(lib), name)
        fn.argtypes = _SIGNATURES[(lib, name)]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU, False when every one is on
    one CUDA device; raises on a mix or on any other device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        _require(t.is_contiguous(), f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           first: torch.Tensor, last: torch.Tensor,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """One query per row against a block pool through a block table.
    q [B,H,hd] x pools [P,bs,KV,hd] x tables [B,nb] (-1 unallocated),
    first/last [B] -> [B,H,hd] in q.dtype."""
    if _on_cpu(q, k_pool, v_pool, block_tables, first, last):
        return ref.paged_attention_ref(q, k_pool, v_pool, block_tables,
                                       first, last, softcap=softcap)
    B, H, hd = q.shape
    P, bs, KV, hd2 = k_pool.shape
    nb = block_tables.shape[1]
    _require(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} not f32/bf16")
    _require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
             "q, k_pool and v_pool must share one dtype")
    _require(v_pool.shape == k_pool.shape and hd2 == hd,
             f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
             f"do not match q {tuple(q.shape)}")
    _require(KV >= 1 and H % KV == 0, f"H={H} not a multiple of KV={KV}")
    _require(8 <= hd <= 256, f"head dim {hd} outside [8, 256]")
    _require(block_tables.shape == (B, nb)
             and first.shape == (B,) and last.shape == (B,),
             "block_tables [B,nb], first [B], last [B] expected")
    for name, t in (("block_tables", block_tables), ("first", first),
                    ("last", last)):
        _require(t.dtype == torch.int32, f"{name} must be int32")
    _contiguous(q=q, k_pool=k_pool, v_pool=v_pool, block_tables=block_tables,
                first=first, last=last)
    if B == 0 or nb == 0:
        return torch.zeros_like(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return _paged_launch(q, k_pool, v_pool, block_tables, first, last,
                         softcap, paged_decode_splits(B, KV, nb, sms))


PAGED_WARPS = 4   # warps of a paged-decode thread block (csrc)


def paged_decode_splits(B: int, KV: int, nb: int, sms: int) -> int:
    """How many thread blocks share one (row, KV head)'s table columns.

    1 when the B*KV blocks already fill the ``sms`` SMs; else enough
    splits for about two blocks per SM (a decode block is latency-bound,
    and a second one per SM keeps more loads in flight), but never so
    many that a split holds fewer columns than its block has warps (each
    warp takes whole columns), and so never more than the ``nb`` columns
    the kernel walks (decode passes the table cut to its live width)."""
    rows = max(1, B * KV)
    if rows >= sms:
        return 1
    return max(1, min(-(-2 * sms // rows), nb // PAGED_WARPS))


def _paged_launch(q, k_pool, v_pool, block_tables, first, last, softcap,
                  n_splits: int) -> torch.Tensor:
    """Launch the paged decode kernel (and its combine pass when
    ``n_splits`` > 1) on checked CUDA inputs."""
    B, H, hd = q.shape
    P, bs, KV, _ = k_pool.shape
    nb = block_tables.shape[1]
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if n_splits > 1:
        part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((B, H, n_splits, hd), dtype=torch.float32,
                               device=q.device)
    rc = _fn("paged_attention", "paged_decode_attention")(
        _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(block_tables),
        _ptr(first), _ptr(last), _ptr(out),
        None if part_ml is None else _ptr(part_ml),
        None if part_acc is None else _ptr(part_acc), B, H, KV, hd, bs, nb,
        P, n_splits, float(softcap or 0.0), _DTYPE_CODE[q.dtype], _stream(q))
    _check_rc(rc, "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Position-masked attention, [B,Sq,H,hd] x [B,Sk,KV,hd]^2 with
    q_pos [B,Sq], kv_pos [B,Sk] (< 0 = invalid slot) -> [B,Sq,H,hd].
    Differentiable in q, k and v (see the module docstring)."""
    if _on_cpu(q, k, v, q_pos, kv_pos):
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                       window=window, softcap=softcap)
    _check_flash(q, k, v, q_pos, kv_pos)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window,
                                    softcap)
    return _flash_launch(q, k, v, q_pos, kv_pos, causal, window, softcap)


def _check_flash(q, k, v, q_pos, kv_pos) -> None:
    """The flash kernels' checks of CUDA inputs."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    _require(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} not f32/bf16")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             "q, k and v must share one dtype")
    _require(k.shape == (B, Sk, KV, hd) and v.shape == k.shape,
             f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match "
             f"q {tuple(q.shape)}")
    _require(KV >= 1 and H % KV == 0, f"H={H} not a multiple of KV={KV}")
    _require(8 <= hd <= 256, f"head dim {hd} outside [8, 256]")
    _require(q_pos.shape == (B, Sq) and kv_pos.shape == (B, Sk),
             "q_pos [B,Sq] and kv_pos [B,Sk] expected")
    _require(q_pos.dtype == torch.int32 and kv_pos.dtype == torch.int32,
             "positions must be int32")
    _contiguous(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)


def _flash_launch(q, k, v, q_pos, kv_pos, causal, window, softcap,
                  lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the forward kernel on checked CUDA inputs; with ``lse``
    ([B,H,Sq] f32) it also writes each row's log-sum-exp there."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _fn("flash_attention", "flash_attention")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(q_pos), _ptr(kv_pos), _ptr(out),
        None if lse is None else _ptr(lse),
        B, Sq, Sk, H, KV, hd, int(bool(causal)), int(window or 0),
        float(softcap or 0.0), _DTYPE_CODE[q.dtype], _stream(q))
    _check_rc(rc, "flash_attention")
    launches["flash_attention"] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """``csrc/flash_attention.cu`` forward (writing the row log-sum-exp)
    and ``csrc/flash_attention_bwd.cu`` backward, on checked CUDA
    inputs; the positions and options take no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, softcap):
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out = _flash_launch(q, k, v, q_pos, kv_pos, causal, window, softcap,
                            lse=lse)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_pos, kv_pos, out,
                                         dout.contiguous(), lse, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, q_pos, kv_pos)`` for
    the output gradient ``dout`` [B,Sq,H,hd], given the forward's
    ``out`` and row log-sum-exp ``lse`` [B,H,Sq] f32.  CPU tensors take
    the plain version (autograd of ``ref.flash_attention_ref``, which
    needs neither ``out`` nor ``lse``); CUDA tensors launch
    ``csrc/flash_attention_bwd.cu``: f32 its FFMA kernels
    (``dkdv_kernel``, ``dq_kernel``), bf16 its tensor-core kernel
    (``bwd_mma_kernel``), each after the row sums of ``dout * out``; a
    refused launch raises.  Gradients of a query row with no valid key
    are unspecified."""
    if _on_cpu(q, k, v, q_pos, kv_pos, out, dout, lse):
        return ref.flash_attention_bwd_ref(q, k, v, q_pos, kv_pos, dout,
                                           causal=causal, window=window,
                                           softcap=softcap)
    _check_flash(q, k, v, q_pos, kv_pos)
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    _require(out.shape == q.shape and dout.shape == q.shape
             and out.dtype == q.dtype and dout.dtype == q.dtype,
             "out and dout must match q's shape and dtype")
    _require(lse.shape == (B, H, Sq) and lse.dtype == torch.float32,
             "lse [B,H,Sq] float32 expected")
    _contiguous(out=out, dout=dout, lse=lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    rc = _fn("flash_attention_bwd", "flash_attention_bwd")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(q_pos), _ptr(kv_pos), _ptr(out),
        _ptr(dout), _ptr(lse), _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv),
        B, Sq, Sk, H, KV, hd, int(bool(causal)), int(window or 0),
        float(softcap or 0.0), _DTYPE_CODE[q.dtype], _stream(q))
    _check_rc(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_aligned(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """The TPU kernel's interface: [B,H,Sq,hd] x [B,KV,Sk,hd]^2 with
    queries right-aligned to the keys (q_pos = arange(Sq) + Sk - Sq)."""
    B, _, Sq, _ = q.shape
    Sk = k.shape[2]
    dev = q.device
    q_pos = (torch.arange(Sq, dtype=torch.int32, device=dev)
             + (Sk - Sq)).expand(B, Sq).contiguous()
    kv_pos = torch.arange(Sk, dtype=torch.int32, device=dev
                          ).expand(B, Sk).contiguous()
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), q_pos, kv_pos,
                          causal=causal, window=window, softcap=softcap)
    return out.transpose(1, 2)


def retrieval_topk(queries: torch.Tensor, docs: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search, [Nq,D] x [Nd,D] (f32) ->
    (scores [Nq,k] f32, ids [Nq,k] int32) for any k >= 1; ties go to the
    lower id, and slots beyond Nd are (-1e30, -1).  On CUDA the shape
    picks the kernel (``topk_route``): ``csrc/topk.cu`` up to
    ``TOPK_NARROW_MAX``; above, ``csrc/topk_list.cu`` for a small corpus
    or a single query at small k, ``csrc/topk_select.cu`` the rest."""
    _require(k >= 1, f"k={k} must be at least 1")
    if _on_cpu(queries, docs):
        return ref.topk_ref(queries, docs, k)
    _check_exact(queries, docs)
    Nq, Nd = queries.shape[0], docs.shape[0]
    if Nq == 0:
        return _fill(0, k, queries.device)
    route = topk_route(Nq, Nd, k)
    sms = torch.cuda.get_device_properties(queries.device
                                           ).multi_processor_count
    if route == "retrieval_topk_select":
        chunk_q, _, n_splits, per, n_sel, sel_per = \
            retrieval_topk_select_plan(Nq, Nd, k, sms)
        return _topk_select_launch(queries, docs, k, chunk_q, n_splits, per,
                                   n_sel, sel_per)
    if route == "retrieval_topk_list":
        return _topk_list_launch(queries, docs, k,
                                 *retrieval_topk_wide_plan(Nq, Nd, k, sms))
    _, n_splits, per = retrieval_topk_plan(Nq, Nd, sms)
    return _topk_launch(queries, docs, k, n_splits, per)


def _check_exact(queries: torch.Tensor, docs: torch.Tensor) -> None:
    """The exact top-k kernels' checks of CUDA inputs."""
    Nq, D = queries.shape
    Nd = docs.shape[0]
    _require(queries.dtype == torch.float32 and docs.dtype == torch.float32,
             "queries and docs must be float32")
    _require(docs.shape == (Nd, D), f"docs {tuple(docs.shape)} vs D={D}")
    _require(D >= 1, "embedding width D must be at least 1")
    _require(Nd < INT32_ROOM, "doc count must fit int32")
    _contiguous(queries=queries, docs=docs)


def _fill(Nq: int, k: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every slot the (-1e30, -1) fill."""
    return (torch.full((Nq, k), ref.NEG_INF, dtype=torch.float32, device=dev),
            torch.full((Nq, k), -1, dtype=torch.int32, device=dev))


def _topk_launch(queries, docs, k: int, n_splits: int, per: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the top-k kernel (and its merge pass when ``n_splits`` > 1)
    on checked CUDA inputs, docs cut into splits of ``per`` rows."""
    Nq, D = queries.shape
    dev = queries.device
    out_s = torch.empty((Nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Nq, k), dtype=torch.int32, device=dev)
    part_s = part_i = None
    if n_splits > 1:
        part_s = torch.empty((Nq, n_splits, k), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((Nq, n_splits, k), dtype=torch.int32, device=dev)
    rc = _fn("topk", "retrieval_topk")(
        _ptr(queries), _ptr(docs),
        None if part_s is None else _ptr(part_s),
        None if part_i is None else _ptr(part_i), _ptr(out_s), _ptr(out_i),
        Nq, docs.shape[0], D, k, per, n_splits, _stream(queries))
    _check_rc(rc, "retrieval_topk")
    launches["retrieval_topk"] += 1
    return out_s, out_i


TOPK_GROUP = 32   # queries per top-k thread block (csrc/topk.cu kG)
TOPK_TILE = 128   # docs per top-k tile (csrc/topk.cu kTD)


def retrieval_topk_plan(Nq: int, Nd: int, sms: int) -> Tuple[int, int, int]:
    """How the top-k kernel cuts its work: (query groups, doc splits,
    docs per split), one thread block per (group, split).

    A block scores its split's docs for a group of ``TOPK_GROUP``
    queries, so each doc row is read once per group.  The docs are split
    for about two blocks per SM over the ``sms`` SMs, but a split keeps
    at least four tiles of ``TOPK_TILE`` docs: a corpus of up to four
    tiles is one split, and one block then writes the result in a single
    launch.  A split is a whole number of tiles, and the last one may be
    short; splits cover [0, Nd) without overlap."""
    groups = max(1, -(-Nq // TOPK_GROUP))
    tiles = max(1, -(-Nd // TOPK_TILE))
    want = max(1, -(-2 * sms // groups))
    per = -(-tiles // max(1, min(want, tiles // 4))) * TOPK_TILE
    return groups, max(1, -(-Nd // per)), per


def ivf_retrieval_topk(queries: torch.Tensor, list_emb: torch.Tensor,
                       list_ids: torch.Tensor, probe_ids: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF probe top-k: queries [Nq,D] scored only against their routed
    lists, list_emb [n_lists,L,D] f32 with list_ids [n_lists,L] int32
    (-1 = padding, anywhere in a row) and probe_ids [Nq,nprobe] int32 ->
    (scores [Nq,k] f32, global ids [Nq,k] int32), for any k >= 1.  The
    top-k of each query over the concatenation of its probed lists in
    probe order: ties go to the earlier probe, then the earlier slot, a
    list named twice is seen twice, and slots past the probed documents
    are (-1e30, -1).

    On CUDA k picks the kernel (``ivf_route``).  Below ``IVF_SELECT_K``,
    ``csrc/ivf_topk.cu``: one launch scores each
    probed list's live rows once per group of the (query, probe) pairs
    that name it (the cut is ``ivf_retrieval_topk_plan``), one sorted
    partial per (query, probe, split), and a second merges each query's
    partials.  From it, ``csrc/ivf_select.cu``: the same scan writes every
    probed slot's score to a matrix, then an exact radix select, gather
    and sort (the cut is ``ivf_retrieval_topk_select_plan``)."""
    _require(k >= 1, f"k={k} must be at least 1")
    if _on_cpu(queries, list_emb, list_ids, probe_ids):
        return ref.ivf_topk_ref(queries, list_emb, list_ids, probe_ids, k)
    if not _check_ivf(queries, list_emb, list_ids, probe_ids):
        return _fill(queries.shape[0], k, queries.device)
    Nq, nprobe = probe_ids.shape
    n_lists, L, _ = list_emb.shape
    sms = torch.cuda.get_device_properties(queries.device
                                           ).multi_processor_count
    if ivf_route(k) == "ivf_retrieval_topk_select":
        chunk_q, _, *cut = ivf_retrieval_topk_select_plan(Nq, nprobe,
                                                          n_lists, L, k, sms)
        return _ivf_select_launch(queries, list_emb, list_ids, probe_ids, k,
                                  chunk_q, *cut)
    _require(nprobe <= IVF_MAX_PARTIALS,
             f"nprobe={nprobe} above {IVF_MAX_PARTIALS}")
    return _ivf_launch(queries, list_emb, list_ids, probe_ids, k,
                       *ivf_retrieval_topk_plan(Nq, nprobe, n_lists, L, sms))


def _check_ivf(queries, list_emb, list_ids, probe_ids) -> bool:
    """The IVF kernels' checks of CUDA inputs; False when there is
    nothing to score (every slot is then the fill)."""
    Nq, D = queries.shape
    n_lists, L, D2 = list_emb.shape
    nprobe = probe_ids.shape[1]
    _require(queries.dtype == torch.float32
             and list_emb.dtype == torch.float32,
             "queries and list_emb must be float32")
    _require(list_ids.dtype == torch.int32 and probe_ids.dtype == torch.int32,
             "list_ids and probe_ids must be int32")
    _require(D2 == D and list_ids.shape == (n_lists, L)
             and probe_ids.shape == (Nq, nprobe),
             f"list_emb {tuple(list_emb.shape)}, list_ids "
             f"{tuple(list_ids.shape)}, probe_ids {tuple(probe_ids.shape)} "
             f"do not match queries {tuple(queries.shape)}")
    _require(Nq * nprobe < 2 ** 31 and n_lists < 2 ** 31
             and nprobe * L < INT32_ROOM,
             "probe table, list count and probed slots must fit int32")
    _contiguous(queries=queries, list_emb=list_emb, list_ids=list_ids,
                probe_ids=probe_ids)
    return Nq > 0 and nprobe > 0 and n_lists > 0 and L > 0


def _ivf_launch(queries, list_emb, list_ids, probe_ids, k: int,
                group_blocks: int, n_splits: int, per: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the IVF scan and merge kernels on checked CUDA inputs, lists
    cut into splits of ``per`` rows, ``group_blocks`` blocks per (list,
    split)."""
    Nq, D = queries.shape
    n_lists, L, _ = list_emb.shape
    nprobe = probe_ids.shape[1]
    dev = queries.device
    out_s = torch.empty((Nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Nq, k), dtype=torch.int32, device=dev)
    part_s = torch.empty((Nq, nprobe, n_splits, k), dtype=torch.float32,
                         device=dev)
    part_r = torch.empty((Nq, nprobe, n_splits, k), dtype=torch.int32,
                         device=dev)
    rc = _fn("ivf_topk", "ivf_retrieval_topk")(
        _ptr(queries), _ptr(list_emb), _ptr(list_ids), _ptr(probe_ids),
        _ptr(part_s), _ptr(part_r), _ptr(out_s), _ptr(out_i), Nq, n_lists,
        L, D, nprobe, k, per, n_splits, group_blocks, _stream(queries))
    _check_rc(rc, "ivf_retrieval_topk")
    launches["ivf_retrieval_topk"] += 1
    return out_s, out_i


IVF_GROUP = 32    # (query, probe) pairs per IVF group (csrc/ivf_topk.cu kG)
IVF_TILE = 128    # list rows per IVF tile (csrc/ivf_topk.cu kTD)
IVF_SPLIT_TILES = 8   # tiles a split holds at most (a block's stream)
IVF_MAX_PARTIALS = 16384   # nprobe * n_splits one merge block holds


def ivf_retrieval_topk_plan(Nq: int, nprobe: int, n_lists: int, L: int,
                            sms: int) -> Tuple[int, int, int]:
    """How the IVF kernel cuts its work: (group blocks, splits per list,
    rows per split), one thread block per (list, split, group block).

    The (query, probe) pairs that name a list form groups of
    ``IVF_GROUP`` in probe-table order; a block scores its split's live
    rows once for each group g of its list with g = z, z + group blocks,
    ... (z its group block), so a list's rows are read once per group.
    There are enough group blocks for the pairs of an even spread over the
    lists (at most 65535, a grid dimension).  At most min(n_lists * group
    blocks, Nq * nprobe) (list, group block) pairs can have work; the lists
    are split for about two blocks per SM over the ``sms`` SMs, and into
    splits of at most ``IVF_SPLIT_TILES`` tiles of ``IVF_TILE`` rows, so
    that the longest lists leave no tail of a few long blocks; but a split
    keeps at least four tiles (a list of up to four tiles is one block)
    and a query's nprobe * splits partials stay within
    ``IVF_MAX_PARTIALS``.  A split is a whole number of tiles, the last one
    may be short; splits cover [0, L) without overlap."""
    pairs = max(1, Nq * nprobe)
    group_blocks = min(65535, max(1, -(-pairs // (max(1, n_lists)
                                                * IVF_GROUP))))
    units = max(1, min(n_lists * group_blocks, pairs))
    tiles = max(1, -(-L // IVF_TILE))
    want = max(1, -(-2 * sms // units), -(-tiles // IVF_SPLIT_TILES))
    n = max(1, min(want, tiles // 4, IVF_MAX_PARTIALS // max(1, nprobe)))
    per = -(-tiles // n) * IVF_TILE
    return group_blocks, max(1, -(-L // per)), per


TOPK_NARROW_MAX = 32   # widest k of csrc/topk.cu and csrc/ivf_topk.cu
TOPK_LIST_MAX = 6176   # widest k of csrc/topk_list.cu (its group of 4)
# doc and candidate counts the kernels index with int32, with room for
# a chunk past the end
INT32_ROOM = 2 ** 31 - 1024


# From this k csrc/ivf_select.cu is as fast as csrc/ivf_topk.cu or faster
# at every shape chip_smoke.py's kernels_ivf_grid times (PERF.md); below
# it the narrow kernel keeps the queries of one or a few (its selection
# costs less than the select route's passes over the score matrix).
IVF_SELECT_K = 16


def ivf_route(k: int) -> str:
    """The entry point, and ``launches`` name, a CUDA IVF probe of width
    ``k`` runs: ``ivf_retrieval_topk`` (``csrc/ivf_topk.cu``) below
    ``IVF_SELECT_K``, ``ivf_retrieval_topk_select``
    (``csrc/ivf_select.cu``) from it.  The crossing measured on the card
    depends on k alone at the shapes timed."""
    return ("ivf_retrieval_topk" if k < IVF_SELECT_K
            else "ivf_retrieval_topk_select")


# Where csrc/topk_list.cu beats csrc/topk_select.cu (chip_smoke.py's
# kernels_topk_grid, PERF.md): a corpus of at most TOPK_LIST_DOCS docs,
# which the list kernel scans in one block per query group, unless a
# single query (whose warps then each keep a list of k) asks for
# TOPK_LIST_SPREAD_K or more; over more docs, a single query up to
# TOPK_LIST_ONE_K, and several query groups up to TOPK_LIST_GROUPS_K over
# at most TOPK_LIST_GROUPS_DOCS docs (the list kernel's time stays flat
# as groups are added, the select kernel's score matrix grows with Nq).
# Elsewhere the select kernel's passes over the score matrix cost less
# than the list kernel's merges into lists of k and its reads of the
# docs once per group of 8.
TOPK_LIST_DOCS = 4 * TOPK_TILE
TOPK_LIST_SPREAD_K = 1024
TOPK_LIST_ONE_K = 128
TOPK_LIST_GROUPS_DOCS = 8192
TOPK_LIST_GROUPS_K = 64


def topk_route(Nq: int, Nd: int, k: int) -> str:
    """The entry point, and ``launches`` name, a CUDA exact top-k of
    ``Nq`` queries over ``Nd`` docs at width ``k`` runs:
    ``retrieval_topk`` (``csrc/topk.cu``) up to ``TOPK_NARROW_MAX``;
    above, up to ``TOPK_LIST_MAX``, ``retrieval_topk_list``
    (``csrc/topk_list.cu``) where the measured grid has it faster (see
    ``TOPK_LIST_DOCS``); else ``retrieval_topk_select``
    (``csrc/topk_select.cu``)."""
    if k <= TOPK_NARROW_MAX:
        return "retrieval_topk"
    if k <= TOPK_LIST_MAX and (
            (Nd <= TOPK_LIST_DOCS and (Nq > 1 or k < TOPK_LIST_SPREAD_K))
            or (Nq == 1 and k <= TOPK_LIST_ONE_K)
            or (Nq > TOPK_LIST_GROUPS[-1] and Nd <= TOPK_LIST_GROUPS_DOCS
                and k <= TOPK_LIST_GROUPS_K)):
        return "retrieval_topk_list"
    return "retrieval_topk_select"


TOPK_CHUNK = 32       # dims per ring chunk (csrc/topk_core.cuh kKC)
TOPK_STAGES = 2       # ring depth (kStages)
TOPK_BUFFER = 32      # candidate buffer per (warp, query) (topk_list.cu kLB)
TOPK_LIST_GROUPS = (4, 8)   # queries per block of topk_list.cu
SMEM_BLOCK = 232_448  # shared memory one block may take on sm_90 (kSmemMax)
# ... and at most what two blocks may take each on one SM (228 KB, 1 KB
# of it reserved per block)
SMEM_TWO_BLOCKS = (233_472 - 2 * 1024) // 2
TOPK_MERGE_ENTRIES = 4096   # lists x k one merge block holds at most
# tests/test_torch_topk_wide_plan.py holds these and topk_list_smem to
# csrc/topk_list.cu's own constants and scan_smem.


def topk_list_smem(group: int, k: int) -> int:
    """Shared memory of a ``csrc/topk_list.cu`` scan block: the ring of
    doc and query chunks, and per (warp, query) a candidate buffer and a
    list of k (score, id) entries."""
    return 4 * (TOPK_STAGES * (TOPK_TILE + group) * TOPK_CHUNK
                + 2 * group * (TOPK_BUFFER + k))


def retrieval_topk_wide_plan(Nq: int, Nd: int, k: int, sms: int
                             ) -> Tuple[int, int, int, int]:
    """How ``csrc/topk_list.cu`` cuts a top-k of width ``k`` (33 to
    ``TOPK_LIST_MAX``): (queries per group, query groups, doc splits, docs
    per split), one thread block per (group, split).

    Each doc row is read once per group.  The group is the smallest of
    ``TOPK_LIST_GROUPS`` that holds all Nq queries, among those whose
    block (``topk_list_smem``, which grows with k) lets two blocks share
    an SM; at a k where none does, 4.  So a wider k shrinks the group and
    the docs are read ceil(Nq / group) times.  (``topk_route`` sends this
    kernel few docs or a single query.)  The splits follow
    ``topk_list_splits``."""
    fits = [g for g in TOPK_LIST_GROUPS
            if topk_list_smem(g, k) <= SMEM_TWO_BLOCKS] or [
                TOPK_LIST_GROUPS[0]]
    group = next((g for g in fits if g >= Nq), fits[-1])
    groups = max(1, -(-Nq // group))
    return (group, groups) + topk_list_splits(groups, Nd, k, sms)


def topk_list_splits(groups: int, Nd: int, k: int, sms: int
                     ) -> Tuple[int, int]:
    """(doc splits, docs per split) of ``csrc/topk_list.cu`` for
    ``groups`` query groups: about two blocks per SM over the ``sms`` SMs,
    but a split keeps at least four tiles of ``TOPK_TILE`` docs and at
    least k docs: a corpus of up to that many is one split, and one block
    then writes the result in a single launch.  A split is a whole number
    of tiles, and the last one may be short; splits cover [0, Nd) without
    overlap."""
    tiles = max(1, -(-Nd // TOPK_TILE))
    want = max(1, -(-2 * sms // groups))
    least = max(4, -(-k // TOPK_TILE))
    per = -(-tiles // max(1, min(want, tiles // least))) * TOPK_TILE
    return max(1, -(-Nd // per)), per


def topk_merge_fan_in(k: int) -> int:
    """Sorted lists of width ``k`` one block of ``csrc/topk_list.cu``'s
    merge takes at a level: the largest power of two, at least 2, whose
    lists hold at most ``TOPK_MERGE_ENTRIES`` entries."""
    fan_in = 2
    while 2 * fan_in * k <= TOPK_MERGE_ENTRIES:
        fan_in *= 2
    return fan_in


def _topk_list_launch(queries, docs, k: int, group: int, groups: int,
                      n_splits: int, per: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/topk_list.cu`` (its scan, and its merge levels when
    ``n_splits`` > 1) on checked CUDA inputs, queries in groups of
    ``group`` and docs cut into splits of ``per`` rows."""
    Nq, D = queries.shape
    dev = queries.device
    out_s = torch.empty((Nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Nq, k), dtype=torch.int32, device=dev)
    # the splits' lists, and the merge's second buffer of lists
    scratch = [None] * 4
    fan_in = 0
    if n_splits > 1:
        fan_in = topk_merge_fan_in(k)
        for j, n in enumerate((n_splits, -(-n_splits // fan_in))):
            scratch[2 * j] = torch.empty((Nq, n, k), dtype=torch.float32,
                                         device=dev)
            scratch[2 * j + 1] = torch.empty((Nq, n, k), dtype=torch.int32,
                                             device=dev)
    rc = _fn("topk_list", "retrieval_topk_list")(
        _ptr(queries), _ptr(docs),
        *(None if t is None else _ptr(t) for t in scratch), _ptr(out_s),
        _ptr(out_i), Nq, docs.shape[0], D, k, group, per, n_splits, fan_in,
        _stream(queries))
    _check_rc(rc, "retrieval_topk_list")
    launches["retrieval_topk_list"] += 1
    return out_s, out_i


SELECT_BYTES = 1 << 30   # scratch of one csrc/topk_select.cu call, at most
SELECT_BINS = 2048       # the widest radix digit's bins (topk_select.cu kBins)
SELECT_STATE = 4         # ints of per-query state (kState)
SELECT_MAX_CHUNKS = 32   # select chunks a query is cut into, at most
SELECT_MIN_CHUNK = 4096  # docs a select chunk holds, at least (but Nd)
# tests/test_torch_topk_select.py holds these and topk_select_scratch to
# csrc/topk_select.cu's own constants and work_ints.


def topk_select_scratch(chunk_q: int, Nd: int, k: int, n_sel: int
                        ) -> Tuple[int, int, int]:
    """Scratch of ``csrc/topk_select.cu`` for a chunk of ``chunk_q``
    queries: (score floats, work ints, candidate entries of 8 bytes).
    The scores S [chunk_q, Nd rounded up to 4]; per query each of its
    ``n_sel`` select chunks' histogram (``SELECT_BINS`` counts) and two
    counts, and the query's state; per query two buffers of min(k, Nd)
    candidates (the sort's runs and the merge's output)."""
    ld = -(-Nd // 4) * 4
    return (chunk_q * ld,
            chunk_q * (n_sel * (SELECT_BINS + 2) + SELECT_STATE),
            2 * chunk_q * min(k, Nd))


def topk_select_bytes(chunk_q: int, Nd: int, k: int, n_sel: int) -> int:
    n_s, n_w, n_c = topk_select_scratch(chunk_q, Nd, k, n_sel)
    return 4 * n_s + 4 * n_w + 8 * n_c


def _select_queries(Nq: int, n_cand: int, k: int) -> int:
    """Queries a chunk of the select kernels holds: all Nq when their
    scratch (``topk_select_scratch`` over ``n_cand`` candidates each)
    fits ``SELECT_BYTES``, else as many as fit, at least one (a single
    query over more candidates than the limit holds takes what it needs)
    and at most 65535 (a grid dimension)."""
    per_q = topk_select_bytes(1, n_cand, k, SELECT_MAX_CHUNKS)
    return max(1, min(Nq, 65535, SELECT_BYTES // per_q))


def _select_chunks(chunk_q: int, n_cand: int, sms: int) -> Tuple[int, int]:
    """(select chunks, candidates a chunk) of the select passes over a
    chunk of ``chunk_q`` queries: each query's ``n_cand`` candidates cut
    into chunks of a multiple of 4, enough for about four blocks per SM
    over the ``sms`` SMs, but at most ``SELECT_MAX_CHUNKS`` (one block a
    query sums their histograms) and each at least ``SELECT_MIN_CHUNK``
    candidates; the chunks cover [0, n_cand) without overlap."""
    n_sel = max(1, min(SELECT_MAX_CHUNKS, -(-4 * sms // chunk_q),
                       n_cand // SELECT_MIN_CHUNK))
    sel_per = max(4, -(-(-(-n_cand // n_sel)) // 4) * 4)
    return max(1, -(-n_cand // sel_per)), sel_per


def _select_buffers(Nq: int, chunk_q: int, n_cand: int, k: int, n_sel: int,
                    dev) -> Tuple[torch.Tensor, ...]:
    """The select kernels' scratch (``topk_select_scratch``: scores, work
    ints, candidate entries) and outputs [Nq, k]."""
    n_s, n_w, n_c = topk_select_scratch(chunk_q, n_cand, k, n_sel)
    return (torch.empty(n_s, dtype=torch.float32, device=dev),
            torch.empty(n_w, dtype=torch.int32, device=dev),
            torch.empty(n_c, dtype=torch.int64, device=dev),
            torch.empty((Nq, k), dtype=torch.float32, device=dev),
            torch.empty((Nq, k), dtype=torch.int32, device=dev))


def retrieval_topk_select_plan(Nq: int, Nd: int, k: int, sms: int
                               ) -> Tuple[int, int, int, int, int, int]:
    """How ``csrc/topk_select.cu`` cuts a top-k of width ``k``: (queries
    per chunk, query chunks, doc splits of the scan, docs per split,
    select chunks, docs per select chunk).

    The queries run in chunks of ``_select_queries``, cut to a multiple of
    ``TOPK_GROUP`` when that is one or more (whole scan groups).  In a
    chunk the scan's grid is (query group, doc split) of
    ``retrieval_topk_plan``, so each doc row is read once per group, and
    the select passes cut each query's docs as ``_select_chunks`` says.
    Splits and select chunks each cover [0, Nd) without overlap."""
    chunk_q = _select_queries(Nq, Nd, k)
    if TOPK_GROUP <= chunk_q < Nq:
        chunk_q -= chunk_q % TOPK_GROUP
    _, n_splits, per = retrieval_topk_plan(chunk_q, Nd, sms)
    return (chunk_q, -(-Nq // chunk_q), n_splits, per,
            *_select_chunks(chunk_q, Nd, sms))


def _topk_select_launch(queries, docs, k: int, chunk_q: int, n_splits: int,
                        per: int, n_sel: int, sel_per: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/topk_select.cu`` (per chunk of ``chunk_q`` queries:
    the scan, three select rounds, the gather, the sort and its merge
    levels) on checked CUDA inputs."""
    Nq, D = queries.shape
    Nd = docs.shape[0]
    bufs = _select_buffers(Nq, chunk_q, Nd, k, n_sel, queries.device)
    rc = _fn("topk_select", "retrieval_topk_select")(
        *map(_ptr, (queries, docs, *bufs)), Nq, Nd, D, k, chunk_q, per,
        n_splits, n_sel, sel_per, _stream(queries))
    _check_rc(rc, "retrieval_topk_select")
    launches["retrieval_topk_select"] += 1
    return bufs[3], bufs[4]


def ivf_retrieval_topk_select_plan(Nq: int, nprobe: int, n_lists: int,
                                   L: int, k: int, sms: int
                                   ) -> Tuple[int, int, int, int, int, int,
                                              int]:
    """How ``csrc/ivf_select.cu`` cuts an IVF probe of width ``k``: (queries
    per chunk, query chunks, group blocks, splits per list, rows per split,
    select chunks, columns per select chunk).

    The queries run in chunks of ``_select_queries`` over the nprobe * L
    candidate columns.  In a chunk the scan's grid is
    ``ivf_retrieval_topk_plan``'s (list, split, group block), so each
    probed list's live rows are read once per group of ``IVF_GROUP``
    pairs, and the select passes cut each query's columns as
    ``_select_chunks`` says.  Splits cover [0, L) and select chunks [0,
    nprobe * L) without overlap."""
    n_cand = nprobe * L
    chunk_q = _select_queries(Nq, n_cand, k)
    return (chunk_q, -(-Nq // chunk_q),
            *ivf_retrieval_topk_plan(chunk_q, nprobe, n_lists, L, sms),
            *_select_chunks(chunk_q, n_cand, sms))


def _ivf_select_launch(queries, list_emb, list_ids, probe_ids, k: int,
                       chunk_q: int, group_blocks: int, n_splits: int,
                       per: int, n_sel: int, sel_per: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ivf_select.cu`` (per chunk of ``chunk_q`` queries: the
    fill, the scan, then the sort of each row of S or the three select
    rounds, the gather, the sort and its merge levels) on checked CUDA
    inputs."""
    Nq, D = queries.shape
    n_lists, L, _ = list_emb.shape
    nprobe = probe_ids.shape[1]
    bufs = _select_buffers(Nq, chunk_q, nprobe * L, k, n_sel, queries.device)
    rc = _fn("ivf_select", "ivf_retrieval_topk_select")(
        *map(_ptr, (queries, list_emb, list_ids, probe_ids, *bufs)), Nq,
        n_lists, L, D, nprobe, k, chunk_q, per, n_splits, group_blocks,
        n_sel, sel_per, _stream(queries))
    _check_rc(rc, "ivf_retrieval_topk_select")
    launches["ivf_retrieval_topk_select"] += 1
    return bufs[3], bufs[4]
