"""Public kernel wrappers: dispatch by the tensor's device.

A CPU tensor runs the plain PyTorch version in ``ref``.  A CUDA tensor
launches the hand-written CUDA kernel (``csrc/``, built on first use by
``build``) after the wrapper checks device, dtype, shape and contiguity,
or raises: there is no fallback from a CUDA tensor to the plain version.
Each wrapper adds one to ``launches[<name>]`` where it launches its
kernel, and nowhere else, so a run can show which kernels it went
through (``reset_launches()`` zeroes the counts).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

launches: Dict[str, int] = {"paged_decode_attention": 0,
                            "flash_attention": 0,
                            "retrieval_topk": 0,
                            "ivf_retrieval_topk": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    ("paged_attention", "paged_decode_attention"):
        [_VP] * 7 + [_I] * 7 + [_F, _I, _VP],
    ("flash_attention", "flash_attention"):
        [_VP] * 6 + [_I] * 8 + [_F, _I, _VP],
    ("topk", "retrieval_topk"): [_VP] * 6 + [_I] * 6 + [_VP],
    ("ivf_topk", "ivf_retrieval_topk"): [_VP] * 8 + [_I] * 6 + [_VP],
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
    out = torch.empty_like(q)
    if B == 0 or nb == 0:
        return out.zero_()
    rc = _fn("paged_attention", "paged_decode_attention")(
        _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(block_tables),
        _ptr(first), _ptr(last), _ptr(out), B, H, KV, hd, bs, nb, P,
        float(softcap or 0.0), _DTYPE_CODE[q.dtype], _stream(q))
    _check_rc(rc, "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Position-masked attention, [B,Sq,H,hd] x [B,Sk,KV,hd]^2 with
    q_pos [B,Sq], kv_pos [B,Sk] (< 0 = invalid slot) -> [B,Sq,H,hd]."""
    if _on_cpu(q, k, v, q_pos, kv_pos):
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                       window=window, softcap=softcap)
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
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = _fn("flash_attention", "flash_attention")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(q_pos), _ptr(kv_pos), _ptr(out),
        B, Sq, Sk, H, KV, hd, int(bool(causal)), int(window or 0),
        float(softcap or 0.0), _DTYPE_CODE[q.dtype], _stream(q))
    _check_rc(rc, "flash_attention")
    launches["flash_attention"] += 1
    return out


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
    (scores [Nq,k] f32, ids [Nq,k] int32); ties go to the lower id, and
    slots beyond Nd are (-1e30, -1)."""
    if _on_cpu(queries, docs):
        return ref.topk_ref(queries, docs, k)
    Nq, D = queries.shape
    Nd = docs.shape[0]
    _require(queries.dtype == torch.float32 and docs.dtype == torch.float32,
             "queries and docs must be float32")
    _require(docs.shape == (Nd, D), f"docs {tuple(docs.shape)} vs D={D}")
    _require(1 <= k <= 32, f"k={k} outside [1, 32]")
    _require(Nd < 2 ** 31, "doc count must fit int32")
    _contiguous(queries=queries, docs=docs)
    dev = queries.device
    out_s = torch.empty((Nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Nq, k), dtype=torch.int32, device=dev)
    if Nq == 0:
        return out_s, out_i
    # split the docs so the (query-tile x split) grid gives every SM a
    # few blocks; a split's doc rows are read once per 8-query tile
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q_tiles = -(-Nq // 8)
    want = max(1, (4 * sms) // q_tiles)
    per = max(256, -(-max(Nd, 1) // want))
    n_splits = max(1, -(-Nd // per))
    part_s = torch.empty((Nq, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Nq, n_splits, k), dtype=torch.int32, device=dev)
    rc = _fn("topk", "retrieval_topk")(
        _ptr(queries), _ptr(docs), _ptr(part_s), _ptr(part_i), _ptr(out_s),
        _ptr(out_i), Nq, Nd, D, k, per, n_splits, _stream(queries))
    _check_rc(rc, "retrieval_topk")
    launches["retrieval_topk"] += 1
    return out_s, out_i


def ivf_retrieval_topk(queries: torch.Tensor, list_emb: torch.Tensor,
                       list_ids: torch.Tensor, probe_ids: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF probe top-k: queries [Nq,D] scored only against their routed
    lists, list_emb [n_lists,L,D] f32 with list_ids [n_lists,L] int32
    (-1 = padding) and probe_ids [Nq,nprobe] int32 -> (scores [Nq,k] f32,
    global ids [Nq,k] int32).  Ties go to the earlier probe, then the
    earlier slot; slots past the probed documents are (-1e30, -1)."""
    if _on_cpu(queries, list_emb, list_ids, probe_ids):
        return ref.ivf_topk_ref(queries, list_emb, list_ids, probe_ids, k)
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
    _require(1 <= k <= 32, f"k={k} outside [1, 32]")
    _require(nprobe <= 65535, f"nprobe={nprobe} above 65535")
    _contiguous(queries=queries, list_emb=list_emb, list_ids=list_ids,
                probe_ids=probe_ids)
    dev = queries.device
    if Nq == 0 or nprobe == 0 or n_lists == 0 or L == 0:
        # nothing to score: every slot is the fill
        return (torch.full((Nq, k), ref.NEG_INF, dtype=torch.float32,
                           device=dev),
                torch.full((Nq, k), -1, dtype=torch.int32, device=dev))
    out_s = torch.empty((Nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Nq, k), dtype=torch.int32, device=dev)
    part_s = torch.empty((Nq, nprobe, k), dtype=torch.float32, device=dev)
    part_r = torch.empty((Nq, nprobe, k), dtype=torch.int32, device=dev)
    rc = _fn("ivf_topk", "ivf_retrieval_topk")(
        _ptr(queries), _ptr(list_emb), _ptr(list_ids), _ptr(probe_ids),
        _ptr(part_s), _ptr(part_r), _ptr(out_s), _ptr(out_i), Nq, n_lists,
        L, D, nprobe, k, _stream(queries))
    _check_rc(rc, "ivf_retrieval_topk")
    launches["ivf_retrieval_topk"] += 1
    return out_s, out_i
