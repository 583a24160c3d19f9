"""Public kernel wrappers: dispatch by the tensor's device.

A CPU tensor runs the plain PyTorch version in ``ref``.  A CUDA tensor
launches the hand-written CUDA kernel (``csrc/``, built on first use by
``build``) after the wrapper checks device, dtype, shape and contiguity,
or raises: there is no fallback from a CUDA tensor to the plain version.
Each wrapper adds one to ``launches[<name>]`` where it launches its
kernel, and nowhere else, so a run can show which kernels it went
through; the k > 32 route of the two top-k functions
(``csrc/topk_wide.cu``) counts under its entry point's name.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

launches: Dict[str, int] = {"paged_decode_attention": 0,
                            "flash_attention": 0,
                            "retrieval_topk": 0,
                            "ivf_retrieval_topk": 0,
                            "retrieval_topk_wide": 0,
                            "ivf_retrieval_topk_wide": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    ("paged_attention", "paged_decode_attention"):
        [_VP] * 9 + [_I] * 8 + [_F, _I, _VP],
    ("flash_attention", "flash_attention"):
        [_VP] * 6 + [_I] * 8 + [_F, _I, _VP],
    ("topk", "retrieval_topk"): [_VP] * 6 + [_I] * 6 + [_VP],
    ("ivf_topk", "ivf_retrieval_topk"): [_VP] * 8 + [_I] * 9 + [_VP],
    ("topk_wide", "retrieval_topk_wide"): [_VP] * 6 + [_I] * 4 + [_VP],
    ("topk_wide", "ivf_retrieval_topk_wide"): [_VP] * 8 + [_I] * 6 + [_VP],
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
    (scores [Nq,k] f32, ids [Nq,k] int32) for any k >= 1; ties go to the
    lower id, and slots beyond Nd are (-1e30, -1).  On CUDA a k of at most
    ``TOPK_NARROW_MAX`` runs ``csrc/topk.cu``, a wider one
    ``csrc/topk_wide.cu``."""
    _require(k >= 1, f"k={k} must be at least 1")
    if _on_cpu(queries, docs):
        return ref.topk_ref(queries, docs, k)
    _check_exact(queries, docs)
    Nq, Nd = queries.shape[0], docs.shape[0]
    if Nq == 0:
        return _fill(0, k, queries.device)
    if wide_route(k):
        return _topk_wide_launch(queries, docs, k)
    sms = torch.cuda.get_device_properties(queries.device
                                           ).multi_processor_count
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
    _require(Nd < 2 ** 31 - WIDE_TILE, "doc count must fit int32")
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

    On CUDA, for k up to ``TOPK_NARROW_MAX``, one launch scores each
    probed list's live rows once per group of the (query, probe) pairs
    that name it (the cut is ``ivf_retrieval_topk_plan``), one sorted
    partial per (query, probe, split), and a second merges each query's
    partials; a wider k runs ``csrc/topk_wide.cu``."""
    _require(k >= 1, f"k={k} must be at least 1")
    if _on_cpu(queries, list_emb, list_ids, probe_ids):
        return ref.ivf_topk_ref(queries, list_emb, list_ids, probe_ids, k)
    if not _check_ivf(queries, list_emb, list_ids, probe_ids):
        return _fill(queries.shape[0], k, queries.device)
    if wide_route(k):
        return _ivf_wide_launch(queries, list_emb, list_ids, probe_ids, k)
    Nq, nprobe = probe_ids.shape
    n_lists, L, _ = list_emb.shape
    _require(nprobe <= IVF_MAX_PARTIALS,
             f"nprobe={nprobe} above {IVF_MAX_PARTIALS}")
    sms = torch.cuda.get_device_properties(queries.device
                                           ).multi_processor_count
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
             and nprobe * L < 2 ** 31 - WIDE_TILE,
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
WIDE_TILE = 1024       # candidates per tile of csrc/topk_wide.cu (kT)


def wide_route(k: int) -> bool:
    """True when a CUDA top-k of width ``k`` runs ``csrc/topk_wide.cu``
    (k above ``TOPK_NARROW_MAX``), False when it runs the narrow kernel."""
    return k > TOPK_NARROW_MAX


def _topk_wide_launch(queries, docs, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/topk_wide.cu``'s exact top-k on checked CUDA inputs:
    one block per query walks the docs in tiles of ``WIDE_TILE``."""
    Nq, D = queries.shape
    out_s, out_i, buf_s, buf_i = _wide_buffers(Nq, k, queries.device)
    rc = _fn("topk_wide", "retrieval_topk_wide")(
        _ptr(queries), _ptr(docs), _ptr(buf_s), _ptr(buf_i), _ptr(out_s),
        _ptr(out_i), Nq, docs.shape[0], D, k, _stream(queries))
    _check_rc(rc, "retrieval_topk_wide")
    launches["retrieval_topk_wide"] += 1
    return out_s, out_i


def _ivf_wide_launch(queries, list_emb, list_ids, probe_ids, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/topk_wide.cu``'s IVF probe on checked CUDA inputs:
    one block per query walks its probed lists' slots in tiles of
    ``WIDE_TILE``."""
    Nq, D = queries.shape
    n_lists, L, _ = list_emb.shape
    out_s, out_i, buf_s, buf_i = _wide_buffers(Nq, k, queries.device)
    rc = _fn("topk_wide", "ivf_retrieval_topk_wide")(
        _ptr(queries), _ptr(list_emb), _ptr(list_ids), _ptr(probe_ids),
        _ptr(buf_s), _ptr(buf_i), _ptr(out_s), _ptr(out_i), Nq, n_lists, L,
        D, probe_ids.shape[1], k, _stream(queries))
    _check_rc(rc, "ivf_retrieval_topk_wide")
    launches["ivf_retrieval_topk_wide"] += 1
    return out_s, out_i


def _wide_buffers(Nq: int, k: int, dev):
    """Outputs [Nq, k] and the carried lists' double buffer [2, Nq, k]."""
    return (torch.empty((Nq, k), dtype=torch.float32, device=dev),
            torch.empty((Nq, k), dtype=torch.int32, device=dev),
            torch.empty((2, Nq, k), dtype=torch.float32, device=dev),
            torch.empty((2, Nq, k), dtype=torch.int32, device=dev))
