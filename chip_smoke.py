#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases card,build,kernels
    python3 chip_smoke.py --profile       # + the slice's device time by kernel

Phases, in order:
  card     nvidia-smi name and power limit, capability (9, 0), TF32 off
  build    compile the CUDA kernels from src/repro_torch/kernels/csrc
  slice    one RAG run at olmo-1b's full width (bf16, seeded random
           weights): FlatIndex top-k, paged chunked prefill with prefix
           forks, paged decode.  A first pass records, for each kernel,
           the inputs of its costliest call; the measured pass starts
           with every launch count at 0 and checks answers, prefix hits,
           finite logits and that every kernel was launched on this path
  kernels  each kernel against its plain PyTorch version on the card, on
           the inputs recorded from the main path (synthetic inputs of
           the same shapes when the slice did not run) and on edge
           cases, with the tolerance stated; median L2-cold times of the
           kernel, its plain version and one library call that computes
           the same function (a yardstick the port never calls), beside
           the bound of the same work on an H100
  parity   the same slice at the olmo-1b smoke config (f32) on the card
           and on the CPU, from the same weights: the answers must agree

The lines before the last are the card's nvidia-smi name and power limit
and the kernels' JSON record; the last line is {"ok": true, "device":
{...}}.  Any failure exits non-zero before those lines are printed.
Exits 2 when no CUDA device is available or when the port's sources are
not beside this script.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ALL_PHASES = ("card", "build", "slice", "kernels", "parity")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2 ** 20
DEV = "cuda"      # where the slice and the kernel cases run
SHARD_DOCS = 1_000_000   # a realistic index shard: 1M docs x D=256, f32

KERNEL_META = {
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:90"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:93"),
    "retrieval_topk": (
        "src/repro_torch/kernels/csrc/topk.cu",
        "src/repro/kernels/topk_retrieval.py:72"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_ms(fn, reps: int = 25) -> float:
    """Median device time of one call of ``fn`` with a cold L2, by CUDA
    events.  Before each call a write of twice the L2 evicts it and a
    short device sleep keeps the card busy while the host enqueues the
    call, so the events bracket the device work and not the host's
    launch (a plain version of many small operations still shows the
    host gaps between them)."""
    import torch
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b, mask=None) -> float:
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def tolerance(want) -> float:
    """f32: 2e-5 absolute (the same f32 math summed in another order).
    bf16: two bf16 ulps of the largest output (the kernel and the plain
    version round the f32 result to bf16 at different f32 values)."""
    import torch
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
    return 2e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


# ------------------------------------------------------------ work counts


def paged_work(q, k_pool, tables, first, last):
    """Bytes and flops one paged decode call needs on these inputs: the
    K/V of the slots that count read once, q, tables and positions read,
    the output written."""
    bs, KV, hd = k_pool.shape[1:]
    H = q.shape[1]
    elt = k_pool.element_size()
    tb, lo, hi = tables.cpu(), first.cpu(), last.cpu()
    slots = 0
    for b in range(q.shape[0]):
        for j in range(tb.shape[1]):
            if tb[b, j] < 0:
                continue
            a = max(int(lo[b]), j * bs)
            z = min(int(hi[b]), j * bs + bs - 1)
            slots += max(0, z - a + 1)
    nbytes = (2 * slots * KV * hd * elt + 2 * q.numel() * q.element_size()
              + 4 * (tables.numel() + 2 * q.shape[0]))
    return nbytes, 4 * H * hd * slots


def flash_work(q, k, q_pos, kv_pos, causal=True, window=None):
    """Bytes and flops of one position-masked flash call: the K/V rows
    that some query may see read once, q and positions read, the output
    written; 4*hd flops per head per valid (query, key) pair."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qp, kp = q_pos[:, :, None], kv_pos[:, None, :]
    valid = (kp >= 0) & (qp >= 0)
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (qp - kp < window)
    pairs = int(valid.sum())
    keys = int(valid.any(dim=1).sum())
    nbytes = (2 * keys * KV * hd * k.element_size()
              + 2 * q.numel() * q.element_size()
              + 4 * (q_pos.numel() + kv_pos.numel()))
    return nbytes, 4 * H * hd * pairs


def topk_work(q, d, k):
    nq, dim = q.shape
    return 4 * (d.shape[0] * dim + nq * dim) + 8 * nq * k, \
        2 * nq * d.shape[0] * dim


# ------------------------------------------------------------------ phases


def phase_card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{name}, capability {cap}, count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"need compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "name": name}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all(ptxas_verbose=True)
    log(f"build: {len(build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")


class MainPathInputs:
    """While installed, each kernel wrapper of ``ops`` keeps the inputs
    of its costliest call (by the bytes it must move) and then runs as
    before.  Pools are kept by reference (later writes change their
    contents, not their shapes or what counts); the small per-call
    tensors are cloned."""

    def __init__(self, ops):
        self.ops = ops
        self.best = {}
        self.orig = {name: getattr(ops, name) for name in ops.launches}

    def _keep(self, name, work, args, kw):
        if name not in self.best or work[0] > self.best[name][0][0]:
            self.best[name] = (work, args, kw)

    def install(self):
        orig = self.orig

        def paged(q, kp, vp, tb, fi, la, softcap=None):
            args = (q.clone(), kp, vp, tb.clone(), fi.clone(), la.clone())
            self._keep("paged_decode_attention",
                       paged_work(args[0], kp, *args[3:]), args,
                       {"softcap": softcap})
            return orig["paged_decode_attention"](q, kp, vp, tb, fi, la,
                                                  softcap=softcap)

        def flash(q, k, v, qp, kvp, causal=True, window=None, softcap=None):
            kw = {"causal": causal, "window": window, "softcap": softcap}
            self._keep("flash_attention",
                       flash_work(q, k, qp, kvp, causal, window),
                       (q, k, v, qp.clone(), kvp.clone()), kw)
            return orig["flash_attention"](q, k, v, qp, kvp, **kw)

        def topk(q, d, k):
            self._keep("retrieval_topk", topk_work(q, d, k), (q, d, k), {})
            return orig["retrieval_topk"](q, d, k)

        self.ops.paged_decode_attention = paged
        self.ops.flash_attention = flash
        self.ops.retrieval_topk = topk

    def remove(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def _rag_setup(n_entities: int):
    from repro_torch.data.corpus import generate_corpus
    from repro_torch.data.tokenizer import Tokenizer
    from repro_torch.retrieval.encoder import TextEncoder
    docs, qas = generate_corpus(n_entities, seed=0)
    tok = Tokenizer.build([d.text for d in docs] + [q.question for q in qas])
    # six distinct questions, then repeats of the 2nd and 3rd: a repeat
    # retrieves the same contexts and forks the cached prefix (the first
    # request opens the frame, which bypasses the prefix cache)
    qs = [qas[i * 7].question for i in range(6)]
    qs += [qs[1], qs[2]]
    return docs, tok, TextEncoder(seed=0), qs


def _rag(cfg, params, docs, tok, enc, device, max_len, chunk, block, batch,
         top_k, new_tokens):
    from repro_torch.rag.pipeline import RAGPipeline
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.serving.engine import ServeEngine
    index = FlatIndex(enc.dim, device=device)
    index.add(enc.encode([d.text for d in docs]), [d.text for d in docs])
    eng = ServeEngine(cfg, params, max_len=max_len, batch_size=batch,
                      prefill_chunk=chunk, paged=True, block_size=block,
                      device=device)
    rag = RAGPipeline(enc, index, eng, tok, top_k=top_k,
                      max_new_tokens=new_tokens)
    return rag, eng


def phase_slice(torch, card, captured: dict, profile: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving.engine import ContinuousSession
    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = Model(cfg).init_params(seed=0, device=DEV)
    torch.cuda.synchronize()
    log(f"slice: olmo-1b {cfg.num_layers} layers d{cfg.d_model} "
        f"{cfg.num_heads}x{cfg.resolved_head_dim} ff{cfg.d_ff} vocab "
        f"{cfg.vocab_size} {cfg.dtype}, {cfg.param_count() / 1e9:.2f}B "
        f"params drawn in {time.perf_counter() - t0:.1f} s")
    docs, tok, enc, qs = _rag_setup(40)
    rag, eng = _rag(cfg, params, docs, tok, enc, DEV, max_len=512,
                    chunk=16, block=16, batch=4, top_k=3, new_tokens=16)

    finite = []
    logits_fn = eng.model._logits

    def checked_logits(p, x):
        out = logits_fn(p, x)
        finite.append(torch.isfinite(out).all())
        return out

    eng.model._logits = checked_logits
    seg = {"s": 0.0, "tokens": 0}
    run_segment = ContinuousSession.run_segment

    def timed_segment(self, drain=False):
        before = int(self.idx.sum())
        t = time.perf_counter()
        events = run_segment(self, drain)
        torch.cuda.synchronize()
        seg["s"] += time.perf_counter() - t
        # idx of finished rows still counts their tokens at this point
        seg["tokens"] += int(self.idx.sum()) - before
        return events

    # first pass: warms up (cuBLAS handles, allocator) and records each
    # kernel's costliest main-path inputs
    rec = MainPathInputs(ops)
    rec.install()
    try:
        warm = [r.answer for r in rag.answer(qs)]
    finally:
        rec.remove()
    captured.update(rec.best)
    torch.cuda.synchronize()

    ContinuousSession.run_segment = timed_segment
    finite.clear()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        results = rag.answer(qs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
    finally:
        ContinuousSession.run_segment = run_segment
    st = rag.last_stats
    check(len(results) == len(qs)
          and [r.question for r in results] == qs, "answers out of order")
    check(all(isinstance(r.answer, str) for r in results), "missing answer")
    check([r.answer for r in results] == warm,
          "two greedy runs of the same questions gave different answers")
    check(all(len(r.contexts) == 3 for r in results), "top-3 contexts")
    check(st.prefix_hits >= 1, f"no prefix hit ({st.prefix_hits})")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    for name in KERNEL_META:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched on the main path")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tag = f"[{card['smi']}]"
    log(f"slice: {len(results)} answers in {wall:.3f} s wall; prefix hits "
        f"{st.prefix_hits} misses {st.prefix_misses}, refills {st.refills}, "
        f"frames {st.frames}, segments {st.segments}, tokens {st.tokens_out}")
    log(f"slice: mean TTFT {st.ttft_mean * 1e3:.2f} ms {tag}")
    log(f"slice: decode {seg['tokens'] / max(seg['s'], 1e-9):.1f} tokens/s "
        f"({seg['tokens']} tokens in {seg['s']:.3f} s of decode segments) "
        f"{tag}")
    log(f"slice: peak memory {peak:.2f} GiB {tag}")
    log(f"slice: launches on the main path {json.dumps(launches)}")
    for r in results[:3]:
        log(f"  q: {r.question!r} -> {r.answer[:60]!r}")
    if profile:
        profile_slice(torch, rag, qs, tag)
    return launches


def profile_slice(torch, rag, qs, tag) -> None:
    """One more pass of the slice under torch.profiler: the device's busy
    share of the traced window (union of kernel, memcpy and memset
    intervals over the span of all traced events) and device time by
    kernel.  The profiler's own host overhead lowers the busy share."""
    from torch.profiler import ProfilerActivity, profile
    trace = ROOT / "build" / "slice_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rag.answer(qs)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(bool(dev), "the profiler traced no device activity")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, end = 0.0, t0
    by_name = {}
    for a, b, e in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    total = sum(by_name.values())
    log(f"profile: traced {(t1 - t0) / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / (t1 - t0):.1f}%), "
        f"{len(dev)} device activities {tag}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {100 * us / total:5.1f}% {us / 1e3:8.2f} ms  {name[:90]}")
    mine = re.compile(r"\b(paged_decode_kernel|flash_kernel|"
                      r"topk_partial_kernel|topk_merge_kernel)\b")
    ours = sum(us for name, us in by_name.items() if mine.search(name))
    log(f"profile: the port's CUDA kernels {ours / 1e3:.2f} ms "
        f"({100 * ours / total:.1f}% of device time)")


def _paged_case(torch, gen, B, H, KV, hd, bs, P, lengths, firsts, nb,
                dtype, all_free_row=False):
    dev = DEV
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, bs, KV, hd, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, bs, KV, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev)
    tables = torch.full((B, nb), -1, dtype=torch.int32, device=dev)
    used = 0
    for b in range(B):
        n = -(-(lengths[b] + 1) // bs)
        if all_free_row and b == B - 1:
            continue
        tables[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    first = torch.tensor(firsts, dtype=torch.int32, device=dev)
    last = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, first, last


def kernels_paged(torch, F, ops, ref, gen, main, rec) -> None:
    bf16, f32 = torch.bfloat16, torch.float32
    synth = _paged_case(torch, gen, 4, 16, 16, 128, 16, 128,
                        [150, 171, 118, 190], [3, 0, 14, 7], 12, bf16)
    if main is None:
        main = (synth, {"softcap": None})
    cases = [
        ("main path", main[0], main[1]["softcap"]),
        ("bf16 H=KV=16 hd128 bs16", synth, None),
        ("f32 hd16", _paged_case(torch, gen, 3, 4, 4, 16, 8, 10,
                                 [20, 9, 30], [2, 0, 5], 4, f32), None),
        ("gqa H4 KV2 f32", _paged_case(torch, gen, 3, 4, 2, 16, 8, 10,
                                       [20, 9, 30], [2, 0, 5], 4, f32),
         None),
        ("softcap 30 f32", _paged_case(torch, gen, 3, 4, 2, 32, 8, 10,
                                       [20, 9, 30], [2, 0, 5], 4, f32),
         30.0),
        ("hd8 bf16 gqa", _paged_case(torch, gen, 2, 4, 1, 8, 4, 8,
                                     [9, 5], [0, 1], 3, bf16), None),
    ]
    errs = {}
    for name, (q, kp, vp, tb, fi, la), cap in cases:
        got = ops.paged_decode_attention(q, kp, vp, tb, fi, la, softcap=cap)
        want = ref.paged_attention_ref(q, kp, vp, tb, fi, la, softcap=cap)
        torch.cuda.synchronize()
        err, tol = max_err(got, want), tolerance(want)
        errs[name] = err
        log(f"  paged_decode_attention [{name}] {tuple(q.shape)} "
            f"{dtype_name(q)} max|err| {err:.3e} (tol {tol:.3g})")
        check(err <= tol, f"paged decode {name}: {err} > {tol}")
    # a row whose table is all -1 must stay finite
    q, kp, vp, tb, fi, la = _paged_case(torch, gen, 2, 2, 1, 8, 4, 4, [5, 0],
                                        [0, 0], 2, f32, all_free_row=True)
    got = ops.paged_decode_attention(q, kp, vp, tb, fi, la)
    want = ref.paged_attention_ref(q, kp, vp, tb, fi, la)
    check(bool(torch.isfinite(got).all()), "all-unallocated row not finite")
    err = max_err(got[0], want[0])
    log(f"  paged_decode_attention [all-unallocated row] finite, row 0 "
        f"max|err| {err:.3e} (tol 2e-05)")
    check(err <= 2e-5, f"paged decode unallocated row: {err}")

    (q, kp, vp, tb, fi, la), kw = main
    t_k = bench_ms(lambda: ops.paged_decode_attention(q, kp, vp, tb, fi, la,
                                                      **kw))
    t_p = bench_ms(lambda: ref.paged_attention_ref(q, kp, vp, tb, fi, la,
                                                   **kw))
    # yardstick: SDPA over the K/V gathered out of the pool (gather not
    # timed); GQA by repeating the KV heads
    B, H, hd = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    nb = tb.shape[1]
    tbl = tb.long().clamp(0, kp.shape[0] - 1)
    kg = kp[tbl].reshape(B, nb * bs, KV, hd).repeat_interleave(
        H // KV, dim=2).transpose(1, 2)
    vg = vp[tbl].reshape(B, nb * bs, KV, hd).repeat_interleave(
        H // KV, dim=2).transpose(1, 2)
    pos = torch.arange(nb * bs, device=DEV)[None]
    mask = ((pos >= fi[:, None]) & (pos <= la[:, None])
            & (tb >= 0).repeat_interleave(bs, 1))[:, None, None, :]
    qs = q[:, :, None, :]
    t_l = bench_ms(lambda: F.scaled_dot_product_attention(qs, kg, vg,
                                                          attn_mask=mask))
    nbytes, flops = paged_work(q, kp, tb, fi, la)
    bnd, by = bound_ms(nbytes, flops, dtype_name(q))
    log(f"  paged_decode_attention main path B{B} H{H} KV{KV} hd{hd} "
        f"bs{bs} nb{nb}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"SDPA(gathered) {t_l:.4f} ms, bound {bnd:.5f} ms ({by}, "
        f"{nbytes} bytes)")
    rec["paged_decode_attention"] = dict(
        max_abs_err=errs["main path"], ms=t_k, plain_ms=t_p, bound_ms=bnd,
        bound_by=by, library_ms=t_l)


def _flash_case(torch, gen, B, Sq, Sk, H, KV, hd, dtype, past, pads):
    """Chunked-prefill shaped inputs: row b has ``past[b]`` cached keys at
    relative positions 0.., its chunk queries follow them (the first
    ``pads[b]`` chunk columns are pads, position -1); unwritten slots of
    the gathered buffer carry -1."""
    dev = DEV
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    nbuf = Sk - Sq
    kv_pos = torch.full((B, Sk), -1, dtype=torch.int32)
    q_pos = torch.full((B, Sq), -1, dtype=torch.int32)
    for b in range(B):
        kv_pos[b, :past[b]] = torch.arange(past[b])
        real = torch.arange(past[b], past[b] + Sq - pads[b])
        q_pos[b, pads[b]:] = real
        kv_pos[b, nbuf + pads[b]:] = real
    return q, k, v, q_pos.to(dev), kv_pos.to(dev)


def kernels_flash(torch, F, ops, ref, gen, main, rec) -> None:
    bf16, f32 = torch.bfloat16, torch.float32
    # olmo-1b chunked prefill: 4 rows, C = 16 queries against the gathered
    # 32-block table (512 slots) + the chunk, bf16
    synth = _flash_case(torch, gen, 4, 16, 528, 16, 16, 128, bf16,
                        [96, 0, 160, 48], [0, 5, 0, 11])
    if main is None:
        main = (synth, {"causal": True, "window": None, "softcap": None})
    cases = [
        ("main path", main[0], main[1]),
        ("bf16 H=KV=16 hd128 Sq16 Sk528", synth, {}),
        ("f32 hd16 gqa", _flash_case(torch, gen, 2, 8, 40, 4, 2, 16, f32,
                                     [10, 3], [0, 2]), {}),
        ("softcap 30 f32", _flash_case(torch, gen, 2, 8, 40, 4, 2, 32, f32,
                                       [10, 3], [0, 2]), {"softcap": 30.0}),
        ("window 5 f32", _flash_case(torch, gen, 2, 8, 40, 4, 4, 16, f32,
                                     [10, 3], [1, 0]), {"window": 5}),
        ("hd8 bf16", _flash_case(torch, gen, 1, 16, 48, 2, 1, 8, bf16,
                                 [20], [3]), {}),
    ]
    errs = {}
    for name, (q, k, v, qp, kvp), kw in cases:
        got = ops.flash_attention(q, k, v, qp, kvp, **kw)
        want = ref.flash_attention_ref(q, k, v, qp, kvp, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite")
        rows = (qp >= 0)[:, :, None, None].expand_as(got)
        err, tol = max_err(got, want, rows), tolerance(want)
        errs[name] = err
        log(f"  flash_attention [{name}] q{tuple(q.shape)} k{tuple(k.shape)}"
            f" {dtype_name(q)} valid rows max|err| {err:.3e} (tol "
            f"{tol:.3g}); every row finite")
        check(err <= tol, f"flash {name}: {err} > {tol}")
    # the TPU kernel's right-aligned interface
    qa = torch.randn(1, 2, 17, 8, generator=gen, device=DEV)
    ka = torch.randn(1, 2, 33, 8, generator=gen, device=DEV)
    va = torch.randn(1, 2, 33, 8, generator=gen, device=DEV)
    for causal in (True, False):
        got = ops.flash_attention_aligned(qa, ka, va, causal=causal)
        want = F.scaled_dot_product_attention(
            qa, ka, va, attn_mask=None if not causal else
            torch.ones(17, 33, dtype=torch.bool, device=DEV).tril(16))
        err = max_err(got, want)
        log(f"  flash_attention_aligned [causal={causal}] vs SDPA max|err| "
            f"{err:.3e} (tol 2e-05)")
        check(err <= 2e-5, f"aligned flash causal={causal}: {err}")

    (q, k, v, qp, kvp), kw = main
    t_k = bench_ms(lambda: ops.flash_attention(q, k, v, qp, kvp, **kw))
    t_p = bench_ms(lambda: ref.flash_attention_ref(q, k, v, qp, kvp, **kw))
    G = q.shape[2] // k.shape[2]
    mask = (kvp[:, None, :] >= 0) & (kvp[:, None, :] <= qp[:, :, None])
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
    t_l = bench_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None]))
    nbytes, flops = flash_work(q, k, qp, kvp, kw.get("causal", True),
                               kw.get("window"))
    bnd, by = bound_ms(nbytes, flops, dtype_name(q))
    log(f"  flash_attention main path q{tuple(q.shape)} k{tuple(k.shape)}: "
        f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, SDPA(bool mask) "
        f"{t_l:.4f} ms, bound {bnd:.5f} ms ({by}, {nbytes} bytes)")
    rec["flash_attention"] = dict(
        max_abs_err=errs["main path"], ms=t_k, plain_ms=t_p, bound_ms=bnd,
        bound_by=by, library_ms=t_l)


def _topk_check(torch, ops, ref, q, d, k, name, tol=1e-5):
    s, i = ops.retrieval_topk(q, d, k)
    s2, i2 = ref.topk_ref(q, d, k)
    torch.cuda.synchronize()
    err = max_err(s, s2)
    same = i == i2
    if not bool(same.all()):
        # differing ids are only allowed where the plain scores tie within
        # tolerance (a different summation order may swap a near-tie)
        gap = (s2[:, :, None] - s2[:, None, :]).abs()
        near = ((gap <= 2 * tol) & ~torch.eye(k, dtype=torch.bool,
                                               device=s2.device)).any(-1)
        check(bool((same | near).all()), f"top-k {name}: ids differ")
    log(f"  retrieval_topk [{name}] Nq{q.shape[0]} Nd{d.shape[0]} "
        f"D{q.shape[1]} k{k} scores max|err| {err:.3e} (tol {tol:g}), ids "
        f"equal {int(same.sum())}/{same.numel()}")
    check(err <= tol, f"top-k {name}: {err} > {tol}")
    return s, i, err


def _topk_times(torch, ops, ref, q, d, k, label):
    t_k = bench_ms(lambda: ops.retrieval_topk(q, d, k))
    t_p = bench_ms(lambda: ref.topk_ref(q, d, k))
    t_l = bench_ms(lambda: torch.topk(q @ d.T, k))
    nbytes, flops = topk_work(q, d, k)
    bnd, by = bound_ms(nbytes, flops, "float32")
    log(f"  retrieval_topk {label} Nq{q.shape[0]} Nd{d.shape[0]} "
        f"D{q.shape[1]} k{k}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"topk(q@d.T) {t_l:.4f} ms, bound {bnd:.5f} ms ({by})")
    return t_k, t_p, t_l, bnd, by


def kernels_topk(torch, ops, ref, gen, main, rec) -> None:
    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device=DEV)
        return x / x.norm(dim=1, keepdim=True)

    if main is None:   # 8 questions against the 240-chunk corpus, k = 3
        main = ((unit(8, 256), unit(240, 256), 3), {})
    qm, dm, km = main[0]
    _, _, err_main = _topk_check(torch, ops, ref, qm, dm, km, "main path")
    base = torch.randn(6, 16, generator=gen, device=DEV)
    dup = torch.cat([base, base, base])          # ids i, i+6, i+12 tie
    s, i, _ = _topk_check(torch, ops, ref, base[:4] * 2.0, dup, 4, "ties")
    check(bool((i[:, 0] == torch.arange(4, device=DEV)).all())
          and bool((i[:, 1] == torch.arange(4, device=DEV) + 6).all()),
          "ties must go to the lowest doc id")
    s, i, _ = _topk_check(torch, ops, ref, unit(4, 8), unit(3, 8), 5,
                          "k > Nd")
    check(bool((i[:, 3:] == -1).all()) and bool((s[:, 3:] <= -1e29).all()),
          "k > Nd must fill (-1e30, -1)")
    _topk_check(torch, ops, ref, unit(33, 64), unit(4097, 64), 32, "ragged")
    qs, ds = unit(32, 256), unit(SHARD_DOCS, 256)
    _topk_check(torch, ops, ref, qs, ds, 5, "1M-doc shard")

    t_k, t_p, t_l, bnd, by = _topk_times(torch, ops, ref, qm, dm, km,
                                         "main path")
    _topk_times(torch, ops, ref, qs, ds, 5, "1M-doc shard")
    rec["retrieval_topk"] = dict(
        max_abs_err=err_main, ms=t_k, plain_ms=t_p, bound_ms=bnd,
        bound_by=by, library_ms=t_l)


def phase_kernels(torch, captured: dict, rec: dict) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)

    def main(name):
        if name not in captured:
            return None
        _, args, kw = captured[name]
        return args, kw

    kernels_paged(torch, F, ops, ref, gen, main("paged_decode_attention"),
                  rec)
    kernels_flash(torch, F, ops, ref, gen, main("flash_attention"), rec)
    kernels_topk(torch, ops, ref, gen, main("retrieval_topk"), rec)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def phase_parity(torch) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    docs, tok, enc, qs = _rag_setup(6)
    cfg = get_smoke_config("olmo-1b", vocab=len(tok))
    params_cpu = Model(cfg).init_params(seed=0, device="cpu")
    params_gpu = _to_device(params_cpu, "cuda")
    answers = {}
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        rag, _ = _rag(cfg, params, docs, tok, enc, dev, max_len=128,
                      chunk=8, block=8, batch=2, top_k=2, new_tokens=8)
        res = rag.answer(qs)
        answers[dev] = [r.answer for r in res]
        log(f"parity[{dev}]: prefix hits {rag.last_stats.prefix_hits}, "
            f"refills {rag.last_stats.refills}")
    check(answers["cuda"] == answers["cpu"],
          f"card and CPU answers differ:\n{answers}")
    log(f"parity: {len(qs)} smoke-config answers equal on card and CPU")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of " + ",".join(ALL_PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="trace one more slice pass with torch.profiler: "
                    "device busy share and device time by kernel")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in ALL_PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    rec, captured, launches = {}, {}, {}
    try:
        t_all = time.perf_counter()
        card = phase_card(torch)
        if "build" in phases:
            phase_build()
        if "slice" in phases:
            launches = phase_slice(torch, card, captured, args.profile)
        if "kernels" in phases:
            phase_kernels(torch, captured, rec)
        if "parity" in phases:
            phase_parity(torch)
        log(f"chip_smoke: phases {phases} passed in "
            f"{time.perf_counter() - t_all:.1f} s")
    except Exception:   # noqa: BLE001  (report any phase failure, exit 1)
        traceback.print_exc()
        return 1
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches.get(name, 0)}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            row[key] = rec.get(name, {}).get(key)
        kernels.append(row)
    log(card["smi"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
