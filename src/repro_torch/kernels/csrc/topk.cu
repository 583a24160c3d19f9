// Exact inner-product top-k retrieval, for sm_90a.
//
// Replaces: src/repro/kernels/topk_retrieval.py, topk_pallas (kernel
//   body _topk_kernel).
//
// queries [Nq, D] x docs [Nd, D] (f32) -> scores [Nq, k] f32 and doc ids
// [Nq, k] int32, ordered by (score desc, id asc): exact ties go to the
// lower id, as the TPU kernel's carried-first merge and lax.top_k do.
// When k > Nd the tail is (-1e30, -1).  1 <= k <= 32; any Nq, Nd, D.
//
// Bound: for the serving path's few queries, memory: the doc matrix,
// Nd*D*4 bytes, has to be read once, at 2*Nq flops per 4 bytes.  At Nq
// 32 the f32 FFMA rate (67 TFLOP/s) is about as tight as the memory
// rate: the kernel stays in f32 FFMA (TF32 would keep three digits and
// change which ids win).
//
// Design: one launch, plus a merge launch only when the docs are split.
//  - Grid (query group, doc split), split rule in ops.retrieval_topk_plan.
//    A block of 4 warps takes a group of kG = 32 queries, so a doc row is
//    read from device memory once per group: once per launch when Nq <=
//    32.
//  - Docs and the group's queries stream through a kStages ring of
//    [kTD docs + kG queries] x kKC dims in shared memory, filled with
//    16-byte cp.async (4-byte when D % 4 or a pointer forbids it) and
//    zero-filled past the split, the group and D, so the next chunk is in
//    flight while one is scored.  A 16-byte doc copy asks L2 for the
//    256-byte block around it: the even chunk of a row brings the odd
//    one.  A query chunk is read again per tile, from L2 (a quarter of
//    the doc bytes); keeping the queries resident measured slower on the
//    card.
//  - Scoring is an f32 FFMA register tile, no shuffles: warp w owns the
//    group's queries 8w..8w+7, lane l tile rows l + 32 j (j < 4); each
//    thread keeps 8x4 sums and reads float4s (a query's float4 is a
//    broadcast; doc rows are XOR-swizzled by 16-byte unit, so a
//    quarter-warp hits 8 distinct bank groups), the next 4 dims' reads
//    issued before the current 128 FFMA.  A split of at most
//    kSpreadTiles tiles for at most 8 queries is latency-bound: there
//    all 4 warps take the 8 queries and warp w rows l + 32 w.  Each
//    (query, doc) sum runs d = 0, 1, ..., D-1 as one fmaf chain,
//    whatever tile, lane or split the doc lands in, so equal doc rows get
//    bitwise-equal scores and exact ties go by id.
//  - Selection is warp-local: per (warp, query) a running threshold (the
//    list's k-th best) and a 64-entry candidate buffer in shared memory.
//    A score enters only if it beats the threshold under the (score, id)
//    order, at a slot given by a ballot; a buffer is sorted (a bitonic
//    network over shuffles) into its top-k when another 32 could
//    overflow it, and at the end, when spread warps' lists merge in warp
//    order.  A block takes 57,344 bytes of shared memory whatever D is.
//  - One split: the block writes the outputs.  Several: each block writes
//    a sorted partial list, and topk_merge_kernel takes the best k per
//    query over the splits' lists.  (score, id) is a total order over
//    distinct ids, so the result is unique; no atomics anywhere.
// The TPU kernel streams doc tiles through one sequential grid axis and
// re-sorts [k + tile] candidates per step; Hopper runs blocks in
// parallel, so the splits' lists merge in a second pass.

#include "common.cuh"

namespace {

constexpr int kMaxK = 32;
constexpr int kG = 32;            // queries per block (group)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQW = kG / kWarps;  // queries per warp
constexpr int kTD = 128;          // docs per tile
constexpr int kDL = kTD / 32;     // docs per lane
// chunk width and ring depth; chip_smoke.py --topk-sweep rebuilds with
// other values
#ifndef TOPK_KC
#define TOPK_KC 32
#endif
#ifndef TOPK_STAGES
#define TOPK_STAGES 2
#endif
constexpr int kKC = TOPK_KC;      // dims per chunk: a 128-byte row piece
constexpr int kStages = TOPK_STAGES;
constexpr int kCB = 64;           // candidate buffer per query
constexpr int kSpreadTiles = 4;  // a split this short spreads its docs
constexpr int kMergeThreads = 256;

// Shared-memory offset of float c of row r in a [rows][kKC] tile whose
// 16-byte units are XOR-swizzled by the row: unit u of row r sits at unit
// u ^ (r & 7), so the 8 lanes of a quarter-warp reading one unit of 8
// consecutive rows hit 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kKC + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

#ifndef TOPK_L2_256B
#define TOPK_L2_256B 1
#endif

// 16-byte global -> shared copy that also asks L2 to fetch the 256-byte
// block around the source: a doc row's next 128-byte piece, which the
// next ring step reads.  Zero-fills like rt::cp_async16.
__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src,
                                              int src_bytes) {
#if TOPK_L2_256B
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
          rt::smem_addr(dst)),
      "l"(src), "r"(src_bytes)
      : "memory");
#else
  rt::cp_async16(dst, src, src_bytes);
#endif
}

// Component c of v (c is a constant once the caller's loop is unrolled).
__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// (s1, i1) ranks before (s2, i2): higher score, then lower id; the -1
// fill id compares as the largest unsigned value, so fills rank last.
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  if (s1 != s2) return s1 > s2;
  return static_cast<unsigned>(i1) < static_cast<unsigned>(i2);
}

// Sort R candidate buffers at once (buffer r at bs + r * stride, its
// first cnt[r] <= 64 entries live) under better() and keep the best k of
// each, warp-wide: lane l holds entries l and l + 32 of every buffer
// (the rest filled with (-inf, -1), which rank last) in registers, a
// 64-entry bitonic network sorts them best first with xor shuffles (the
// R networks interleave, hiding the shuffles' latency), and lanes
// l < min(cnt[r], k) write entry l back.  cnt[r] becomes min(cnt[r], k).
template <int R>
__device__ __forceinline__ void sort_lists(float* bs, int* bi, int stride,
                                           int (&cnt)[R], int k, int lane) {
  __syncwarp();
  float s[R][2];
  int id[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = lane + 32 * h < cnt[r];
      s[r][h] = live ? bs[r * stride + lane + 32 * h] : -INFINITY;
      id[r][h] = live ? bi[r * stride + lane + 32 * h] : -1;
    }
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int step = size >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (step == 32) {   // entries l and l + 32: one lane holds both
          if (!better(s[r][0], id[r][0], s[r][1], id[r][1])) {
            const float ts = s[r][0];
            const int ti = id[r][0];
            s[r][0] = s[r][1];
            id[r][0] = id[r][1];
            s[r][1] = ts;
            id[r][1] = ti;
          }
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = lane + 32 * h;
          const float so = __shfl_xor_sync(0xffffffffu, s[r][h], step);
          const int io = __shfl_xor_sync(0xffffffffu, id[r][h], step);
          // the lower entry of a pair keeps the better one in a block
          // sorted best first, the worse one in a block sorted worst first
          const bool want_better = ((e & step) == 0) == ((e & size) == 0);
          if (better(so, io, s[r][h], id[r][h]) == want_better) {
            s[r][h] = so;
            id[r][h] = io;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cnt[r] = min(cnt[r], k);
    if (lane < cnt[r]) {
      bs[r * stride + lane] = s[r][0];
      bi[r * stride + lane] = id[r][0];
    }
  }
  __syncwarp();
}

// sort_lists for one buffer, out of line (the scan loop calls it from
// many unrolled places); returns the new count.
__device__ __noinline__ int reselect(float* bs, int* bi, int cnt, int k,
                                     int lane) {
  int c[1] = {cnt};
  sort_lists<1>(bs, bi, 0, c, k, lane);
  return c[0];
}

// Score one kKC-dim chunk: acc[r][j] += q row r . doc row j (rows j *
// 32 apart from ds, j < kNJ) for the warp's kQW queries (rows kKC apart
// from qs), over the chunk's dims in order.  The reads of the next
// 4 dims are issued before the FFMA of the current ones (two register
// sets, a and b); the loop stays rolled, so one warp alone re-runs a
// small body.  Each thread's doc rows have the same swizzle, lane & 7.
template <int kNJ>
__device__ __forceinline__ void score_chunk(float (&acc)[kQW][kDL],
                                            const float* ds, const float* qs,
                                            int lane) {
  auto read = [&](float4 (&qv)[kQW], float4 (&dv)[kNJ], int kk) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      dv[j] = *reinterpret_cast<const float4*>(
          ds + j * 32 * kKC + (((kk >> 2) ^ (lane & 7)) << 2));
#pragma unroll
    for (int r = 0; r < kQW; ++r)
      qv[r] = *reinterpret_cast<const float4*>(qs + r * kKC + kk);
  };
  // dim by dim, so 32 independent FFMA separate two of one chain
  auto fma4 = [&](const float4 (&qv)[kQW], const float4 (&dv)[kNJ]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < kQW; ++r)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          acc[r][j] = fmaf(part(qv[r], c), part(dv[j], c), acc[r][j]);
  };
  float4 qa[kQW], da[kNJ], qb[kQW], db[kNJ];
  read(qa, da, 0);
#pragma unroll 1
  for (int kk = 0; kk < kKC; kk += 8) {
    read(qb, db, kk + 4);
    fma4(qa, da);
    if (kk + 8 < kKC) read(qa, da, kk + 8);
    fma4(qb, db);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
topk_scan_kernel(const float* __restrict__ q, const float* __restrict__ docs,
                 float* __restrict__ dst_s, int* __restrict__ dst_i, int Nq,
                 int Nd, int D, int k, int docs_per_split, int n_splits) {
  const int q0 = blockIdx.x * kG;
  const int split = blockIdx.y;
  const int nq = min(kG, Nq - q0);
  const int d_begin = split * docs_per_split;
  const int d_end = min(Nd, d_begin + docs_per_split);
  const int nk = (D + kKC - 1) / kKC;
  const int n_tiles = d_end > d_begin ? (d_end - d_begin + kTD - 1) / kTD : 0;
  const int steps = n_tiles * nk;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ring = smem;                          // [S][kTD][kKC], swizzled
  float* q_s = ring + kStages * kTD * kKC;     // [S][kG][kKC]
  float* cand_s = q_s + kStages * kG * kKC;
  int* cand_i = reinterpret_cast<int*>(cand_s + kG * kCB);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  auto load = [&](int s) {
    const int st = s % kStages;
    const int row0 = d_begin + (s / nk) * kTD;
    const int col0 = (s % nk) * kKC;
    float* ds = ring + st * kTD * kKC;
    if (kVec) {
#pragma unroll
      for (int i = 0; i < kTD * kKC / 4 / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / (kKC / 4), c = (idx % (kKC / 4)) * 4;
        const bool ok = row0 + r < d_end && col0 + c < D;
        cp_async16_l2(ds + swz(r, c),
                      ok ? docs + (size_t)(row0 + r) * D + col0 + c : docs,
                      ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < kTD * kKC / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kKC, c = idx % kKC;
        const bool ok = row0 + r < d_end && col0 + c < D;
        rt::cp_async4(ds + swz(r, c),
                      ok ? docs + (size_t)(row0 + r) * D + col0 + c : docs,
                      ok ? 4 : 0);
      }
    }
    {   // the same chunk of the group's queries
      float* qs = q_s + st * kG * kKC;
      if (kVec) {
#pragma unroll
        for (int i = 0; i < kG * kKC / 4 / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int r = idx / (kKC / 4), c = (idx % (kKC / 4)) * 4;
          const bool ok = r < nq && col0 + c < D;
          rt::cp_async16(qs + r * kKC + c,
                         ok ? q + (size_t)(q0 + r) * D + col0 + c : q,
                         ok ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < kG * kKC / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int r = idx / kKC, c = idx % kKC;
          const bool ok = r < nq && col0 + c < D;
          rt::cp_async4(qs + r * kKC + c,
                        ok ? q + (size_t)(q0 + r) * D + col0 + c : q,
                        ok ? 4 : 0);
        }
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    rt::cp_async_commit();
  }

  // Warp roles.  In general warp w owns the group's queries 8w..8w+7 and
  // scores them against tile rows lane + 32 j (j < kDL).  A split of at
  // most kSpreadTiles tiles for at most kQW queries is latency-bound, so
  // there all warps take queries 0..7 and warp w rows lane + 32 w only;
  // each warp keeps its own lists, merged at the end in warp order.
  const bool spread = nq <= kQW && n_tiles <= kSpreadTiles;
  const int slice = spread ? 0 : warp;       // query slice: 8 slice + r
  const int nqw = max(0, min(kQW, nq - slice * kQW));
  const int nj = spread ? 1 : kDL;
  const int row = lane + (spread ? 32 * warp : 0);   // the first doc row
  float ts[kQW];
  int ti[kQW], cnt[kQW];
#pragma unroll
  for (int r = 0; r < kQW; ++r) {
    ts[r] = rt::kNegInf;
    ti[r] = -1;
    cnt[r] = 0;
  }
  float acc[kQW][kDL];
#pragma unroll
  for (int r = 0; r < kQW; ++r)
#pragma unroll
    for (int j = 0; j < kDL; ++j) acc[r][j] = 0.f;

  for (int s = 0; s < steps; ++s) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    rt::cp_async_commit();
    if (nqw == 0) continue;

    const int st = s % kStages;
    const int kc = s % nk;
    const float* ds = ring + st * kTD * kKC + row * kKC;
    const float* qs = q_s + (st * kG + slice * kQW) * kKC;
    if (spread)
      score_chunk<1>(acc, ds, qs, lane);
    else
      score_chunk<kDL>(acc, ds, qs, lane);
    if (kc != nk - 1) continue;

    // the tile is scored: offer its docs to the warp's queries
    const int base = d_begin + (s / nk) * kTD + row;
#pragma unroll
    for (int r = 0; r < kQW; ++r) {
      if (r >= nqw) break;
      float* bs = cand_s + (warp * kQW + r) * kCB;
      int* bi = cand_i + (warp * kQW + r) * kCB;
#pragma unroll
      for (int j = 0; j < kDL; ++j) {
        if (j >= nj) break;
        if (cnt[r] > kCB - 32) {
          cnt[r] = reselect(bs, bi, cnt[r], k, lane);
          if (cnt[r] == k) {
            ts[r] = bs[k - 1];
            ti[r] = bi[k - 1];
          }
        }
        const int doc = base + j * 32;
        const bool pass =
            doc < d_end && better(acc[r][j], doc, ts[r], ti[r]);
        const unsigned m = __ballot_sync(0xffffffffu, pass);
        if (pass) {
          const int pos = cnt[r] + __popc(m & ((1u << lane) - 1u));
          bs[pos] = acc[r][j];
          bi[pos] = doc;
        }
        cnt[r] += __popc(m);
      }
    }
#pragma unroll
    for (int r = 0; r < kQW; ++r)
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[r][j] = 0.f;
  }
  rt::cp_async_wait<0>();
  __syncthreads();   // the ring is free: it holds the lists' counts now

  // Each warp sorts its lists, all at once.  Then warp w writes the
  // results of the group's queries w, w + kWarps, ...; when spread, warp
  // 0's list of a query first takes in warps 1..3's in warp order: all
  // at once when the four fit one buffer (4k <= kCB), else one at a time
  // (at most 2k <= kCB entries).  (With this epilogue ptxas gives the scan
  // loop more registers, and it measured faster on the card than one that
  // spreads only when 4k <= kCB.)
  int* cnt_s = reinterpret_cast<int*>(ring);   // [kWarps][kQW]
  {
    int c[kQW];
#pragma unroll
    for (int r = 0; r < kQW; ++r) c[r] = r < nqw ? cnt[r] : 0;
    sort_lists<kQW>(cand_s + warp * kQW * kCB, cand_i + warp * kQW * kCB,
                    kCB, c, k, lane);
    if (lane == 0)
      for (int r = 0; r < kQW; ++r) cnt_s[warp * kQW + r] = c[r];
  }
  __syncthreads();
  auto append = [&](int qi, int n, int w) {   // warp w's list after n
    const int src = w * kQW + qi, m = cnt_s[src];
    if (lane < m) {
      cand_s[qi * kCB + n + lane] = cand_s[src * kCB + lane];
      cand_i[qi * kCB + n + lane] = cand_i[src * kCB + lane];
    }
    return n + m;
  };
  auto write = [&](int qi, int n) {
    if (lane < k) {
      const size_t o = n_splits == 1
                           ? (size_t)(q0 + qi) * k + lane
                           : ((size_t)(q0 + qi) * n_splits + split) * k + lane;
      dst_s[o] = lane < n ? cand_s[qi * kCB + lane] : rt::kNegInf;
      dst_i[o] = lane < n ? cand_i[qi * kCB + lane] : -1;
    }
  };
  if (spread && kWarps * k <= kCB) {   // queries warp and warp + 4
    int c[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int qi = warp + kWarps * t;
      c[t] = 0;
      if (qi >= nq) continue;
      c[t] = cnt_s[qi];
      for (int w = 1; w < kWarps; ++w) c[t] = append(qi, c[t], w);
    }
    sort_lists<2>(cand_s + warp * kCB, cand_i + warp * kCB, kWarps * kCB, c,
                  k, lane);
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (warp + kWarps * t < nq) write(warp + kWarps * t, c[t]);
    return;
  }
  for (int qi = warp; qi < nq; qi += kWarps) {
    // the list of warp qi / kQW, slot qi % kQW (warp 0 when spread)
    int n = cnt_s[qi];
    for (int w = 1; spread && w < kWarps; ++w)
      n = reselect(cand_s + qi * kCB, cand_i + qi * kCB, append(qi, n, w),
                   k, lane);
    write(qi, n);
  }
}

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, float* __restrict__ out_s,
                  int* __restrict__ out_i, int n_splits, int k) {
  const int qi = blockIdx.x;
  __shared__ float rs[kMergeThreads];
  __shared__ int ri[kMergeThreads];
  __shared__ int rw[kMergeThreads];
  extern __shared__ int head[];   // [n_splits] read cursor per list
  const int tid = threadIdx.x;
  const float* ps = part_s + (size_t)qi * n_splits * k;
  const int* pi = part_i + (size_t)qi * n_splits * k;
  for (int s = tid; s < n_splits; s += kMergeThreads) head[s] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float bs = rt::kNegInf;
    int bi = -1;
    int bw = -1;
    for (int s = tid; s < n_splits; s += kMergeThreads) {
      const int h = head[s];
      if (h >= k) continue;
      const float cs = ps[(size_t)s * k + h];
      const int c = pi[(size_t)s * k + h];
      if (bw < 0 || better(cs, c, bs, bi)) {
        bs = cs;
        bi = c;
        bw = s;
      }
    }
    rs[tid] = bs;
    ri[tid] = bi;
    rw[tid] = bw;
    __syncthreads();
    for (int o = kMergeThreads / 2; o > 0; o >>= 1) {
      if (tid < o && rw[tid + o] >= 0 &&
          (rw[tid] < 0 || better(rs[tid + o], ri[tid + o], rs[tid], ri[tid]))) {
        rs[tid] = rs[tid + o];
        ri[tid] = ri[tid + o];
        rw[tid] = rw[tid + o];
      }
      __syncthreads();
    }
    if (tid == 0) {
      out_s[(size_t)qi * k + j] = rs[0];
      out_i[(size_t)qi * k + j] = ri[0];
      if (rw[0] >= 0) ++head[rw[0]];
    }
    __syncthreads();
  }
}

// Shared memory of a scan block: the ring of doc and query chunks and
// the candidate buffers, whatever D is.
constexpr size_t kScanSmem =
    sizeof(float) * kStages * (kTD + kG) * kKC +
    (sizeof(float) + sizeof(int)) * kG * kCB;

template <bool kVec>
cudaError_t launch_scan(dim3 grid, cudaStream_t st, const float* q,
                        const float* docs, float* dst_s, int* dst_i, int Nq,
                        int Nd, int D, int k, int docs_per_split,
                        int n_splits) {
  auto kernel = topk_scan_kernel<kVec>;
  // once per device: all of the SM's 228 KB as shared memory, so that as
  // many blocks fit as the registers allow
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = rt::allow_smem(kernel, kScanSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  kernel<<<grid, kThreads, kScanSmem, st>>>(q, docs, dst_s, dst_i, Nq, Nd, D,
                                            k, docs_per_split, n_splits);
  return cudaGetLastError();
}

}  // namespace

// Docs [d*docs_per_split, (d+1)*docs_per_split) form split d (the split
// rule is ops.retrieval_topk_plan).  part_s/part_i: scratch of Nq *
// n_splits * k entries, unused (may be null) when n_splits == 1.
// Returns a cudaError_t code (0 = ok).
extern "C" int retrieval_topk(const void* queries, const void* docs,
                              void* part_s, void* part_i, void* out_s,
                              void* out_i, int Nq, int Nd, int D, int k,
                              int docs_per_split, int n_splits,
                              void* stream) {
  if (k < 1 || k > kMaxK || D < 1 || n_splits < 1 || docs_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* d = static_cast<const float*>(docs);
  const bool one = n_splits == 1;
  float* dst_s = static_cast<float*>(one ? out_s : part_s);
  int* dst_i = static_cast<int*>(one ? out_i : part_i);
  const bool vec = D % 4 == 0 && rt::aligned16(q) && rt::aligned16(d);
  const dim3 grid((Nq + kG - 1) / kG, n_splits);
  const cudaError_t err =
      vec ? launch_scan<true>(grid, st, q, d, dst_s, dst_i, Nq, Nd, D, k,
                              docs_per_split, n_splits)
          : launch_scan<false>(grid, st, q, d, dst_s, dst_i, Nq, Nd, D, k,
                               docs_per_split, n_splits);
  if (err != cudaSuccess || one) return static_cast<int>(err);
  const size_t smem2 = sizeof(int) * n_splits;
  const cudaError_t err2 = rt::allow_smem(topk_merge_kernel, smem2);
  if (err2 != cudaSuccess) return static_cast<int>(err2);
  topk_merge_kernel<<<Nq, kMergeThreads, smem2, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_splits, k);
  return static_cast<int>(cudaGetLastError());
}
