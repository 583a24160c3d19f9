// The scan core of the IVF probe kernels (csrc/ivf_topk.cu for k <= 32,
// csrc/ivf_select.cu above): block (l, s, z) of a (list, split, group
// block) grid finds the (query, probe) pairs that name list l in the probe
// table, in groups of kG, and streams the live span of split s's rows
// once per group through a cp.async ring in shared memory into an f32
// FFMA register tile.  What a kernel does with the scores is its sink's:
// after each tile the sink gets the tile's scores of the warp's pairs, and
// after the group's last tile the block is the sink's (csrc/ivf_topk.cu
// keeps a partial top-k per pair; csrc/ivf_select.cu writes every score
// to a matrix).  Each (query, row) score is one fmaf chain over d = 0,
// 1, ..., D-1 whatever split, tile, lane or group the row lands in, so a
// document held in two lists or scored by two groups, and the two
// kernels, give bitwise-equal scores.  The design notes are
// csrc/ivf_topk.cu's.
#pragma once

#include "common.cuh"

namespace {

constexpr int kG = 32;            // (query, probe) pairs per group
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQW = kG / kWarps;  // pairs per warp slice
constexpr int kTD = 128;          // rows per tile
constexpr int kDL = kTD / 32;     // rows per lane, at most
// chunk width and ring depth; chip_smoke.py --ivf-sweep rebuilds with
// other values
#ifndef IVF_KC
#define IVF_KC 32
#endif
#ifndef IVF_STAGES
#define IVF_STAGES 4
#endif
constexpr int kKC = IVF_KC;       // dims per chunk: a 128-byte row piece
constexpr int kStages = IVF_STAGES;
constexpr int kScanPer = 8;       // probe-table entries per thread a step
// Shared memory of the ring of row and query chunks, at the start of the
// scan kernels' dynamic shared memory.
constexpr size_t kRingSmem = sizeof(float) * kStages * (kTD + kG) * kKC;

// Shared-memory offset of float c of row r in a [rows][kKC] tile whose
// 16-byte units are XOR-swizzled by the row (see csrc/topk.cu).
__device__ __forceinline__ int swz(int r, int c) {
  return r * kKC + (((c >> 2) ^ (r & 7)) << 2) + (c & 3);
}

#ifndef IVF_L2_256B
#define IVF_L2_256B 1
#endif

// 16-byte global -> shared copy that also asks L2 for the 256-byte block
// around the source (a row's next 128-byte piece).  Zero-fills like
// rt::cp_async16.
__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src,
                                              int src_bytes) {
#if IVF_L2_256B
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
          rt::smem_addr(dst)),
      "l"(src), "r"(src_bytes)
      : "memory");
#else
  rt::cp_async16(dst, src, src_bytes);
#endif
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// acc[r][j] += pair row r . tile row j (r < kQ pair rows, rows j * 32
// apart from ds, j < kNJ) over one kKC-dim chunk, dims in order; the next
// 4 dims' reads are issued before the current FFMA (as in csrc/topk.cu).
// A warp whose slice holds fewer than 8 pairs reads only kQ query rows.
template <int kQ, int kNJ>
__device__ __forceinline__ void score_chunk(float (&acc)[kQW][kDL],
                                            const float* ds, const float* qs,
                                            int lane) {
  auto read = [&](float4 (&qv)[kQ], float4 (&dv)[kNJ], int kk) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      dv[j] = *reinterpret_cast<const float4*>(
          ds + j * 32 * kKC + (((kk >> 2) ^ (lane & 7)) << 2));
#pragma unroll
    for (int r = 0; r < kQ; ++r)
      qv[r] = *reinterpret_cast<const float4*>(qs + r * kKC + kk);
  };
  auto fma4 = [&](const float4 (&qv)[kQ], const float4 (&dv)[kNJ]) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < kQ; ++r)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          acc[r][j] = fmaf(part(qv[r], c), part(dv[j], c), acc[r][j]);
  };
  float4 qa[kQ], da[kNJ], qb[kQ], db[kNJ];
  read(qa, da, 0);
#pragma unroll 1
  for (int kk = 0; kk < kKC; kk += 8) {
    read(qb, db, kk + 4);
    fma4(qa, da);
    if (kk + 8 < kKC) read(qa, da, kk + 8);
    fma4(qb, db);
  }
}

// Block-wide, uniform: the pairs (flat index q * nprobe + p into the
// probe table of `total` entries) that name list l, of rank [g * kG, g *
// kG + kG) in table order, into pair_s; returns how many.  The scan goes
// from (pos, seen) -- table position and matches before it -- and leaves
// them at the step that held the group's end, where the block's next
// group resumes.
__device__ int find_pairs(const int* __restrict__ probe, int total, int l,
                          int g, int& pos, int& seen, int* pair_s,
                          int* warp_cnt, int tid) {
  const int lo = g * kG, hi = lo + kG;
  const int lane = tid & 31, warp = tid >> 5;
  int step_pos = pos, step_seen = seen;
  while (pos < total && seen < hi) {
    const int base = pos + tid * kScanPer;
    unsigned mask = 0;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i)
      if (base + i < total && probe[base + i] == l) mask |= 1u << i;
    const int c = __popc(mask);
    int inc = c;   // inclusive prefix over the warp's lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    if (lane == 31) warp_cnt[warp] = inc;
    __syncthreads();
    int r = seen + inc - c, step_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) r += warp_cnt[w];
      step_total += warp_cnt[w];
    }
    while (mask) {
      const int i = __ffs(mask) - 1;
      mask &= mask - 1;
      if (r >= lo && r < hi) pair_s[r - lo] = base + i;
      ++r;
    }
    __syncthreads();
    step_pos = pos;
    step_seen = seen;
    pos += kThreads * kScanPer;
    seen += step_total;
  }
  const int n = min(seen, hi) - lo;
  pos = step_pos;
  seen = step_seen;
  return max(0, n);
}

// Before a scan kernel's first launch on a device: its dynamic shared
// memory above 48 KB, and all of the SM's carveout for shared memory.
template <auto kernel>
cudaError_t prepare_scan(size_t smem_bytes) {
  static bool ready[64] = {};   // once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  err = rt::allow_smem(kernel, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

// A group as the block's warps see it: the sink reads its pairs and the
// warp roles from here.
struct ScanGroup {
  int n;              // pairs in the group
  const int* pair_s;  // their flat probe-table indices (shared memory)
  int slice;          // the warp's slice: pairs slice * kQW + r, r < nqw
  int nqw;
  int nwp;            // warps per slice
  int nj;             // rows a lane scores of a tile: lane + 32 (part nj + j)
  int hi;             // the end of the split's live span
};

// The scan of block (blockIdx.x = list l, .y = split, .z = group block)
// over the groups g = z, z + group_blocks, ... of the pairs that name l.
// smem: the kernel's dynamic shared memory, whose first kRingSmem bytes
// hold the ring.  The sink's calls: begin(g) before a group's tiles;
// tile(g, acc, base, live, lane) once a tile is scored, acc[r][j] the
// score of pair slice * kQW + r (r < nqw) on slot base + 32 j (j < nj),
// live[j] whether that slot holds a document; end(g, tid) once the
// ring is drained and the block has met at a barrier (the ring is then
// the sink's scratch), with a barrier after it.
template <bool kVec, class Sink>
__device__ __forceinline__ void ivf_scan(const float* __restrict__ q,
                                         const float* __restrict__ list_emb,
                                         const int* __restrict__ list_ids,
                                         const int* __restrict__ probe_ids,
                                         int Nq, int L, int D, int nprobe,
                                         int rows_per_split, int group_blocks,
                                         float* smem, Sink& sink) {
  const int l = blockIdx.x;
  const int split = blockIdx.y;
  const int total = Nq * nprobe;
  const int nk = (D + kKC - 1) / kKC;

  float* ring = smem;                          // [S][kTD][kKC], swizzled
  float* q_s = ring + kStages * kTD * kKC;     // [S][kG][kKC]
  __shared__ int pair_s[kG];    // the group's pairs, flat probe index
  __shared__ int grp_q[kG];     // and their queries
  __shared__ int warp_cnt[kWarps];
  __shared__ int span_w[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* ids = list_ids + (size_t)l * L;
  const float* emb = list_emb + (size_t)l * L * D;
  const int r_begin = split * rows_per_split;
  const int r_end = min(L, r_begin + rows_per_split);

  int pos = 0, seen = 0;
  int lo = -1, hi = -1;   // the split's live span, once the block has work
  for (int g = blockIdx.z;; g += group_blocks) {
    const int n = find_pairs(probe_ids, total, l, g, pos, seen, pair_s,
                             warp_cnt, tid);
    if (n == 0) return;
    if (tid < n) grp_q[tid] = pair_s[tid] / nprobe;
    if (lo < 0) {
      // first and last live slot of the split: only that span is read
      int a = r_end, b = r_begin - 1;
#pragma unroll 8
      for (int r = r_begin + tid; r < r_end; r += kThreads)
        if (ids[r] >= 0) {
          a = min(a, r);
          b = max(b, r);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a = min(a, __shfl_xor_sync(0xffffffffu, a, o));
        b = max(b, __shfl_xor_sync(0xffffffffu, b, o));
      }
      if (lane == 0) {
        span_w[0][warp] = a;
        span_w[1][warp] = b;
      }
      __syncthreads();
      a = span_w[0][0];
      b = span_w[1][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        a = min(a, span_w[0][w]);
        b = max(b, span_w[1][w]);
      }
      lo = b >= a ? a : r_begin;
      hi = b >= a ? b + 1 : r_begin;
    }
    __syncthreads();   // grp_q

    const int n_tiles = (hi - lo + kTD - 1) / kTD;
    const int steps = n_tiles * nk;
    auto load = [&](int s) {
      const int st = s % kStages;
      const int row0 = lo + (s / nk) * kTD;
      const int col0 = (s % nk) * kKC;
      float* ds = ring + st * kTD * kKC;
      float* qs = q_s + st * kG * kKC;
      if (kVec) {
#pragma unroll
        for (int i = 0; i < kTD * kKC / 4 / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int r = idx / (kKC / 4), c = (idx % (kKC / 4)) * 4;
          const bool ok = row0 + r < hi && col0 + c < D;
          cp_async16_l2(ds + swz(r, c),
                        ok ? emb + (size_t)(row0 + r) * D + col0 + c : emb,
                        ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < kG * kKC / 4 / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int r = idx / (kKC / 4), c = (idx % (kKC / 4)) * 4;
          const bool ok = r < n && col0 + c < D;
          rt::cp_async16(qs + r * kKC + c,
                         ok ? q + (size_t)grp_q[r] * D + col0 + c : q,
                         ok ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < kTD * kKC / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int r = idx / kKC, c = idx % kKC;
          const bool ok = row0 + r < hi && col0 + c < D;
          rt::cp_async4(ds + swz(r, c),
                        ok ? emb + (size_t)(row0 + r) * D + col0 + c : emb,
                        ok ? 4 : 0);
        }
#pragma unroll 4
        for (int i = 0; i < kG * kKC / kThreads; ++i) {
          const int idx = tid + i * kThreads;
          const int r = idx / kKC, c = idx % kKC;
          const bool ok = r < n && col0 + c < D;
          rt::cp_async4(qs + r * kKC + c,
                        ok ? q + (size_t)grp_q[r] * D + col0 + c : q,
                        ok ? 4 : 0);
        }
      }
    };

    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load(s);
      rt::cp_async_commit();
    }

    // Warp roles by the group's size: qsl slices of 8 pairs, nwp = 4 / qsl
    // warps per slice.  Warp w takes slice w / nwp and, of each tile, the
    // rows lane + 32 (part * nj + j), j < nj = qsl, part = w % nwp: every
    // warp scores, so a ring step's FFMA are spread over the 4 warps (one
    // warp scoring a whole tile for 8 pairs measured slower on the card).
    const int qsl = n <= kQW ? 1 : n <= 2 * kQW ? 2 : 4;
    const int nwp = kWarps / qsl;
    const int slice = warp / nwp;
    const int nqw = max(0, min(kQW, n - slice * kQW));
    const int nj = qsl;
    const int row = lane + 32 * (warp % nwp) * nj;
    const ScanGroup grp{n, pair_s, slice, nqw, nwp, nj, hi};
    sink.begin(grp);
    float acc[kQW][kDL];
#pragma unroll
    for (int r = 0; r < kQW; ++r)
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[r][j] = 0.f;
    int live[kDL];   // the tile's ids are live: read at its first step

    for (int s = 0; s < steps; ++s) {
      rt::cp_async_wait<kStages - 2>();
      __syncthreads();
      if (s + kStages - 1 < steps) load(s + kStages - 1);
      rt::cp_async_commit();
      if (nqw == 0) continue;

      const int base = lo + (s / nk) * kTD + row;
      if (s % nk == 0) {
#pragma unroll
        for (int j = 0; j < kDL; ++j)
          live[j] = j < nj && base + j * 32 < hi && ids[base + j * 32] >= 0;
      }
      const int st = s % kStages;
      const float* ds = ring + st * kTD * kKC + row * kKC;
      const float* qs = q_s + (st * kG + slice * kQW) * kKC;
      if (nj == 2)
        score_chunk<kQW, 2>(acc, ds, qs, lane);
      else if (nj == kDL)
        score_chunk<kQW, kDL>(acc, ds, qs, lane);
      else if (nqw > kQW / 2)
        score_chunk<kQW, 1>(acc, ds, qs, lane);
      else if (nqw > kQW / 4)
        score_chunk<kQW / 2, 1>(acc, ds, qs, lane);
      else if (nqw > 1)
        score_chunk<2, 1>(acc, ds, qs, lane);
      else
        score_chunk<1, 1>(acc, ds, qs, lane);
      if (s % nk != nk - 1) continue;
      sink.tile(grp, acc, base, live, lane);
#pragma unroll
      for (int r = 0; r < kQW; ++r)
#pragma unroll
        for (int j = 0; j < kDL; ++j) acc[r][j] = 0.f;
    }
    rt::cp_async_wait<0>();
    __syncthreads();   // the ring is free: the sink's scratch now
    sink.end(grp, tid);
    __syncthreads();   // pair_s, grp_q and the ring are reused
  }
}

}  // namespace
