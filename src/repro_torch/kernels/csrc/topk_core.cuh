// The scan core of the exact top-k kernels (csrc/topk.cu for k <= 32,
// csrc/topk_list.cu above): a ring of doc and query chunks in shared
// memory filled with cp.async, an f32 FFMA register tile and the (score,
// id) order.  Both kernels run blocks of kWarps warps over tiles of kTD
// docs; a block takes a group of kWarps * kQW queries (kQW per warp).
// Each (query, doc) score is one fmaf chain over d = 0, 1, ..., D-1 in
// both, so the two give bitwise-equal scores and exact ties go by id
// alike.
#pragma once

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
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

// Score one kKC-dim chunk: acc[r][j] += q row r . doc row j (rows j *
// 32 apart from ds, j < kNJ) for the warp's kQW queries (rows kKC apart
// from qs), over the chunk's dims in order.  The reads of the next
// 4 dims are issued before the FFMA of the current ones (two register
// sets, a and b); the loop stays rolled, so one warp alone re-runs a
// small body.  Each thread's doc rows have the same swizzle, lane & 7.
template <int kQW, int kNJ>
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

// Issue ring step s's copies: chunk s % nk (kKC dims) of tile s / nk of
// the split's docs [d_begin, d_end) into ring stage s % kStages (rows
// swizzled), and the same chunk of the group's kG queries from q0 (nq of
// them) beside it, zero-filled past the split, the group and D.  16-byte
// cp.async when kVec (D % 4 == 0, aligned pointers), else 4-byte.
template <bool kVec, int kG>
__device__ __forceinline__ void load_stage(float* ring, float* q_s,
                                           const float* q, const float* docs,
                                           int s, int nk, int d_begin,
                                           int d_end, int q0, int nq, int D,
                                           int tid) {
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
  float* qs = q_s + st * kG * kKC;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < (kG * kKC / 4 + kThreads - 1) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      if (kG * kKC / 4 % kThreads != 0 && idx >= kG * kKC / 4) break;
      const int r = idx / (kKC / 4), c = (idx % (kKC / 4)) * 4;
      const bool ok = r < nq && col0 + c < D;
      rt::cp_async16(qs + r * kKC + c,
                     ok ? q + (size_t)(q0 + r) * D + col0 + c : q,
                     ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < (kG * kKC + kThreads - 1) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      if (kG * kKC % kThreads != 0 && idx >= kG * kKC) break;
      const int r = idx / kKC, c = idx % kKC;
      const bool ok = r < nq && col0 + c < D;
      rt::cp_async4(qs + r * kKC + c,
                    ok ? q + (size_t)(q0 + r) * D + col0 + c : q,
                    ok ? 4 : 0);
    }
  }
}

}  // namespace
