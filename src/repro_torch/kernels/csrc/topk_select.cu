// Exact inner-product top-k retrieval above k 32, for sm_90a: every score
// written once, an exact radix select of each query's k-th, and a sort of
// the k winners.  (csrc/topk.cu keeps k <= 32; ops.topk_route sends
// csrc/topk_list.cu the small corpora and single queries where its lists
// of k cost less, this kernel the rest and every k > 6176; it serves any
// k.)
//
// Replaces, for those shapes: src/repro/kernels/topk_retrieval.py, topk_pallas
//   (kernel body _topk_kernel), whose lax.top_k over [carried best +
//   tile] serves any k.
//
// queries [Nq, D] x docs [Nd, D] (f32) -> scores [Nq, k] f32 and doc ids
// [Nq, k] int32, ordered by (score desc, id asc); when k > Nd the tail is
// (-1e30, -1).  Any Nq, Nd, D, k.  The contract of csrc/topk.cu, exactly.
//
// Bound: as csrc/topk.cu's: the doc matrix, Nd*D*4 bytes, read once, at
// 2*Nq flops per 4 bytes (at Nq 32 the f32 FFMA rate is about as tight
// as the memory rate).  This design also writes each score once and reads
// it back four times (4 * Nq * Nd * 4 bytes: 0.6 GB at Nq 32 and 1M
// docs, against the 1 GB doc matrix), which a list in shared memory
// avoids but cannot hold at this k.
//
// Design: per chunk of queries (ops.retrieval_topk_select_plan keeps the
// scratch under a byte limit), nine launches and one per merge level.
//  - Scan.  Grid (query group of kG = 32, doc split) from
//    ops.retrieval_topk_plan, so each doc row is read once per group.
//    Scoring is topk.cu's core (csrc/topk_core.cuh: the cp.async ring and
//    the f32 FFMA register tile; one fmaf chain over d = 0 .. D-1 per
//    (query, doc), so the scores are bitwise those of topk.cu and
//    topk_list.cu).  Every score goes to a scratch S [queries, ld] (ld =
//    Nd rounded up to 4); lane l holds rows l + 32 j, so a warp's stores
//    of one query are 128 contiguous bytes.
//  - Select.  A score s becomes a 32-bit key u(s) whose unsigned order is
//    the score order (-0.0 first becomes +0.0: the two compare equal, so
//    their ties go by id).  Each query's k-th key tau is found digit by
//    digit, 11 + 11 + 10 bits from the top.  A round is a histogram
//    launch over (select chunk, query), in shared memory (integer
//    atomics, so the counts do not depend on their order), of the digit
//    of the keys that carry the prefix found so far, written per chunk;
//    then a launch of one block per query sums the chunks' histograms,
//    picks the digit that holds the k-th key, and adds to each chunk's
//    count of keys above tau its keys in the higher digits.  Every round
//    reads S again: the first digit of unit vectors' scores (sign and
//    exponent) puts most keys in a few bins, so little would be dropped
//    by compacting early.
//  - Gather.  Over (select chunk, query): the c keys above tau fill slots
//    [0, c), a chunk's in the range after the earlier chunks'; the first
//    k - c keys equal to tau in doc order fill slots [c, k), so ties at
//    tau go to the lower id.  Where a chunk's range is taken whole, its
//    keys take its slots in any order, from a counter in shared memory
//    that a warp bumps once for all its keys; only the one chunk whose
//    ties straddle k ranks its keys in doc order, by a block-wide scan of
//    each pass's counts.
//  - Sort.  Runs of kRun = 2048 entries are bitonic-sorted in shared
//    memory, one block of a thread per pair a run, best first under
//    (score desc, id asc).  One run writes the outputs and the fill tail
//    at once; else pairwise rank merges in device memory, one launch a
//    level, double the run length each: an entry lands at its index plus
//    the entries of the sibling run that rank before it (ties to the
//    earlier run).  (score, id) is a total order over distinct ids, so a
//    merge is a bijection onto its positions, and the output does not
//    depend on the order the gather filled the slots in: two calls give
//    bitwise-equal results.
// The TPU kernel carries the best k per query through its sequential
// grid; here blocks run in parallel, so the work is cut into passes over
// S, each spread over the card.
// The select, gather, sort and merge kernels are csrc/select_core.cuh's,
// shared with csrc/ivf_select.cu.

#include <limits.h>

#include <algorithm>

#include "select_core.cuh"
#include "topk_core.cuh"

namespace {

constexpr int kG = 32;              // queries per scan block (group)
constexpr int kQW = kG / kWarps;    // queries per warp

// Scores of the group's queries against the split's docs, each written
// to S [Nq, ld].  The ring, the swizzle, the tile and the spread warps of
// a group of at most kQW queries are csrc/topk_list.cu's scan.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
select_scan_kernel(const float* __restrict__ q,
                   const float* __restrict__ docs, float* __restrict__ S,
                   int Nq, int Nd, int D, size_t ld, int docs_per_split) {
  const int q0 = blockIdx.x * kG;
  const int nq = min(kG, Nq - q0);
  const int d_begin = blockIdx.y * docs_per_split;
  const int d_end = min(Nd, d_begin + docs_per_split);
  const int nk = (D + kKC - 1) / kKC;
  const int n_tiles =
      d_end <= d_begin ? 0 : (d_end - d_begin + kTD - 1) / kTD;
  const int steps = n_tiles * nk;

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [S][kTD][kKC], swizzled
  float* q_s = ring + kStages * kTD * kKC;         // [S][kG][kKC]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<kVec, kG>(ring, q_s, q, docs, s, nk, d_begin, d_end, q0,
                           nq, D, tid);
    rt::cp_async_commit();
  }
  // Warp w scores queries kQW w + r against tile rows lane + 32 j; when
  // the group holds at most kQW queries, every warp takes them all and
  // warp w rows lane + 32 w only.
  const bool spread = nq <= kQW;
  const int slice = spread ? 0 : warp;
  const int nqw = max(0, min(kQW, nq - slice * kQW));
  const int nj = spread ? 1 : kDL;
  const int row = lane + (spread ? 32 * warp : 0);
  float acc[kQW][kDL];
#pragma unroll
  for (int r = 0; r < kQW; ++r)
#pragma unroll
    for (int j = 0; j < kDL; ++j) acc[r][j] = 0.f;

  for (int s = 0; s < steps; ++s) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps)
      load_stage<kVec, kG>(ring, q_s, q, docs, s + kStages - 1, nk, d_begin,
                           d_end, q0, nq, D, tid);
    rt::cp_async_commit();
    if (nqw == 0) continue;

    const int st = s % kStages;
    const float* ds = ring + st * kTD * kKC + row * kKC;
    const float* qs = q_s + (st * kG + slice * kQW) * kKC;
    if (spread)
      score_chunk<kQW, 1>(acc, ds, qs, lane);
    else
      score_chunk<kQW, kDL>(acc, ds, qs, lane);
    if (s % nk != nk - 1) continue;

    const int base = d_begin + (s / nk) * kTD + row;
#pragma unroll
    for (int r = 0; r < kQW; ++r) {
      if (r >= nqw) break;
      float* dst = S + static_cast<size_t>(q0 + slice * kQW + r) * ld;
#pragma unroll
      for (int j = 0; j < kDL; ++j) {
        if (j >= nj) break;
        const int doc = base + 32 * j;
        if (doc < d_end) dst[doc] = acc[r][j];
      }
    }
#pragma unroll
    for (int r = 0; r < kQW; ++r)
#pragma unroll
      for (int j = 0; j < kDL; ++j) acc[r][j] = 0.f;
  }
  rt::cp_async_wait<0>();
}

size_t scan_smem() {
  return sizeof(float) * kStages * (kTD + kG) * kKC;
}

}  // namespace

// Queries [q0, q0 + chunk_q) form a chunk; in a chunk, docs
// [d * docs_per_split, (d + 1) * docs_per_split) form scan split d and
// [c * sel_per, (c + 1) * sel_per) select chunk c (sel_per a multiple
// of 4); the rule is ops.retrieval_topk_select_plan.  Scratch: scores
// chunk_q * ld floats (ld = Nd rounded up to 4), work
// sel::work_ints(chunk_q, n_sel) ints, cand 2 * chunk_q * min(k, Nd)
// 8-byte entries.  Returns a cudaError_t code (0 = ok).
extern "C" int retrieval_topk_select(const void* queries, const void* docs,
                                     void* scores, void* work, void* cand,
                                     void* out_s, void* out_i, int Nq, int Nd,
                                     int D, int k, int chunk_q,
                                     int docs_per_split, int n_splits,
                                     int n_sel, int sel_per, void* stream) {
  if (Nq < 1 || Nd < 0 || D < 1 || k < 1 || chunk_q < 1 ||
      chunk_q > 65535 || docs_per_split < 1 || n_splits < 1 ||
      n_splits > 65535 || n_sel < 1 || sel_per < 4 || sel_per % 4 != 0 ||
      Nd > INT_MAX - sel_per ||
      static_cast<long long>(n_splits) * docs_per_split < Nd ||
      static_cast<long long>(n_sel) * sel_per < Nd)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* d = static_cast<const float*>(docs);
  float* S = static_cast<float*>(scores);
  const size_t ld = (static_cast<size_t>(Nd) + 3) / 4 * 4;
  sel::Entry* ca = static_cast<sel::Entry*>(cand);
  sel::Entry* cb = ca + static_cast<size_t>(chunk_q) * std::min(k, Nd);
  const bool vec = D % 4 == 0 && rt::aligned16(q) && rt::aligned16(d);
  for (int q0 = 0; q0 < Nq; q0 += chunk_q) {
    const int nq = std::min(chunk_q, Nq - q0);
    float* os = static_cast<float*>(out_s) + static_cast<size_t>(q0) * k;
    int* oi = static_cast<int*>(out_i) + static_cast<size_t>(q0) * k;
    if (Nd > 0) {
      const dim3 grid((nq + kG - 1) / kG, n_splits);
      const float* qc = q + static_cast<size_t>(q0) * D;
      if (vec)
        select_scan_kernel<true><<<grid, kThreads, scan_smem(), st>>>(
            qc, d, S, nq, Nd, D, ld, docs_per_split);
      else
        select_scan_kernel<false><<<grid, kThreads, scan_smem(), st>>>(
            qc, d, S, nq, Nd, D, ld, docs_per_split);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const cudaError_t err = sel::select_topk(
        st, S, ld, nq, Nd, k, chunk_q, n_sel, sel_per,
        static_cast<int*>(work), ca, cb, os, oi, sel::SameId{});
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
