// IVF probe top-k retrieval from k 16, for sm_90a: each probed list's
// live rows scored once per group of the (query, probe) pairs that name
// it, every score written to a matrix, then the exact radix select, gather
// and sort of csrc/topk_select.cu.  (ops.ivf_route keeps k < 16 on
// csrc/ivf_topk.cu, where its selection costs less than these passes;
// this kernel serves any k.)
//
// Replaces, from k 16: src/repro/kernels/topk_retrieval.py,
//   ivf_topk_pallas (kernel body _ivf_topk_kernel), whose lax.top_k over
//   [carried best + tile] serves any k.
//
// queries [Nq, D] f32 x list_emb [n_lists, L, D] f32 with list_ids
// [n_lists, L] int32 (-1 = padding slot, anywhere in a row) and probe_ids
// [Nq, nprobe] int32 -> scores [Nq, k] f32 and global doc ids [Nq, k]
// int32: the top-k of the concatenation of each query's probed lists in
// probe order, ordered by (score desc, probe rank asc, slot asc); a list
// named twice is seen twice, a probe id outside [0, n_lists) probes an
// empty list, and slots past the probed documents are (-1e30, -1).  The
// contract of csrc/ivf_topk.cu, exactly, for any k >= 1.
//
// Bound: memory at the serving path's few queries: the live rows of the
// probed lists read once, at 2 flops per 4 bytes per (query, probe) that
// names the list.  The scan reads each list's live span once per group
// of 32 pairs, as csrc/ivf_topk.cu's does.  This design also writes the
// score matrix S [Nq, nprobe * L] (a fill, then the scores) and reads it
// back four times (4 * 4 * Nq * nprobe * L bytes), which a list of width
// k in shared memory avoids but cannot hold at large k.
//
// Design: per chunk of queries (ops.ivf_retrieval_topk_select_plan keeps
// the scratch under a byte limit):
//  - Fill.  -inf over the chunk's rows of S [chunk_q, ld] (ld = nprobe * L
//    rounded up to 4): the slots the scan never writes (outside a list's
//    live span, padding, probe ids outside the lists) stay -inf.
//  - Scan.  csrc/ivf_core.cuh's, grid (list, split, group block) from
//    ops.ivf_retrieval_topk_plan, so each probed list's live rows are read
//    once per group of 32 pairs, not once per query.  Its sink writes the
//    score of pair (q, p) on slot `slot` to S[q, p * L + slot], and -inf
//    for a -1 slot inside the span; a warp's stores of one pair are 128
//    contiguous bytes.  The score is one fmaf chain over d = 0 .. D-1, as
//    in csrc/ivf_topk.cu, so the two kernels' scores are bitwise equal.
//  - Select.  csrc/select_core.cuh's three radix rounds, gather, sort runs
//    and merge levels over each row of S, nprobe * L candidates, k_eff =
//    min(k, nprobe * L).  A candidate's key is its column c = p * L + slot,
//    and the select breaks ties by the lowest column: by probe rank, then
//    slot, the IVF contract.  The last sort or merge launch writes each
//    entry through a map: score -inf becomes (-1e30, -1), any other column
//    c the doc id list_ids[probe_ids[q, c / L], c % L].
//  - A query of at most kRun candidates skips the select: one block a
//    query sorts its whole row of S in shared memory and writes the mapped
//    outputs, so such a call is three launches (fill, scan, sort).
// No atomics whose order reaches a result: two calls on the same inputs
// are bitwise equal.
// The TPU kernel carries each query's best k through its sequential grid
// of (query, probe) steps; here the scan reads a list once for a group of
// pairs, and the selection runs as passes over S spread over the card.

#include <limits.h>

#include <algorithm>

#include "ivf_core.cuh"
#include "select_core.cuh"

namespace {

constexpr int kFillThreads = 256;

// Column c of query qi's row -> (score, doc id); -inf -> the fill.
struct IvfIds {
  const int* list_ids;
  const int* probe;   // the chunk's rows of probe_ids
  int L, nprobe;
  __device__ __forceinline__ sel::Entry operator()(
      int qi, const sel::Entry& e) const {
    if (e.s == -INFINITY) return sel::Entry{rt::kNegInf, -1};
    const int p = e.i / L;
    const int l = probe[static_cast<size_t>(qi) * nprobe + p];
    return sel::Entry{e.s, list_ids[static_cast<size_t>(l) * L + e.i - p * L]};
  }
};

// The scan's sink: every scored slot of the span to S[q, p * L + slot].
struct WriteSink {
  float* S;
  size_t ld;
  int L, nprobe;
  __device__ __forceinline__ void begin(const ScanGroup&) {}
  __device__ __forceinline__ void tile(const ScanGroup& g,
                                       const float (&acc)[kQW][kDL],
                                       int base, const int (&live)[kDL],
                                       int) {
#pragma unroll
    for (int r = 0; r < kQW; ++r) {
      if (r >= g.nqw) break;
      const int pair = g.pair_s[g.slice * kQW + r];
      const int qi = pair / nprobe;
      float* dst = S + static_cast<size_t>(qi) * ld +
                   static_cast<size_t>(pair - qi * nprobe) * L;
#pragma unroll
      for (int j = 0; j < kDL; ++j) {
        if (j >= g.nj) break;
        const int slot = base + 32 * j;
        if (slot < g.hi) dst[slot] = live[j] ? acc[r][j] : -INFINITY;
      }
    }
  }
  __device__ __forceinline__ void end(const ScanGroup&, int) {}
};

__global__ void __launch_bounds__(kFillThreads)
ivf_fill_kernel(float4* __restrict__ S, size_t n4) {
  const float4 v = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (size_t i = static_cast<size_t>(blockIdx.x) * kFillThreads +
                  threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * kFillThreads)
    S[i] = v;
}

// As csrc/ivf_topk.cu's scan: 1 block per SM asked for, so ptxas does not
// trade registers for occupancy; shared memory allows 2.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ivf_write_kernel(const float* __restrict__ q,
                 const float* __restrict__ list_emb,
                 const int* __restrict__ list_ids,
                 const int* __restrict__ probe_ids, float* __restrict__ S,
                 size_t ld, int Nq, int L, int D, int nprobe,
                 int rows_per_split, int group_blocks) {
  extern __shared__ float4 smem4[];
  WriteSink sink{S, ld, L, nprobe};
  ivf_scan<kVec>(q, list_emb, list_ids, probe_ids, Nq, L, D, nprobe,
                 rows_per_split, group_blocks, reinterpret_cast<float*>(smem4),
                 sink);
}

// Query blockIdx.x's row of S, nc <= kRun candidates, sorted whole in
// shared memory (padded with (-inf, -1), which ranks after every
// candidate), its first k written through the map, the fill past nc.
__global__ void __launch_bounds__(sel::kSortThreads)
ivf_sort_row_kernel(const float* __restrict__ S, size_t ld, int nc,
                    float* __restrict__ out_s, int* __restrict__ out_i,
                    int k, IvfIds map) {
  __shared__ sel::Entry e[sel::kRun];
  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  int P = 1;
  while (P < nc) P <<= 1;
  const float* row = S + static_cast<size_t>(qi) * ld;
  for (int x = tid; x < P; x += sel::kSortThreads)
    e[x] = x < nc ? sel::Entry{row[x], x} : sel::Entry{-INFINITY, -1};
  sel::sort_run(e, P, tid);
  sel::write_out(e, nc, qi, out_s, out_i, k, map, tid, sel::kSortThreads);
}

template <bool kVec>
cudaError_t launch_write(dim3 grid, cudaStream_t st, const float* q,
                         const float* emb, const int* ids, const int* probe,
                         float* S, size_t ld, int Nq, int L, int D,
                         int nprobe, int rows_per_split, int group_blocks) {
  const cudaError_t err = prepare_scan<ivf_write_kernel<kVec>>(kRingSmem);
  if (err != cudaSuccess) return err;
  ivf_write_kernel<kVec><<<grid, kThreads, kRingSmem, st>>>(
      q, emb, ids, probe, S, ld, Nq, L, D, nprobe, rows_per_split,
      group_blocks);
  return cudaGetLastError();
}

}  // namespace

// Queries [q0, q0 + chunk_q) form a chunk.  In a chunk, rows [s *
// rows_per_split, (s + 1) * rows_per_split) of each list form scan split
// s, group_blocks blocks share a list's groups of 32 pairs, and columns
// [c * sel_per, (c + 1) * sel_per) of S form select chunk c (sel_per a
// multiple of 4); the rule is ops.ivf_retrieval_topk_select_plan.
// Scratch: scores chunk_q * ld floats (ld = nprobe * L rounded up to 4),
// work sel::work_ints(chunk_q, n_sel) ints, cand 2 * chunk_q * min(k,
// nprobe * L) 8-byte entries.  Returns a cudaError_t code (0 = ok).
extern "C" int ivf_retrieval_topk_select(
    const void* queries, const void* list_emb, const void* list_ids,
    const void* probe_ids, void* scores, void* work, void* cand, void* out_s,
    void* out_i, int Nq, int n_lists, int L, int D, int nprobe, int k,
    int chunk_q, int rows_per_split, int n_splits, int group_blocks,
    int n_sel, int sel_per, void* stream) {
  const long long nc = static_cast<long long>(nprobe) * L;
  if (Nq < 1 || n_lists < 1 || L < 1 || D < 1 || nprobe < 1 || k < 1 ||
      chunk_q < 1 || chunk_q > 65535 || rows_per_split < 1 ||
      n_splits < 1 || n_splits > 65535 ||
      static_cast<long long>(n_splits) * rows_per_split < L ||
      group_blocks < 1 || group_blocks > 65535 || n_sel < 1 ||
      sel_per < 4 || sel_per % 4 != 0 || nc > INT_MAX - sel_per ||
      static_cast<long long>(n_sel) * sel_per < nc ||
      static_cast<long long>(chunk_q) * nprobe > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* emb = static_cast<const float*>(list_emb);
  const int* ids = static_cast<const int*>(list_ids);
  const int* probe = static_cast<const int*>(probe_ids);
  float* S = static_cast<float*>(scores);
  const int n_cand = static_cast<int>(nc);
  const size_t ld = (static_cast<size_t>(n_cand) + 3) / 4 * 4;
  sel::Entry* ca = static_cast<sel::Entry*>(cand);
  sel::Entry* cb = ca + static_cast<size_t>(chunk_q) * std::min(k, n_cand);
  const bool vec = D % 4 == 0 && rt::aligned16(q) && rt::aligned16(emb);
  const dim3 grid(n_lists, n_splits, group_blocks);
  for (int q0 = 0; q0 < Nq; q0 += chunk_q) {
    const int nq = std::min(chunk_q, Nq - q0);
    float* os = static_cast<float*>(out_s) + static_cast<size_t>(q0) * k;
    int* oi = static_cast<int*>(out_i) + static_cast<size_t>(q0) * k;
    const float* qc = q + static_cast<size_t>(q0) * D;
    const int* pc = probe + static_cast<size_t>(q0) * nprobe;
    const size_t n4 = nq * ld / 4;
    const int fill_blocks = static_cast<int>(std::min<size_t>(
        (n4 + kFillThreads - 1) / kFillThreads, 4096));
    ivf_fill_kernel<<<fill_blocks, kFillThreads, 0, st>>>(
        reinterpret_cast<float4*>(S), n4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = vec ? launch_write<true>(grid, st, qc, emb, ids, pc, S, ld, nq, L,
                                   D, nprobe, rows_per_split, group_blocks)
              : launch_write<false>(grid, st, qc, emb, ids, pc, S, ld, nq, L,
                                    D, nprobe, rows_per_split, group_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    const IvfIds map{ids, pc, L, nprobe};
    if (n_cand <= sel::kRun) {
      ivf_sort_row_kernel<<<nq, sel::kSortThreads, 0, st>>>(S, ld, n_cand,
                                                            os, oi, k, map);
      err = cudaGetLastError();
    } else {
      err = sel::select_topk(st, S, ld, nq, n_cand, k, chunk_q, n_sel,
                             sel_per, static_cast<int*>(work), ca, cb, os, oi,
                             map);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
