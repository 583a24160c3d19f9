// IVF probe top-k for k > 32, for sm_90a (csrc/ivf_topk.cu keeps
// k <= 32; the exact top-k's wider routes are csrc/topk_list.cu and
// csrc/topk_select.cu).
//
// Replaces, for k > 32: src/repro/kernels/topk_retrieval.py,
//   ivf_topk_pallas (kernel body _ivf_topk_kernel), whose lax.top_k over
//   [carried best + tile] serves any k.
//
// ivf_retrieval_topk_wide: queries [Nq, D] x list_emb [n_lists, L, D] f32
//   with list_ids [n_lists, L] int32 (-1 = padding) and probe_ids [Nq,
//   nprobe] int32 -> the top-k of the concatenation of each query's
//   probed lists in probe order, ordered by (score desc, probe rank asc,
//   slot asc); a probe id outside [0, n_lists) probes an empty list.
//   When fewer than k candidates exist the tail is (-1e30, -1); any
//   k >= 1, Nq, n_lists, L, D.  The contract of csrc/ivf_topk.cu, exactly.
//
// Bound: memory at the serving path's few queries: the probed lists'
//   live rows read once, 2 flops per 4 bytes per query.  This design
//   reads them once per query instead, and is far from that bound: it is
//   the simple, right version (PERF.md has its times).
//
// Design: one launch, one block of 256 threads per query.
//  - Candidates are numbered c = p * L + slot, and c is the key that
//    breaks score ties: keys are unique, so (score, key) is a total order
//    and every step below is exact.
//  - The block walks its candidates in tiles of kT = 1024.  Each thread
//    scores 4 candidates, each (query, candidate) score one fmaf chain
//    over d = 0, 1, ..., D-1 from 0, the chain the narrow kernel uses, so
//    the scores are bitwise equal to its.  A candidate that does not
//    exist (a padding slot, a probe outside the lists) scores -inf and
//    keeps its unique key.
//  - The tile is bitonic-sorted best first in shared memory.
//  - The carried best k lives in a global double buffer [2, Nq, k] that
//    the wrapper allocates, so k has no upper limit; it starts as k
//    entries (-inf, INT_MIN + j), keys no candidate has.  When the
//    tile's best beats the carried k-th, the two sorted lists merge by
//    ranks: a carried entry's position is its index plus the number of
//    the tile's first min(kT, k) entries that rank before it (a binary
//    search), a tile entry's its index plus the number of carried
//    entries that rank before it; positions below k are written to the
//    other buffer, which then becomes the carried list.
//  - At the end an entry of score -inf becomes (-1e30, -1); any other
//    key becomes its doc id, list_ids[probe_ids[q, p], slot].
// No atomics; two calls on the same inputs are bitwise equal.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kT = 1024;                 // candidates per tile
constexpr int kThreads = 256;
constexpr int kPer = kT / kThreads;      // candidates per thread per tile

// (s1, i1) ranks before (s2, i2): higher score, then lower key (as
// unsigned, so the initial INT_MIN + j keys rank after every candidate).
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  if (s1 != s2) return s1 > s2;
  return static_cast<unsigned>(i1) < static_cast<unsigned>(i2);
}

// Entries of the sorted list (xs, xi)[0, n) that rank before (s, i), or,
// with or_equal, that do not rank after it.  The list may sit in shared
// or global memory (written by this block: plain loads, not __ldg).
__device__ __forceinline__ int rank_in(const float* xs, const int* xi, int n,
                                       float s, int i, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = or_equal ? !better(s, i, xs[mid], xi[mid])
                                 : better(xs[mid], xi[mid], s, i);
    if (before)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    topk_wide_kernel(const float* __restrict__ queries,
                     const float* __restrict__ emb,
                     const int* __restrict__ list_ids,
                     const int* __restrict__ probe_ids, float* buf_s,
                     int* buf_i, float* __restrict__ out_s,
                     int* __restrict__ out_i, int n_cand, int n_lists, int L,
                     int D, int nprobe, int k) {
  __shared__ float ts[kT];
  __shared__ int ti[kT];
  const int tid = threadIdx.x;
  const size_t qk = static_cast<size_t>(blockIdx.x) * k;
  const size_t plane = static_cast<size_t>(gridDim.x) * k;
  float* cs = buf_s + qk;              // carried list
  int* ci = buf_i + qk;
  float* ns = buf_s + plane + qk;      // the merge's output
  int* ni = buf_i + plane + qk;
  for (int j = tid; j < k; j += kThreads) {
    cs[j] = -INFINITY;
    ci[j] = INT_MIN + j;
  }
  const float* qrow = queries + static_cast<size_t>(blockIdx.x) * D;
  const int* prow = probe_ids + static_cast<size_t>(blockIdx.x) * nprobe;
  const int m = min(kT, k);            // tile entries that can enter

  for (int base = 0; base < n_cand; base += kT) {
    __syncthreads();   // the last tile's reads and merge writes are done
    const float* row[kPer];
    bool live[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int c = base + tid + r * kThreads;
      live[r] = c < n_cand;
      row[r] = qrow;   // a readable row for a candidate that does not exist
      if (!live[r]) continue;
      const int p = c / L;
      const int slot = c - p * L;
      const int pid = __ldg(prow + p);
      live[r] = pid >= 0 && pid < n_lists &&
                __ldg(list_ids + static_cast<size_t>(pid) * L + slot) >= 0;
      if (live[r]) row[r] = emb + (static_cast<size_t>(pid) * L + slot) * D;
    }
    float acc[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) acc[r] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = __ldg(qrow + d);
#pragma unroll
      for (int r = 0; r < kPer; ++r) acc[r] = fmaf(qd, __ldg(row[r] + d), acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int e = tid + r * kThreads;
      ts[e] = live[r] ? acc[r] : -INFINITY;
      ti[e] = base + e;
    }
    __syncthreads();
    // bitonic sort of the tile, best first
    for (int size = 2; size <= kT; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < kT / 2; t += kThreads) {
          const int a = 2 * t - (t & (stride - 1));
          const int b = a + stride;
          const float sa = ts[a], sb = ts[b];
          const int ia = ti[a], ib = ti[b];
          const bool best_first = (a & size) == 0;
          if (best_first ? better(sb, ib, sa, ia) : better(sa, ia, sb, ib)) {
            ts[a] = sb;
            ts[b] = sa;
            ti[a] = ib;
            ti[b] = ia;
          }
        }
        __syncthreads();
      }
    }
    // the same values in every thread: the branch is uniform
    if (!better(ts[0], ti[0], cs[k - 1], ci[k - 1])) continue;
    for (int j = tid; j < k; j += kThreads) {
      const float s = cs[j];
      const int i = ci[j];
      const int pos = j + rank_in(ts, ti, m, s, i, false);
      if (pos < k) {
        ns[pos] = s;
        ni[pos] = i;
      }
    }
    for (int j = tid; j < m; j += kThreads) {
      const float s = ts[j];
      const int i = ti[j];
      const int pos = j + rank_in(cs, ci, k, s, i, true);
      if (pos < k) {
        ns[pos] = s;
        ni[pos] = i;
      }
    }
    float* swap_s = cs;
    cs = ns;
    ns = swap_s;
    int* swap_i = ci;
    ci = ni;
    ni = swap_i;
  }
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    const float s = cs[j];
    const int key = ci[j];
    int id = -1;
    if (s != -INFINITY) {
      const int p = key / L;
      const int slot = key - p * L;
      id = __ldg(list_ids + static_cast<size_t>(__ldg(prow + p)) * L + slot);
    }
    out_s[qk + j] = id < 0 ? rt::kNegInf : s;
    out_i[qk + j] = id;
  }
}

}  // namespace

// buf_s / buf_i: [2, Nq, k] scratch of the carried lists.  Returns a
// cudaError_t.
extern "C" int ivf_retrieval_topk_wide(const void* queries,
                                       const void* list_emb,
                                       const void* list_ids,
                                       const void* probe_ids, void* buf_s,
                                       void* buf_i, void* out_s, void* out_i,
                                       int Nq, int n_lists, int L, int D,
                                       int nprobe, int k, void* stream) {
  if (Nq < 1 || n_lists < 1 || L < 1 || D < 1 || nprobe < 1 || k < 1 ||
      static_cast<long long>(nprobe) * L > INT_MAX - kT)
    return static_cast<int>(cudaErrorInvalidValue);
  topk_wide_kernel<<<Nq, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(list_emb),
      static_cast<const int*>(list_ids), static_cast<const int*>(probe_ids),
      static_cast<float*>(buf_s), static_cast<int*>(buf_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), nprobe * L,
      n_lists, L, D, nprobe, k);
  return static_cast<int>(cudaGetLastError());
}
