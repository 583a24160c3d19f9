// IVF probe top-k retrieval, for sm_90a.
//
// Replaces: src/repro/kernels/topk_retrieval.py, ivf_topk_pallas (kernel
//   body _ivf_topk_kernel).
//
// queries [Nq, D] f32 x list_emb [n_lists, L, D] f32 with list_ids
// [n_lists, L] int32 (-1 = padding slot) and probe_ids [Nq, nprobe]
// int32 -> scores [Nq, k] f32 and global doc ids [Nq, k] int32.  Each
// query is scored only against its nprobe routed lists.  The result is
// the stable top-k of the concatenation of the probed lists in probe
// order: score descending, then probe rank ascending, then slot within
// the list ascending -- what the TPU kernel's carried-first merge and
// the oracle's lax.top_k over the concatenation give.  Padding slots
// never enter the result; when the probed lists hold fewer than k
// documents the tail is (-1e30, -1).  A probe id outside [0, n_lists)
// probes an empty list.  k <= 32.
//
// Bound: memory.  The least work reads the live rows of the distinct
// lists the queries probe once, at 2 flops per 4 bytes per query that
// probes them.
//
// Design: two launches.  Pass 1 runs one block per (query, probe): the
// block reads probe_ids[q, p] itself (the TPU kernel gets it by scalar
// prefetch) and walks the list 32 slots per warp at a time.  Lane j
// loads slot j's id, the warp ballots the live slots, and for each live
// slot the 32 lanes read its row together (coalesced) and reduce the dot
// product with shuffles, so padding rows are never read.  Lane j keeps
// the slots it loaded in a sorted list of k (score, slot) in registers;
// the block then merges its 256 lists by k rounds of a block-wide
// arg-best into a partial top-k per (query, probe) in global scratch.
// Pass 2 merges a query's nprobe partials in probe order with a
// block-wide arg-best per output slot, keyed (score, probe rank), and
// maps the winning slot to its global id.  Each (query, probe) pair
// reads its list again: grouping the queries that probe one list, so
// its rows are read once, is later work.

#include "common.cuh"

namespace {

constexpr int kMaxK = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeThreads = 128;

// (s1, r1) ranks before (s2, r2): higher score, then lower rank (slot
// or probe index); the -1 fill rank compares as the largest unsigned
// value, so fills rank last.
__device__ __forceinline__ bool better(float s1, int r1, float s2, int r2) {
  if (s1 != s2) return s1 > s2;
  return static_cast<unsigned>(r1) < static_cast<unsigned>(r2);
}

__device__ __forceinline__ void insert_sorted(float* ls, int* lr, int k,
                                              float s, int r) {
  if (!better(s, r, ls[k - 1], lr[k - 1])) return;
  int j = k - 1;
  while (j > 0 && better(s, r, ls[j - 1], lr[j - 1])) {
    ls[j] = ls[j - 1];
    lr[j] = lr[j - 1];
    --j;
  }
  ls[j] = s;
  lr[j] = r;
}

__global__ void __launch_bounds__(kThreads)
ivf_probe_kernel(const float* __restrict__ q,
                 const float* __restrict__ list_emb,
                 const int* __restrict__ list_ids,
                 const int* __restrict__ probe_ids,
                 float* __restrict__ part_s, int* __restrict__ part_r,
                 int n_lists, int L, int D, int nprobe, int k) {
  const int qi = blockIdx.x;
  const int p = blockIdx.y;
  extern __shared__ float q_s[];                        // [D]
  __shared__ float ws[kWarps];
  __shared__ int wr[kWarps];
  __shared__ int wt[kWarps];
  __shared__ int winner;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int l = probe_ids[(size_t)qi * nprobe + p];

  for (int i = tid; i < D; i += kThreads) q_s[i] = q[(size_t)qi * D + i];
  __syncthreads();

  float ls[kMaxK];
  int lr[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    ls[j] = rt::kNegInf;
    lr[j] = -1;
  }
  if (l >= 0 && l < n_lists) {
    const float* emb = list_emb + (size_t)l * L * D;
    const int* ids = list_ids + (size_t)l * L;
    for (int base = warp * 32; base < L; base += kThreads) {
      const int slot = base + lane;
      const bool live = slot < L && ids[slot] >= 0;
      unsigned todo = __ballot_sync(0xffffffffu, live);
      float mine = 0.f;
      while (todo) {
        const int b = __ffs(todo) - 1;
        todo &= todo - 1;
        const float* row = emb + (size_t)(base + b) * D;
        float acc = 0.f;
        for (int d = lane; d < D; d += 32) acc += q_s[d] * row[d];
        acc = rt::warp_sum(acc);
        if (lane == b) mine = acc;
      }
      if (live) insert_sorted(ls, lr, k, mine, slot);
    }
  }

  // k rounds: every thread offers the head of its sorted list, the block
  // picks the best (ties by rank, then by thread), the owner advances
  int h = 0;
  const size_t out0 = ((size_t)qi * nprobe + p) * k;
  for (int j = 0; j < k; ++j) {
    float s = ls[h];
    int r = lr[h];
    int t = tid;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      const int r2 = __shfl_xor_sync(0xffffffffu, r, o);
      const int t2 = __shfl_xor_sync(0xffffffffu, t, o);
      if (better(s2, r2, s, r) || (s2 == s && r2 == r && t2 < t)) {
        s = s2;
        r = r2;
        t = t2;
      }
    }
    if (lane == 0) {
      ws[warp] = s;
      wr[warp] = r;
      wt[warp] = t;
    }
    __syncthreads();
    if (tid == 0) {
      float bs = ws[0];
      int br = wr[0];
      int bt = wt[0];
      for (int w = 1; w < kWarps; ++w) {
        if (better(ws[w], wr[w], bs, br) ||
            (ws[w] == bs && wr[w] == br && wt[w] < bt)) {
          bs = ws[w];
          br = wr[w];
          bt = wt[w];
        }
      }
      part_s[out0 + j] = bs;
      part_r[out0 + j] = br;
      winner = bt;
    }
    __syncthreads();
    if (tid == winner) ++h;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
ivf_merge_kernel(const float* __restrict__ part_s,
                 const int* __restrict__ part_r,
                 const int* __restrict__ list_ids,
                 const int* __restrict__ probe_ids,
                 float* __restrict__ out_s, int* __restrict__ out_i,
                 int n_lists, int L, int nprobe, int k) {
  const int qi = blockIdx.x;
  __shared__ float rs[kMergeThreads];
  __shared__ int rp[kMergeThreads];
  extern __shared__ int head[];   // [nprobe] read cursor per partial
  const int tid = threadIdx.x;
  const float* ps = part_s + (size_t)qi * nprobe * k;
  const int* pr = part_r + (size_t)qi * nprobe * k;
  for (int p = tid; p < nprobe; p += kMergeThreads) head[p] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    // heads compare by (score, probe rank): within one partial the
    // entries are already in (score, slot) order
    float bs = rt::kNegInf;
    int bp = -1;
    for (int p = tid; p < nprobe; p += kMergeThreads) {
      const int h = head[p];
      if (h >= k) continue;
      const float s = ps[(size_t)p * k + h];
      if (bp < 0 || better(s, p, bs, bp)) {
        bs = s;
        bp = p;
      }
    }
    rs[tid] = bs;
    rp[tid] = bp;
    __syncthreads();
    for (int o = kMergeThreads / 2; o > 0; o >>= 1) {
      if (tid < o && rp[tid + o] >= 0 &&
          (rp[tid] < 0 || better(rs[tid + o], rp[tid + o], rs[tid], rp[tid]))) {
        rs[tid] = rs[tid + o];
        rp[tid] = rp[tid + o];
      }
      __syncthreads();
    }
    if (tid == 0) {
      const int p = rp[0];
      float s = rt::kNegInf;
      int id = -1;
      if (p >= 0) {
        const int slot = pr[(size_t)p * k + head[p]];
        const int l = probe_ids[(size_t)qi * nprobe + p];
        if (slot >= 0 && l >= 0 && l < n_lists) {
          s = rs[0];
          id = list_ids[(size_t)l * L + slot];
        }
        ++head[p];
      }
      out_s[(size_t)qi * k + j] = s;
      out_i[(size_t)qi * k + j] = id;
    }
    __syncthreads();
  }
}

}  // namespace

// part_s/part_r: scratch of Nq * nprobe * k entries.  Returns a
// cudaError_t code (0 = ok).
extern "C" int ivf_retrieval_topk(const void* queries, const void* list_emb,
                                  const void* list_ids, const void* probe_ids,
                                  void* part_s, void* part_r, void* out_s,
                                  void* out_i, int Nq, int n_lists, int L,
                                  int D, int nprobe, int k, void* stream) {
  if (k < 1 || k > kMaxK || nprobe < 1 || nprobe > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = sizeof(float) * D;
  cudaError_t err = rt::allow_smem(ivf_probe_kernel, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1(Nq, nprobe);
  ivf_probe_kernel<<<grid1, kThreads, smem1, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(list_emb),
      static_cast<const int*>(list_ids), static_cast<const int*>(probe_ids),
      static_cast<float*>(part_s), static_cast<int*>(part_r), n_lists, L, D,
      nprobe, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = sizeof(int) * nprobe;
  err = rt::allow_smem(ivf_merge_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_merge_kernel<<<Nq, kMergeThreads, smem2, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_r),
      static_cast<const int*>(list_ids), static_cast<const int*>(probe_ids),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_lists, L,
      nprobe, k);
  return static_cast<int>(cudaGetLastError());
}
