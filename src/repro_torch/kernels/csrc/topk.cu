// Exact inner-product top-k retrieval, for sm_90a.
//
// Replaces: src/repro/kernels/topk_retrieval.py, topk_pallas (kernel
//   body _topk_kernel).
//
// queries [Nq, D] x docs [Nd, D] (f32) -> scores [Nq, k] f32 and doc ids
// [Nq, k] int32, ordered by (score desc, id asc): exact ties go to the
// lower id, as the TPU kernel's carried-first merge and lax.top_k do.
// When k > Nd the tail is (-1e30, -1).  k <= 32.
//
// Bound: memory for the serving path's few queries: the doc matrix,
// Nd*D*4 bytes, has to be read once, at 2*Nq flops per 4 bytes.
//
// Design: two launches.  Pass 1 cuts the docs into contiguous splits;
// one block takes one split for a tile of up to 8 queries (held in
// shared memory), so a doc row is read once per query tile.  Each warp
// walks the split's docs with a stride of 8 warps: the 32 lanes read one
// doc row together (coalesced), compute the tile's 8 partial dot
// products, and reduce them with shuffles; lane r then offers the score
// to query r's running top-k list, which it keeps sorted in its own
// registers.  The block merges its 8 warps' lists per query into a
// partial top-k per (query, split) in global scratch.  Pass 2 merges the
// splits' sorted lists per query with a block-wide arg-best per output
// slot.  The TPU kernel instead streams doc tiles through one
// sequential grid axis and re-sorts [k + tile] candidates per step;
// Hopper runs blocks in parallel, so the merge moves to a second pass.

#include "common.cuh"

namespace {

constexpr int kQT = 8;        // queries per block in pass 1
constexpr int kMaxK = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (s1, i1) ranks before (s2, i2): higher score, then lower id; the -1
// fill id compares as the largest unsigned value, so fills rank last.
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  if (s1 != s2) return s1 > s2;
  return static_cast<unsigned>(i1) < static_cast<unsigned>(i2);
}

__device__ __forceinline__ void insert_sorted(float* ls, int* li, int k,
                                              float s, int i) {
  if (!better(s, i, ls[k - 1], li[k - 1])) return;
  int j = k - 1;
  while (j > 0 && better(s, i, ls[j - 1], li[j - 1])) {
    ls[j] = ls[j - 1];
    li[j] = li[j - 1];
    --j;
  }
  ls[j] = s;
  li[j] = i;
}

__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ q,
                    const float* __restrict__ docs,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    int Nq, int Nd, int D, int k, int docs_per_split,
                    int n_splits) {
  const int q0 = blockIdx.x * kQT;
  const int split = blockIdx.y;
  const int nq = min(kQT, Nq - q0);
  const int d_begin = split * docs_per_split;
  const int d_end = min(Nd, d_begin + docs_per_split);
  extern __shared__ float smem[];
  float* q_s = smem;                                    // [kQT][D]
  float* cs = q_s + kQT * D;                            // [kWarps][kQT][k]
  int* ci = reinterpret_cast<int*>(cs + kWarps * kQT * k);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kQT * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = r < nq ? q[(size_t)(q0 + r) * D + i % D] : 0.f;
  }
  __syncthreads();

  float ls[kMaxK];
  int li[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    ls[j] = rt::kNegInf;
    li[j] = -1;
  }
  for (int doc = d_begin + warp; doc < d_end; doc += kWarps) {
    const float* row = docs + (size_t)doc * D;
    float acc[kQT];
#pragma unroll
    for (int r = 0; r < kQT; ++r) acc[r] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float x = row[d];
#pragma unroll
      for (int r = 0; r < kQT; ++r) acc[r] += q_s[r * D + d] * x;
    }
    float mine = 0.f;
#pragma unroll
    for (int r = 0; r < kQT; ++r) {
      const float s = rt::warp_sum(acc[r]);
      if (lane == r) mine = s;
    }
    if (lane < nq) insert_sorted(ls, li, k, mine, doc);
  }
  if (lane < kQT) {
    for (int j = 0; j < k; ++j) {
      cs[(warp * kQT + lane) * k + j] = ls[j];
      ci[(warp * kQT + lane) * k + j] = li[j];
    }
  }
  __syncthreads();
  if (tid < nq) {
    int head[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) head[w] = 0;
    const size_t out0 = ((size_t)(q0 + tid) * n_splits + split) * k;
    for (int j = 0; j < k; ++j) {
      int bw = 0;
      float bs = cs[(0 * kQT + tid) * k + head[0]];
      int bi = ci[(0 * kQT + tid) * k + head[0]];
      for (int w = 1; w < kWarps; ++w) {
        const float s = cs[(w * kQT + tid) * k + head[w]];
        const int i = ci[(w * kQT + tid) * k + head[w]];
        if (better(s, i, bs, bi)) {
          bw = w;
          bs = s;
          bi = i;
        }
      }
      part_s[out0 + j] = bs;
      part_i[out0 + j] = bi;
      ++head[bw];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, float* __restrict__ out_s,
                  int* __restrict__ out_i, int n_splits, int k) {
  const int qi = blockIdx.x;
  __shared__ float rs[kThreads];
  __shared__ int ri[kThreads];
  __shared__ int rw[kThreads];
  extern __shared__ int head[];   // [n_splits] read cursor per list
  const int tid = threadIdx.x;
  const float* ps = part_s + (size_t)qi * n_splits * k;
  const int* pi = part_i + (size_t)qi * n_splits * k;
  for (int s = tid; s < n_splits; s += kThreads) head[s] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float bs = rt::kNegInf;
    int bi = -1;
    int bw = -1;
    for (int s = tid; s < n_splits; s += kThreads) {
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
    for (int o = kThreads / 2; o > 0; o >>= 1) {
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

}  // namespace

// part_s/part_i: scratch of Nq * n_splits * k entries.  Returns a
// cudaError_t code (0 = ok).
extern "C" int retrieval_topk(const void* queries, const void* docs,
                              void* part_s, void* part_i, void* out_s,
                              void* out_i, int Nq, int Nd, int D, int k,
                              int docs_per_split, int n_splits,
                              void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = sizeof(float) * kQT * D +
                       (sizeof(float) + sizeof(int)) * kWarps * kQT * k;
  cudaError_t err = rt::allow_smem(topk_partial_kernel, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((Nq + kQT - 1) / kQT, n_splits);
  topk_partial_kernel<<<grid1, kThreads, smem1, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(docs),
      static_cast<float*>(part_s), static_cast<int*>(part_i), Nq, Nd, D, k,
      docs_per_split, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = sizeof(int) * n_splits;
  err = rt::allow_smem(topk_merge_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<Nq, kThreads, smem2, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_splits, k);
  return static_cast<int>(cudaGetLastError());
}
