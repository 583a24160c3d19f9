// Exact inner-product top-k retrieval for 32 < k <= 6176, for sm_90a: a
// list of width k per query in shared memory.  (csrc/topk.cu keeps
// k <= 32; ops.topk_route sends this kernel a small corpus, a single
// query at k <= 128, or several query groups at k <= 64 over at most
// 8192 docs, and csrc/topk_select.cu the rest.)
//
// Replaces, for those k: src/repro/kernels/topk_retrieval.py, topk_pallas
//   (kernel body _topk_kernel), whose lax.top_k over [carried best +
//   tile] serves any k.
//
// queries [Nq, D] x docs [Nd, D] (f32) -> scores [Nq, k] f32 and doc ids
// [Nq, k] int32, ordered by (score desc, id asc); when k > Nd the tail is
// (-1e30, -1).  Any Nq, Nd, D.  The contract of csrc/topk.cu, exactly.
//
// Bound: as csrc/topk.cu's: the doc matrix, Nd*D*4 bytes, read once, at
// 2*Nq flops per 4 bytes; at Nq 32 the f32 FFMA rate is about as tight as
// the memory rate.
//
// Design: one scan launch when the docs form one split; else the scan
// and its merge levels.
//  - Grid (query group, doc split) and the group's size from
//    ops.retrieval_topk_wide_plan.  A block of 4 warps takes a group of
//    kG = 4 * kQW queries (kQW = 2 or 1: the plan shrinks the group from
//    8 to 4 as k grows, so the lists fit), and each doc row is read from
//    device memory once per group.  (Larger groups would read the docs
//    fewer times, but at the shapes where that counts csrc/topk_select.cu
//    is as fast or faster, and ops.topk_route sends them there.)
//  - Scoring is topk.cu's core (csrc/topk_core.cuh): the cp.async ring
//    and the f32 FFMA register tile, warp w on the group's queries
//    kQW w ... kQW w + kQW - 1, lane l on tile rows l + 32 j.  When the
//    group holds at most kQW queries, every warp takes them all and warp
//    w rows l + 32 w only.  Each (query, doc) score is one fmaf chain over
//    d = 0, 1, ..., D-1, so the scores are bitwise those of topk.cu.
//  - Selection: per (warp, query) a sorted list of k entries in shared
//    memory, a threshold in registers, and a 32-entry candidate buffer.
//    The list's first nr entries are real, the rest fills (-inf, -1),
//    which rank last.  A score enters the buffer only if it beats the
//    threshold under the (score, id) order, at a slot given by a ballot.
//    When the ballot's entries would overflow the buffer (and at the end)
//    the warp sorts the buffer (a bitonic network over shuffles) and
//    merges it into the list's real entries in place by ranks: a list
//    entry moves back by the buffer entries ranking before it, a buffer
//    entry lands at its index plus the list entries ranking before it,
//    positions past k drop out; binary searches of fixed steps without
//    branches, kListChunks list chunks of 32 at a time (read and
//    ranked before any is written, from the top down, so nothing is
//    overwritten before it is read).  The threshold is then the better of
//    itself and the list's k-th.  A block takes 4 * (kStages * (kTD + kG)
//    * kKC + 2 * kG * (kLB + k)) bytes of shared memory: 40,960 at kG 8
//    and k 64, so two blocks share an SM up to k 1232 at kG 8.
//  - One split: the block writes the outputs (spread warps' lists of a
//    query merge on the way out, block-wide, by ranks).  Several: each
//    block writes a sorted partial list, and list_merge_kernel merges the
//    splits' lists of a query in a tree of pairwise rank merges, fan_in
//    lists a block in shared memory, one launch per level of fan_in until
//    one list is left.  (score, id) is a total order over distinct ids
//    and ties among fills go to the earlier list, so every merge is a
//    bijection onto its positions; no atomics anywhere, and two calls
//    give bitwise-equal results.

#include "topk_core.cuh"

namespace {

constexpr int kMergeThreads = 256;
constexpr int kSmemMax = 232448;   // a block's shared memory on sm_90

constexpr int kLB = 32;   // candidate buffer per (warp, query): one a lane
constexpr int kListChunks = 2;   // list chunks of 32 a merge ranks at once

// For N keys at once: the entries of the sorted list (xs, xi) + off[j],
// [0, n), that rank before (s[j], id[j]) or, with or_equal[j], that do
// not rank after it.  A binary search of fixed steps (the largest power
// of two <= n, then halves) without branches: every step reads an entry
// (clamped into the list) and selects, so the lanes of a warp never
// diverge; the N searches interleave, so their reads overlap.
template <int N>
__device__ __forceinline__ void rank_n(const float* xs, const int* xi,
                                       const int (&off)[N], int n,
                                       const float (&s)[N],
                                       const int (&id)[N],
                                       const bool (&or_equal)[N],
                                       int (&pos)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) pos[j] = 0;
  if (n <= 0) return;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int t = pos[j] + step;
      const int m = off[j] + min(t, n) - 1;
      const float xv = xs[m];
      const int xiv = xi[m];
      const bool before = or_equal[j] ? !better(s[j], id[j], xv, xiv)
                                      : better(xv, xiv, s[j], id[j]);
      pos[j] = t <= n && before ? t : pos[j];
    }
  }
}

__device__ __forceinline__ int rank_in(const float* xs, const int* xi, int n,
                                       float s, int i, bool or_equal) {
  int pos[1];
  rank_n<1>(xs, xi, {0}, n, {s}, {i}, {or_equal}, pos);
  return pos[0];
}

// Sort 32 entries, one a lane, best first under better(), warp-wide: a
// bitonic network over xor shuffles (csrc/topk.cu's, on one entry a lane).
__device__ __forceinline__ void sort32(float& s, int& id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int step = size >> 1; step > 0; step >>= 1) {
      const float so = __shfl_xor_sync(0xffffffffu, s, step);
      const int io = __shfl_xor_sync(0xffffffffu, id, step);
      const bool want_better = ((lane & step) == 0) == ((lane & size) == 0);
      if (better(so, io, s, id) == want_better) {
        s = so;
        id = io;
      }
    }
  }
}

// Merge the candidate buffer (bs, bi)[0, cnt), cnt <= kLB, into the
// sorted list (ls, li)[0, k), keeping the best k, warp-wide; the buffer is
// then free.  The list's first nr entries are real, the rest fills, which
// rank after any real entry and stay where they are past the merged
// entries; so the work grows with nr, not k.  Returns the new nr.  Out of
// line: the scan loop calls it from many unrolled places (inlined, it
// measured slower at 1M docs: the scan loop's registers).
__device__ __noinline__ int flush(float* ls, int* li, float* bs, int* bi,
                                  int cnt, int nr, int k, int lane) {
  constexpr int kU = kListChunks;
  __syncwarp();
  float s = lane < cnt ? bs[lane] : -INFINITY;
  int id = lane < cnt ? bi[lane] : -1;
  sort32(s, id, lane);
  if (lane < cnt) {   // sorted, back for the list entries' searches
    bs[lane] = s;
    bi[lane] = id;
  }
  const int pos_b = lane < cnt ? lane + rank_in(ls, li, nr, s, id, true) : k;
  __syncwarp();
  // List entries move back by the buffer entries ranking before them;
  // those before the buffer's best stay.  kU chunks at a time from the
  // top: all read and ranked before any is written, and each lands at
  // or above its index, so nothing is overwritten before it is read.
  const int first = __shfl_sync(0xffffffffu, pos_b, 0);
  for (int top = nr; top > first; top -= 32 * kU) {
    const int base = top - 32 * kU;
    float v[kU];
    int vi[kU], p[kU], off[kU];
    bool strict[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = max(base + 32 * u + lane, 0);
      v[u] = ls[i];
      vi[u] = li[i];
      off[u] = 0;
      strict[u] = false;
    }
    rank_n<kU>(bs, bi, off, cnt, v, vi, strict, p);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + 32 * u + lane;
      if (i >= first && i >= 0 && i + p[u] < k) {
        ls[i + p[u]] = v[u];
        li[i + p[u]] = vi[u];
      }
    }
    __syncwarp();
  }
  if (pos_b < k) {
    ls[pos_b] = s;
    li[pos_b] = id;
  }
  __syncwarp();
  return min(k, nr + cnt);
}

// A scan launch's arguments.
struct ScanArgs {
  const float* q;
  const float* docs;
  float* dst_s;
  int* dst_i;
  int Nq, Nd, D, k, docs_per_split, n_splits;
};

template <bool kVec, int kQW>
__global__ void __launch_bounds__(kThreads)
topk_list_scan_kernel(const ScanArgs a) {
  constexpr int kG = kWarps * kQW;
  const float* __restrict__ q = a.q;
  const float* __restrict__ docs = a.docs;
  const int Nq = a.Nq, D = a.D, k = a.k, n_splits = a.n_splits;
  const int q0 = blockIdx.x * kG;
  const int split = blockIdx.y;
  const int nq = min(kG, Nq - q0);
  const int d_begin = split * a.docs_per_split;
  const int d_end = min(a.Nd, d_begin + a.docs_per_split);
  const int nk = (D + kKC - 1) / kKC;
  const int n_tiles =
      d_end <= d_begin ? 0 : (d_end - d_begin + kTD - 1) / kTD;
  const int steps = n_tiles * nk;

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [S][kTD][kKC], swizzled
  float* q_s = ring + kStages * kTD * kKC;         // [S][kG][kKC]
  float* cand_s = q_s + kStages * kG * kKC;        // [kG][kLB] per slot
  int* cand_i = reinterpret_cast<int*>(cand_s + kG * kLB);
  float* list_s = reinterpret_cast<float*>(cand_i + kG * kLB);   // [kG][k]
  int* list_i = reinterpret_cast<int*>(list_s + kG * k);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int e = tid; e < kG * k; e += kThreads) {
    list_s[e] = -INFINITY;
    list_i[e] = -1;
  }

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<kVec, kG>(ring, q_s, q, docs, s, nk, d_begin, d_end, q0,
                           nq, D, tid);
    rt::cp_async_commit();
  }

  // Warp roles.  Warp w owns the group's queries kQW w + r (r < kQW) and
  // scores them against tile rows lane + 32 j (j < kDL).  When the group
  // holds at most kQW queries, all warps take queries 0..kQW-1 and warp w
  // rows lane + 32 w only; each warp keeps its own lists.  Either way
  // warp w's list r is slot kQW w + r.
  const bool spread = nq <= kQW;
  const int slice = spread ? 0 : warp;       // query slice: kQW slice + r
  const int nqw = max(0, min(kQW, nq - slice * kQW));
  const int nj = spread ? 1 : kDL;
  const int row = lane + (spread ? 32 * warp : 0);   // the first doc row
  float ts[kQW];
  int ti[kQW], cnt[kQW], nr[kQW];   // threshold, buffer and list counts
#pragma unroll
  for (int r = 0; r < kQW; ++r) {
    ts[r] = -INFINITY;
    ti[r] = -1;
    cnt[r] = 0;
    nr[r] = 0;
  }
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
    const int kc = s % nk;
    const float* ds = ring + st * kTD * kKC + row * kKC;
    const float* qs = q_s + (st * kG + slice * kQW) * kKC;
    if (spread)
      score_chunk<kQW, 1>(acc, ds, qs, lane);
    else
      score_chunk<kQW, kDL>(acc, ds, qs, lane);
    if (kc != nk - 1) continue;

    // the tile is scored: offer its docs to the warp's queries
    const int base = d_begin + (s / nk) * kTD + row;
#pragma unroll
    for (int r = 0; r < kQW; ++r) {
      if (r >= nqw) break;
      const int slot = warp * kQW + r;
      float* bs = cand_s + slot * kLB;
      int* bi = cand_i + slot * kLB;
#pragma unroll
      for (int j = 0; j < kDL; ++j) {
        if (j >= nj) break;
        const int doc = base + j * 32;
        bool pass = doc < d_end && better(acc[r][j], doc, ts[r], ti[r]);
        unsigned m = __ballot_sync(0xffffffffu, pass);
        if (cnt[r] + __popc(m) > kLB) {   // full: merge it, then offer again
          float* ls = list_s + slot * k;
          int* li = list_i + slot * k;
          nr[r] = flush(ls, li, bs, bi, cnt[r], nr[r], k, lane);
          cnt[r] = 0;
          if (better(ls[k - 1], li[k - 1], ts[r], ti[r])) {
            ts[r] = ls[k - 1];
            ti[r] = li[k - 1];
          }
          pass = doc < d_end && better(acc[r][j], doc, ts[r], ti[r]);
          m = __ballot_sync(0xffffffffu, pass);
        }
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
  __syncthreads();   // the lists' fill is visible to every warp
#pragma unroll
  for (int r = 0; r < kQW; ++r)
    if (r < nqw && cnt[r] > 0) {
      const int slot = warp * kQW + r;
      flush(list_s + slot * k, list_i + slot * k, cand_s + slot * kLB,
            cand_i + slot * kLB, cnt[r], nr[r], k, lane);
    }
  __syncthreads();

  // Outputs: the final list (fill as (-1e30, -1)) when there is one
  // split, else the split's sorted partial (fill as (-inf, -1)).
  auto put = [&](int qi, int j, float s, int id) {
    const size_t o = n_splits == 1
                         ? (size_t)(q0 + qi) * k + j
                         : ((size_t)(q0 + qi) * n_splits + split) * k + j;
    a.dst_s[o] = n_splits == 1 && id < 0 ? rt::kNegInf : s;
    a.dst_i[o] = id;
  };
  if (!spread) {
    for (int r = 0; r < nqw; ++r) {
      const int slot = warp * kQW + r;
      for (int j = lane; j < k; j += 32)
        put(slot, j, list_s[slot * k + j], list_i[slot * k + j]);
    }
    return;
  }
  // spread: query r's entry i of warp w's list lands at i plus the
  // entries of the other warps' lists that rank before it (ties, only
  // among fills, to the lower warp); positions past k drop out
  for (int e = tid; e < nq * kWarps * k; e += kThreads) {
    const int r = e / (kWarps * k);
    const int w = e / k % kWarps;
    const int i = e % k;
    const int slot = w * kQW + r;
    const float s = list_s[slot * k + i];
    const int id = list_i[slot * k + i];
    int pos = i;
    for (int o = 0; o < kWarps && pos < k; ++o)
      if (o != w)
        pos += rank_in(list_s + (o * kQW + r) * k, list_i + (o * kQW + r) * k,
                       k, s, id, o < w);
    if (pos < k) put(r, pos, s, id);
  }
}

// Merge the sorted lists [c * fan_in, min(n_in, (c + 1) * fan_in)) of
// query q (block (q, c)) into list c of [Nq, n_out, k], or into the
// outputs [Nq, k] (fill as (-1e30, -1)) when `last`: in shared memory, a
// tree of pairwise rank merges (lists 2j and 2j + 1 into j; an entry
// lands at its index plus the entries of the other list that rank before
// it, ties to the earlier list; positions past k drop out).  A list's
// fills (-inf, -1) rank after its real entries, so a level first fills
// its outputs and then places the real entries only, each warp a list at
// a time (searching the other list's real entries): the work grows with
// the real entries, and the scan's threshold leaves few.
__global__ void __launch_bounds__(kMergeThreads)
list_merge_kernel(const float* __restrict__ in_s,
                  const int* __restrict__ in_i, float* __restrict__ out_s,
                  int* __restrict__ out_i, int n_in, int n_out, int k,
                  int fan_in, int last) {
  constexpr int kMU = 4;   // entries a lane ranks at once
  const int qi = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);      // [fan_in][k]
  int* xi = reinterpret_cast<int*>(xs + fan_in * k);
  float* ys = reinterpret_cast<float*>(xi + fan_in * k);   // [fan_in/2][k]
  int* yi = reinterpret_cast<int*>(ys + fan_in / 2 * k);
  int* xn = yi + fan_in / 2 * k;                    // real entries a list
  int* yn = xn + fan_in;
  const int m0 = min(fan_in, n_in - c * fan_in);
  const size_t base = ((size_t)qi * n_in + (size_t)c * fan_in) * k;
#pragma unroll 8
  for (int e = tid; e < m0 * k; e += kMergeThreads) {
    xs[e] = in_s[base + e];
    xi[e] = in_i[base + e];
  }
  __syncthreads();
  for (int l = tid; l < m0; l += kMergeThreads)
    xn[l] = rank_in(xs + l * k, xi + l * k, k, -INFINITY, -1, false);
  __syncthreads();
  float* ps = xs;
  int* pi = xi;
  int* pn = xn;
  float* ns = ys;
  int* ni = yi;
  int* nn = yn;
  for (int m = m0; m > 1; m = (m + 1) / 2) {
    const int h = (m + 1) / 2;
    for (int e = tid; e < h * k; e += kMergeThreads) {
      ns[e] = -INFINITY;
      ni[e] = -1;
    }
    if (tid < h)
      nn[tid] = min(k, pn[2 * tid] + (2 * tid + 1 < m ? pn[2 * tid + 1] : 0));
    __syncthreads();
    for (int l = tid >> 5; l < m; l += kMergeThreads / 32) {
      const int o = (l ^ 1) < m ? l ^ 1 : l;
      const int n_o = o != l ? pn[o] : 0;
      for (int i0 = lane; i0 < pn[l]; i0 += 32 * kMU) {
        float v[kMU];
        int vi[kMU], off[kMU], p[kMU];
        bool tie_before[kMU];
#pragma unroll
        for (int u = 0; u < kMU; ++u) {
          const int i = min(i0 + 32 * u, pn[l] - 1);
          v[u] = ps[l * k + i];
          vi[u] = pi[l * k + i];
          off[u] = o * k;
          tie_before[u] = l & 1;
        }
        rank_n<kMU>(ps, pi, off, n_o, v, vi, tie_before, p);
#pragma unroll
        for (int u = 0; u < kMU; ++u) {
          const int i = i0 + 32 * u;
          if (i < pn[l] && i + p[u] < k) {
            ns[(l >> 1) * k + i + p[u]] = v[u];
            ni[(l >> 1) * k + i + p[u]] = vi[u];
          }
        }
      }
    }
    __syncthreads();
    float* ts = ps;
    ps = ns;
    ns = ts;
    int* tix = pi;
    pi = ni;
    ni = tix;
    int* tn = pn;
    pn = nn;
    nn = tn;
  }
  const size_t o = ((size_t)qi * n_out + c) * k;
  for (int j = tid; j < k; j += kMergeThreads) {
    const int id = pi[j];
    out_s[o + j] = last && id < 0 ? rt::kNegInf : ps[j];
    out_i[o + j] = id;
  }
}

size_t scan_smem(int group, int k) {
  return sizeof(float) * (kStages * (kTD + group) * kKC +
                          2 * static_cast<size_t>(group) * (kLB + k));
}

size_t merge_smem(int fan_in, int k) {
  return sizeof(float) * (2 * static_cast<size_t>(fan_in + fan_in / 2) * k +
                          fan_in + fan_in / 2);
}

// Once per device and kernel: a block may take up to kSmemMax of shared
// memory, and the SM gives all its 228 KB to shared memory, so that as
// many blocks fit as the registers allow.  (A template on the kernel
// itself: the scan kernels share one type, and each needs its own flag.)
template <auto kernel>
cudaError_t prepare() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  err = rt::allow_smem(kernel, kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

template <bool kVec, int kQW>
cudaError_t launch_scan(cudaStream_t st, const ScanArgs& a) {
  constexpr auto kernel = topk_list_scan_kernel<kVec, kQW>;
  const cudaError_t err = prepare<kernel>();
  if (err != cudaSuccess) return err;
  constexpr int kG = kWarps * kQW;
  const dim3 grid((a.Nq + kG - 1) / kG, a.n_splits);
  kernel<<<grid, kThreads, scan_smem(kG, a.k), st>>>(a);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_scan_group(int group, cudaStream_t st, const ScanArgs& a) {
  return group == 8 ? launch_scan<kVec, 2>(st, a)
                    : launch_scan<kVec, 1>(st, a);
}

// Merge the n_splits sorted lists of each query in `src` (part) into the
// outputs [Nq, k] in dst (fill as (-1e30, -1)), fan_in lists a block a
// level: part -> tmp -> part -> ... -> dst.
cudaError_t merge_levels(cudaStream_t st, float* part_s, int* part_i,
                         float* tmp_s, int* tmp_i, float* dst_s, int* dst_i,
                         int Nq, int k, int n_splits, int fan_in) {
  cudaError_t err = prepare<list_merge_kernel>();
  if (err != cudaSuccess) return err;
  const float* src_s = part_s;
  const int* src_i = part_i;
  bool into_tmp = true;
  for (int n = n_splits; n > 1;) {
    const int n_out = (n + fan_in - 1) / fan_in;
    float* o_s = n_out == 1 ? dst_s : into_tmp ? tmp_s : part_s;
    int* o_i = n_out == 1 ? dst_i : into_tmp ? tmp_i : part_i;
    list_merge_kernel<<<dim3(Nq, n_out), kMergeThreads,
                        merge_smem(fan_in, k), st>>>(
        src_s, src_i, o_s, o_i, n, n_out, k, fan_in, n_out == 1 ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_s = o_s;
    src_i = o_i;
    into_tmp = !into_tmp;
    n = n_out;
  }
  return cudaSuccess;
}

}  // namespace

// Docs [d*docs_per_split, (d+1)*docs_per_split) form split d, queries
// [g*group, (g+1)*group) group g (the rule is
// ops.retrieval_topk_wide_plan; group is 4 or 8).  When n_splits
// > 1: part_s/part_i scratch of Nq * n_splits * k entries, tmp_s/tmp_i of
// Nq * ceil(n_splits / fan_in) * k, and fan_in (>= 2) lists merge in one
// block; unused (may be null / 0) when n_splits == 1.  Returns a
// cudaError_t code (0 = ok).
extern "C" int retrieval_topk_list(const void* queries, const void* docs,
                                   void* part_s, void* part_i, void* tmp_s,
                                   void* tmp_i, void* out_s, void* out_i,
                                   int Nq, int Nd, int D, int k, int group,
                                   int docs_per_split, int n_splits,
                                   int fan_in, void* stream) {
  if (Nq < 1 || Nd < 0 || k < 1 || D < 1 || n_splits < 1 ||
      docs_per_split < 1 ||
      (group != 4 && group != 8) ||
      scan_smem(group, k) > kSmemMax ||
      (n_splits > 1 && (fan_in < 2 || merge_smem(fan_in, k) > kSmemMax)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ScanArgs a{static_cast<const float*>(queries),
             static_cast<const float*>(docs),
             static_cast<float*>(out_s),
             static_cast<int*>(out_i),
             Nq, Nd, D, k, docs_per_split, n_splits};
  const bool vec = D % 4 == 0 && rt::aligned16(a.q) && rt::aligned16(a.docs);
  auto scan = [&]() {
    return vec ? launch_scan_group<true>(group, st, a)
               : launch_scan_group<false>(group, st, a);
  };
  if (n_splits == 1) return static_cast<int>(scan());
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* ts = static_cast<float*>(tmp_s);
  int* ti = static_cast<int*>(tmp_i);
  a.dst_s = ps;
  a.dst_i = pi;
  cudaError_t err = scan();
  if (err == cudaSuccess)
    err = merge_levels(st, ps, pi, ts, ti, static_cast<float*>(out_s),
                       static_cast<int*>(out_i), Nq, k, n_splits, fan_in);
  return static_cast<int>(err);
}
