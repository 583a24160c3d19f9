// The selection core of the top-k kernels that write every candidate's
// score to a matrix S [queries, ld] first (csrc/topk_select.cu, the exact
// top-k above the list kernel's route; csrc/ivf_select.cu, the IVF probe
// above k 32): an exact radix select of each query's k_eff-th key over
// its row of S, the gather of the k_eff winners, and their sort, as runs
// in shared memory and pairwise rank merges in device memory.  A
// candidate's key is its column in S, and ties go to the lower column.
// Each output entry passes through the caller's map (column -> id) as it
// is written.  The design notes are csrc/topk_select.cu's.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace {
namespace sel {

constexpr int kBins = 2048;         // the widest digit: 11 bits
constexpr int kState = 4;           // per query: tau's prefix, rem, c
constexpr int kHistThreads = 512;
constexpr int kHistUnroll = 4;      // float4 loads a thread has in flight
constexpr int kPickThreads = 256;
constexpr int kGatherThreads = 256;
constexpr int kGatherUnroll = 4;    // float4 loads a thread has in flight
constexpr int kMergeThreads = 256;
// Entries a sort block takes.  One block sorting a query's whole list
// leaves all but Nq SMs idle through its barrier-bound steps; runs spread
// the sort over the card.  The tests build with a shorter run, so that
// the merge levels run on small inputs too.
#ifndef SELECT_RUN
#define SELECT_RUN 2048
#endif
constexpr int kRun = SELECT_RUN;
constexpr int kSortThreads = kRun / 2;

struct __align__(8) Entry {
  float s;
  int i;
};
static_assert(kRun >= 64 && (kRun & (kRun - 1)) == 0 &&
                  kSortThreads <= 1024 && kRun * sizeof(Entry) <= 48 * 1024,
              "a sort run: a power of two, whole warps, static shared memory");

// Round r's digit: bits [shift, shift + bits) of the key.
__device__ __forceinline__ int digit_shift(int round) {
  return round == 0 ? 21 : round == 1 ? 10 : 0;
}
__device__ __forceinline__ int digit_bits(int round) {
  return round < 2 ? 11 : 10;
}

// The key of a score: unsigned order = score order; -0.0 keys as +0.0.
__device__ __forceinline__ unsigned key_of(float s) {
  unsigned b = __float_as_uint(s);
  b = (b << 1) == 0u ? 0u : b;   // -0.0 -> +0.0, on the bits
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// a ranks before b: higher score, then lower column (as unsigned, so the
// -1 of a padding entry ranks last)
__device__ __forceinline__ bool before(const Entry& a, const Entry& b) {
  if (a.s != b.s) return a.s > b.s;
  return static_cast<unsigned>(a.i) < static_cast<unsigned>(b.i);
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Round `round`'s histogram of query blockIdx.y over select chunk
// blockIdx.x (docs [b * per, (b + 1) * per)): the digit of each key that
// carries the query's prefix (every key in round 0), counted in shared
// memory and written to part [Nq][n_sel][kBins].
__global__ void __launch_bounds__(kHistThreads)
select_hist_kernel(const float* __restrict__ S, size_t ld, int Nd, int per,
                   int n_sel, int round, const int* __restrict__ state,
                   int* __restrict__ part) {
  __shared__ int h[kBins];
  const int b = blockIdx.x;
  const int qi = blockIdx.y;
  const int tid = threadIdx.x;
  const int shift = digit_shift(round);
  const int nb = 1 << digit_bits(round);
  const int hi = shift + digit_bits(round);   // 32 in round 0: unused
  const unsigned prefix =
      round == 0 ? 0u : static_cast<unsigned>(state[qi * kState]);
  for (int i = tid; i < nb; i += kHistThreads) h[i] = 0;
  __syncthreads();
  const int begin = b * per;
  const int end = min(Nd, begin + per);
  const int n4 = end > begin ? (end - begin + 3) / 4 : 0;
  const float4* row = reinterpret_cast<const float4*>(
                          S + static_cast<size_t>(qi) * ld) +
                      begin / 4;
  auto count = [&](float s, int doc) {
    if (doc >= end) return;
    const unsigned key = key_of(s);
    if (round == 0 || (key >> hi) == prefix)
      atomicAdd(&h[(key >> shift) & (nb - 1)], 1);
  };
  for (int i0 = 0; i0 < n4; i0 += kHistUnroll * kHistThreads) {
    float4 v[kHistUnroll];
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int idx = i0 + u * kHistThreads + tid;
      if (idx < n4) v[u] = row[idx];
    }
#pragma unroll
    for (int u = 0; u < kHistUnroll; ++u) {
      const int idx = i0 + u * kHistThreads + tid;
      if (idx >= n4) break;
      const int doc = begin + 4 * idx;
      count(v[u].x, doc);
      count(v[u].y, doc + 1);
      count(v[u].z, doc + 2);
      count(v[u].w, doc + 3);
    }
  }
  __syncthreads();
  int* dst = part + (static_cast<size_t>(qi) * n_sel + b) * kBins;
  for (int i = tid; i < nb; i += kHistThreads) dst[i] = h[i];
}

// Round `round`'s pick for query blockIdx.x: the digit whose bin holds
// the rem-th highest key among those carrying the prefix (rem = k_eff in
// round 0), found by a scan of the summed histograms from the highest
// bin down.  state [prefix, rem, c, ties]: the prefix grows by the digit,
// rem loses the keys in higher bins; above [Nq][n_sel] gains each
// chunk's keys in higher bins.  After the last round the prefix is tau,
// and above / tie [Nq][n_sel] become each chunk's exclusive prefix, in
// chunk order, of the keys above tau and of the keys equal to it; c is
// the count above tau and ties the count equal to it.
__global__ void __launch_bounds__(kPickThreads)
select_pick_kernel(const int* __restrict__ part, int* __restrict__ above,
                   int* __restrict__ tie, int* __restrict__ state, int n_sel,
                   int round, int k_eff) {
  constexpr int kPer = kBins / kPickThreads;   // bins a thread: 8
  static_assert(kPer == 8, "two int4 loads a chunk");
  __shared__ int warp_tot[kPickThreads / 32];
  __shared__ int pick[2];
  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb = 1 << digit_bits(round);
  int* st = state + qi * kState;
  const int rem = round == 0 ? k_eff : st[1];
  const int* hq = part + static_cast<size_t>(qi) * n_sel * kBins;
  // thread t counts bins nb - 1 - (kPer t + j), j < kPer: highest first;
  // they are bins [lo, lo + kPer) of each chunk's histogram
  const int lo = nb - kPer * (tid + 1);
  int c[kPer] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (lo >= 0) {
#pragma unroll 4
    for (int b = 0; b < n_sel; ++b) {
      const int4* h4 =
          reinterpret_cast<const int4*>(hq + static_cast<size_t>(b) * kBins + lo);
      const int4 x = h4[0], y = h4[1];
      c[7] += x.x;
      c[6] += x.y;
      c[5] += x.z;
      c[4] += x.w;
      c[3] += y.x;
      c[2] += y.y;
      c[1] += y.z;
      c[0] += y.w;
    }
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) sum += c[j];
  const int incl = warp_inclusive_scan(sum, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int higher = incl - sum;   // keys in the bins above this thread's
  for (int w = 0; w < warp; ++w) higher += warp_tot[w];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (higher < rem && rem <= higher + c[j]) {
      pick[0] = nb - 1 - (kPer * tid + j);
      pick[1] = higher;
    }
    higher += c[j];
  }
  __syncthreads();
  const int bin = pick[0];
  for (int b = warp; b < n_sel; b += kPickThreads / 32) {
    const int* hb = hq + static_cast<size_t>(b) * kBins;
    int a = 0;
    for (int x = bin + 1 + lane; x < nb; x += 32) a += hb[x];
    a = warp_sum_int(a);
    if (lane == 0) {
      int* ab = above + static_cast<size_t>(qi) * n_sel + b;
      *ab = (round == 0 ? 0 : *ab) + a;
      if (round == 2) tie[static_cast<size_t>(qi) * n_sel + b] = hb[bin];
    }
  }
  if (tid == 0) {
    st[0] = static_cast<int>(
        round == 0 ? static_cast<unsigned>(bin)
                   : (static_cast<unsigned>(st[0]) << digit_bits(round)) |
                         static_cast<unsigned>(bin));
    st[1] = rem - pick[1];
    st[2] = k_eff - st[1];
  }
  if (round != 2) return;
  __syncthreads();
  if (tid == 0) {
    int a = 0, t = 0;
    for (int b = 0; b < n_sel; ++b) {
      const size_t o = static_cast<size_t>(qi) * n_sel + b;
      const int na = above[o], nt = tie[o];
      above[o] = a;
      tie[o] = t;
      a += na;
      t += nt;
    }
    st[3] = t;
  }
}

// Query blockIdx.y's winners in select chunk blockIdx.x into its k_eff
// slots of cand.  The chunk's keys above tau take slots [A, A + its
// count) and its keys equal to tau [c + T, c + T + its count) cut at
// k_eff, A and T the counts in the earlier chunks.  A range taken whole
// is filled in any order (a warp takes its keys' slots from a counter in
// shared memory at once); a chunk whose ties straddle k_eff ranks its
// keys in doc order instead, by a block-wide scan of each pass's counts.
__global__ void __launch_bounds__(kGatherThreads)
select_gather_kernel(const float* __restrict__ S, size_t ld, int Nd, int per,
                     int n_sel, const int* __restrict__ above,
                     const int* __restrict__ tie,
                     const int* __restrict__ state, Entry* __restrict__ cand,
                     int k_eff) {
  __shared__ int warp_tot[kGatherThreads / 32];
  __shared__ int next[2];   // the next free slot above tau / at tau
  const int b = blockIdx.x;
  const int qi = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* st = state + qi * kState;
  const unsigned tau = static_cast<unsigned>(st[0]);
  const int rem = st[1];
  const int c = st[2];
  const size_t o = static_cast<size_t>(qi) * n_sel + b;
  const int t0 = tie[o];
  const int n_t = (b + 1 < n_sel ? tie[o + 1] : st[3]) - t0;
  const bool take_ties = t0 + n_t <= rem;   // all of the chunk's ties
  const bool ranked = t0 < rem && !take_ties;
  Entry* out = cand + static_cast<size_t>(qi) * k_eff;
  const int begin = b * per;
  const int end = min(Nd, begin + per);
  const int n4 = end > begin ? (end - begin + 3) / 4 : 0;
  const float4* row = reinterpret_cast<const float4*>(
                          S + static_cast<size_t>(qi) * ld) +
                      begin / 4;
  // the 4 keys of float4 idx above tau / equal to it, as bits
  auto flags = [&](const float4& x, int idx, unsigned& fa, unsigned& ft) {
    fa = ft = 0;
    if (idx >= n4) return;
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (begin + 4 * idx + e >= end) break;
      const unsigned key = key_of(v[e]);
      fa |= static_cast<unsigned>(key > tau) << e;
      ft |= static_cast<unsigned>(key == tau) << e;
    }
  };
  auto put = [&](const float4& x, int idx, unsigned f, int slot) {
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((f >> e) & 1u) out[slot++] = Entry{v[e], begin + 4 * idx + e};
  };

  if (!ranked) {
    if (tid == 0) {
      next[0] = above[o];
      next[1] = c + t0;
    }
    __syncthreads();
    // a warp's keys of one pass take consecutive slots of one counter
    auto place = [&](const float4& x, int idx, unsigned f, int* counter) {
      if (!__any_sync(0xffffffffu, f != 0)) return;
      const int n = __popc(f);
      const int incl = warp_inclusive_scan(n, lane);
      int base = 0;
      if (lane == 31) base = atomicAdd(counter, incl);
      base = __shfl_sync(0xffffffffu, base, 31);
      put(x, idx, f, base + incl - n);
    };
    for (int i0 = 0; i0 < n4; i0 += kGatherUnroll * kGatherThreads) {
      float4 x[kGatherUnroll];
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int idx = i0 + u * kGatherThreads + tid;
        if (idx < n4) x[u] = row[idx];
      }
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int idx = i0 + u * kGatherThreads + tid;
        unsigned fa, ft;
        flags(x[u], idx, fa, ft);
        place(x[u], idx, fa, &next[0]);
        if (take_ties) place(x[u], idx, ft, &next[1]);
      }
    }
    return;
  }
  // the chunk whose ties straddle k_eff: ranks in doc order
  int pos_a = above[o], pos_t = t0;
  for (int i0 = 0; i0 < n4; i0 += kGatherThreads) {
    const int idx = i0 + tid;
    float4 x = {0.f, 0.f, 0.f, 0.f};
    if (idx < n4) x = row[idx];
    unsigned fa, ft;
    flags(x, idx, fa, ft);
    const int mine = (__popc(fa) << 16) | __popc(ft);
    if (!__syncthreads_or(mine)) continue;
    // both counts in one int: a pass's ties stay below 2^16
    const int incl = warp_inclusive_scan(mine, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int prior = incl - mine, total = 0;
#pragma unroll
    for (int w = 0; w < kGatherThreads / 32; ++w) {
      if (w < warp) prior += warp_tot[w];
      total += warp_tot[w];
    }
    put(x, idx, fa, pos_a + (prior >> 16));
    int t = pos_t + (prior & 0xffff);
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!((ft >> e) & 1u)) continue;
      if (t < rem) out[c + t] = Entry{v[e], begin + 4 * idx + e};
      ++t;
    }
    pos_a += total >> 16;
    pos_t += total & 0xffff;
  }
}

// Sort e[0, P) best first (P a power of two, kRun at most), the block's
// kSortThreads threads a pair each: a bitonic network in shared memory.
__device__ __forceinline__ void sort_run(Entry* e, int P, int tid) {
  // A step of stride <= 32 keeps each warp on its own 64-entry pieces,
  // so it waits for its warp only, unless the step before crossed warps.
  bool crossed = true;   // the loads
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool cross = stride > 32;
      if (cross || crossed)
        __syncthreads();
      else
        __syncwarp();
      crossed = cross;
      for (int t = tid; t < P / 2; t += kSortThreads) {
        const int a = 2 * t - (t & (stride - 1));
        const int b = a + stride;
        const Entry ea = e[a], eb = e[b];
        const bool best_first = (a & size) == 0;
        if (best_first ? before(eb, ea) : before(ea, eb)) {
          e[a] = eb;
          e[b] = ea;
        }
      }
    }
  }
  __syncthreads();
}

// The outputs of a query from its sorted entries e[0, n): slot x < k is
// map(qi, e[x]) or, past n, the fill (-1e30, -1).
template <class Map>
__device__ __forceinline__ void write_out(const Entry* e, int n, int qi,
                                          float* __restrict__ out_s,
                                          int* __restrict__ out_i, int k,
                                          const Map& map, int tid,
                                          int threads) {
  const size_t o = static_cast<size_t>(qi) * k;
  for (int x = tid; x < k; x += threads) {
    const Entry v = x < n ? map(qi, e[x]) : Entry{rt::kNegInf, -1};
    out_s[o + x] = v.s;
    out_i[o + x] = v.i;
  }
}

// Run blockIdx.x (entries [x * kRun, min(k_eff, (x + 1) * kRun))) of
// query blockIdx.y, bitonic-sorted best first in shared memory (padded
// to a power of two with (-inf, -1), which ranks last), a thread per
// pair: written back in place, or, with out_s (one run), through the map
// as the outputs [Nq, k] with the fill tail (-1e30, -1).
template <class Map>
__global__ void __launch_bounds__(kSortThreads)
select_sort_kernel(Entry* __restrict__ cand, int k_eff,
                   float* __restrict__ out_s, int* __restrict__ out_i,
                   int k, Map map) {
  __shared__ Entry e[kRun];
  const int qi = blockIdx.y;
  const int tid = threadIdx.x;
  const int begin = blockIdx.x * kRun;
  const int n = max(0, min(kRun, k_eff - begin));
  int P = 1;
  while (P < n) P <<= 1;
  Entry* src = cand + static_cast<size_t>(qi) * k_eff + begin;
  for (int x = tid; x < P; x += kSortThreads)
    e[x] = x < n ? src[x] : Entry{-INFINITY, -1};
  sort_run(e, P, tid);
  if (out_s == nullptr) {
    for (int x = tid; x < n; x += kSortThreads) src[x] = e[x];
    return;
  }
  write_out(e, n, qi, out_s, out_i, k, map, tid, kSortThreads);
}

// Entries of the sorted list xs[0, n) that rank before x or, with
// or_equal, that do not rank after it.
__device__ __forceinline__ int rank_in(const Entry* xs, int n, const Entry& x,
                                       bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool pre = or_equal ? !before(x, xs[mid]) : before(xs[mid], x);
    if (pre)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One merge level of query blockIdx.y: sorted runs 2m and 2m + 1 of
// length L (the last may be short or alone) into run m of length 2L of
// dst; an entry lands at its index plus the entries of the sibling run
// that rank before it (ties to the earlier run).  With out_s (the last
// level) through the map into the outputs [Nq, k], slots [k_eff, k)
// the fill.
template <class Map>
__global__ void __launch_bounds__(kMergeThreads)
select_merge_kernel(const Entry* __restrict__ src, Entry* __restrict__ dst,
                    float* __restrict__ out_s, int* __restrict__ out_i,
                    int k_eff, int L, int k, Map map) {
  const int qi = blockIdx.y;
  const int x = blockIdx.x * kMergeThreads + threadIdx.x;
  if (x >= (out_s != nullptr ? k : k_eff)) return;
  const size_t o = static_cast<size_t>(qi) * k;
  if (x >= k_eff) {
    out_s[o + x] = rt::kNegInf;
    out_i[o + x] = -1;
    return;
  }
  const Entry* base = src + static_cast<size_t>(qi) * k_eff;
  const int run = x / L;
  const int sib = (run ^ 1) * L;
  const Entry v = base[x];
  int pos = x;
  if (sib < k_eff)
    pos = min(run, run ^ 1) * L + (x - run * L) +
          rank_in(base + sib, min(L, k_eff - sib), v, run & 1);
  if (out_s != nullptr) {
    const Entry m = map(qi, v);
    out_s[o + pos] = m.s;
    out_i[o + pos] = m.i;
  } else {
    dst[static_cast<size_t>(qi) * k_eff + pos] = v;
  }
}

// The map of the exact top-k: a column is the doc id.
struct SameId {
  __device__ __forceinline__ Entry operator()(int, const Entry& e) const {
    return e;
  }
};

// The int scratch of a chunk of chunk_q queries: the histograms [chunk_q]
// [n_sel][kBins], above and tie [chunk_q][n_sel], state [chunk_q][kState].
inline size_t work_ints(int chunk_q, int n_sel) {
  return static_cast<size_t>(chunk_q) *
         (static_cast<size_t>(n_sel) * (kBins + 2) + kState);
}

// The selection of one chunk of nq queries (chunk_q, the chunk size the
// scratch was cut for) over their rows of S [nq, ld], nd candidates a
// row: three select rounds, the gather, the sort and its merge levels,
// into the outputs os / oi [nq, k] through the map.  work holds
// work_ints(chunk_q, n_sel) ints, ca and cb chunk_q * min(k, nd) entries
// each.  Returns the first launch error.
template <class Map>
cudaError_t select_topk(cudaStream_t st, const float* S, size_t ld, int nq,
                        int nd, int k, int chunk_q, int n_sel, int sel_per,
                        int* work, Entry* ca, Entry* cb, float* os, int* oi,
                        const Map& map) {
  const int k_eff = std::min(k, nd);
  const int runs = std::max(1, (k_eff + kRun - 1) / kRun);
  int* part = work;
  int* above = part + static_cast<size_t>(chunk_q) * n_sel * kBins;
  int* tie = above + static_cast<size_t>(chunk_q) * n_sel;
  int* state = tie + static_cast<size_t>(chunk_q) * n_sel;
  cudaError_t err = cudaSuccess;
  auto check = [&]() {
    err = cudaGetLastError();
    return err == cudaSuccess;
  };
  if (k_eff > 0) {
    for (int round = 0; round < 3; ++round) {
      select_hist_kernel<<<dim3(n_sel, nq), kHistThreads, 0, st>>>(
          S, ld, nd, sel_per, n_sel, round, state, part);
      if (!check()) return err;
      select_pick_kernel<<<nq, kPickThreads, 0, st>>>(
          part, above, tie, state, n_sel, round, k_eff);
      if (!check()) return err;
    }
    select_gather_kernel<<<dim3(n_sel, nq), kGatherThreads, 0, st>>>(
        S, ld, nd, sel_per, n_sel, above, tie, state, ca, k_eff);
    if (!check()) return err;
  }
  select_sort_kernel<Map><<<dim3(runs, nq), kSortThreads, 0, st>>>(
      ca, k_eff, runs == 1 ? os : nullptr, runs == 1 ? oi : nullptr, k, map);
  if (!check()) return err;
  const Entry* src = ca;
  Entry* dst = cb;
  for (int L = kRun; runs > 1 && L < k_eff; L *= 2) {
    const bool last = 2 * static_cast<long long>(L) >= k_eff;
    const int n = last ? k : k_eff;
    const dim3 grid((n + kMergeThreads - 1) / kMergeThreads, nq);
    select_merge_kernel<Map><<<grid, kMergeThreads, 0, st>>>(
        src, dst, last ? os : nullptr, last ? oi : nullptr, k_eff, L, k, map);
    if (!check()) return err;
    src = dst;
    dst = dst == cb ? ca : cb;
  }
  return cudaSuccess;
}

}  // namespace sel
}  // namespace
