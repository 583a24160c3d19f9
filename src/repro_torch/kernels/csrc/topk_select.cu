// Exact inner-product top-k retrieval for k > 6176, for sm_90a: every
// score written once, an exact radix select of each query's k-th, and a
// sort of the k winners.  (csrc/topk.cu keeps k <= 32, csrc/topk_list.cu
// 33 <= k <= 6176; the kernel itself serves any k.)
//
// Replaces, for those k: src/repro/kernels/topk_retrieval.py, topk_pallas
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

#include <limits.h>

#include <algorithm>

#include "topk_core.cuh"

namespace {

constexpr int kG = 32;              // queries per scan block (group)
constexpr int kQW = kG / kWarps;    // queries per warp
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

__device__ __forceinline__ bool before(const Entry& a, const Entry& b) {
  return better(a.s, a.i, b.s, b.i);
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

// Run blockIdx.x (entries [x * kRun, min(k_eff, (x + 1) * kRun))) of
// query blockIdx.y, bitonic-sorted best first in shared memory (padded
// to a power of two with (-inf, -1), which ranks last), a thread per
// pair: written back in place, or, with out_s (one run), as the outputs
// [Nq, k] with the fill tail (-1e30, -1).
__global__ void __launch_bounds__(kSortThreads)
select_sort_kernel(Entry* __restrict__ cand, int k_eff,
                   float* __restrict__ out_s, int* __restrict__ out_i,
                   int k) {
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
  if (out_s == nullptr) {
    for (int x = tid; x < n; x += kSortThreads) src[x] = e[x];
    return;
  }
  const size_t o = static_cast<size_t>(qi) * k;
  for (int x = tid; x < k; x += kSortThreads) {
    out_s[o + x] = x < n ? e[x].s : rt::kNegInf;
    out_i[o + x] = x < n ? e[x].i : -1;
  }
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
// level) into the outputs [Nq, k], slots [k_eff, k) the fill.
__global__ void __launch_bounds__(kMergeThreads)
select_merge_kernel(const Entry* __restrict__ src, Entry* __restrict__ dst,
                    float* __restrict__ out_s, int* __restrict__ out_i,
                    int k_eff, int L, int k) {
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
    out_s[o + pos] = v.s;
    out_i[o + pos] = v.i;
  } else {
    dst[static_cast<size_t>(qi) * k_eff + pos] = v;
  }
}

size_t scan_smem() {
  return sizeof(float) * kStages * (kTD + kG) * kKC;
}

// The int scratch of a chunk of chunk_q queries: the histograms [chunk_q]
// [n_sel][kBins], above and tie [chunk_q][n_sel], state [chunk_q][kState].
size_t work_ints(int chunk_q, int n_sel) {
  return static_cast<size_t>(chunk_q) *
         (static_cast<size_t>(n_sel) * (kBins + 2) + kState);
}

}  // namespace

// Queries [q0, q0 + chunk_q) form a chunk; in a chunk, docs
// [d * docs_per_split, (d + 1) * docs_per_split) form scan split d and
// [c * sel_per, (c + 1) * sel_per) select chunk c (sel_per a multiple
// of 4); the rule is ops.retrieval_topk_select_plan.  Scratch: scores
// chunk_q * ld floats (ld = Nd rounded up to 4), work work_ints(chunk_q,
// n_sel) ints, cand 2 * chunk_q * min(k, Nd) 8-byte entries.  Returns a
// cudaError_t code (0 = ok).
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
  cudaError_t err = cudaSuccess;
  const float* q = static_cast<const float*>(queries);
  const float* d = static_cast<const float*>(docs);
  float* S = static_cast<float*>(scores);
  const size_t ld = (static_cast<size_t>(Nd) + 3) / 4 * 4;
  const int k_eff = std::min(k, Nd);
  const int runs = std::max(1, (k_eff + kRun - 1) / kRun);
  int* part = static_cast<int*>(work);
  int* above = part + static_cast<size_t>(chunk_q) * n_sel * kBins;
  int* tie = above + static_cast<size_t>(chunk_q) * n_sel;
  int* state = tie + static_cast<size_t>(chunk_q) * n_sel;
  Entry* ca = static_cast<Entry*>(cand);
  Entry* cb = ca + static_cast<size_t>(chunk_q) * k_eff;
  const bool vec = D % 4 == 0 && rt::aligned16(q) && rt::aligned16(d);
  auto check = [&]() {
    err = cudaGetLastError();
    return err == cudaSuccess;
  };
  for (int q0 = 0; q0 < Nq; q0 += chunk_q) {
    const int nq = std::min(chunk_q, Nq - q0);
    float* os = static_cast<float*>(out_s) + static_cast<size_t>(q0) * k;
    int* oi = static_cast<int*>(out_i) + static_cast<size_t>(q0) * k;
    if (k_eff > 0) {
      const dim3 grid((nq + kG - 1) / kG, n_splits);
      const float* qc = q + static_cast<size_t>(q0) * D;
      if (vec)
        select_scan_kernel<true><<<grid, kThreads, scan_smem(), st>>>(
            qc, d, S, nq, Nd, D, ld, docs_per_split);
      else
        select_scan_kernel<false><<<grid, kThreads, scan_smem(), st>>>(
            qc, d, S, nq, Nd, D, ld, docs_per_split);
      if (!check()) return static_cast<int>(err);
      for (int round = 0; round < 3; ++round) {
        select_hist_kernel<<<dim3(n_sel, nq), kHistThreads, 0, st>>>(
            S, ld, Nd, sel_per, n_sel, round, state, part);
        if (!check()) return static_cast<int>(err);
        select_pick_kernel<<<nq, kPickThreads, 0, st>>>(
            part, above, tie, state, n_sel, round, k_eff);
        if (!check()) return static_cast<int>(err);
      }
      select_gather_kernel<<<dim3(n_sel, nq), kGatherThreads, 0, st>>>(
          S, ld, Nd, sel_per, n_sel, above, tie, state, ca, k_eff);
      if (!check()) return static_cast<int>(err);
    }
    select_sort_kernel<<<dim3(runs, nq), kSortThreads, 0, st>>>(
        ca, k_eff, runs == 1 ? os : nullptr, runs == 1 ? oi : nullptr, k);
    if (!check()) return static_cast<int>(err);
    const Entry* src = ca;
    Entry* dst = cb;
    for (int L = kRun; runs > 1 && L < k_eff; L *= 2) {
      const bool last = 2 * static_cast<long long>(L) >= k_eff;
      const int n = last ? k : k_eff;
      select_merge_kernel<<<dim3((n + kMergeThreads - 1) / kMergeThreads,
                                 nq),
                            kMergeThreads, 0, st>>>(
          src, dst, last ? os : nullptr, last ? oi : nullptr, k_eff, L, k);
      if (!check()) return static_cast<int>(err);
      src = dst;
      dst = dst == cb ? ca : cb;
    }
  }
  return static_cast<int>(cudaSuccess);
}
