// IVF probe top-k retrieval, for sm_90a.
//
// Replaces: src/repro/kernels/topk_retrieval.py, ivf_topk_pallas (kernel
//   body _ivf_topk_kernel).
//
// queries [Nq, D] f32 x list_emb [n_lists, L, D] f32 with list_ids
// [n_lists, L] int32 (-1 = padding slot, anywhere in a row) and probe_ids
// [Nq, nprobe] int32 -> scores [Nq, k] f32 and global doc ids [Nq, k]
// int32.  Each query is scored only against its nprobe routed lists.  The
// result is the stable top-k of the concatenation of the probed lists in
// probe order: score descending, then probe rank ascending, then slot
// within the list ascending -- what the TPU kernel's carried-first merge
// and the oracle's lax.top_k over the concatenation give.  A query that
// names one list twice sees its documents twice.  Padding slots never
// enter the result; when the probed lists hold fewer than k documents the
// tail is (-1e30, -1).  A probe id outside [0, n_lists) probes an empty
// list.  1 <= k <= 32.
//
// Bound: memory.  The least work reads the live rows of the distinct
// lists the queries probe once, at 2 flops per 4 bytes per (query, probe)
// that names the list: at the serving path's few queries far below the
// f32 FFMA rate.  Measured on an H100 (PERF.md): about 43% of that bound
// on a 1M-doc shard; what holds the rest back is not measured.
//
// Design: two launches, a scan over (list, split, group block) blocks and
// a merge per query.  The scan up to its scored tiles (pairs, live span,
// ring, FFMA tile) is csrc/ivf_core.cuh's, shared with csrc/ivf_select.cu;
// the selection below is this file's sink.  The grid is sized from
// shapes alone (split rule and group blocks in
// ops.ivf_retrieval_topk_plan); a block with no work exits.
//  - Block (l, s, z) scans probe_ids itself, in table order, for the
//    (query, probe) pairs that name list l (a ballot and a block prefix
//    sum, 1024 entries a step), and takes the pairs of rank [32 g, 32 g +
//    32) for g = z, z + group_blocks, ...: a list probed by more pairs
//    than a group holds is scored once per group.  No table is built on
//    the host and nothing is sorted.
//  - It streams only the live span of its split's rows (first to last
//    live slot: the padding at a list's end is never read) through a
//    kStages ring of [kTD rows + kG query rows] x kKC dims in shared
//    memory, filled by 16-byte cp.async (4-byte when D % 4 or a pointer
//    forbids it), so each probed list's live rows are read from device
//    memory once per group of the pairs that probe it.  A -1 slot inside
//    the span is scored and then masked by its id, read at the tile's
//    first ring step.
//  - Scoring is the exact kernel's (csrc/topk.cu) f32 FFMA register tile:
//    a warp holds up to 8 pairs x up to 4 rows per lane.  The group's size
//    picks the warp layout, every warp scoring: <= 8 pairs, the 4 warps
//    share them and split a tile's rows (reading only 1, 2, 4 or 8 query
//    rows); <= 16, two warps per 8; else one warp per 8.  Each (query,
//    row) sum runs d = 0, 1, ..., D-1 as one fmaf chain, whatever split,
//    tile, lane or group the row lands in, so a document held in two
//    lists, or scored by two groups, gets bitwise-equal scores.
//  - Selection is the exact kernel's: per (warp, pair) a running threshold
//    and a 64-entry candidate buffer ranked by (score, slot), sorted by a
//    bitonic network over shuffles; warps that share a pair merge their
//    lists at the end.  Each block writes one sorted partial top-k per
//    (query, probe, split), filled with (-1e30, -1) where the split holds
//    fewer live rows than k, so every partial of a pair that names a list
//    is written.
//  - ivf_merge_kernel, one warp per query, takes its nprobe x n_splits
//    partials keyed (score, p * n_splits + s): within a partial the order
//    is (score, slot) and splits cover slots in ascending order, so the
//    result is ordered (score, probe rank, slot).  A pair whose probe id
//    is outside [0, n_lists) has no partial and is skipped before any
//    read.  No atomics anywhere.
// The TPU kernel runs one grid step per (query, probe) and DMAs the whole
// padded list; here one block reads a list for all the pairs of a group.

#include "ivf_core.cuh"

namespace {

constexpr int kMaxK = 32;
constexpr int kCB = 64;           // candidate buffer per pair
constexpr int kMergeThreads = 32;  // one warp per query

// (s1, r1) ranks before (s2, r2): higher score, then lower rank (slot, or
// partial index in the merge); the -1 fill compares as the largest
// unsigned value, so fills rank last.
__device__ __forceinline__ bool better(float s1, int r1, float s2, int r2) {
  if (s1 != s2) return s1 > s2;
  return static_cast<unsigned>(r1) < static_cast<unsigned>(r2);
}

// Sort R candidate buffers at once (buffer r at bs + r * stride, its
// first cnt[r] <= 64 entries live) under better() and keep the best k of
// each, warp-wide, by a 64-entry bitonic network over xor shuffles (as in
// csrc/topk.cu).  cnt[r] becomes min(cnt[r], k).  The network's 21
// stages run as a loop, not unrolled: a block sorts once or a few times,
// and unrolled the networks for 1 to 8 buffers grew the kernel from 6.5k
// to 25k instructions for no measured gain.
template <int R>
__device__ __forceinline__ void sort_lists(float* bs, int* bi, int stride,
                                           int (&cnt)[R], int k, int lane) {
  __syncwarp();
  float s[R][2];
  int id[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = lane + 32 * h < cnt[r];
      s[r][h] = live ? bs[r * stride + lane + 32 * h] : -INFINITY;
      id[r][h] = live ? bi[r * stride + lane + 32 * h] : -1;
    }
#pragma unroll 1
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll 1
    for (int step = size >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (step == 32) {
          if (!better(s[r][0], id[r][0], s[r][1], id[r][1])) {
            const float ts = s[r][0];
            const int ti = id[r][0];
            s[r][0] = s[r][1];
            id[r][0] = id[r][1];
            s[r][1] = ts;
            id[r][1] = ti;
          }
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = lane + 32 * h;
          const float so = __shfl_xor_sync(0xffffffffu, s[r][h], step);
          const int io = __shfl_xor_sync(0xffffffffu, id[r][h], step);
          const bool want_better = ((e & step) == 0) == ((e & size) == 0);
          if (better(so, io, s[r][h], id[r][h]) == want_better) {
            s[r][h] = so;
            id[r][h] = io;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cnt[r] = min(cnt[r], k);
    if (lane < cnt[r]) {
      bs[r * stride + lane] = s[r][0];
      bi[r * stride + lane] = id[r][0];
    }
  }
  __syncwarp();
}

__device__ __noinline__ int reselect(float* bs, int* bi, int cnt, int k,
                                     int lane) {
  int c[1] = {cnt};
  sort_lists<1>(bs, bi, 0, c, k, lane);
  return c[0];
}

// sort_lists of the first R of kQW buffers kCB apart.
template <int R, int N>
__device__ __forceinline__ void sort_first(float* bs, int* bi, int (&cnt)[N],
                                           int k, int lane) {
  int c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = cnt[r];
  sort_lists<R>(bs, bi, kCB, c, k, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) cnt[r] = c[r];
}

// The scan's sink: per (warp, pair) a running threshold and a kCB-entry
// candidate buffer in shared memory, offered each scored tile's live
// rows; at the group's end each warp sorts its lists and the block writes
// one sorted partial top-k per (query, probe, split).
struct TopkSink {
  float* cand_s;   // [kG][kCB], buffer warp * kQW + r
  int* cand_i;
  int* cnt_s;      // [kWarps][kQW], over the drained ring
  float* part_s;
  int* part_r;
  int k, split, n_splits, warp;
  float ts[kQW];
  int ti[kQW], cnt[kQW];

  __device__ __forceinline__ void begin(const ScanGroup&) {
#pragma unroll
    for (int r = 0; r < kQW; ++r) {
      ts[r] = rt::kNegInf;
      ti[r] = -1;
      cnt[r] = 0;
    }
  }

  // the tile is scored: offer its live rows to the warp's pairs
  __device__ __forceinline__ void tile(const ScanGroup& g,
                                       const float (&acc)[kQW][kDL],
                                       int base, const int (&live)[kDL],
                                       int lane) {
#pragma unroll
    for (int r = 0; r < kQW; ++r) {
      if (r >= g.nqw) break;
      float* bs = cand_s + (warp * kQW + r) * kCB;
      int* bi = cand_i + (warp * kQW + r) * kCB;
#pragma unroll
      for (int j = 0; j < kDL; ++j) {
        if (j >= g.nj) break;
        if (cnt[r] > kCB - 32) {
          cnt[r] = reselect(bs, bi, cnt[r], k, lane);
          if (cnt[r] == k) {
            ts[r] = bs[k - 1];
            ti[r] = bi[k - 1];
          }
        }
        const int slot = base + j * 32;
        const bool pass = live[j] && better(acc[r][j], slot, ts[r], ti[r]);
        const unsigned m = __ballot_sync(0xffffffffu, pass);
        if (pass) {
          const int at = cnt[r] + __popc(m & ((1u << lane) - 1u));
          bs[at] = acc[r][j];
          bi[at] = slot;
        }
        cnt[r] += __popc(m);
      }
    }
  }

  // Each warp sorts its live lists.  Then warp w writes the partials of
  // pairs w, w + kWarps, ...: pair i's list is row i % 8 of its slice's
  // part-0 warp, which first takes in the slice's other warps' lists
  // (all at once when they fit one buffer, else one at a time).
  __device__ __forceinline__ void end(const ScanGroup& g, int tid) {
    const int lane = tid & 31;
    {
      int c[kQW];
#pragma unroll
      for (int r = 0; r < kQW; ++r) c[r] = r < g.nqw ? cnt[r] : 0;
      float* bs = cand_s + warp * kQW * kCB;
      int* bi = cand_i + warp * kQW * kCB;
      if (g.nqw > kQW / 2)
        sort_lists<kQW>(bs, bi, kCB, c, k, lane);
      else if (g.nqw > kQW / 4)
        sort_first<kQW / 2>(bs, bi, c, k, lane);
      else if (g.nqw > 1)
        sort_first<2>(bs, bi, c, k, lane);
      else if (g.nqw == 1)
        sort_first<1>(bs, bi, c, k, lane);
      if (lane == 0)
        for (int r = 0; r < kQW; ++r) cnt_s[warp * kQW + r] = c[r];
    }
    __syncthreads();
    for (int i = warp; i < g.n; i += kWarps) {
      const int own = (i / kQW) * g.nwp * kQW + i % kQW;
      float* bs = cand_s + own * kCB;
      int* bi = cand_i + own * kCB;
      int m = cnt_s[own];
      for (int w = 1; w < g.nwp; ++w) {
        const int src = own + w * kQW, add = cnt_s[src];
        if (lane < add) {
          bs[m + lane] = cand_s[src * kCB + lane];
          bi[m + lane] = cand_i[src * kCB + lane];
        }
        m += add;
        if (g.nwp * k > kCB || w == g.nwp - 1)
          m = reselect(bs, bi, m, k, lane);
      }
      if (lane < k) {
        const size_t o = ((size_t)g.pair_s[i] * n_splits + split) * k + lane;
        part_s[o] = lane < m ? bs[lane] : rt::kNegInf;
        part_r[o] = lane < m ? bi[lane] : -1;
      }
    }
  }
};

// The explicit 1 block per SM keeps ptxas from aiming at 3 (168
// registers, spilling in the scan loop); shared memory allows 2.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ivf_scan_kernel(const float* __restrict__ q,
                const float* __restrict__ list_emb,
                const int* __restrict__ list_ids,
                const int* __restrict__ probe_ids,
                float* __restrict__ part_s, int* __restrict__ part_r, int Nq,
                int L, int D, int nprobe, int k, int rows_per_split,
                int n_splits, int group_blocks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cand_s = smem + kRingSmem / sizeof(float);   // [kG][kCB]
  TopkSink sink;
  sink.cand_s = cand_s;
  sink.cand_i = reinterpret_cast<int*>(cand_s + kG * kCB);
  sink.cnt_s = reinterpret_cast<int*>(smem);
  sink.part_s = part_s;
  sink.part_r = part_r;
  sink.k = k;
  sink.split = blockIdx.y;
  sink.n_splits = n_splits;
  sink.warp = threadIdx.x >> 5;
  ivf_scan<kVec>(q, list_emb, list_ids, probe_ids, Nq, L, D, nprobe,
                 rows_per_split, group_blocks, smem, sink);
}

__global__ void __launch_bounds__(kMergeThreads)
ivf_merge_kernel(const float* __restrict__ part_s,
                 const int* __restrict__ part_r,
                 const int* __restrict__ list_ids,
                 const int* __restrict__ probe_ids,
                 float* __restrict__ out_s, int* __restrict__ out_i,
                 int n_lists, int L, int nprobe, int n_splits, int k) {
  const int qi = blockIdx.x;
  extern __shared__ int head[];   // [nprobe * n_splits] read cursors
  const int lane = threadIdx.x;
  const int np = nprobe * n_splits;
  const int* probe = probe_ids + (size_t)qi * nprobe;
  const float* ps = part_s + (size_t)qi * np * k;
  const int* pr = part_r + (size_t)qi * np * k;
  // a probe outside [0, n_lists) has no partials: start it exhausted
  for (int c = lane; c < np; c += kMergeThreads) {
    const int l = probe[c / n_splits];
    head[c] = l >= 0 && l < n_lists ? 0 : k;
  }
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    // heads compare by (score, probe rank * n_splits + split): within one
    // partial the entries are already in (score, slot) order.  A total
    // order, so every lane ends the butterfly on the same head.
    float bs = rt::kNegInf;
    int bc = -1;
    for (int c = lane; c < np; c += kMergeThreads) {
      const int h = head[c];
      if (h >= k) continue;
      const float s = ps[(size_t)c * k + h];
      if (bc < 0 || better(s, c, bs, bc)) {
        bs = s;
        bc = c;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(0xffffffffu, bs, o);
      const int c2 = __shfl_xor_sync(0xffffffffu, bc, o);
      if (c2 >= 0 && (bc < 0 || better(s2, c2, bs, bc))) {
        bs = s2;
        bc = c2;
      }
    }
    if (lane == 0) {
      float s = rt::kNegInf;
      int id = -1;
      if (bc >= 0) {
        const int slot = pr[(size_t)bc * k + head[bc]];
        if (slot >= 0) {
          s = bs;
          id = list_ids[(size_t)probe[bc / n_splits] * L + slot];
        }
        ++head[bc];
      }
      out_s[(size_t)qi * k + j] = s;
      out_i[(size_t)qi * k + j] = id;
    }
    __syncwarp();
  }
}

// Shared memory of a scan block: the ring of row and query chunks and
// the candidate buffers, whatever D is.
constexpr size_t kScanSmem =
    kRingSmem + (sizeof(float) + sizeof(int)) * kG * kCB;

template <bool kVec>
cudaError_t launch_scan(dim3 grid, cudaStream_t st, const float* q,
                        const float* emb, const int* ids, const int* probe,
                        float* part_s, int* part_r, int Nq, int L, int D,
                        int nprobe, int k, int rows_per_split, int n_splits,
                        int group_blocks) {
  const cudaError_t err = prepare_scan<ivf_scan_kernel<kVec>>(kScanSmem);
  if (err != cudaSuccess) return err;
  ivf_scan_kernel<kVec><<<grid, kThreads, kScanSmem, st>>>(
      q, emb, ids, probe, part_s, part_r, Nq, L, D, nprobe, k,
      rows_per_split, n_splits, group_blocks);
  return cudaGetLastError();
}

}  // namespace

// Rows [s * rows_per_split, (s + 1) * rows_per_split) of each list form
// split s; group_blocks blocks share a list's groups of 32 pairs (the rule
// is ops.ivf_retrieval_topk_plan).  part_s/part_r: scratch of Nq * nprobe
// * n_splits * k entries.  Returns a cudaError_t code (0 = ok).
extern "C" int ivf_retrieval_topk(const void* queries, const void* list_emb,
                                  const void* list_ids, const void* probe_ids,
                                  void* part_s, void* part_r, void* out_s,
                                  void* out_i, int Nq, int n_lists, int L,
                                  int D, int nprobe, int k,
                                  int rows_per_split, int n_splits,
                                  int group_blocks, void* stream) {
  if (k < 1 || k > kMaxK || D < 1 || nprobe < 1 || n_splits < 1 ||
      n_splits > 65535 || group_blocks < 1 || group_blocks > 65535 ||
      rows_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(queries);
  const float* emb = static_cast<const float*>(list_emb);
  const int* ids = static_cast<const int*>(list_ids);
  const int* probe = static_cast<const int*>(probe_ids);
  float* ps = static_cast<float*>(part_s);
  int* pr = static_cast<int*>(part_r);
  const bool vec = D % 4 == 0 && rt::aligned16(q) && rt::aligned16(emb);
  const dim3 grid(n_lists, n_splits, group_blocks);
  cudaError_t err =
      vec ? launch_scan<true>(grid, st, q, emb, ids, probe, ps, pr, Nq, L, D,
                              nprobe, k, rows_per_split, n_splits,
                              group_blocks)
          : launch_scan<false>(grid, st, q, emb, ids, probe, ps, pr, Nq, L,
                               D, nprobe, k, rows_per_split, n_splits,
                               group_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = sizeof(int) * nprobe * n_splits;
  err = rt::allow_smem(ivf_merge_kernel, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_merge_kernel<<<Nq, kMergeThreads, smem2, st>>>(
      ps, pr, ids, probe, static_cast<float*>(out_s),
      static_cast<int*>(out_i), n_lists, L, nprobe, n_splits, k);
  return static_cast<int>(cudaGetLastError());
}