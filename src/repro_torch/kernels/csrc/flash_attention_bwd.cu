// Position-masked flash attention, backward, for sm_90a.
//
// Replaces no Pallas kernel: the reference trains by autodiff of its jnp
// blocked attention (src/repro/models/layers.py, flash_attention), and
// its Pallas flash kernel has no backward.  The port's model sends every
// attention through csrc/flash_attention.cu, so training on the card
// needs this gradient of what that kernel computes (the semantics of
// kernels/ref.py's flash_attention_ref): a key counts iff kv_pos >= 0,
// and (causal) kv_pos <= q_pos, and (window > 0) q_pos - kv_pos < window;
// scale 1/sqrt(hd); the softcap's chain rule 1 - tanh^2(s/cap); GQA's G
// query heads of a KV head share its K and V.
//
// Inputs: q, k, v, the positions, the forward's output O, dO and the
// forward's row log-sum-exp lse [B, H, Sq] (f32).  Outputs dq, dk, dv in
// the input type.  First delta_kernel: delta = rowsum(dO * O) per (b,
// h, query), one warp a row, into the wrapper's [B, H, Sq] f32 scratch;
// then the dK/dV and dQ work, both reading delta.  dK and dV
// are summed per key tile, dQ per query tile, each by the one block that
// owns it: no atomics, fixed loop and summation orders, so two calls
// give the same bits.  P = exp(S - lse) and dS = P (dP - delta) (times
// 1 - tanh^2 under the softcap) are recomputed in both kernels; dS is
// the gradient of the capped, scaled score, so dK and dQ take the scale
// once at the end.  A query row with no valid key has P = 0 on every
// key: it adds nothing to dK or dV, and its dq is 0.
//
// bf16 (the training path): tensor cores through mma.sync m16n8k16 (bf16
// in, f32 sums), from the primitives flash_attention.cu's forward uses.
// One launch, bwd_mma_kernel, holds both kinds of block (they need only
// delta): under a causal mask the first key tiles and the last query
// tiles have the most work, so each kind runs heaviest first and the
// lighter blocks of both kinds fill the SMs the heavy ones leave.
//   dK/dV (dkdv_block): one block per (row, KV head, tile of 64 keys), 4
//     warps of 16 keys.  At hd <= 128 each warp keeps its K and V rows
//     as mma A fragments in registers (ldmatrix, once).  The block walks
//     the G heads of the group and the tiles of 64 queries in a fixed
//     order; each tile's Q, dO, lse, delta and q_pos come into shared
//     memory by 16-byte cp.async, double buffered, rows padded to hd + 8
//     bf16 so ldmatrix and ldmatrix.trans hit 8 distinct bank groups.
//     For each 16 queries a warp computes S^T = K Q^T and dP^T = V dO^T
//     into f32 registers (B fragments by ldmatrix from the Q and dO
//     rows), forms P^T and dS^T there, repacks both as bf16 A fragments
//     (as the forward repacks P) and accumulates dV += P^T dO and dK +=
//     dS^T Q with B fragments by ldmatrix.trans: S, P and dS never go
//     through shared memory.
//   dQ (dq_block): one block per (row, head, tile of 64 queries), 4 warps
//     of 16 queries holding Q and dO as A fragments; it walks the key
//     tiles (64 keys; K, V and kv_pos by cp.async, double buffered):
//     S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K.
//   The score step is branch free (the mask by selects, the softcap's
//     branch once per 16 x 16 block), and the products run over the
//     padded head dim, so the mma and ldmatrix stream is straight-line
//     code the compiler can schedule.
//   hd 256: dK plus dV of 16 keys x 256 columns would be 256 f32
//     registers a lane.  Two warps share 16 keys and split the output
//     columns (a dK/dV block takes 32 keys), each computing the whole
//     S^T and dP^T: the two score products run twice, the two output
//     products once.  K and V (dK/dV) and Q and dO (dQ) are read from
//     shared memory by ldmatrix for every product, and the dQ key tile
//     is 32 keys, so both blocks stay within 227 KB of shared memory.
//   hd that is not a multiple of 16 is zero-padded in shared memory (hd
//     rounds up to 16/32/64/128/256): the zero columns add nothing to a
//     score, and the output columns past hd are not stored.
//   Dead tiles: a block skips a tile (before its loads) when no (query,
//     key) pair of it can count, tested position by position against the
//     bounds of the other side ([min, max] of the block's valid keys, or
//     of its queries); the block tests its whole position row once, up
//     front, 32 positions a warp per coalesced read, into flags in shared
//     memory.  Inside a kept tile a warp skips each 16 x 16 sub-tile by
//     the same test against its own 16 keys or queries.  A bound may
//     keep a dead tile, which is exact: a masked P, and so its dS, is 0.
//   Rounding: P and dS are rounded to bf16 for their products, as the
//     forward rounds P; each term is then off by at most 2^-9 of itself,
//     on top of the outputs' own bf16 rounding (2^-9): well inside the
//     2e-2 of max|grad| the tests and chip_smoke.py hold the kernel to.
//   Why mma.sync and not wgmma: the four products of a tile alternate
//     between key-major and query-major operands, and repacking P and dS
//     from the accumulators into A fragments in registers is what keeps
//     them out of shared memory; mma.sync takes that per warp with
//     16-row tiles, where wgmma wants 64-row warpgroup tiles, its B
//     operand in a swizzled shared layout and asynchronous fences.  The
//     products here are small next to the bytes (below), so the higher
//     issue rate of wgmma is not what this kernel waits on.
//
// f32: delta_kernel, then dkdv_kernel (one block per (row, KV head, 32
// keys)) and dq_kernel (one block per (row, head, 32 queries)): exact f32
// FFMA from shared memory, no TF32, so the card's gradients at the f32
// smoke configs equal the CPU's.  P and dS of each 32 x 32 tile pair go
// through shared memory; rows are padded to hd+1 floats so the row and
// column reads hit distinct banks.
//
// Bound: at olmo-1b's training shape (B 4, S 256, 16 heads of hd 128,
// causal) the 8 tensors move ~34 MB: ~0.010 ms at 3.35 TB/s.  The bf16
// kernels execute 7 products (4 in dK/dV, 3 in dQ) of ~0.54 GFLOP each
// under the causal mask, ~3.8 GFLOP: ~0.004 ms at 989 TFLOP/s, so the
// bytes bound it; what a block waits on is its serial chain of tiles
// (load latency, then ldmatrix and mma per 16 x 16 sub-tile).  Each
// warp re-reads its Q and dO (or K and V) sub-tile by ldmatrix for every
// 16 rows it owns, which at long non-causal rows (whisper's encoder)
// makes shared-memory reads, not the tensor cores, the busiest unit.

#include <climits>

#include "common.cuh"

namespace {

__device__ __forceinline__ bool key_valid(int qp, int kp, int causal,
                                          int window) {
  if (kp < 0) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && qp - kp >= window) return false;
  return true;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Can a query at qp see any key whose valid positions lie in [lo, hi]
// (lo > hi: no valid key)?  Never false when some key there counts.
__device__ __forceinline__ bool sees_keys(int qp, int lo, int hi, int causal,
                                          int window) {
  return lo <= hi && (!causal || lo <= qp) &&
         (window <= 0 || qp - hi < window);
}

// Can a key at kp be seen by any query whose positions lie in [lo, hi]?
__device__ __forceinline__ bool seen_by(int kp, int lo, int hi, int causal,
                                        int window) {
  return kp >= 0 && lo <= hi && (!causal || kp <= hi) &&
         (window <= 0 || lo - kp < window);
}

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int Sq, int H, int hd, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + warp;   // (b, s, h)
  if (row >= rows) return;
  const T* o = out + (size_t)row * hd;
  const T* g = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += rt::to_f32(o[d]) * rt::to_f32(g[d]);
  acc = rt::warp_sum(acc);
  if (lane == 0) {
    const int h = row % H, bs = row / H;
    const int b = bs / Sq, s = bs % Sq;
    delta[((size_t)b * H + h) * Sq + s] = acc;
  }
}

// ------------------------------------------------------------------ f32

constexpr int kBQ = 32;         // queries per tile
constexpr int kBK = 32;         // keys per tile
constexpr int kThreads = 256;
constexpr int kPairs = kBQ * kBK / kThreads;   // score pairs per thread

// Shared-memory layout of both tile kernels: four [32][HD+1] f32 row
// tiles (Q, dO, K, V), P and dS [32][33], then lse, delta and the two
// position rows.
template <int HD>
struct Smem {
  static constexpr int LD = HD + 1;
  static constexpr int PL = kBK + 1;
  static constexpr int kTile = 32 * LD;
  static constexpr size_t kBytes =
      sizeof(float) * (4 * kTile + 2 * kBQ * PL + 2 * kBQ) +
      sizeof(int) * (kBQ + kBK);
};

template <int HD>
struct Tiles {
  float *q, *dout, *k, *v, *p, *ds, *lse, *delta;
  int *qp, *kp;
  __device__ explicit Tiles(float* base) {
    using S = Smem<HD>;
    q = base;
    dout = q + S::kTile;
    k = dout + S::kTile;
    v = k + S::kTile;
    p = v + S::kTile;
    ds = p + kBQ * S::PL;
    lse = ds + kBQ * S::PL;
    delta = lse + kBQ;
    qp = reinterpret_cast<int*>(delta + kBQ);
    kp = qp + kBQ;
  }
};

// rows [r0, r0 + 32) of head `head` of x [B, S, heads, hd] -> dst
// [32][HD+1], zero past S and past hd.
template <int HD>
__device__ void load_rows(float* dst, const float* x, int b, int r0, int S,
                          int heads, int head, int hd) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < 32 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float val = 0.f;
    if (r0 + r < S && d < hd)
      val = x[(((size_t)b * S + r0 + r) * heads + head) * hd + d];
    dst[r * LD + d] = val;
  }
}

// positions [r0, r0 + n) of row b of pos [B, S] -> dst, `fill` past S
__device__ void load_pos(int* dst, const int* pos, int b, int r0, int n,
                         int S, int fill) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = r0 + i < S ? pos[(size_t)b * S + r0 + i] : fill;
}

// Does any (query, key) pair of the two tiles count?  Block-uniform.
__device__ bool tiles_live(const int* qp, const int* kp, int nq, int causal,
                           int window) {
  int live = 0;
  for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
    const int r = i / kBK, c = i % kBK;
    live |= r < nq && key_valid(qp[r], kp[c], causal, window);
  }
  return __syncthreads_or(live);
}

// P and dS of the tile pair into t.p / t.ds: S = Q K^T * scale (then the
// softcap), P = exp(S - lse) on valid pairs (0 elsewhere), dP = dO V^T,
// dS = P (dP - delta), times 1 - tanh^2 under the softcap.
template <int HD>
__device__ void tile_scores(const Tiles<HD>& t, int nq, float scale,
                            int causal, int window, float softcap) {
  constexpr int LD = HD + 1, PL = kBK + 1;
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    const int i = threadIdx.x + e * kThreads;
    const int r = i / kBK, c = i % kBK;
    const float* qr = t.q + r * LD;
    const float* dr = t.dout + r * LD;
    const float* kr = t.k + c * LD;
    const float* vr = t.v + c * LD;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      s += qr[d] * kr[d];
      dp += dr[d] * vr[d];
    }
    s *= scale;
    float th = 0.f;
    if (softcap > 0.f) {
      th = tanhf(s / softcap);
      s = softcap * th;
    }
    const bool ok = r < nq && key_valid(t.qp[r], t.kp[c], causal, window);
    const float p = ok ? expf(s - t.lse[r]) : 0.f;
    float ds = p * (dp - t.delta[r]);
    if (softcap > 0.f) ds *= 1.f - th * th;
    t.p[r * PL + c] = p;
    t.ds[r * PL + c] = ds;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const int* __restrict__ q_pos,
            const int* __restrict__ kv_pos, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
            int H, int KV, int hd, float scale, int causal, int window,
            float softcap) {
  constexpr int LD = HD + 1, PL = kBK + 1;
  constexpr int E = kBK * HD / kThreads;     // owned (key, column) slots
  extern __shared__ float smem[];
  const Tiles<HD> t(smem);
  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  load_rows<HD>(t.k, k, b, k0, Sk, KV, kvh, hd);
  load_rows<HD>(t.v, v, b, k0, Sk, KV, kvh, hd);
  load_pos(t.kp, kv_pos, b, k0, kBK, Sk, -1);
  float dk_acc[E], dv_acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  const int col = threadIdx.x % HD;          // the same for every slot
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = 0; q0 < Sq; q0 += kBQ) {
      const int nq = min(kBQ, Sq - q0);
      __syncthreads();                       // the last tile's reads done
      load_pos(t.qp, q_pos, b, q0, kBQ, Sq, 0);
      __syncthreads();
      if (!tiles_live(t.qp, t.kp, nq, causal, window)) continue;
      load_rows<HD>(t.q, q, b, q0, Sq, H, h, hd);
      load_rows<HD>(t.dout, dout, b, q0, Sq, H, h, hd);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        const size_t o = ((size_t)b * H + h) * Sq + q0 + r;
        t.lse[r] = r < nq ? lse[o] : 0.f;
        t.delta[r] = r < nq ? delta[o] : 0.f;
      }
      __syncthreads();
      tile_scores<HD>(t, nq, scale, causal, window, softcap);
      __syncthreads();
      for (int r = 0; r < nq; ++r) {
        const float qv = t.q[r * LD + col], gv = t.dout[r * LD + col];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = (threadIdx.x + e * kThreads) / HD;
          dv_acc[e] += t.p[r * PL + c] * gv;
          dk_acc[e] += t.ds[r * PL + c] * qv;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = (threadIdx.x + e * kThreads) / HD;
    if (k0 + c < Sk && col < hd) {
      const size_t o = (((size_t)b * Sk + k0 + c) * KV + kvh) * hd + col;
      dk[o] = dk_acc[e] * scale;
      dv[o] = dv_acc[e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ q_pos,
          const int* __restrict__ kv_pos, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd,
          float scale, int causal, int window, float softcap) {
  constexpr int LD = HD + 1, PL = kBK + 1;
  constexpr int E = kBQ * HD / kThreads;     // owned (query, column) slots
  extern __shared__ float smem[];
  const Tiles<HD> t(smem);
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int nq = min(kBQ, Sq - q0);
  load_rows<HD>(t.q, q, b, q0, Sq, H, h, hd);
  load_rows<HD>(t.dout, dout, b, q0, Sq, H, h, hd);
  load_pos(t.qp, q_pos, b, q0, kBQ, Sq, 0);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const size_t o = ((size_t)b * H + h) * Sq + q0 + r;
    t.lse[r] = r < nq ? lse[o] : 0.f;
    t.delta[r] = r < nq ? delta[o] : 0.f;
  }
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  const int col = threadIdx.x % HD;
  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    __syncthreads();                         // the last tile's reads done
    load_pos(t.kp, kv_pos, b, k0, kBK, Sk, -1);
    __syncthreads();
    if (!tiles_live(t.qp, t.kp, nq, causal, window)) continue;
    load_rows<HD>(t.k, k, b, k0, Sk, KV, kvh, hd);
    load_rows<HD>(t.v, v, b, k0, Sk, KV, kvh, hd);
    __syncthreads();
    tile_scores<HD>(t, nq, scale, causal, window, softcap);
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      const float kv = t.k[c * LD + col];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = (threadIdx.x + e * kThreads) / HD;
        acc[e] += t.ds[r * PL + c] * kv;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = (threadIdx.x + e * kThreads) / HD;
    if (r < nq && col < hd)
      dq[(((size_t)b * Sq + q0 + r) * H + h) * hd + col] = acc[e] * scale;
  }
}

template <int HD>
cudaError_t launch_f32_hd(const void* q, const void* k, const void* v,
                          const void* q_pos, const void* kv_pos,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, void* dk, void* dv,
                          int B, int Sq, int Sk, int H, int KV, int hd,
                          int causal, int window, float softcap,
                          cudaStream_t stream) {
  const size_t smem = Smem<HD>::kBytes;
  cudaError_t err = rt::allow_smem(dkdv_kernel<HD>, smem);
  if (err == cudaSuccess) err = rt::allow_smem(dq_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const dim3 gkv((Sk + kBK - 1) / kBK, KV, B);
  dkdv_kernel<HD><<<gkv, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, KV, hd,
      scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq((Sq + kBQ - 1) / kBQ, H, B);
  dq_kernel<HD><<<gq, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), Sq, Sk, H, KV, hd, scale, causal, window,
      softcap);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16

using bf16 = __nv_bfloat16;

// Tile shapes for a head dim padded to HD (16, 32, 64, 128 or 256).
template <int HD>
struct MmaBwd {
  static constexpr int NW = 4;                   // warps a block
  static constexpr int CS = HD > 128 ? 2 : 1;    // warps sharing 16 keys
  static constexpr int BKV = 16 * NW / CS;       // keys a dK/dV block
  static constexpr int BQ = 16 * NW;             // queries a dK/dV tile,
                                                 // and a dQ block
  static constexpr int BKT = HD > 128 ? 32 : 64;  // keys a dQ tile
  static constexpr int LD = HD + 8;   // shared row stride, bf16 elements
  static constexpr int KS = HD / 16;  // k-steps along hd
  static constexpr int OC = HD / CS;  // dK/dV columns a warp owns
  static constexpr bool kReg = HD <= 128;   // operands held as fragments
  // dK/dV: K and V [BKV][LD]; two stages of Q and dO [BQ][LD], then lse,
  // delta and q_pos [BQ]; then the query tiles' flags (sized at launch)
  static constexpr int kKVBytes = BKV * LD * 2;
  static constexpr int kQStage = 2 * BQ * LD * 2 + 3 * BQ * 4;
  static constexpr int kSmemKV = 2 * kKVBytes + 2 * kQStage;
  // dQ: Q and dO [BQ][LD]; two stages of K and V [BKT][LD], then kv_pos;
  // then the key tiles' flags (sized at launch)
  static constexpr int kQBytes = BQ * LD * 2;
  static constexpr int kKStage = 2 * BKT * LD * 2 + BKT * 4;
  static constexpr int kSmemQ = 2 * kQBytes + 2 * kKStage;
  static_assert(kSmemKV <= 227 * 1024 && kSmemQ <= 227 * 1024,
                "a block's tiles must fit in shared memory");
};

// rows [r0, r0 + n) of head `head` of x [B, S, heads, hd] -> dst [n][LD]
// by 16-byte cp.async (zero past S and past hd); threads t0, t0 + nt, ...
// `vec` 0 (hd not a multiple of 8, or a pointer not 16-byte aligned):
// element by element, at once.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* x, int b,
                                          int r0, int n, int S, int heads,
                                          int head, int hd, int vec, int t0,
                                          int nt) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int i = t0; i < n * CH; i += nt) {
    const int r = i / CH, c = (i % CH) * 8, s = r0 + r;
    bf16* d = dst + r * LD + c;
    if (vec) {
      const bool ok = s < S && c < hd;
      const size_t off =
          (((size_t)b * S + (ok ? s : 0)) * heads + head) * hd + (ok ? c : 0);
      rt::cp_async16(d, x + off, ok ? 16 : 0);
    } else {
      for (int e = 0; e < 8; ++e) {
        const bool in = s < S && c + e < hd;
        d[e] = in ? x[(((size_t)b * S + s) * heads + head) * hd + c + e]
                  : rt::from_f32<bf16>(0.f);
      }
    }
  }
}

// n 4-byte values [r0, r0 + n) of `src` -> dst by cp.async, 0 past S
__device__ __forceinline__ void load_row4(void* dst, const void* src, int r0,
                                          int n, int S, int t0, int nt) {
  for (int r = t0; r < n; r += nt) {
    const bool ok = r0 + r < S;
    rt::cp_async4(static_cast<char*>(dst) + 4 * r,
                  static_cast<const char*>(src) + 4 * (ok ? r0 + r : 0),
                  ok ? 4 : 0);
  }
}

// Which of the ceil(n / T) tiles of T positions of a position row `pos`
// [n] hold a position that passes `test`: flags[p] = 1 when one of the 32
// positions from 32 * p on does (tile t owns flags[t * T / 32 ...] up to
// the next tile's; every flag of the last tile is written, 0 past n).
// The block's warps take 32 positions each at a time, one coalesced read
// and a vote.  The launch sizes the flags: flag_bytes<T>(n).
template <int T>
__host__ __device__ constexpr int flag_bytes(int n) {
  return (n + T - 1) / T * (T / 32);
}

template <int T, typename F>
__device__ __forceinline__ void mark_tiles(unsigned char* flags,
                                           const int* pos, int n, int nw,
                                           F test) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int parts = flag_bytes<T>(n);
#pragma unroll 4
  for (int part = warp; part < parts; part += nw) {
    const int s = part * 32 + lane;
    const bool any = __any_sync(0xffffffffu, s < n && test(pos[s]));
    if (lane == 0) flags[part] = any;
  }
}

template <int T>
__device__ __forceinline__ bool tile_live(const unsigned char* flags,
                                          int t) {
  constexpr int P = T / 32;
  bool any = false;
#pragma unroll
  for (int i = 0; i < P; ++i) any |= flags[t * P + i] != 0;
  return any;
}

// The ldmatrix operands of one m16n8k16 step out of a [.][LD] bf16 tile.
// A: rows r0..r0+15, columns c0..c0+15.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* t, int r0,
                                       int c0, int lane) {
  rt::ldmatrix_x4(a, t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                         c0 + (lane >> 4) * 8);
}
// B of two n-tiles whose columns are rows r0..r0+15 (the k dimension
// along the row): {b[0], b[1]} rows r0..r0+7, {b[2], b[3]} r0+8..r0+15.
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t b[4], const bf16* t, int r0,
                                       int c0, int lane) {
  rt::ldmatrix_x4(b, t + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 +
                         ((lane >> 3) & 1) * 8);
}
// B of two n-tiles, k = rows r0..r0+15 and n = columns c0..c0+15:
// {b[0], b[1]} columns c0..c0+7, {b[2], b[3]} c0+8..c0+15.
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t b[4], const bf16* t, int r0,
                                        int c0, int lane) {
  rt::ldmatrix_x4_trans(b, t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LD + c0 + (lane >> 4) * 8);
}

// A fragment of a 16 x 16 tile held as two accumulators x[0], x[1]
// (columns 0-7 and 8-15), rounded to bf16 (the forward's repack of P).
__device__ __forceinline__ void repack(uint32_t a[4], const float x[2][4]) {
  a[0] = rt::pack_bf16(x[0][0], x[0][1]);
  a[1] = rt::pack_bf16(x[0][2], x[0][3]);
  a[2] = rt::pack_bf16(x[1][0], x[1][1]);
  a[3] = rt::pack_bf16(x[1][2], x[1][3]);
}

// key_valid without branches, for the tensor-core kernels' registers
__device__ __forceinline__ bool key_ok(int qp, int kp, int causal,
                                       int window) {
  return (kp >= 0) & ((causal == 0) | (kp <= qp)) &
         ((window <= 0) | (qp - kp < window));
}

// Scale (then softcap) a 16 x 16 score block in place, and the softcap's
// chain-rule factor 1 - tanh^2 beside it (1 without a cap): one branch,
// uniform over the block.
__device__ __forceinline__ void cap_scores(float s[2][4], float cg[2][4],
                                           float scale, float softcap) {
  if (softcap > 0.f) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float th = tanhf(s[n][e] * scale / softcap);
        s[n][e] = softcap * th;
        cg[n][e] = 1.f - th * th;
      }
  } else {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        cg[n][e] = 1.f;
      }
  }
}

// Store an accumulator pair (row, columns c, c + 1) times `mul` as bf16.
__device__ __forceinline__ void store2(bf16* row, int c, int hd, float x0,
                                       float x1, float mul) {
  if (c + 1 < hd && hd % 2 == 0) {
    *reinterpret_cast<uint32_t*>(row + c) = rt::pack_bf16(x0 * mul, x1 * mul);
  } else {
    if (c < hd) row[c] = rt::from_f32<bf16>(x0 * mul);
    if (c + 1 < hd) row[c + 1] = rt::from_f32<bf16>(x1 * mul);
  }
}

// dK and dV of keys [kt * BKV, kt * BKV + BKV) of KV head kvh, row b.
template <int HD>
__device__ __forceinline__ void dkdv_block(
    unsigned char* smem, int kt, int kvh, int b, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Sk, int H, int KV, int hd,
    float scale, int causal, int window, float softcap, int vec) {
  using C = MmaBwd<HD>;
  constexpr int LD = C::LD, KS = C::KS, BQ = C::BQ, BKV = C::BKV;
  constexpr int NT = C::NW * 32, ON = C::OC / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = H / KV, k0 = kt * BKV;
  const int kr0 = (warp / C::CS) * 16;       // the warp's first key row
  const int c0 = (warp % C::CS) * C::OC;     // its first output column
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + BKV * LD;
  unsigned char* stages = smem + 2 * C::kKVBytes;

  load_tile<HD>(k_s, k, b, k0, BKV, Sk, KV, kvh, hd, vec, tid, NT);
  load_tile<HD>(v_s, v, b, k0, BKV, Sk, KV, kvh, hd, vec, tid, NT);
  rt::cp_async_commit();

  // this lane's two keys (rows g and g + 8 of the warp's 16), the
  // warp's and the block's [min, max] of valid key positions
  const int* kpr = kv_pos + (size_t)b * Sk;
  const int key0 = k0 + kr0 + g;
  const int kp0 = key0 < Sk ? kpr[key0] : -1;
  const int kp1 = key0 + 8 < Sk ? kpr[key0 + 8] : -1;
  const int wmin = warp_min(min(kp0 < 0 ? INT_MAX : kp0,
                                kp1 < 0 ? INT_MAX : kp1));
  const int wmax = warp_max(max(kp0, kp1));
  int bmin = INT_MAX, bmax = -1;
  for (int c = lane; c < BKV; c += 32) {
    const int kp = k0 + c < Sk ? kpr[k0 + c] : -1;
    if (kp >= 0) {
      bmin = min(bmin, kp);
      bmax = max(bmax, kp);
    }
  }
  bmin = warp_min(bmin);
  bmax = warp_max(bmax);

  // the live query tiles (the same for every head of the group), then
  // the live (head, query tile) pairs in order, head-major
  const int* qpr = q_pos + (size_t)b * Sq;
  const int nqt = (Sq + BQ - 1) / BQ;
  unsigned char* flags = stages + 2 * C::kQStage;
  mark_tiles<BQ>(flags, qpr, Sq, C::NW, [&](int qp) {
    return sees_keys(qp, bmin, bmax, causal, window);
  });
  __syncthreads();
  int gi = 0, qt = -1;
  auto next_tile = [&]() -> int {
    for (;;) {
      if (++qt >= nqt) {
        qt = 0;
        if (++gi >= G) return -1;
      }
      if (tile_live<BQ>(flags, qt)) return gi * nqt + qt;
    }
  };
  auto stage_q = [&](int st) {
    return reinterpret_cast<bf16*>(stages + st * C::kQStage);
  };
  auto stage_f = [&](int st) {   // lse, delta, then q_pos
    return reinterpret_cast<float*>(stages + st * C::kQStage +
                                    2 * BQ * LD * 2);
  };
  auto issue = [&](int tile, int st) {
    const int h = kvh * G + tile / nqt, q0 = (tile % nqt) * BQ;
    bf16* qs = stage_q(st);
    float* fs = stage_f(st);
    const size_t row = ((size_t)b * H + h) * Sq;
    load_tile<HD>(qs, q, b, q0, BQ, Sq, H, h, hd, vec, tid, NT);
    load_tile<HD>(qs + BQ * LD, dout, b, q0, BQ, Sq, H, h, hd, vec, tid, NT);
    load_row4(fs, lse + row, q0, BQ, Sq, tid, NT);
    load_row4(fs + BQ, delta + row, q0, BQ, Sq, tid, NT);
    load_row4(fs + 2 * BQ, qpr, q0, BQ, Sq, tid, NT);
  };

  float dk_acc[ON][4], dv_acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  int tile = next_tile();
  if (tile >= 0) issue(tile, 0);
  rt::cp_async_commit();
  rt::cp_async_wait<1>();                    // K and V have landed
  __syncthreads();
  uint32_t ka[C::kReg ? KS : 1][4], va[C::kReg ? KS : 1][4];
  if constexpr (C::kReg) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      frag_a<LD>(ka[kk], k_s, kr0, kk * 16, lane);
      frag_a<LD>(va[kk], v_s, kr0, kk * 16, lane);
    }
  }

  int st = 0;
  while (tile >= 0) {
    const int tn = next_tile();
    if (tn >= 0) {
      issue(tn, st ^ 1);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = stage_q(st);
    const bf16* ds = qs + BQ * LD;
    const float* ls = stage_f(st);
    const float* dls = ls + BQ;
    const int* qps = reinterpret_cast<const int*>(ls + 2 * BQ);
    const int q0 = (tile % nqt) * BQ;
#pragma unroll 1
    for (int j = 0; j < BQ; j += 16) {
      // skip 16 queries none of which sees the warp's keys
      const int r = j + (lane & 15);
      if (!__any_sync(0xffffffffu,
                      q0 + r < Sq &&
                          sees_keys(qps[r], wmin, wmax, causal, window)))
        continue;
      // S^T = K Q^T and dP^T = V dO^T: rows are the warp's keys
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4], bq[4], bd[4];
        frag_b<LD>(bq, qs, j, kk * 16, lane);
        frag_b<LD>(bd, ds, j, kk * 16, lane);
        if constexpr (C::kReg) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = ka[kk][i];
        } else {
          frag_a<LD>(a, k_s, kr0, kk * 16, lane);
        }
        rt::mma_bf16_16816(s[0], a, bq[0], bq[1]);
        rt::mma_bf16_16816(s[1], a, bq[2], bq[3]);
        if constexpr (C::kReg) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = va[kk][i];
        } else {
          frag_a<LD>(a, v_s, kr0, kk * 16, lane);
        }
        rt::mma_bf16_16816(dp[0], a, bd[0], bd[1]);
        rt::mma_bf16_16816(dp[1], a, bd[2], bd[3]);
      }
      // P^T and dS^T in place: (key g or g + 8, query n*8 + 2*t4 + e)
      float cg[2][4];
      cap_scores(s, cg, scale, softcap);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j + n * 8 + 2 * t4 + (e & 1);
          const bool ok = (q0 + c < Sq) &
                          key_ok(qps[c], e < 2 ? kp0 : kp1, causal, window);
          const float x = __expf(s[n][e] - ls[c]);
          const float p = ok ? x : 0.f;
          dp[n][e] = p * (dp[n][e] - dls[c]) * cg[n][e];
          s[n][e] = p;
        }
      }
      uint32_t pa[4], da[4];
      repack(pa, s);
      repack(da, dp);
      // dV += P^T dO and dK += dS^T Q over the warp's columns
#pragma unroll
      for (int np = 0; np < C::OC / 16; ++np) {
        uint32_t bd[4], bq[4];
        frag_bt<LD>(bd, ds, j, c0 + np * 16, lane);
        frag_bt<LD>(bq, qs, j, c0 + np * 16, lane);
        rt::mma_bf16_16816(dv_acc[2 * np], pa, bd[0], bd[1]);
        rt::mma_bf16_16816(dv_acc[2 * np + 1], pa, bd[2], bd[3]);
        rt::mma_bf16_16816(dk_acc[2 * np], da, bq[0], bq[1]);
        rt::mma_bf16_16816(dk_acc[2 * np + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();   // the stage is refilled two tiles on
    tile = tn;
    st ^= 1;
  }

#pragma unroll
  for (int n = 0; n < ON; ++n) {
    const int c = c0 + n * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key >= Sk) continue;
      const size_t o = (((size_t)b * Sk + key) * KV + kvh) * hd;
      store2(dk + o, c, hd, dk_acc[n][2 * half], dk_acc[n][2 * half + 1],
             scale);
      store2(dv + o, c, hd, dv_acc[n][2 * half], dv_acc[n][2 * half + 1],
             1.f);
    }
  }
}

// dQ of queries [qt * BQ, qt * BQ + BQ) of head h, row b.
template <int HD>
__device__ __forceinline__ void dq_block(
    unsigned char* smem, int qt, int h, int b, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk,
    int H, int KV, int hd, float scale, int causal, int window,
    float softcap, int vec) {
  using C = MmaBwd<HD>;
  constexpr int LD = C::LD, KS = C::KS, BQ = C::BQ, BKT = C::BKT;
  constexpr int NT = C::NW * 32, ON = HD / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvh = h / (H / KV);
  const int qbase = qt * BQ, q0 = qbase + warp * 16;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + BQ * LD;
  unsigned char* stages = smem + 2 * C::kQBytes;

  load_tile<HD>(q_s, q, b, qbase, BQ, Sq, H, h, hd, vec, tid, NT);
  load_tile<HD>(do_s, dout, b, qbase, BQ, Sq, H, h, hd, vec, tid, NT);
  rt::cp_async_commit();

  // this lane's two query rows (g and g + 8 of the warp's 16), and the
  // [min, max] of the warp's and the block's query positions
  const int* qpr = q_pos + (size_t)b * Sq;
  const bool in0 = q0 + g < Sq, in1 = q0 + g + 8 < Sq;
  const int qp0 = in0 ? qpr[q0 + g] : 0, qp1 = in1 ? qpr[q0 + g + 8] : 0;
  const size_t row = ((size_t)b * H + h) * Sq;
  const float lse0 = in0 ? lse[row + q0 + g] : 0.f;
  const float lse1 = in1 ? lse[row + q0 + g + 8] : 0.f;
  const float dl0 = in0 ? delta[row + q0 + g] : 0.f;
  const float dl1 = in1 ? delta[row + q0 + g + 8] : 0.f;
  const int wmin = warp_min(min(in0 ? qp0 : INT_MAX, in1 ? qp1 : INT_MAX));
  const int wmax = warp_max(max(in0 ? qp0 : INT_MIN, in1 ? qp1 : INT_MIN));
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = lane; r < BQ; r += 32) {
    if (qbase + r < Sq) {
      qmin = min(qmin, qpr[qbase + r]);
      qmax = max(qmax, qpr[qbase + r]);
    }
  }
  qmin = warp_min(qmin);
  qmax = warp_max(qmax);

  // the live key tiles, in order
  const int* kpr = kv_pos + (size_t)b * Sk;
  const int ntiles = (Sk + BKT - 1) / BKT;
  unsigned char* flags = stages + 2 * C::kKStage;
  mark_tiles<BKT>(flags, kpr, Sk, C::NW, [&](int kp) {
    return seen_by(kp, qmin, qmax, causal, window);
  });
  __syncthreads();
  int jt = -1;
  auto next_tile = [&]() -> int {
    while (++jt < ntiles)
      if (tile_live<BKT>(flags, jt)) return jt;
    return -1;
  };
  auto stage_k = [&](int st) {
    return reinterpret_cast<bf16*>(stages + st * C::kKStage);
  };
  auto stage_kp = [&](int st) {
    return reinterpret_cast<int*>(stages + st * C::kKStage +
                                  2 * BKT * LD * 2);
  };
  auto issue = [&](int j, int st) {
    bf16* ks = stage_k(st);
    load_tile<HD>(ks, k, b, j * BKT, BKT, Sk, KV, kvh, hd, vec, tid, NT);
    load_tile<HD>(ks + BKT * LD, v, b, j * BKT, BKT, Sk, KV, kvh, hd, vec,
                  tid, NT);
    load_row4(stage_kp(st), kpr, j * BKT, BKT, Sk, tid, NT);
  };

  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int j = next_tile();
  if (j >= 0) issue(j, 0);
  rt::cp_async_commit();
  rt::cp_async_wait<1>();                    // Q and dO have landed
  __syncthreads();
  const int wr = warp * 16;                  // the warp's rows in q_s
  uint32_t qa[C::kReg ? KS : 1][4], ga[C::kReg ? KS : 1][4];
  if constexpr (C::kReg) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      frag_a<LD>(qa[kk], q_s, wr, kk * 16, lane);
      frag_a<LD>(ga[kk], do_s, wr, kk * 16, lane);
    }
  }

  int st = 0;
  while (j >= 0) {
    const int jn = next_tile();
    if (jn >= 0) {
      issue(jn, st ^ 1);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stage_k(st);
    const bf16* vs = ks + BKT * LD;
    const int* kps = stage_kp(st);
    const int k0 = j * BKT;
#pragma unroll 1
    for (int jj = 0; jj < BKT; jj += 16) {
      // skip 16 keys none of which the warp's queries see
      const int c = jj + (lane & 15);
      if (!__any_sync(0xffffffffu,
                      k0 + c < Sk &&
                          seen_by(kps[c], wmin, wmax, causal, window)))
        continue;
      // S = Q K^T and dP = dO V^T: rows are the warp's queries
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4], bk[4], bv[4];
        frag_b<LD>(bk, ks, jj, kk * 16, lane);
        frag_b<LD>(bv, vs, jj, kk * 16, lane);
        if constexpr (C::kReg) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
        } else {
          frag_a<LD>(a, q_s, wr, kk * 16, lane);
        }
        rt::mma_bf16_16816(s[0], a, bk[0], bk[1]);
        rt::mma_bf16_16816(s[1], a, bk[2], bk[3]);
        if constexpr (C::kReg) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = ga[kk][i];
        } else {
          frag_a<LD>(a, do_s, wr, kk * 16, lane);
        }
        rt::mma_bf16_16816(dp[0], a, bv[0], bv[1]);
        rt::mma_bf16_16816(dp[1], a, bv[2], bv[3]);
      }
      // dS in place: (query g or g + 8, key jj + n*8 + 2*t4 + e)
      float cg[2][4];
      cap_scores(s, cg, scale, softcap);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = jj + n * 8 + 2 * t4 + (e & 1);
          const bool lo = e < 2;
          const bool ok = (lo ? in0 : in1) & (k0 + cc < Sk) &
                          key_ok(lo ? qp0 : qp1, kps[cc], causal, window);
          const float x = __expf(s[n][e] - (lo ? lse0 : lse1));
          const float p = ok ? x : 0.f;
          dp[n][e] = p * (dp[n][e] - (lo ? dl0 : dl1)) * cg[n][e];
        }
      }
      uint32_t da[4];
      repack(da, dp);
      // dQ += dS K
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bb[4];
        frag_bt<LD>(bb, ks, jj, np * 16, lane);
        rt::mma_bf16_16816(acc[2 * np], da, bb[0], bb[1]);
        rt::mma_bf16_16816(acc[2 * np + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();   // the stage is refilled two tiles on
    j = jn;
    st ^= 1;
  }

#pragma unroll
  for (int n = 0; n < ON; ++n) {
    const int c = n * 8 + 2 * t4;
    if (in0)
      store2(dq + (((size_t)b * Sq + q0 + g) * H + h) * hd, c, hd,
             acc[n][0], acc[n][1], scale);
    if (in1)
      store2(dq + (((size_t)b * Sq + q0 + g + 8) * H + h) * hd, c, hd,
             acc[n][2], acc[n][3], scale);
  }
}

// One launch for both kinds of block, which need only delta: blocks
// [0, nkt * KV * B) take dK/dV, key tiles in increasing order (under a
// causal mask the first have the most queries to visit); the rest take dQ,
// query tiles in decreasing order.  Lighter blocks then fill the SMs that
// heavier ones leave, across both kinds.
template <int HD>
__global__ void __launch_bounds__(MmaBwd<HD>::NW * 32)
bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ q_pos,
               const int* __restrict__ kv_pos, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int B, int Sq, int Sk, int H, int KV,
               int hd, float scale, int causal, int window, float softcap,
               int vec) {
  using C = MmaBwd<HD>;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int nkt = (Sk + C::BKV - 1) / C::BKV;
  const int nqt = (Sq + C::BQ - 1) / C::BQ;
  int i = blockIdx.x;
  if (i < nkt * KV * B) {
    dkdv_block<HD>(smem, i / (KV * B), (i / B) % KV, i % B, q, k, v, q_pos,
                   kv_pos, dout, lse, delta, dk, dv, Sq, Sk, H, KV, hd,
                   scale, causal, window, softcap, vec);
  } else {
    i -= nkt * KV * B;
    dq_block<HD>(smem, nqt - 1 - i / (H * B), (i / B) % H, i % B, q, k, v,
                 q_pos, kv_pos, dout, lse, delta, dq, Sq, Sk, H, KV, hd,
                 scale, causal, window, softcap, vec);
  }
}

template <int HD>
cudaError_t launch_mma_hd(const void* q, const void* k, const void* v,
                          const void* q_pos, const void* kv_pos,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, void* dk, void* dv,
                          int B, int Sq, int Sk, int H, int KV, int hd,
                          int causal, int window, float softcap,
                          cudaStream_t stream) {
  using C = MmaBwd<HD>;
  const int smem_kv = C::kSmemKV + flag_bytes<C::BQ>(Sq);
  const int smem_q = C::kSmemQ + flag_bytes<C::BKT>(Sk);
  const int smem = smem_kv > smem_q ? smem_kv : smem_q;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = rt::allow_smem(bwd_mma_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int vec = hd % 8 == 0 && rt::aligned16(q) && rt::aligned16(k) &&
                  rt::aligned16(v) && rt::aligned16(dout);
  const int blocks = (Sk + C::BKV - 1) / C::BKV * KV * B +
                     (Sq + C::BQ - 1) / C::BQ * H * B;
  bwd_mma_kernel<HD><<<blocks, C::NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      B, Sq, Sk, H, KV, hd, scale, causal, window, softcap, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, const void* out,
                   const void* dout, const void* lse, void* delta, void* dq,
                   void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                   int hd, int causal, int window, float softcap,
                   cudaStream_t st) {
  const int rows = B * Sq * H;
  delta_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), Sq, H, hd, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define RT_BWD_HD(N)                                                        \
  if (hd <= N) {                                                            \
    if constexpr (sizeof(T) == 4)                                           \
      return launch_f32_hd<N>(q, k, v, q_pos, kv_pos, dout, lse, delta, dq, \
                              dk, dv, B, Sq, Sk, H, KV, hd, causal, window, \
                              softcap, st);                                 \
    else                                                                    \
      return launch_mma_hd<N>(q, k, v, q_pos, kv_pos, dout, lse, delta, dq, \
                              dk, dv, B, Sq, Sk, H, KV, hd, causal, window, \
                              softcap, st);                                 \
  }
  RT_BWD_HD(16)
  RT_BWD_HD(32)
  RT_BWD_HD(64)
  RT_BWD_HD(128)
  RT_BWD_HD(256)
#undef RT_BWD_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// dq, dk, dv of flash_attention(q, k, v, q_pos, kv_pos) given dout and
// the forward's out and lse [B, H, Sq] f32; delta is [B, H, Sq] f32
// scratch.  window <= 0: no window; softcap <= 0: no softcap.  f32 takes
// the FFMA kernels, bf16 the tensor-core ones.  Returns a cudaError_t
// code (0 = ok).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* kv_pos, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int causal, int window,
                                   float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return launch<float>(q, k, v, q_pos, kv_pos, out, dout, lse, delta, dq,
                         dk, dv, B, Sq, Sk, H, KV, hd, causal, window,
                         softcap, st);
  if (dtype == RT_BF16)
    return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, dout, lse,
                                 delta, dq, dk, dv, B, Sq, Sk, H, KV, hd,
                                 causal, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
