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
// the input type; all arithmetic in f32.  Three kernels:
//   1. delta_kernel: delta = rowsum(dO * O) per (b, h, query), one warp
//      a row, into the wrapper's [B, H, Sq] f32 scratch.
//   2. dkdv_kernel: one block per (b, KV head, 32-key tile).  It loops
//      over the G heads of the group and the 32-query tiles, recomputes
//      P = exp(S - lse) and dS = P * (dP - delta) for the tile pair in
//      shared memory, and accumulates dV += P^T dO and dK += dS^T Q in
//      registers (each thread owns fixed (key, column) slots).  No
//      atomics: the block owns its keys' gradients.
//   3. dq_kernel: one block per (b, head, 32-query tile); it loops over
//      the key tiles and accumulates dQ += dS K the same way.
// A tile pair with no valid (query, key) pair is skipped, tested pair by
// pair from the positions, so no valid key is ever skipped.  A query row
// with no valid key has an unspecified forward output: its P and dS are
// 0 here, so it adds nothing to dK or dV, and its dq is 0.
//
// Bound: for olmo-1b's training shape (B 4, S 256, 16 heads of hd 128,
// causal) the 8 tensors move ~34 MB (~0.010 ms at 3.35 TB/s), while the
// recomputed products are ~3.8 GFLOP of FFMA; at f32 FFMA rates the
// operations bound it.  This design is the simple, deterministic one:
// f32 FFMA from shared memory, rows padded to hd+1 floats so the row and
// column reads hit distinct banks.  A tensor-core (mma.sync / wgmma)
// design is later work.  Output is deterministic: fixed loop orders, no
// atomics.

#include "common.cuh"

namespace {

constexpr int kBQ = 32;         // queries per tile
constexpr int kBK = 32;         // keys per tile
constexpr int kThreads = 256;
constexpr int kPairs = kBQ * kBK / kThreads;   // score pairs per thread

__device__ __forceinline__ bool key_valid(int qp, int kp, int causal,
                                          int window) {
  if (kp < 0) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && qp - kp >= window) return false;
  return true;
}

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
// [32][HD+1] f32, zero past S and past hd.
template <typename T, int HD>
__device__ void load_rows(float* dst, const T* x, int b, int r0, int S,
                          int heads, int head, int hd) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < 32 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float val = 0.f;
    if (r0 + r < S && d < hd)
      val = rt::to_f32(x[(((size_t)b * S + r0 + r) * heads + head) * hd + d]);
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
// dS = P (dP - delta), times 1 - tanh^2 under the softcap.  dS is the
// gradient of the capped, scaled score; the caller multiplies by scale.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int Sq, int H, int hd, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + warp;   // (b, s, h)
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ q_pos,
            const int* __restrict__ kv_pos, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
            int KV, int hd, float scale, int causal, int window,
            float softcap) {
  constexpr int LD = HD + 1, PL = kBK + 1;
  constexpr int E = kBK * HD / kThreads;     // owned (key, column) slots
  extern __shared__ float smem[];
  const Tiles<HD> t(smem);
  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  load_rows<T, HD>(t.k, k, b, k0, Sk, KV, kvh, hd);
  load_rows<T, HD>(t.v, v, b, k0, Sk, KV, kvh, hd);
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
      load_rows<T, HD>(t.q, q, b, q0, Sq, H, h, hd);
      load_rows<T, HD>(t.dout, dout, b, q0, Sq, H, h, hd);
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
      dk[o] = rt::from_f32<T>(dk_acc[e] * scale);
      dv[o] = rt::from_f32<T>(dv_acc[e]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const int* __restrict__ q_pos,
          const int* __restrict__ kv_pos, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd,
          float scale, int causal, int window, float softcap) {
  constexpr int LD = HD + 1, PL = kBK + 1;
  constexpr int E = kBQ * HD / kThreads;     // owned (query, column) slots
  extern __shared__ float smem[];
  const Tiles<HD> t(smem);
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int nq = min(kBQ, Sq - q0);
  load_rows<T, HD>(t.q, q, b, q0, Sq, H, h, hd);
  load_rows<T, HD>(t.dout, dout, b, q0, Sq, H, h, hd);
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
    load_rows<T, HD>(t.k, k, b, k0, Sk, KV, kvh, hd);
    load_rows<T, HD>(t.v, v, b, k0, Sk, KV, kvh, hd);
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
      dq[(((size_t)b * Sq + q0 + r) * H + h) * hd + col] =
          rt::from_f32<T>(acc[e] * scale);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const void* q_pos, const void* kv_pos,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                      int H, int KV, int hd, int causal, int window,
                      float softcap, cudaStream_t stream) {
  const size_t smem = Smem<HD>::kBytes;
  cudaError_t err = rt::allow_smem(dkdv_kernel<T, HD>, smem);
  if (err == cudaSuccess) err = rt::allow_smem(dq_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const dim3 gkv((Sk + kBK - 1) / kBK, KV, B);
  dkdv_kernel<T, HD><<<gkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, hd, scale,
      causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq((Sq + kBQ - 1) / kBQ, H, B);
  dq_kernel<T, HD><<<gq, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Sk, H, KV, hd, scale, causal, window,
      softcap);
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
  const int per = kThreads / 32;
  delta_kernel<T><<<(rows + per - 1) / per, kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout),
      static_cast<float*>(delta), Sq, H, hd, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define RT_BWD_HD(N)                                                      \
  if (hd <= N)                                                            \
    return launch_hd<T, N>(q, k, v, q_pos, kv_pos, dout, lse, delta, dq,  \
                           dk, dv, B, Sq, Sk, H, KV, hd, causal, window,  \
                           softcap, st);
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
// scratch.  window <= 0: no window; softcap <= 0: no softcap.  Returns a
// cudaError_t code (0 = ok).
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
