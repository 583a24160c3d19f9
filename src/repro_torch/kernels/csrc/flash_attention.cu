// Position-masked flash attention (forward), for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
//   (kernel body _flash_kernel), and the same online-softmax math that
//   the JAX model runs in plain jnp as layers.flash_attention (chunked
//   prefill and prefill).  One kernel serves both: the Pallas kernel's
//   right-aligned masking is the special case q_pos = arange(Sq) + Sk-Sq,
//   kv_pos = arange(Sk).
//
// Layout [B, S, heads, hd] (the model's layout).  A key counts iff
// kv_pos >= 0, and (causal) kv_pos <= q_pos, and (window > 0)
// q_pos - kv_pos < window.  GQA: query head h reads KV head h / (H/KV).
// Fused softcap.  f32 accumulation; output in the input type.  Masked
// scores use the finite -1e30 sentinel, so a query with no valid key
// (a pad query) comes out finite.
//
// Bound: on the serving path, memory.  A chunk of C = 16 queries per
// row does 4*C*hd flops per key it reads, about 16 flops/byte in bf16,
// under the card's ~295 flops/byte balance; the time is the K/V bytes
// of the keys that are live for the chunk.
//
// Design: one thread block per (q tile of 16 rows, head, batch row) and
// a loop over kv tiles of 16 keys, with f32 online softmax state in
// shared memory (the TPU kernel carries it across sequential grid
// steps; here the loop inside the block replaces that grid axis).
// Before loading a kv tile the block checks, from the tile's kv_pos
// alone, whether any (query, key) pair of the tile is valid and skips
// the tile's K/V loads otherwise: chunked prefill gathers the whole
// block-table width and most of those slots are unwritten (-1), and
// causal tiles in a query tile's future are skipped the same way.
// Shared rows are padded to hd+1 floats so the score loop's strided
// reads hit distinct banks.

#include "common.cuh"

namespace {

constexpr int kBQ = 16;
constexpr int kBK = 16;
constexpr int kThreads = 128;

__device__ __forceinline__ bool key_valid(int qp, int kp, int causal,
                                          int window) {
  if (kp < 0) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && qp - kp >= window) return false;
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ kv_pos, T* __restrict__ out, int Sq,
             int Sk, int H, int KV, int hd, float scale, int causal,
             int window, float softcap) {
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int kvh = h / G;
  const int ld = hd + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBQ][ld], pre-scaled
  float* k_s = q_s + kBQ * ld;        // [kBK][ld]
  float* v_s = k_s + kBK * ld;        // [kBK][ld]
  float* acc_s = v_s + kBK * ld;      // [kBQ][hd]
  float* p_s = acc_s + kBQ * hd;      // [kBQ][kBK]
  float* m_s = p_s + kBQ * kBK;       // [kBQ]
  float* l_s = m_s + kBQ;             // [kBQ]
  float* a_s = l_s + kBQ;             // [kBQ]
  int* qp_s = reinterpret_cast<int*>(a_s + kBQ);  // [kBQ]
  int* kp_s = qp_s + kBQ;                         // [kBK]
  const int tid = threadIdx.x;
  const int q0 = qt * kBQ;
  const int nrows = min(kBQ, Sq - q0);

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    float x = 0.f;
    if (r < nrows) x = rt::to_f32(q[(((size_t)b * Sq + q0 + r) * H + h) * hd + d]);
    q_s[r * ld + d] = x * scale;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    qp_s[r] = r < nrows ? q_pos[(size_t)b * Sq + q0 + r] : 0;
    m_s[r] = rt::kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    for (int c = tid; c < kBK; c += kThreads)
      kp_s[c] = (k0 + c < Sk) ? kv_pos[(size_t)b * Sk + k0 + c] : -1;
    __syncthreads();
    int live = 0;
    for (int i = tid; i < nrows * kBK; i += kThreads)
      live |= key_valid(qp_s[i / kBK], kp_s[i % kBK], causal, window);
    if (!__syncthreads_or(live)) continue;   // uniform: whole tile masked
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int c = i / hd, d = i % hd;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk) {
        const size_t off = (((size_t)b * Sk + k0 + c) * KV + kvh) * hd + d;
        kx = rt::to_f32(k[off]);
        vx = rt::to_f32(v[off]);
      }
      k_s[c * ld + d] = kx;
      v_s[c * ld + d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += q_s[r * ld + d] * k_s[c * ld + d];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const bool ok = r < nrows && key_valid(qp_s[r], kp_s[c], causal, window);
      p_s[i] = ok ? s : rt::kNegInf;   // rows past Sq are never written
    }
    __syncthreads();
    for (int r = tid; r < kBQ; r += kThreads) {
      float mx = m_s[r];
      for (int c = 0; c < kBK; ++c) mx = fmaxf(mx, p_s[r * kBK + c]);
      const float alpha = expf(m_s[r] - mx);
      float sum = 0.f;
      for (int c = 0; c < kBK; ++c) {
        const float e = expf(p_s[r * kBK + c] - mx);
        p_s[r * kBK + c] = e;
        sum += e;
      }
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = mx;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      float acc = acc_s[i] * a_s[r];
      for (int c = 0; c < kBK; ++c) acc += p_s[r * kBK + c] * v_s[c * ld + d];
      acc_s[i] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < nrows * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    out[(((size_t)b * Sq + q0 + r) * H + h) * hd + d] =
        rt::from_f32<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, void* out, int B,
                   int Sq, int Sk, int H, int KV, int hd, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const int ld = hd + 1;
  const size_t smem =
      sizeof(float) * (kBQ * ld + 2 * kBK * ld + kBQ * hd + kBQ * kBK +
                       3 * kBQ) +
      sizeof(int) * (kBQ + kBK);
  cudaError_t err = rt::allow_smem(flash_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(out), Sq, Sk, H, KV,
      hd, 1.f / sqrtf(static_cast<float>(hd)), causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap.  Returns a
// cudaError_t code (0 = ok).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* q_pos, const void* kv_pos,
                               void* out, int B, int Sq, int Sk, int H,
                               int KV, int hd, int causal, int window,
                               float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return launch<float>(q, k, v, q_pos, kv_pos, out, B, Sq, Sk, H, KV, hd,
                         causal, window, softcap, st);
  if (dtype == RT_BF16)
    return launch<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, Sq, Sk, H,
                                 KV, hd, causal, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
