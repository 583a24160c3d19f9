// Paged decode attention through a block table, for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention.py,
//   paged_decode_attention_pallas (kernel body _paged_attn_kernel).
//
// Computes, for one query per batch row, attention over that row's
// context, which lives in fixed-size blocks of a shared pool
// [P, bs, KV, hd] addressed through block_tables [B, nb] (-1 =
// unallocated).  Slot t of table column j holds absolute position
// j*bs + t; it counts iff first[b] <= pos <= last[b] and the block is
// allocated.  GQA (G = H/KV query heads per KV head), optional softcap,
// f32 online softmax; output [B, H, hd] in the input type.
//
// Bound: memory.  A decode step reads each live K/V block once and does
// 4*G*hd flops per slot, far below the card's ~295 flops/byte balance.
//
// Design: one thread block per (row, KV head), so the row's K/V blocks
// are read once for all G query heads that share them.  The block reads
// its own table entries (the TPU kernel gets them by scalar prefetch)
// and skips, without touching the pool, every entry that is -1 or lies
// wholly outside [first, last]: the bytes read are the live blocks only.
// Each live block is staged in shared memory as f32, scored with one
// warp per (head, slot) dot product, and folded into an f32 online
// softmax whose accumulator stays in shared memory.  Skipping a block
// is exact: it would only contribute -1e30 scores, which the first live
// block's rescale factor exp(-1e30 - m) = 0 removes.  A row with no live
// slot writes zeros (finite).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ first,
                    const int* __restrict__ last, T* __restrict__ out,
                    int H, int KV, int hd, int bs, int nb, int P,
                    float scale, float softcap) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  extern __shared__ float smem[];
  float* q_s = smem;             // [G][hd]
  float* k_s = q_s + G * hd;     // [bs][hd]
  float* v_s = k_s + bs * hd;    // [bs][hd]
  float* p_s = v_s + bs * hd;    // [G][bs] scores, then probabilities
  float* acc_s = p_s + G * bs;   // [G][hd]
  float* m_s = acc_s + G * hd;   // [G] running max
  float* l_s = m_s + G;          // [G] running denominator
  float* a_s = l_s + G;          // [G] this block's rescale factor
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    q_s[i] = rt::to_f32(q[((size_t)b * H + kvh * G + g) * hd + d]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = rt::kNegInf;
    l_s[g] = 0.f;
  }
  const int lo = first[b];
  const int hi = last[b];
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const int blk = tables[(size_t)b * nb + j];
    const int p0 = j * bs;
    // uniform across the thread block: skip dead entries unread
    if (blk < 0 || blk >= P || p0 > hi || p0 + bs - 1 < lo) continue;
    const size_t base = (size_t)blk * bs * KV * hd;
    for (int i = tid; i < bs * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const size_t off = base + ((size_t)t * KV + kvh) * hd + d;
      k_s[i] = rt::to_f32(k_pool[off]);
      v_s[i] = rt::to_f32(v_pool[off]);
    }
    __syncthreads();
    for (int pr = warp; pr < G * bs; pr += kWarps) {
      const int g = pr / bs, t = pr % bs;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[g * hd + d] * k_s[t * hd + d];
      part = rt::warp_sum(part);
      if (lane == 0) {
        float s = part * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int pos = p0 + t;
        p_s[pr] = (pos >= lo && pos <= hi) ? s : rt::kNegInf;
      }
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float mx = m_s[g];
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, p_s[g * bs + t]);
      const float alpha = expf(m_s[g] - mx);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float e = expf(p_s[g * bs + t] - mx);
        p_s[g * bs + t] = e;
        sum += e;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = mx;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      float acc = acc_s[i] * a_s[g];
      for (int t = 0; t < bs; ++t) acc += p_s[g * bs + t] * v_s[t * hd + d];
      acc_s[i] = acc;
    }
    __syncthreads();
  }
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    out[((size_t)b * H + kvh * G + g) * hd + d] =
        rt::from_f32<T>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* first, const void* last,
                   void* out, int B, int H, int KV, int hd, int bs, int nb,
                   int P, float softcap, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * (2 * G * hd + 2 * bs * hd + G * bs + 3 * G);
  cudaError_t err = rt::allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KV);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(first), static_cast<const int*>(last),
      static_cast<T*>(out), H, KV, hd, bs, nb, P,
      1.f / sqrtf(static_cast<float>(hd)), softcap);
  return cudaGetLastError();
}

}  // namespace

// softcap <= 0 means no softcap.  Returns a cudaError_t code (0 = ok).
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* first, const void* last,
                                      void* out, int B, int H, int KV, int hd,
                                      int bs, int nb, int P, float softcap,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return launch<float>(q, k_pool, v_pool, tables, first, last, out, B, H,
                         KV, hd, bs, nb, P, softcap, st);
  if (dtype == RT_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, first, last, out,
                                 B, H, KV, hd, bs, nb, P, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
