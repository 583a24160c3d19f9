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
// Bound: memory.  A decode step reads each live K/V slot once and does
// 4*G*hd flops per slot, far below the card's ~295 flops/byte balance.
// At serving batch the live K/V is a few MB, so the time is how soon
// enough loads are in flight: spread over the SMs, many per warp.
//
// Design: thread blocks of 4 warps per (row, KV head, split).  The split
// (flash-decoding) cuts the row's table columns into n_splits ranges
// when B*KV blocks alone would leave SMs idle; the wrapper picks the
// count (ops.paged_decode_splits).  Inside a block the warps take the
// range's columns in turn.  A warp reads its table entries 32 at a time
// and ballots the live ones: entries that are -1, out of the pool, or
// wholly outside [first, last] are skipped unread, and so are the dead
// slots at either end of a live block.  Within a warp, hd/8 lanes (bf16;
// hd/4 for f32) cover one slot's row with 16-byte loads straight into
// registers, so a load instruction covers 32*8/hd slots (2 at hd 128).
// The warp keeps a ring of 4 such steps in flight (a deeper ring costs
// registers, and with them blocks per SM); the next steps' loads, the
// next block's included, are issued before the current one is scored.
// There is no shared memory and no barrier in the column loop.  q and
// each slot group's online-softmax state (m, l, and an accumulator
// slice per lane) stay in registers; a slot's score is reduced with xor
// shuffles inside its lane group.  The G query heads
// of a KV head loop over the K/V already in registers, so each K/V byte
// is read once per KV head (in groups of 8 heads above G = 8).  At the
// end the slot groups merge by shuffles, the 4 warps through shared
// memory in warp order, and with n_splits > 1 each block writes f32
// partials (m, l, acc) to scratch that paged_combine_kernel merges in
// split order.  Fixed orders and no atomics: the output is
// deterministic.  A masked slot takes no part at all (it is not read and
// not weighed), which equals the plain version's exp(-1e30 - m) = 0.
// A row with no live slot writes zeros (finite).

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// one 16-byte chunk -> its elements as f32
__device__ __forceinline__ void chunk_f32(const uint4& x, float* f,
                                          const float*) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void chunk_f32(const uint4& x, float* f,
                                          const __nv_bfloat16*) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// LPS lanes per slot, CPL 16-byte chunks per lane, GT query heads in
// registers.
template <typename T, int LPS, int CPL, int GT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ first,
                    const int* __restrict__ last, T* __restrict__ out,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int H, int KV, int hd, int bs, int nb, int P,
                    int n_splits, float scale, float softcap, int vec) {
  constexpr int EPL = 16 / sizeof(T);   // elements per chunk
  constexpr int E = CPL * EPL;          // elements per lane
  constexpr int SPW = 32 / LPS;         // slots per warp step
  constexpr int D = 4;                  // warp steps in flight
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sg = lane / LPS, li = lane % LPS;
  const int lo = first[b], hi = last[b];
  const int per = (nb + n_splits - 1) / n_splits;
  const int c_begin = split * per, c_end = min(nb, c_begin + per);
  const int* trow = tables + (size_t)b * nb;
  extern __shared__ float smem[];
  float* w_ml = smem;                        // [kWarps][GT][2]
  float* w_acc = smem + kWarps * GT * 2;     // [kWarps][GT][hd]

  for (int g0 = 0; g0 < G; g0 += GT) {
    const int gn = min(GT, G - g0);
    float qf[GT][E], acc[GT][E], m[GT], l[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      m[g] = rt::kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = (c * LPS + li) * EPL + e;
          qf[g][c * EPL + e] =
              g < gn && d < hd
                  ? rt::to_f32(q[((size_t)b * H + kvh * G + g0 + g) * hd + d])
                  : 0.f;
          acc[g][c * EPL + e] = 0.f;
        }
      }
    }

    // ---- the warp's slot stream: live columns c_begin + warp + 4i,
    // and in each the slots [t0, thi] inside [first, last]
    int cbase = -32, centry = -1, cur = -1, t0 = 0, thi = -1;
    unsigned cmask = 0;
    bool done = false;
    // -> the pool row of this lane's slot (-1: none); false at the end
    auto next_step = [&](int& row) -> bool {
      t0 += SPW;
      while (!done && t0 > thi) {
        if (cmask == 0) {
          cbase += 32;
          if (c_begin + warp + cbase * kWarps >= c_end) {
            done = true;
            break;
          }
          const int c = c_begin + warp + (cbase + lane) * kWarps;
          bool lv = false;
          centry = -1;
          if (c < c_end) {
            centry = trow[c];
            lv = centry >= 0 && centry < P && c * bs <= hi &&
                 c * bs + bs - 1 >= lo;
          }
          cmask = __ballot_sync(0xffffffffu, lv);
          continue;
        }
        const int bit = __ffs(cmask) - 1;
        cmask &= cmask - 1;
        cur = __shfl_sync(0xffffffffu, centry, bit);
        const int p0 = (c_begin + warp + (cbase + bit) * kWarps) * bs;
        t0 = max(0, lo - p0);
        thi = min(bs - 1, hi - p0);
      }
      if (done) {
        row = -1;
        return false;
      }
      row = t0 + sg <= thi ? cur * bs + t0 + sg : -1;
      return true;
    };
    auto load = [&](int row, uint4* kc, uint4* vc) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        kc[c] = vc[c] = make_uint4(0, 0, 0, 0);
        const int d0 = (c * LPS + li) * EPL;
        if (row < 0 || d0 >= hd) continue;
        const size_t off = ((size_t)row * KV + kvh) * hd + d0;
        if (vec) {
          kc[c] = *reinterpret_cast<const uint4*>(k_pool + off);
          vc[c] = *reinterpret_cast<const uint4*>(v_pool + off);
        } else {
          T* ke = reinterpret_cast<T*>(&kc[c]);
          T* ve = reinterpret_cast<T*>(&vc[c]);
          for (int e = 0; e < EPL && d0 + e < hd; ++e) {
            ke[e] = k_pool[off + e];
            ve[e] = v_pool[off + e];
          }
        }
      }
    };

    int rows[D];
    bool has[D];
    uint4 kb[D][CPL], vb[D][CPL];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      has[i] = next_step(rows[i]);
      load(rows[i], kb[i], vb[i]);
    }
    bool run = has[0];
    while (run) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        if (!has[i]) {
          run = false;
          break;
        }
        float kf[E], vf[E];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          chunk_f32(kb[i][c], kf + c * EPL, k_pool);
          chunk_f32(vb[i][c], vf + c * EPL, v_pool);
        }
        const bool ok = rows[i] >= 0;
        // refill this ring slot before scoring it
        has[i] = next_step(rows[i]);
        load(rows[i], kb[i], vb[i]);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          if (g >= gn) break;
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part += qf[g][e] * kf[e];
#pragma unroll
          for (int o = LPS / 2; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          if (ok) {
            float s = part * scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            const float mn = fmaxf(m[g], s);
            const float al = expf(m[g] - mn);
            const float p = expf(s - mn);
            l[g] = l[g] * al + p;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * al + p * vf[e];
            m[g] = mn;
          }
        }
      }
    }

    // ---- slot groups of the warp merge by shuffles (lane order fixed)
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mn = fmaxf(m[g], m2);
        const float a = expf(m[g] - mn), a2 = expf(m2 - mn);
        l[g] = l[g] * a + l2 * a2;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float x2 = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * a + x2 * a2;
        }
        m[g] = mn;
      }
    }
    if (sg == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (li == 0) {
          w_ml[(warp * GT + g) * 2] = m[g];
          w_ml[(warp * GT + g) * 2 + 1] = l[g];
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const int d = (c * LPS + li) * EPL + e;
            if (d < hd) w_acc[(warp * GT + g) * hd + d] = acc[g][c * EPL + e];
          }
      }
    }
    __syncthreads();
    // ---- the 4 warps merge in warp order
    for (int i = threadIdx.x; i < gn * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      float mt = rt::kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        mt = fmaxf(mt, w_ml[(w * GT + g) * 2]);
      float lt = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(w_ml[(w * GT + g) * 2] - mt);
        lt += w_ml[(w * GT + g) * 2 + 1] * f;
        a += w_acc[(w * GT + g) * hd + d] * f;
      }
      const size_t bh = (size_t)b * H + kvh * G + g0 + g;
      if (n_splits == 1) {
        out[bh * hd + d] = rt::from_f32<T>(a / fmaxf(lt, 1e-30f));
      } else {
        const size_t pi = bh * n_splits + split;
        part_acc[pi * hd + d] = a;
        if (d == 0) {
          part_ml[pi * 2] = mt;
          part_ml[pi * 2 + 1] = lt;
        }
      }
    }
    __syncthreads();   // shared memory is reused by the next head group
  }
}

// Merge the n_splits partials of each (row, head) in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int hd, int n_splits) {
  const size_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_splits * 2;
  float mt = rt::kNegInf;
  for (int s = 0; s < n_splits; ++s) mt = fmaxf(mt, ml[2 * s]);
  float lt = 0.f;
  for (int s = 0; s < n_splits; ++s) lt += ml[2 * s + 1] * expf(ml[2 * s] - mt);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      a += part_acc[(bh * n_splits + s) * hd + d] * expf(ml[2 * s] - mt);
    out[bh * hd + d] = rt::from_f32<T>(a / fmaxf(lt, 1e-30f));
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *tables, *first, *last;
  void *out, *part_ml, *part_acc;
  int B, H, KV, hd, bs, nb, P, n_splits;
  float softcap;
  cudaStream_t stream;
};

template <typename T, int LPS, int CPL, int GT>
cudaError_t launch_shape(const Args& a) {
  auto kernel = paged_decode_kernel<T, LPS, CPL, GT>;
  const size_t smem = sizeof(float) * kWarps * GT * (2 + a.hd);
  cudaError_t err = rt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec = a.hd % (16 / sizeof(T)) == 0 && rt::aligned16(a.k_pool) &&
                  rt::aligned16(a.v_pool);
  const dim3 grid(a.B, a.KV, a.n_splits);
  paged_decode_kernel<T, LPS, CPL, GT><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.first), static_cast<const int*>(a.last),
      static_cast<T*>(a.out), static_cast<float*>(a.part_ml),
      static_cast<float*>(a.part_acc), a.H, a.KV, a.hd, a.bs, a.nb, a.P,
      a.n_splits, 1.f / sqrtf(static_cast<float>(a.hd)), a.softcap, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  paged_combine_kernel<T><<<a.B * a.H, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.part_ml),
      static_cast<const float*>(a.part_acc), static_cast<T*>(a.out), a.hd,
      a.n_splits);
  return cudaGetLastError();
}

template <typename T, int LPS, int CPL>
cudaError_t launch_heads(const Args& a) {
  const int G = a.H / a.KV;
  if (G == 1) return launch_shape<T, LPS, CPL, 1>(a);
  if (G == 2) return launch_shape<T, LPS, CPL, 2>(a);
  if (G <= 4) return launch_shape<T, LPS, CPL, 4>(a);
  return launch_shape<T, LPS, CPL, 8>(a);   // loops groups of 8 heads
}

template <typename T>
cudaError_t launch(const Args& a) {
  constexpr int EPL = 16 / sizeof(T);
  const int chunks = (a.hd + EPL - 1) / EPL;
  if (chunks <= 4) return launch_heads<T, 4, 1>(a);
  if (chunks <= 8) return launch_heads<T, 8, 1>(a);
  if (chunks <= 16) return launch_heads<T, 16, 1>(a);
  if (chunks <= 32) return launch_heads<T, 32, 1>(a);
  return launch_heads<T, 32, 2>(a);   // f32 hd > 128
}

}  // namespace

// softcap <= 0 means no softcap.  n_splits > 1 needs part_ml [B,H,n,2]
// and part_acc [B,H,n,hd] f32 scratch.  Returns a cudaError_t code
// (0 = ok).
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* first, const void* last,
                                      void* out, void* part_ml,
                                      void* part_acc, int B, int H, int KV,
                                      int hd, int bs, int nb, int P,
                                      int n_splits, float softcap, int dtype,
                                      void* stream) {
  if (n_splits < 1 || (n_splits > 1 && (!part_ml || !part_acc)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k_pool, v_pool, tables, first, last, out, part_ml,
               part_acc, B, H, KV, hd, bs, nb, P, n_splits, softcap,
               static_cast<cudaStream_t>(stream)};
  if (dtype == RT_F32) {
    if (hd > 256) return static_cast<int>(cudaErrorInvalidValue);
    return launch<float>(a);
  }
  if (dtype == RT_BF16) return launch<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
