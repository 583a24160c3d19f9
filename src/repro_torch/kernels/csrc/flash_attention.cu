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
// Fused softcap.  f32 softmax state; output in the input type.  Masked
// scores use the finite -1e30 sentinel, so a query with no valid key
// (a pad query) comes out finite.
//
// Bound: on the serving path, latency, then memory.  A prefill chunk of
// C = 16 queries per row does 4*C*hd flops per key it reads, about 16
// flops per byte in bf16, far under the card's ~295 flops/byte balance,
// and the live K/V of a chunk is a few hundred KB: the time is a launch,
// the serial chain of kv tiles inside a thread block, and the latency of
// each tile's loads.
//
// Design, bf16 (flash_mma_kernel): tensor cores through mma.sync
// m16n8k16 (bf16 in, f32 sums).  wgmma is not used: it needs 64 query
// rows per tile, and a 16-query chunk of one MHA head would leave 3/4 of
// that tile empty.  One warp owns 16 query rows of one (row, head) and
// keeps them as mma A fragments in registers (ldmatrix, once; hd > 128
// re-reads them from shared memory per tile to stay within registers).
// K/V tiles come into shared memory with 16-byte cp.async, double
// buffered, rows padded by 16 bytes so ldmatrix (K) and ldmatrix.trans
// (V) hit 8 distinct bank groups.  S = Q K^T lands in f32 registers;
// scale, softcap, the position mask and the online softmax (quad
// shuffles for the row max; the row sum is kept per lane and reduced
// once at the end) stay in registers, and P is repacked in registers as
// the bf16 A operand of the P V product: no shared-memory round trip for
// S or P.  The only barriers per tile are the copy pipeline's.  A tile
// with no valid (query, key) pair is skipped before its loads, decided
// from kv_pos alone (the chunk path gathers the whole block-table width,
// mostly unwritten -1 slots): each lane tests one tile and a ballot
// gives the live tiles 32 at a time.  The test bounds the block's query
// positions by [min, max], so it may keep a dead tile, which is exact: a
// masked score weighs exp(-1e30 - m) = 0 once any valid key is seen.
//   Sq <= 16 (the chunk path): one thread block per (row, head); its 8
//   warps split the 16-key tiles between them (split-K inside the block),
//   each with its own (m, l, O), merged through shared memory at the end
//   in warp order.  Only __syncwarp inside the loop.
//   Sq > 16: 4 warps take 16 query rows each (64 per block) and share
//   each 32-key tile, with two __syncthreads per tile.
//   hd that is not a multiple of 16 is zero-padded along the
//   contraction in shared memory (hd rounds up to 16/32/64/128/256).
//   P is rounded to bf16 for the P V product: at most 2^-9 max|v| of
//   error against the f32 plain version.
//
// f32 (flash_kernel): exact f32 FMA from shared memory, no TF32, so the
// card's greedy answers at the f32 smoke config equal the CPU's.  One
// thread block per (16 query rows, head, row), 16-key tiles, the same
// skip of dead tiles.  Shared rows are padded to hd+1 floats.
//
// With a non-null `lse` (the training path) each kernel also writes the
// row's log-sum-exp m + log(l) of its scaled, capped, masked scores
// [B, H, Sq] f32, which flash_attention_bwd.cu's backward reads; serving
// passes null, and the output does not depend on it.
//
// Output is deterministic: fixed summation and merge orders, no atomics.

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

// ------------------------------------------------------------------ f32

constexpr int kBQ = 16;
constexpr int kBK = 16;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ kv_pos, float* __restrict__ out,
             float* __restrict__ lse, int Sq, int Sk, int H, int KV, int hd,
             float scale, int causal, int window, float softcap) {
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int kvh = h / G;
  const int ld = hd + 1;
  extern __shared__ float fsmem[];
  float* q_s = fsmem;                 // [kBQ][ld], pre-scaled
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
    if (r < nrows) x = q[(((size_t)b * Sq + q0 + r) * H + h) * hd + d];
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
        kx = k[off];
        vx = v[off];
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
        acc_s[i] / fmaxf(l_s[r], 1e-30f);
  }
  if (lse != nullptr)
    for (int r = tid; r < nrows; r += kThreads)
      lse[((size_t)b * H + h) * Sq + q0 + r] = m_s[r] + logf(l_s[r]);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* q_pos, const void* kv_pos, void* out,
                       void* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                       int causal, int window, float softcap,
                       cudaStream_t stream) {
  const int ld = hd + 1;
  const size_t smem =
      sizeof(float) * (kBQ * ld + 2 * kBK * ld + kBQ * hd + kBQ * kBK +
                       3 * kBQ) +
      sizeof(int) * (kBQ + kBK);
  cudaError_t err = rt::allow_smem(flash_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KV, hd,
      1.f / sqrtf(static_cast<float>(hd)), causal, window, softcap);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16

using bf16 = __nv_bfloat16;

// Tile shapes for a head dim padded to HD (16, 32, 64, 128 or 256).
// kSplit: the warps split the 16-key tiles of one 16-query tile (8
// warps, so a chunk's few live tiles spread over more serial chains; 4
// at hd 256, where 8 would not fit in shared memory); else 4 warps take
// 16 query rows each and share every 32-key tile (32 rather than 64
// keys: half the score registers and shared memory, more blocks per SM).
template <int HD, bool kSplit>
struct MmaCfg {
  static constexpr int NW = kSplit && HD < 256 ? 8 : 4;  // warps
  static constexpr int QW = kSplit ? 1 : NW;   // warps along queries
  static constexpr int KW = NW / QW;           // warp groups along keys
  static constexpr int BK = kSplit ? 16 : 32;  // keys per kv tile
  static constexpr int LD = HD + 8;    // shared row stride, bf16 elements
  static constexpr int NT = BK / 8;    // score n-tiles per kv tile
  static constexpr int KS = HD / 16;   // k-steps along hd
  static constexpr int ON = HD / 8;    // output n-tiles
  static constexpr bool kQReg = HD <= 128;
  static constexpr int kQBytes = QW * 16 * LD * 2;
  static constexpr int kKVBytes = BK * LD * 2;             // K or V
  static constexpr int kStageBytes = 2 * kKVBytes + BK * 4;  // + kv_pos
  static constexpr int kGroupBytes = 2 * kStageBytes;        // 2 stages
  static constexpr int kSmem = kQBytes + KW * kGroupBytes;
  static_assert(!kSplit || KW * 16 * HD * 4 + KW * 16 * 2 * 4 <=
                               KW * kGroupBytes,
                "the merge must fit in the kv buffers");
};

template <int HD, bool kSplit>
__global__ void __launch_bounds__((MmaCfg<HD, kSplit>::NW * 32))
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, bf16* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int hd, float scale, int causal, int window, float softcap,
                 int vec) {
  using C = MmaCfg<HD, kSplit>;
  constexpr int QW = C::QW, KW = C::KW, BK = C::BK, LD = C::LD;
  constexpr int NT = C::NT, KS = C::KS, ON = C::ON, CH = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = warp % QW, ki = warp / QW;
  const int gt = qi * 32 + lane;            // thread index in the group
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qbase = blockIdx.x * 16 * QW;
  const int q0 = qbase + qi * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const int hd16 = (hd + 15) & ~15;         // contraction width used
  bf16* q_s = reinterpret_cast<bf16*>(smem) + qi * 16 * LD;
  unsigned char* grp = smem + C::kQBytes + ki * C::kGroupBytes;

  // ---- Q tile -> shared (zero past Sq and past hd) -> A fragments
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    bf16* dst = q_s + r * LD + c;
    const bf16* src = q + (((size_t)b * Sq + s) * H + h) * hd + c;
    if (vec) {
      uint4 x = make_uint4(0, 0, 0, 0);
      if (s < Sq && c < hd) x = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst) = x;
    } else {
      for (int e = 0; e < 8; ++e)
        dst[e] = (s < Sq && c + e < hd) ? src[e] : __float2bfloat16(0.f);
    }
  }
  __syncwarp();
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  uint32_t qa[C::kQReg ? KS : 1][4];
  if constexpr (C::kQReg) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      rt::ldmatrix_x4(qa[ks], q_s + a_row * LD + ks * 16 + a_col);
  }

  // ---- positions: this lane's two rows, the group's [min, max]
  const int* qpr = q_pos + (size_t)b * Sq;
  const int* kpr = kv_pos + (size_t)b * Sk;
  const int qp0 = q0 + g < Sq ? qpr[q0 + g] : -1;
  const int qp1 = q0 + g + 8 < Sq ? qpr[q0 + g + 8] : -1;
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = lane; r < 16 * QW; r += 32) {
    if (qbase + r < Sq) {
      const int p = qpr[qbase + r];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);
  const int ntiles = (Sk + BK - 1) / BK;

  // live tiles of this group (tiles ki, ki+KW, ...), 32 at a time
  int chunk = -32;
  unsigned live = 0;
  auto next_tile = [&]() -> int {
    while (live == 0) {
      chunk += 32;
      if (ki + chunk * KW >= ntiles) return -1;
      const int j = ki + (chunk + lane) * KW;
      bool any = false;
      if (j < ntiles) {
        // unrolled, so the tile's loads are all in flight at once
#pragma unroll
        for (int c = 0; c < BK; ++c) {
          const int kp = j * BK + c < Sk ? kpr[j * BK + c] : -1;
          any |= kp >= 0 && (!causal || kp <= qmax) &&
                 (window <= 0 || kp > qmin - window);
        }
      }
      live = __ballot_sync(0xffffffffu, any);
    }
    const int bit = __ffs(live) - 1;
    live &= live - 1;
    return ki + (chunk + bit) * KW;
  };
  auto stage_k = [&](int st) {
    return reinterpret_cast<bf16*>(grp + st * C::kStageBytes);
  };
  auto stage_kp = [&](int st) {
    return reinterpret_cast<int*>(grp + st * C::kStageBytes +
                                  2 * C::kKVBytes);
  };
  auto issue = [&](int j, int st) {
    bf16* ks = stage_k(st);
    bf16* vs = ks + BK * LD;
    const int k0 = j * BK;
    for (int i = gt; i < BK * CH; i += QW * 32) {
      const int r = i / CH, c = (i % CH) * 8, key = k0 + r;
      const bool ok = key < Sk && c < hd;
      const size_t off =
          (((size_t)b * Sk + (ok ? key : 0)) * KV + kvh) * hd + (ok ? c : 0);
      if (vec) {
        rt::cp_async16(ks + r * LD + c, k + off, ok ? 16 : 0);
        rt::cp_async16(vs + r * LD + c, v + off, ok ? 16 : 0);
      } else {
        for (int e = 0; e < 8; ++e) {
          const bool in = key < Sk && c + e < hd;
          const size_t o = (((size_t)b * Sk + key) * KV + kvh) * hd + c + e;
          ks[r * LD + c + e] = in ? k[o] : __float2bfloat16(0.f);
          vs[r * LD + c + e] = in ? v[o] : __float2bfloat16(0.f);
        }
      }
    }
    int* kps = stage_kp(st);
    for (int r = gt; r < BK; r += QW * 32) {
      const bool ok = k0 + r < Sk;
      rt::cp_async4(kps + r, kpr + (ok ? k0 + r : 0), ok ? 4 : 0);
    }
  };
  // a group is one warp (split) or the whole block
  static_assert(QW == 1 || KW == 1, "groups are a warp or the block");
  auto group_sync = [&]() {
    if constexpr (QW == 1)
      __syncwarp();
    else
      __syncthreads();
  };

  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = rt::kNegInf, m1 = rt::kNegInf, l0 = 0.f, l1 = 0.f;

  int j = next_tile();
  if (j >= 0) {
    issue(j, 0);
    rt::cp_async_commit();
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
    group_sync();
    const bf16* ks = stage_k(st);
    const bf16* vs = ks + BK * LD;
    const int* kps = stage_kp(st);

    // S = Q K^T, f32 in registers
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk * 16 < hd16) {
        uint32_t a[4];
        if constexpr (C::kQReg) {
          a[0] = qa[kk][0]; a[1] = qa[kk][1];
          a[2] = qa[kk][2]; a[3] = qa[kk][3];
        } else {
          rt::ldmatrix_x4(a, q_s + a_row * LD + kk * 16 + a_col);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          rt::ldmatrix_x4(bb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       LD + kk * 16 + ((lane >> 3) & 1) * 8);
          rt::mma_bf16_16816(s[2 * np], a, bb[0], bb[1]);
          rt::mma_bf16_16816(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }

    // scale, softcap, mask; online softmax with quad shuffles
    const int k0 = j * BK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t4 + e;
        const int kp = kps[c];
        const bool in = k0 + c < Sk;
        float x0 = s[n][e] * scale, x1 = s[n][2 + e] * scale;
        if (softcap > 0.f) {
          x0 = softcap * tanhf(x0 / softcap);
          x1 = softcap * tanhf(x1 / softcap);
        }
        s[n][e] = in && key_valid(qp0, kp, causal, window) ? x0 : rt::kNegInf;
        s[n][2 + e] =
            in && key_valid(qp1, kp, causal, window) ? x1 : rt::kNegInf;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = __expf(m0 - mx0), al1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = __expf(s[n][0] - m0);
      s[n][1] = __expf(s[n][1] - m0);
      s[n][2] = __expf(s[n][2] - m1);
      s[n][3] = __expf(s[n][3] - m1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + rs0;   // this lane's share; the quad sums at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      o[n][0] *= al0; o[n][1] *= al0;
      o[n][2] *= al1; o[n][3] *= al1;
    }

    // O += P V, P repacked from the S registers as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = rt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = rt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = rt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = rt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        if (np * 16 < hd16) {
          uint32_t bb[4];
          rt::ldmatrix_x4_trans(
              bb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      np * 16 + (lane >> 4) * 8);
          rt::mma_bf16_16816(o[2 * np], pa, bb[0], bb[1]);
          rt::mma_bf16_16816(o[2 * np + 1], pa, bb[2], bb[3]);
        }
      }
    }
    group_sync();   // the stage is refilled two tiles on
    j = jn;
    st ^= 1;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  if constexpr (!kSplit) {
#pragma unroll
    for (int n = 0; n < ON; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t4 + e;
        if (c >= hd) continue;
        if (q0 + g < Sq)
          out[(((size_t)b * Sq + q0 + g) * H + h) * hd + c] =
              __float2bfloat16(o[n][e] / fmaxf(l0, 1e-30f));
        if (q0 + g + 8 < Sq)
          out[(((size_t)b * Sq + q0 + g + 8) * H + h) * hd + c] =
              __float2bfloat16(o[n][2 + e] / fmaxf(l1, 1e-30f));
      }
    }
    if (lse != nullptr && t4 == 0) {
      float* lr = lse + ((size_t)b * H + h) * Sq;
      if (q0 + g < Sq) lr[q0 + g] = m0 + logf(l0);
      if (q0 + g + 8 < Sq) lr[q0 + g + 8] = m1 + logf(l1);
    }
  } else {
    // merge the warps' (m, l, O) in warp order, through the kv buffers
    __syncthreads();
    float* mo = reinterpret_cast<float*>(smem + C::kQBytes);  // [KW][16][HD]
    float* ml = mo + KW * 16 * HD;                            // [KW][16][2]
    float* mine = mo + ki * 16 * HD;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int c = n * 8 + 2 * t4;
      mine[g * HD + c] = o[n][0];
      mine[g * HD + c + 1] = o[n][1];
      mine[(g + 8) * HD + c] = o[n][2];
      mine[(g + 8) * HD + c + 1] = o[n][3];
    }
    if (t4 == 0) {
      ml[(ki * 16 + g) * 2] = m0;
      ml[(ki * 16 + g) * 2 + 1] = l0;
      ml[(ki * 16 + g + 8) * 2] = m1;
      ml[(ki * 16 + g + 8) * 2 + 1] = l1;
    }
    __syncthreads();
    for (int i = tid; i < 16 * hd; i += C::NW * 32) {
      const int r = i / hd, d = i % hd;
      if (q0 + r >= Sq) continue;
      float mt = rt::kNegInf;
#pragma unroll
      for (int w = 0; w < KW; ++w) mt = fmaxf(mt, ml[(w * 16 + r) * 2]);
      float lt = 0.f, acc = 0.f;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const float f = expf(ml[(w * 16 + r) * 2] - mt);
        lt += ml[(w * 16 + r) * 2 + 1] * f;
        acc += mo[(w * 16 + r) * HD + d] * f;
      }
      out[(((size_t)b * Sq + q0 + r) * H + h) * hd + d] =
          __float2bfloat16(acc / fmaxf(lt, 1e-30f));
      if (lse != nullptr && d == 0)
        lse[((size_t)b * H + h) * Sq + q0 + r] = mt + logf(lt);
    }
  }
}

template <int HD, bool kSplit>
cudaError_t launch_mma_hd(const void* q, const void* k, const void* v,
                          const void* q_pos, const void* kv_pos, void* out,
                          void* lse, int B, int Sq, int Sk, int H, int KV,
                          int hd, int causal, int window, float softcap,
                          cudaStream_t stream) {
  using C = MmaCfg<HD, kSplit>;
  cudaError_t err = rt::allow_smem(flash_mma_kernel<HD, kSplit>, C::kSmem);
  if (err != cudaSuccess) return err;
  const int vec = hd % 8 == 0 && rt::aligned16(q) && rt::aligned16(k) &&
                  rt::aligned16(v);
  const dim3 grid((Sq + 16 * C::QW - 1) / (16 * C::QW), H, B);
  flash_mma_kernel<HD, kSplit><<<grid, C::NW * 32, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KV, hd,
      1.f / sqrtf(static_cast<float>(hd)), causal, window, softcap, vec);
  return cudaGetLastError();
}

template <bool kSplit>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* q_pos, const void* kv_pos, void* out,
                       void* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                       int causal, int window, float softcap,
                       cudaStream_t st) {
#define RT_FLASH_HD(N)                                                     \
  if (hd <= N)                                                             \
    return launch_mma_hd<N, kSplit>(q, k, v, q_pos, kv_pos, out, lse, B,   \
                                    Sq, Sk, H, KV, hd, causal, window,     \
                                    softcap, st);
  RT_FLASH_HD(16)
  RT_FLASH_HD(32)
  RT_FLASH_HD(64)
  RT_FLASH_HD(128)
  RT_FLASH_HD(256)
#undef RT_FLASH_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// window <= 0: no window; softcap <= 0: no softcap; lse null: no row
// log-sum-exp.  Returns a cudaError_t code (0 = ok).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* q_pos, const void* kv_pos,
                               void* out, void* lse, int B, int Sq, int Sk, int H,
                               int KV, int hd, int causal, int window,
                               float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32)
    return launch_f32(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Sk, H, KV,
                      hd, causal, window, softcap, st);
  if (dtype == RT_BF16) {
    if (Sq <= 16)
      return launch_mma<true>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Sk, H,
                              KV, hd, causal, window, softcap, st);
    return launch_mma<false>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Sk, H,
                             KV, hd, causal, window, softcap, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
