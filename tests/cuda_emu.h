// Just enough of CUDA to run a block-synchronous kernel source on the CPU:
// each block's threads are fibres (ucontext) taking turns on the calling
// thread, __syncthreads() a barrier at which a fibre yields until every
// thread of the block has arrived, __shared__ a static (one block runs
// at a time).  A warp's shuffles, ballots and __syncwarp() go through a
// barrier of its 32 threads and a slot per lane.  The fibres run in
// thread order between barriers, so the emulation checks what the
// barriers order, not what a missing one would leave to chance.
// cp.async copies at once (zero-filled like the card's);
// dynamic shared memory is one buffer, filled with 0x7f bytes (a score
// that beats every real one) before each block, so a read of a slot the
// kernel never wrote shows up in its results.  Used by
// tests/test_torch_topk_wide_plan.py to run csrc/topk_list.cu and
// csrc/topk.cu as written; it checks a kernel's logic (ranks, merges,
// barriers, warp exchanges), not its speed or what nvcc makes of it.
// Also used by tests/test_torch_topk_select.py (csrc/topk_select.cu:
// shared-memory atomics, block-wide votes, scans) and
// tests/test_torch_ivf_select.py (csrc/ivf_select.cu and csrc/ivf_topk.cu:
// three-dimensional grids, __ffs), and tests/test_torch_flash_grad.py
// (csrc/flash_attention_bwd.cu: the tensor-core primitives ldmatrix,
// mma.sync m16n8k16 and the bf16 packing, held to the PTX ISA's fragment
// tables by tests/test_torch_mma_emu.py).
#pragma once
#include <algorithm>
#include <array>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <functional>
#include <ucontext.h>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __restrict__
#define __noinline__ __attribute__((noinline))
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
// the running fibre's index (set before each switch into a fibre)
inline dim3 threadIdx{0, 0, 0};
inline dim3 blockIdx{0, 0, 0}, gridDim{1, 1, 1};

// the block's fibres: each CUDA thread runs on its own stack and yields
// to the scheduler (emu_block) while it waits at a barrier
inline ucontext_t emu_sched;
inline std::vector<ucontext_t> emu_fibre;
inline std::vector<std::unique_ptr<char[]>> emu_stack;
constexpr size_t kEmuStack = 256 * 1024;
inline int emu_current = 0;
inline std::function<void()> emu_body;
inline bool emu_fibre_yielded = false;   // false: the fibre returned
inline void emu_yield() {
  emu_fibre_yielded = true;
  swapcontext(&emu_fibre[emu_current], &emu_sched);
}
struct EmuBarrier {
  int expected, count = 0;
  unsigned phase = 0;
  explicit EmuBarrier(int n) : expected(n) {}
  void arrive_and_wait() {
    const unsigned p = phase;
    if (++count == expected) {   // the last to arrive releases the rest
      count = 0;
      ++phase;
      return;
    }
    while (phase == p) emu_yield();
  }
};
inline std::unique_ptr<EmuBarrier> emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

// one slot per lane and a barrier per warp of the running block; six
// 32-bit registers per lane for the tensor-core fragments (mma)
inline std::vector<std::unique_ptr<EmuBarrier>> emu_warp_barriers;
inline std::vector<std::array<uint64_t, 32>> emu_warp_slots;
inline std::vector<std::array<uint32_t, 32 * 6>> emu_warp_regs;
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
template <typename T>
T emu_exchange(T v, int src_lane) {
  auto& slots = emu_warp_slots[threadIdx.x / 32];
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  slots[threadIdx.x % 32] = bits;
  __syncwarp();
  T r;
  std::memcpy(&r, &slots[src_lane & 31], sizeof(T));
  __syncwarp();
  return r;
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu_exchange(v, static_cast<int>(threadIdx.x % 32) ^ mask);
}
template <typename T>
T __shfl_sync(unsigned, T v, int src_lane) {
  return emu_exchange(v, src_lane);
}
template <typename T>
T __shfl_up_sync(unsigned, T v, int delta) {
  const int lane = static_cast<int>(threadIdx.x % 32);
  return emu_exchange(v, lane >= delta ? lane - delta : lane);
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  auto& slots = emu_warp_slots[threadIdx.x / 32];
  slots[threadIdx.x % 32] = pred;
  __syncwarp();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l)
    if (slots[l]) m |= 1u << l;
  __syncwarp();
  return m;
}
// 1 if pred is non-zero in any thread of the block, in every thread
inline int emu_vote = 0;
inline int __syncthreads_or(int pred) {
  __syncthreads();   // every thread has read the last vote
  if (threadIdx.x == 0) emu_vote = 0;
  __syncthreads();
  if (pred) emu_vote = 1;
  __syncthreads();
  return emu_vote;
}
// the card's atomics are device-wide; the fibres take turns on one
// thread, so a plain add is atomic here
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __clz(int x) {
  return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x));
}

typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <typename T>
T __ldg(const T* p) {
  return *p;
}
using std::max;
using std::min;

namespace rt {
constexpr float kNegInf = -1e30f;
template <typename K>
cudaError_t allow_smem(K, size_t) {
  return cudaSuccess;
}
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}
inline void cp_async16(void* dst, const void* src, int src_bytes) {
  std::memset(dst, 0, 16);
  std::memcpy(dst, src, src_bytes);
}
inline void cp_async4(void* dst, const void* src, int src_bytes) {
  std::memset(dst, 0, 4);
  std::memcpy(dst, src, src_bytes);
}
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}

// ---- the tensor-core primitives of csrc/common.cuh, warp-collective:
// each lane posts its operand (an address, or its fragment registers) in
// the warp's slots, and after the warp barrier reads the others'.  b16
// values travel as raw bits; a bf16 is the high half of an f32.
inline float emu_bf16(uint32_t bits16) {
  const uint32_t u = (bits16 & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// f32 -> bf16 bits, round to nearest even (NaN kept quiet)
inline uint32_t emu_to_bf16(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
// two f32 -> one register of two bf16, `lo` in the low half
inline uint32_t pack_bf16(float lo, float hi) {
  return emu_to_bf16(lo) | (emu_to_bf16(hi) << 16);
}
// ldmatrix .m8n8.x4.b16: lane 8i + r gives the address of row r of
// matrix i; lane l receives in register i the two b16 at row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i (the low half the
// lower column).  With .trans each matrix is read transposed: row
// 2 (l % 4) and 2 (l % 4) + 1, column l / 4.
inline void emu_ldmatrix(uint32_t r[4], const void* p, bool trans) {
  auto& slots = emu_warp_slots[threadIdx.x / 32];
  const int lane = static_cast<int>(threadIdx.x % 32);
  slots[lane] = reinterpret_cast<uintptr_t>(p);
  __syncwarp();
  auto row = [&](int src) {
    return reinterpret_cast<const uint16_t*>(
        static_cast<uintptr_t>(slots[src]));
  };
  for (int i = 0; i < 4; ++i) {
    uint32_t lo, hi;
    if (trans) {
      lo = row(8 * i + 2 * (lane % 4))[lane / 4];
      hi = row(8 * i + 2 * (lane % 4) + 1)[lane / 4];
    } else {
      lo = row(8 * i + lane / 4)[2 * (lane % 4)];
      hi = row(8 * i + lane / 4)[2 * (lane % 4) + 1];
    }
    r[i] = lo | (hi << 16);
  }
  __syncwarp();
}
inline void ldmatrix_x4(uint32_t r[4], const void* p) {
  emu_ldmatrix(r, p, false);
}
inline void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  emu_ldmatrix(r, p, true);
}
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, D = A B + C.
// With g = lane / 4, t = lane % 4, lane l holds A [16 x 16] as a0 = row
// g, columns 2t, 2t+1; a1 = row g+8, the same columns; a2 = row g,
// columns 2t+8, 2t+9; a3 = row g+8, those; B [16 x 8] as b0 = rows 2t,
// 2t+1 of column g, b1 = rows 2t+8, 2t+9; C and D as c0, c1 = row g,
// columns 2t, 2t+1 and c2, c3 = row g+8.  Each product of two bf16 is
// exact in f32; the sums are f32, in k order after C.
inline void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                           uint32_t b1) {
  auto& regs = emu_warp_regs[threadIdx.x / 32];
  const int lane = static_cast<int>(threadIdx.x % 32);
  uint32_t* mine = &regs[lane * 6];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  __syncwarp();
  // the b16 at (row, k) of A and at (k, col) of B, from their owners
  auto A = [&](int row, int k) {
    const int reg = (row >= 8) + 2 * (k >= 8);
    const uint32_t v = regs[((row % 8) * 4 + (k % 8) / 2) * 6 + reg];
    return emu_bf16(k % 2 ? v >> 16 : v);
  };
  auto B = [&](int k, int col) {
    const uint32_t v = regs[(col * 4 + (k % 8) / 2) * 6 + 4 + (k >= 8)];
    return emu_bf16(k % 2 ? v >> 16 : v);
  };
  const int g = lane / 4, t = lane % 4;
  float d[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >= 2), col = 2 * t + e % 2;
    float acc = c[e];
    for (int k = 0; k < 16; ++k) acc += A(row, k) * B(k, col);
    d[e] = acc;
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) c[e] = d[e];
}
}  // namespace rt
inline float __expf(float x) { return std::exp(x); }

// extern __shared__ memory of the running block
inline std::vector<float4> emu_smem;
template <typename T>
T* emu_dyn_smem() {
  return reinterpret_cast<T*>(emu_smem.data());
}

inline void emu_fibre_main() { emu_body(); }

// One block of `block` threads (blockIdx already set): a fibre for each,
// resumed in thread order until every one has returned.
template <typename K, typename... A>
void emu_block(int block, K kernel, A... args) {
  emu_barrier = std::make_unique<EmuBarrier>(block);
  emu_warp_barriers.clear();
  for (int w = 0; w < (block + 31) / 32; ++w)
    emu_warp_barriers.push_back(std::make_unique<EmuBarrier>(32));
  emu_warp_slots.assign((block + 31) / 32, {});
  emu_warp_regs.assign((block + 31) / 32, {});
  emu_body = [=] { kernel(args...); };
  emu_fibre.assign(block, ucontext_t{});
  while (emu_stack.size() < static_cast<size_t>(block))
    emu_stack.push_back(std::make_unique<char[]>(kEmuStack));
  std::vector<char> done(block, 0);
  for (int t = 0; t < block; ++t) {
    getcontext(&emu_fibre[t]);
    emu_fibre[t].uc_stack.ss_sp = emu_stack[t].get();
    emu_fibre[t].uc_stack.ss_size = kEmuStack;
    emu_fibre[t].uc_link = &emu_sched;
    makecontext(&emu_fibre[t], emu_fibre_main, 0);
  }
  for (int left = block; left > 0;) {
    for (int t = 0; t < block; ++t) {
      if (done[t]) continue;
      emu_current = t;
      threadIdx = dim3(t, 0, 0);
      emu_fibre_yielded = false;
      swapcontext(&emu_sched, &emu_fibre[t]);
      if (!emu_fibre_yielded) {
        done[t] = 1;
        --left;
      }
    }
  }
}

// kernel<<<grid, block, smem, stream>>>(args...) becomes
// emu_launch_dyn(grid, block, smem, kernel, args...): blocks one after
// another in x-fastest, then y, then z order, each with fresh dynamic
// shared memory.
template <typename K, typename... A>
void emu_launch_dyn(dim3 grid, int block, size_t smem, K kernel, A... args) {
  gridDim = grid;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        emu_smem.assign((smem + 15) / 16, float4{});
        std::memset(emu_smem.data(), 0x7f,
                    emu_smem.size() * sizeof(float4));
        emu_block(block, kernel, args...);
      }
}
