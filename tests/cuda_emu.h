// Just enough of CUDA to run a block-synchronous kernel source on the CPU:
// each block's threads are std::threads, __syncthreads() a std::barrier,
// __shared__ a static (one block runs at a time).  A warp's shuffles,
// ballots and __syncwarp() go through a barrier of its 32 threads and a
// slot per lane; cp.async copies at once (zero-filled like the card's);
// dynamic shared memory is one buffer, filled with 0x7f bytes (a score
// that beats every real one) before each block, so a read of a slot the
// kernel never wrote shows up in its results.  Used by
// tests/test_torch_topk_wide_plan.py to run csrc/topk_list.cu and
// csrc/topk.cu as written; it checks a kernel's logic (ranks, merges,
// barriers, warp exchanges), not its speed or what nvcc makes of it.
// Also used by tests/test_torch_topk_select.py (csrc/topk_select.cu:
// shared-memory atomics, block-wide votes, scans) and
// tests/test_torch_ivf_select.py (csrc/ivf_select.cu and csrc/ivf_topk.cu:
// three-dimensional grids, __ffs).
#pragma once
#include <algorithm>
#include <array>
#include <atomic>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
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
inline thread_local dim3 threadIdx{0, 0, 0};
inline dim3 blockIdx{0, 0, 0}, gridDim{1, 1, 1};
inline std::unique_ptr<std::barrier<>> emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

// one slot per lane and a barrier per warp of the running block
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline std::vector<std::array<uint64_t, 32>> emu_warp_slots;
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
inline std::atomic<int> emu_vote{0};
inline int __syncthreads_or(int pred) {
  __syncthreads();   // every thread has read the last vote
  if (threadIdx.x == 0) emu_vote = 0;
  __syncthreads();
  if (pred) emu_vote = 1;
  __syncthreads();
  return emu_vote.load();
}
// the card's atomics are device-wide; a block's threads are std::threads
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
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
}  // namespace rt

// extern __shared__ memory of the running block
inline std::vector<float4> emu_smem;
template <typename T>
T* emu_dyn_smem() {
  return reinterpret_cast<T*>(emu_smem.data());
}

// One block of `block` threads (blockIdx already set).
template <typename K, typename... A>
void emu_block(int block, K kernel, A... args) {
  emu_barrier = std::make_unique<std::barrier<>>(block);
  emu_warp_barriers.clear();
  for (int w = 0; w < (block + 31) / 32; ++w)
    emu_warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
  emu_warp_slots.assign((block + 31) / 32, {});
  std::vector<std::thread> threads;
  for (int t = 0; t < block; ++t)
    threads.emplace_back([=] {
      threadIdx.x = t;
      kernel(args...);
    });
  for (auto& th : threads) th.join();
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
