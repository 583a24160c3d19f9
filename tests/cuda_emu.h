// Just enough of CUDA to run a block-synchronous kernel source on the CPU:
// each block's threads are std::threads, __syncthreads() a std::barrier,
// __shared__ a static (one block runs at a time).  Used by
// tests/test_torch_topk_wide.py to run csrc/topk_wide.cu as written; it
// checks the kernel's logic (ranks, merges, barriers), not its speed or
// what nvcc makes of it.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
};
inline thread_local dim3 threadIdx{0, 0, 0};
inline dim3 blockIdx{0, 0, 0}, gridDim{1, 1, 1};
inline std::unique_ptr<std::barrier<>> emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename T>
T __ldg(const T* p) {
  return *p;
}
using std::max;
using std::min;

namespace rt {
constexpr float kNegInf = -1e30f;
}

// kernel<<<grid, block>>>(args...) becomes emu_launch(grid, block, kernel,
// args...): blocks one after another, each with `block` threads.
template <typename K, typename... A>
void emu_launch(int grid, int block, K kernel, A... args) {
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    emu_barrier = std::make_unique<std::barrier<>>(block);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
