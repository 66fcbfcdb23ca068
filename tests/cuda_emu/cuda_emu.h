// Host emulation of the CUDA subset that naf_tpu_torch/csrc uses, so the
// kernels compile as plain C++ (g++ -std=c++20 -DNAF_CPU_EMU) and run on the
// CPU in the tests.  Each block runs as THREADS host threads joined by a
// std::barrier at __syncthreads; blocks run one after another, so a
// function-local `static` stands in for a block's __shared__ variable.
// Only semantics are emulated: no warps, no timing, no memory model beyond
// the barrier.
#pragma once

#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  uint32_t x, y, z, w;
};
struct uint2 {
  uint32_t x, y;
};

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __shared__ static
#define __align__(n) alignas(n)

inline int __popc(unsigned v) { return __builtin_popcount(v); }

namespace naf_emu {

inline thread_local dim3 thread_idx, block_idx;
inline dim3 block_dim, grid_dim;
inline std::barrier<>* block_barrier = nullptr;
alignas(16) inline uint8_t dyn_smem[232448];

template <typename K, typename... A>
void launch(K kernel, dim3 grid, dim3 block, A... args) {
  block_dim = block;
  grid_dim = grid;
  for (unsigned b = 0; b < grid.x; ++b) {
    std::barrier<> bar(block.x);
    block_barrier = &bar;
    std::vector<std::thread> threads;
    threads.reserve(block.x);
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([=] {
        thread_idx = dim3(t);
        block_idx = dim3(b);
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}

}  // namespace naf_emu

#define threadIdx naf_emu::thread_idx
#define blockIdx naf_emu::block_idx
#define blockDim naf_emu::block_dim
#define gridDim naf_emu::grid_dim

inline void __syncthreads() { naf_emu::block_barrier->arrive_and_wait(); }
