// Host emulation of the CUDA subset that naf_tpu_torch/csrc uses, so the
// kernels compile as plain C++ (g++ -std=c++20 -DNAF_CPU_EMU) and run on the
// CPU in the tests.  Each block runs as THREADS host threads joined by a
// std::barrier at __syncthreads; blocks run one after another, so a
// function-local `static` stands in for a block's __shared__ variable.
// Each 32 threads form a warp with a barrier of its own: a warp intrinsic
// posts the lane's value to a slot, meets the warp, reads the slots it
// needs and meets it again, so every lane of the warp must call it (the
// kernels call them with the full mask).  Because blocks run in order of
// their index, a ticket taken with atomicAdd equals the block index and a
// decoupled look-back only ever meets earlier tiles that have finished
// (the FASTQ emit's two chained look-backs too, and every payload that a
// flag publishes is already written): the wait for an unpublished tile is
// compiled but never taken here, and __threadfence is a plain fence.  The
// card tests (tests/test_torch_cuda.py) meet unfinished tiles.
// Only semantics are emulated: no timing, no memory model beyond the
// barriers.
#pragma once

#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) uint4 {  // 16-byte aligned, as CUDA's
  uint32_t x, y, z, w;
};
struct uint2 {
  uint32_t x, y;
};
struct alignas(16) longlong2 {  // 16-byte aligned, as CUDA's
  long long x, y;
};

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
// A small device: one SM that holds two blocks, so a kernel that sizes its
// grid to the device (a persistent grid) loops over several tiles a block.
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1;
  return cudaSuccess;
}
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 2;
  return cudaSuccess;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

inline int __popc(unsigned v) { return __builtin_popcount(v); }
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __clz(int v) { return v ? __builtin_clz(static_cast<unsigned>(v)) : 32; }
// 0xFF in each byte of a that equals (or is at least, unsigned) b's
inline unsigned __vcmpeq4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 32; i += 8) r |= ((a >> i & 0xFFu) == (b >> i & 0xFFu) ? 0xFFu : 0u) << i;
  return r;
}
inline unsigned __vcmpgeu4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 32; i += 8) r |= ((a >> i & 0xFFu) >= (b >> i & 0xFFu) ? 0xFFu : 0u) << i;
  return r;
}
// Per-byte sum of a and b, each byte mod 256 (nothing carries into the next)
inline unsigned __vadd4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 32; i += 8) r |= ((a >> i) + (b >> i) & 0xFFu) << i;
  return r;
}
// Byte n of the result is byte (s >> 4n) & 7 of y:x (x the low four).
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = static_cast<uint64_t>(y) << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<unsigned>(v >> (8 * (s >> (4 * i) & 7)) & 0xFFu) << (8 * i);
  return r;
}
// Blocks run one after another, so a fence between a payload and the flag
// that publishes it orders nothing that another block could see early.
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

namespace naf_emu {

inline thread_local dim3 thread_idx, block_idx;
inline dim3 block_dim, grid_dim;
inline std::barrier<>* block_barrier = nullptr;
inline std::deque<std::barrier<>>* warp_barriers = nullptr;
inline uint64_t* warp_slots = nullptr;  // one per thread of the block
alignas(16) inline uint8_t dyn_smem[232448];

template <typename K, typename... A>
void launch(K kernel, dim3 grid, dim3 block, A... args) {
  block_dim = block;
  grid_dim = grid;
  for (unsigned b = 0; b < grid.x; ++b) {
    std::barrier<> bar(block.x);
    std::deque<std::barrier<>> warps;
    for (unsigned w = 0; w * 32 < block.x; ++w)
      warps.emplace_back(block.x - w * 32 < 32 ? block.x - w * 32 : 32);
    std::vector<uint64_t> slots(block.x);
    block_barrier = &bar;
    warp_barriers = &warps;
    warp_slots = slots.data();
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

inline void warp_sync() { (*warp_barriers)[thread_idx.x / 32].arrive_and_wait(); }

// Post v for this lane and meet the warp; returns the warp's 32 slots.
template <typename T>
const uint64_t* warp_post(T v) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  warp_slots[thread_idx.x] = b;
  warp_sync();
  return warp_slots + (thread_idx.x & ~31u);
}

template <typename T>
T warp_read(const uint64_t* slots, unsigned lane) {
  T v;
  std::memcpy(&v, slots + lane, sizeof(T));
  warp_sync();  // every lane has read before a slot is posted again
  return v;
}

inline unsigned lane() { return thread_idx.x & 31u; }
inline unsigned warp_size() {
  const unsigned w0 = thread_idx.x & ~31u;
  return block_dim.x - w0 < 32 ? block_dim.x - w0 : 32;
}

}  // namespace naf_emu

#define threadIdx naf_emu::thread_idx
#define blockIdx naf_emu::block_idx
#define blockDim naf_emu::block_dim
#define gridDim naf_emu::grid_dim

inline void __syncthreads() { naf_emu::block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { naf_emu::warp_sync(); }

template <typename T>
T __shfl_sync(unsigned, T v, int src) {
  return naf_emu::warp_read<T>(naf_emu::warp_post(v), static_cast<unsigned>(src) & 31u);
}

template <typename T>
T __shfl_up_sync(unsigned, T v, unsigned d) {
  const unsigned l = naf_emu::lane();
  return naf_emu::warp_read<T>(naf_emu::warp_post(v), l >= d ? l - d : l);
}

template <typename T>
T __shfl_down_sync(unsigned, T v, unsigned d) {
  const unsigned l = naf_emu::lane();
  return naf_emu::warp_read<T>(naf_emu::warp_post(v), l + d < naf_emu::warp_size() ? l + d : l);
}

template <typename T>
T __shfl_xor_sync(unsigned, T v, int m) {
  const unsigned l = naf_emu::lane(), src = l ^ static_cast<unsigned>(m);
  return naf_emu::warp_read<T>(naf_emu::warp_post(v), src < naf_emu::warp_size() ? src : l);
}

inline unsigned __ballot_sync(unsigned, int p) {
  const uint64_t* s = naf_emu::warp_post<int>(p != 0);
  unsigned mask = 0;
  for (unsigned i = 0; i < naf_emu::warp_size(); ++i) mask |= static_cast<unsigned>(s[i] != 0) << i;
  naf_emu::warp_sync();
  return mask;
}

inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
