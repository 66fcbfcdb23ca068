// Shared pieces of the naf_tpu_torch kernels: tile geometry, chunk loads,
// the block-wide scan, the line-length summary of the emit kernels, and
// the launch macro.
//
// Every kernel here works on tiles of 128 contiguous bytes per thread, one
// thread block per tile: 64 KiB tiles of 512 threads (the FASTA emit, and
// the per-byte kernels), or 32 KiB tiles of 256 threads (FASTQ, and the
// standalone classifies).  A thread keeps its 128 bytes in 32 registers,
// so a kernel that walks them several times reads device memory once.  The
// mask parity carries across threads through block_exclusive_scan and
// across tiles by a scan between launches over a [tiles]-sized array; the
// emits, the classifies, the scans and the compaction carry by warp scans
// and decoupled look-back in one pass (emit_common.cuh, scan.cuh).
//
// Built with NAF_CPU_EMU defined, the same sources compile as plain C++
// against tests/cuda_emu/cuda_emu.h, which runs each block's threads as host
// threads; the CPU tests use that build to check the kernels' logic.
#pragma once

#include <cstdint>

#ifdef NAF_CPU_EMU
#include "cuda_emu.h"
#define NAF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  naf_emu::launch(kernel, grid, block, __VA_ARGS__)
#define NAF_EXTERN_SHARED(type, name) type* name = reinterpret_cast<type*>(naf_emu::dyn_smem)
#else
#include <cuda_runtime.h>
#define NAF_LAUNCH(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(__VA_ARGS__)
#define NAF_EXTERN_SHARED(type, name) extern __shared__ __align__(16) type name[]
#endif

namespace naf {

constexpr int TILE = 65536;                 // bytes per block (the TPU kernels' _TILE)
constexpr int THREADS = 512;                // threads per block
constexpr int PER_THREAD = TILE / THREADS;  // 128 bytes per thread
constexpr int WORDS = PER_THREAD / 4;       // held as 32 u32 registers

// class-table bits (ops/tables.py:device_tables builds the table)
constexpr uint32_t CLS_UNEX_SEQ = 1;    // UNEXPECTED_BY_TYPE[seq_type]
constexpr uint32_t CLS_UNEX_TEXT = 2;   // IS_UNEXPECTED_TEXT (id bytes)
constexpr uint32_t CLS_UNEX_COM = 4;    // IS_UNEXPECTED_COMMENT
constexpr uint32_t CLS_EOL = 8;         // IS_EOL
constexpr uint32_t CLS_UNEX_QUAL = 16;  // IS_UNEXPECTED_QUAL

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[WORDS], int k) {
  return (w[k >> 2] >> ((k & 3) * 8)) & 0xFFu;
}

// Byte j of x[0:n], or `pad` at and past n.
__device__ __forceinline__ uint32_t byte_or(const uint8_t* x, long long n, long long j,
                                            uint32_t pad) {
  return (j >= 0 && j < n) ? x[j] : pad;
}

// The 128 bytes x[start:start+128] into w; bytes at and past n read as pad.
__device__ __forceinline__ void load_chunk(const uint8_t* x, long long n, long long start,
                                           uint32_t (&w)[WORDS], uint32_t pad) {
  const uint8_t* p = x + start;
  if (start + PER_THREAD <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      uint4 v = q[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) v |= byte_or(x, n, start + 4 * i + k, pad) << (8 * k);
      w[i] = v;
    }
  }
}

// Store the 128 bytes of w to out[start:start+128], keeping only bytes below n.
__device__ __forceinline__ void store_chunk(uint8_t* out, long long n, long long start,
                                            const uint32_t (&w)[WORDS]) {
  uint8_t* p = out + start;
  if (start + PER_THREAD <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      uint4 v;
      v.x = w[4 * i];
      v.y = w[4 * i + 1];
      v.z = w[4 * i + 2];
      v.w = w[4 * i + 3];
      q[i] = v;
    }
  } else {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
      if (start + k < n) p[k] = static_cast<uint8_t>(byte_of(w, k));
  }
}

// Exclusive scan of one value per thread in thread order over a block of
// NT threads; `op(earlier, later)` must be associative with `identity` as
// its unit.  `buf` is an NT-sized shared array; every thread of the block
// must call this.  Returns the exclusive prefix and writes the block total
// to *total.
template <int NT = THREADS, typename T, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T v, T identity, T* buf, Op op, T* total) {
  const int tid = threadIdx.x;
  buf[tid] = v;
  __syncthreads();
  for (int off = 1; off < NT; off <<= 1) {
    T other = tid >= off ? buf[tid - off] : identity;
    __syncthreads();
    if (tid >= off) buf[tid] = op(other, buf[tid]);
    __syncthreads();
  }
  T excl = tid > 0 ? buf[tid - 1] : identity;
  *total = buf[NT - 1];
  __syncthreads();
  return excl;
}

// Line-length summary of kept sequence bytes between EOLs: total, whether
// an EOL occurs, kept bytes before the first EOL and after the last, and
// the longest line that lies wholly inside.
struct Lines {
  int total, has, pre, post, mx;
};

__device__ __forceinline__ Lines combine(const Lines& a, const Lines& b) {
  Lines r;
  r.total = a.total + b.total;
  r.has = a.has | b.has;
  r.pre = a.has ? a.pre : a.total + b.pre;
  r.post = b.has ? b.post : a.post + b.total;
  int m = a.mx > b.mx ? a.mx : b.mx;
  if (a.has && b.has && a.post + b.pre > m) m = a.post + b.pre;
  r.mx = m;
  return r;
}

}  // namespace naf
