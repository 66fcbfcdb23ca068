// Shared pieces of the naf_tpu_torch kernels: tile geometry, chunk loads,
// the line-length summary of the emit kernels, and the launch macro.
//
// The byte kernels work on 128 contiguous bytes per thread, one thread
// block per tile: 64 KiB tiles of 512 threads (the FASTA emit), or 32 KiB
// tiles of 256 threads (FASTQ, the standalone classifies and the mask
// parity).  A thread keeps its 128 bytes in 32 registers, so a kernel that
// walks them several times reads device memory once.  Every kernel that
// carries a value across tiles (the emits, the classifies, the mask
// parity, the scans and the compaction) does so by warp scans and
// decoupled look-back in one pass (emit_common.cuh, scan.cuh).
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
