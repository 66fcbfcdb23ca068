// Shared pieces of the i32 prefix scan and the stream compaction: element
// tiles, their loads and stores, the scan operators, and the carry kernel
// that scans per-tile totals in one block.
//
// Both kernels work on tiles of SCAN_TILE elements, one thread block of
// SCAN_THREADS threads per tile, SCAN_PER contiguous elements per thread
// (16 u8 or 16 i32: one or four 16-byte loads).  A CUDA grid runs its
// blocks in no order, so nothing carries from one tile to the next inside
// a launch: each kernel is three launches on one stream, a per-tile
// reduce, scan_carry_kernel over the [tiles] totals, and a per-tile pass
// that applies each tile's carry.
#pragma once

#include "common.cuh"

namespace naf {

constexpr int SCAN_THREADS = 512;
constexpr int SCAN_PER = 16;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_PER;  // 8192 elements
constexpr int INT_MIN_ = -2147483647 - 1;
// the TPU max scan's carry start (naf_tpu/ops/scan_fused.py _NEGBIG)
constexpr int NEG_BIG = -(1 << 30);

// Add with i32 wrap-around, as the TPU kernel's i32 adds.
struct AddOp {
  static constexpr int kIdent = 0;
  __device__ __forceinline__ int operator()(int a, int b) const {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
};

struct MaxOp {
  static constexpr int kIdent = INT_MIN_;
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// The SCAN_PER elements x[start:start+SCAN_PER] into v; elements at and
// past n read as pad.  16-byte loads where the run is whole and aligned.
template <typename T>
__device__ __forceinline__ void load_elems(const T* x, long long n, long long start,
                                           T (&v)[SCAN_PER], T pad) {
  const T* p = x + start;
  if (start + SCAN_PER <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    alignas(16) T tmp[SCAN_PER];
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < static_cast<int>(SCAN_PER * sizeof(T) / 16); ++i)
      reinterpret_cast<uint4*>(tmp)[i] = q[i];
#pragma unroll
    for (int k = 0; k < SCAN_PER; ++k) v[k] = tmp[k];
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_PER; ++k) v[k] = start + k < n ? p[k] : pad;
  }
}

// Store v to out[start:start+SCAN_PER], keeping only elements below n.
template <typename T>
__device__ __forceinline__ void store_elems(T* out, long long n, long long start,
                                            const T (&v)[SCAN_PER]) {
  T* p = out + start;
  if (start + SCAN_PER <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    alignas(16) T tmp[SCAN_PER];
#pragma unroll
    for (int k = 0; k < SCAN_PER; ++k) tmp[k] = v[k];
#pragma unroll
    for (int i = 0; i < static_cast<int>(SCAN_PER * sizeof(T) / 16); ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(tmp)[i];
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_PER; ++k)
      if (start + k < n) p[k] = v[k];
  }
}

__device__ __forceinline__ long long elem_start() {
  return static_cast<long long>(blockIdx.x) * SCAN_TILE +
         static_cast<long long>(threadIdx.x) * SCAN_PER;
}

// One block: carry[j] = op(init, totals[0..j-1]) for j < tiles, and
// carry[tiles] = op(init, every total).  Walks the totals SCAN_THREADS at
// a time; every thread keeps the running value.
template <typename Op>
__global__ void __launch_bounds__(SCAN_THREADS) scan_carry_kernel(const int* totals, int tiles,
                                                                  int init, int* carry) {
  __shared__ int buf[SCAN_THREADS];
  Op op;
  int run = init;
  for (int base = 0; base < tiles; base += SCAN_THREADS) {
    const int j = base + static_cast<int>(threadIdx.x);
    const int v = j < tiles ? totals[j] : Op::kIdent;
    int total;
    const int ex = block_exclusive_scan<SCAN_THREADS>(v, Op::kIdent, buf, op, &total);
    if (j < tiles) carry[j] = op(run, ex);
    run = op(run, total);
  }
  if (threadIdx.x == 0) carry[tiles] = run;
}

}  // namespace naf
