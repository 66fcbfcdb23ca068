// Pieces of the one-pass i32 prefix scan (scan.cu) that the stream
// compaction (compact.cu) shares: 16-element runs and their loads and
// stores, the scan operators, warp scans, and the decoupled look-back.
//
// A tile is SCAN_THREADS threads of SCAN_RUNS runs of 16 elements, one
// 16-byte load of a u8 run or four of an i32 run.  Run k of a thread starts
// at element tile + warp * 32 * 16 * SCAN_RUNS + 512 k + 16 lane, so a
// warp's loads of one run are contiguous and run order is element order.
//
// The look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016) carries across tiles in one launch.  A
// block takes its tile from an atomic ticket, so every earlier tile has
// started; it publishes its aggregate, then its inclusive prefix, each in
// one 64-bit store of its status word (state in the high half, the full
// 32-bit value in the low half, so the value is there when the state is),
// and warp 0 combines the words before it back to the nearest prefix.
#pragma once

#include "common.cuh"

namespace naf {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_RUNS = 6;                                   // 16-element runs a thread
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_RUNS * 16;       // 24576 elements
constexpr int SCAN_WARP_SPAN = 32 * SCAN_RUNS * 16;            // elements of one warp
constexpr int INT_MIN_ = -2147483647 - 1;
// the TPU max scan's carry start (naf_tpu/ops/scan_fused.py _NEGBIG)
constexpr int NEG_BIG = -(1 << 30);
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;
constexpr int LOOK_BACK = 4;                                   // status words a lane reads
// status word of a tile: state in the high half, value in the low half
constexpr unsigned long long ST_AGGREGATE = 1ull << 32;        // the tile's own value
constexpr unsigned long long ST_PREFIX = 2ull << 32;           // this and every earlier tile

// Add with i32 wrap-around, as the TPU kernel's i32 adds (and the
// compaction's unsigned counts, bit for bit).
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

// The 16 elements x[start:start+16] as words (4 for u8, 16 for i32), with
// 16-byte loads where the run is whole and aligned; elements at and past
// n read as 0.
template <typename T>
__device__ __forceinline__ void load16(const T* x, long long n, long long start,
                                       uint32_t (&r)[4 * sizeof(T)]) {
  const T* p = x + start;
  if (start + 16 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(T)); ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * static_cast<int>(sizeof(T)); ++i) r[i] = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t v = start + e < n ? static_cast<uint32_t>(p[e]) : 0u;
      if constexpr (sizeof(T) == 1) {
        r[e >> 2] |= v << (8 * (e & 3));
      } else {
        r[e] = v;
      }
    }
  }
}

// Element i of a run that load16 read.
template <typename T>
__device__ __forceinline__ T elem(const uint32_t (&r)[4 * sizeof(T)], int i) {
  if constexpr (sizeof(T) == 1) {
    return static_cast<T>(r[i >> 2] >> (8 * (i & 3)));
  } else {
    return static_cast<T>(r[i]);
  }
}

// Elements 4q..4q+3 of a run of 16 i32.
__device__ __forceinline__ uint4 quad(const int (&o)[16], int q) {
  uint4 v;
  v.x = static_cast<uint32_t>(o[4 * q]);
  v.y = static_cast<uint32_t>(o[4 * q + 1]);
  v.z = static_cast<uint32_t>(o[4 * q + 2]);
  v.w = static_cast<uint32_t>(o[4 * q + 3]);
  return v;
}

// Store the 16 i32 of o to out[start:start+16], keeping only elements below
// n; 16-byte stores where the run is whole and aligned.
__device__ __forceinline__ void store16(int* out, long long n, long long start,
                                        const int (&o)[16]) {
  int* p = out + start;
  if (start + 16 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) reinterpret_cast<uint4*>(p)[q] = quad(o, q);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (start + e < n) p[e] = o[e];
  }
}

template <typename Op>
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  Op op;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL_WARP, v, d);
    if (lane >= d) v = op(o, v);
  }
  return v;
}

// op over the 32 lanes' values, in every lane (op must commute).
template <typename Op>
__device__ __forceinline__ int warp_reduce(int v) {
  Op op;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = op(v, __shfl_xor_sync(FULL_WARP, v, d));
  return v;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* s) {
  return *reinterpret_cast<const volatile unsigned long long*>(s);
}

__device__ __forceinline__ void store_status(unsigned long long* s, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(s) = v;
}

__device__ __forceinline__ unsigned long long status_word(unsigned long long state, int v) {
  return state | static_cast<unsigned>(v);
}

// op over the values of the tiles before tile t > 0, by the 32 lanes of one
// warp (op must commute, as add and max do): each round reads the status
// words of the 32 * LOOK_BACK tiles below `top` (lane l the LOOK_BACK words
// from top - LOOK_BACK l down), waits until each has published, and
// combines them from the nearest tile back to the nearest inclusive prefix;
// with no prefix among them, it moves down.  Tile 0 publishes only its
// prefix, so no round reaches below it.
template <typename Op>
__device__ __forceinline__ int look_back(const unsigned long long* status, int t, int lane) {
  Op op;
  int excl = Op::kIdent;
  for (int top = t - 1;; top -= 32 * LOOK_BACK) {
    const int j0 = top - lane * LOOK_BACK;
    unsigned long long s[LOOK_BACK];
    bool waiting = false;
#pragma unroll
    for (int i = 0; i < LOOK_BACK; ++i) {
      s[i] = j0 - i >= 0 ? load_status(status + j0 - i) : status_word(ST_PREFIX, Op::kIdent);
      waiting |= (s[i] >> 32) == 0;
    }
    while (__any_sync(FULL_WARP, waiting)) {
      waiting = false;
#pragma unroll
      for (int i = 0; i < LOOK_BACK; ++i) {
        if ((s[i] >> 32) == 0) s[i] = load_status(status + j0 - i);
        waiting |= (s[i] >> 32) == 0;
      }
    }
    int first = LOOK_BACK;  // this lane's nearest prefix
#pragma unroll
    for (int i = LOOK_BACK - 1; i >= 0; --i)
      if ((s[i] >> 32) == 2) first = i;
    const unsigned pre = __ballot_sync(FULL_WARP, first < LOOK_BACK);
    const int stop = pre ? __ffs(static_cast<int>(pre)) - 1 : 32;  // lane of the nearest one
    int v = Op::kIdent;
#pragma unroll
    for (int i = 0; i < LOOK_BACK; ++i)
      if (lane < stop || (lane == stop && i <= first))
        v = op(v, static_cast<int>(static_cast<unsigned>(s[i])));
    excl = op(excl, warp_reduce<Op>(v));
    if (pre) return excl;
  }
}

}  // namespace naf
