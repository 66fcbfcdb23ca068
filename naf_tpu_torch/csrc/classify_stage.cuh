// The stage of the standalone classifies (classify.cu, classify_fastq.cu):
// their tile geometry, each warp's 4 KiB shared stage with the loads and
// stores that go through it, and the flag bytes made from eight bit masks.
//
// A block of CL_THREADS threads takes its 32 KiB tile by atomic ticket.
// Each warp loads its 4,096 bytes into its stage with 16-byte loads of 512
// contiguous bytes, and each lane takes its 128 contiguous bytes from
// there.  Both outputs leave through the stage, so that every 16-byte
// store instruction writes 512 contiguous bytes (stored straight, a lane's
// 16-byte stores would be half-sector writes 128 bytes from the next
// lane's).  A ragged or unaligned run takes byte loads and stores below n.
#pragma once

#include "classify.cuh"

namespace naf {

constexpr int CL_THREADS = 256;
constexpr int CL_WARPS = CL_THREADS / 32;
constexpr int CL_TILE = CL_THREADS * PER_THREAD;  // 32 KiB

// Slot of 16-byte group q of lane l's 128 bytes in a warp's stage of 256
// slots.  Eight lanes of a 16-byte shared access, whether they write group
// q of lanes 8m..8m+7 or read slots i = 32j + 8m .. 32j + 8m + 7 in byte
// order, meet eight different 16-byte bank groups.
__device__ __forceinline__ int cl_slot(int l, int q) { return 8 * l + (q ^ (l & 7)); }

// Bits s..s+3 of a mask as the low bits of four bytes.
__device__ __forceinline__ uint32_t spread4(const Bits& b, int i, int s) {
  return ((b.q[i] >> s & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Transpose of the 8 x 8 bit matrix whose row r is byte r of (lo, hi):
// bit c of byte r goes to bit r of byte c (three delta swaps).
__device__ __forceinline__ void transpose8(uint32_t& lo, uint32_t& hi) {
  uint32_t t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (lo >> 28 | hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// The flag bytes of 32 bytes, from word i of the eight flag masks in bit
// order: (f[0..7]) bytes 0-31.  Byte b of the eight masks gathers into
// eight bytes (__byte_perm), whose bit transpose is bytes 8b..8b+7.
__device__ __forceinline__ void flag_bytes(const uint32_t (&mk)[8], uint32_t (&f)[8]) {
  uint32_t p[4][2];  // masks 2h, 2h + 1 interleaved: bytes 0-1, then 2-3
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    p[h][0] = __byte_perm(mk[2 * h], mk[2 * h + 1], 0x5140);
    p[h][1] = __byte_perm(mk[2 * h], mk[2 * h + 1], 0x7362);
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t sel = b & 1 ? 0x7632u : 0x5410u;
    uint32_t lo = __byte_perm(p[0][b >> 1], p[1][b >> 1], sel);
    uint32_t hi = __byte_perm(p[2][b >> 1], p[3][b >> 1], sel);
    transpose8(lo, hi);
    f[2 * b] = lo;
    f[2 * b + 1] = hi;
  }
}

// The warp's stage to out[base : base + 4096], bytes below n only: 16-byte
// stores of 512 contiguous bytes where the run is whole.
__device__ __forceinline__ void store_stage(const uint4* st, uint8_t* out, long long n,
                                            long long base, int lane) {
  if (base + 32 * PER_THREAD <= n && (reinterpret_cast<uintptr_t>(out + base) & 15) == 0) {
    uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 32 * j + lane;
      dst[i] = st[cl_slot(i >> 3, i & 7)];
    }
  } else {
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(st);
    for (int e = lane; e < 32 * PER_THREAD && base + e < n; e += 32) {
      const int i = e >> 4;
      out[base + e] = sb[16 * cl_slot(i >> 3, i & 7) + (e & 15)];
    }
  }
}

// The warp's x[base:base+4096] to its stage, and the lane's 128 bytes to
// w (bytes at and past n read as PAD): where the run is whole, 16-byte
// loads of 512 contiguous bytes each.
__device__ __forceinline__ void load_warp(const uint8_t* x, long long n, long long base,
                                          uint4* st, int lane, uint32_t (&w)[WORDS]) {
  if (base + 32 * PER_THREAD <= n && (reinterpret_cast<uintptr_t>(x + base) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 32 * j + lane;
      st[cl_slot(i >> 3, i & 7)] = src[i];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = st[cl_slot(lane, q)];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else {
    load_chunk(x, n, base + lane * PER_THREAD, w, PAD);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      st[cl_slot(lane, q)] = uint4{w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]};
  }
}

}  // namespace naf
