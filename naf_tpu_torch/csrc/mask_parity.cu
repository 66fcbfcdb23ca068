// Mask parity apply: out[i] = ch[i] + 32 * (parity of tog[0..i]), the case
// of each rendered char from the toggles at the masked-span bounds.
//
// Replaces naf_tpu/ops/emit_fused.py:_maskapply_kernel
// (apply_mask_parity_pallas), which carries the running parity across its
// in-order grid in SMEM.  Here pass 1 writes the parity of each 64 KiB tile,
// the tile parities are scanned between launches, and pass 2 scans the
// threads' parities inside each tile and applies them.
//
// Bound: memory.  Pass 1 reads 1 B/B; pass 2 reads 2 B/B and writes 1 B/B.
#include "common.cuh"

namespace naf {

struct XorOp {
  __device__ int operator()(int a, int b) const { return a ^ b; }
};

__device__ __forceinline__ int chunk_parity(const uint32_t (&w)[WORDS]) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) x ^= w[i];
  return __popc(x & 0x01010101u) & 1;
}

__global__ void __launch_bounds__(THREADS) tile_parity_kernel(const uint8_t* tog, long long n,
                                                              int* tile_par) {
  __shared__ int buf[THREADS];
  const long long start = static_cast<long long>(blockIdx.x) * TILE +
                          static_cast<long long>(threadIdx.x) * PER_THREAD;
  uint32_t w[WORDS];
  load_chunk(tog, n, start, w, 0);
  int total;
  block_exclusive_scan(chunk_parity(w), 0, buf, XorOp(), &total);
  if (threadIdx.x == 0) tile_par[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS) apply_parity_kernel(const uint8_t* ch,
                                                               const uint8_t* tog, long long n,
                                                               const int* tile_in,
                                                               uint8_t* out) {
  __shared__ int buf[THREADS];
  const long long start = static_cast<long long>(blockIdx.x) * TILE +
                          static_cast<long long>(threadIdx.x) * PER_THREAD;
  uint32_t w[WORDS];
  load_chunk(tog, n, start, w, 0);
  int total;
  uint32_t p = tile_in[blockIdx.x] ^ block_exclusive_scan(chunk_parity(w), 0, buf, XorOp(), &total);
  uint32_t c[WORDS];
  load_chunk(ch, n, start, c, 0);
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    p ^= byte_of(w, k) & 1;
    const uint32_t v = (byte_of(c, k) + 32 * p) & 0xFF;
    c[k >> 2] = (c[k >> 2] & ~(0xFFu << ((k & 3) * 8))) | (v << ((k & 3) * 8));
  }
  store_chunk(out, n, start, c);
}

}  // namespace naf

extern "C" int naf_mask_parity_tiles(const uint8_t* tog, long long n, int* tile_par, int tiles,
                                     void* stream) {
  NAF_LAUNCH(naf::tile_parity_kernel, tiles, naf::THREADS, 0, stream, tog, n, tile_par);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int naf_mask_parity_apply(const uint8_t* ch, const uint8_t* tog, long long n,
                                     const int* tile_in, uint8_t* out, int tiles, void* stream) {
  NAF_LAUNCH(naf::apply_parity_kernel, tiles, naf::THREADS, 0, stream, ch, tog, n, tile_in,
             out);
  return static_cast<int>(cudaGetLastError());
}
