// 4-bit nucleotide unpack: each packed byte -> two ASCII chars, low nibble
// first, through the 16-entry DNA or RNA code table.
//
// Replaces naf_tpu/ops/unpack.py:_unpack_kernel (unpack_4bit_pallas_u16 and
// the interleave of unpack_4bit_pallas).  The TPU kernel writes u16 lanes
// to dodge a minor-dim relayout and maps codes with a compare chain; here a
// thread reads 8 packed bytes and writes the 16 chars as one 16-byte store.
//
// Bound: memory, 1 B read and 2 B written per packed byte.
#include "common.cuh"

namespace naf {

constexpr int UNPACK_THREADS = 256;

__global__ void __launch_bounds__(UNPACK_THREADS) unpack_kernel(const uint8_t* packed,
                                                                long long m,
                                                                const uint8_t* code_to_nuc,
                                                                uint8_t* out) {
  __shared__ uint8_t chars[16];
  if (threadIdx.x < 16) chars[threadIdx.x] = code_to_nuc[threadIdx.x];
  __syncthreads();
  const long long i0 = (static_cast<long long>(blockIdx.x) * UNPACK_THREADS + threadIdx.x) * 8;
  if (i0 >= m) return;
  uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t b = i0 + k < m ? packed[i0 + k] : 0;
    const uint32_t pair = chars[b & 15] | (static_cast<uint32_t>(chars[b >> 4]) << 8);
    o[k >> 1] |= pair << ((k & 1) * 16);
  }
  uint8_t* dst = out + 2 * i0;
  if (i0 + 8 <= m && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint4 v;
    v.x = o[0];
    v.y = o[1];
    v.z = o[2];
    v.w = o[3];
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    for (int k = 0; k < 16 && i0 + k / 2 < m; ++k)
      dst[k] = static_cast<uint8_t>((o[k >> 2] >> ((k & 3) * 8)) & 0xFF);
  }
}

}  // namespace naf

extern "C" int naf_unpack_4bit(const uint8_t* packed, long long m, const uint8_t* code_to_nuc,
                               uint8_t* out, void* stream) {
  const long long threads = (m + 7) / 8;
  const long long blocks = (threads + naf::UNPACK_THREADS - 1) / naf::UNPACK_THREADS;
  if (blocks > 0)
    NAF_LAUNCH(naf::unpack_kernel, static_cast<unsigned>(blocks), naf::UNPACK_THREADS, 0, stream,
               packed, m, code_to_nuc, out);
  return static_cast<int>(cudaGetLastError());
}
