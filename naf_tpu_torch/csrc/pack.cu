// 4-bit nucleotide pack: ASCII -> IUPAC code, two codes a byte, low nibble
// first.
//
// Replaces naf_tpu/ops/pack.py:_pack_kernel (pack_4bit_pallas).  The TPU
// kernel maps bytes with a 16-way compare chain because Mosaic has no fast
// gather; here the 256-entry NUC_CODE table sits in shared memory.  The
// caller's one-byte roll on odd nibble parity (parallel/block.py:335) and
// the zero padding to the output length (_fit) are folded into the kernel:
// out[j] = code(s[2j]) | code(s[2j+1]) << 4 for j < n/2, else 0, where
// s[i] = src[(i + shift) % n].
//
// Bound: memory, 1 B read and 0.5 B written per input byte.  A thread
// turns 16 input bytes (one 16-byte load when shift is 0) into 8 output
// bytes (one 8-byte store).
#include "common.cuh"

namespace naf {

constexpr int PACK_THREADS = 256;

__global__ void __launch_bounds__(PACK_THREADS) pack_kernel(const uint8_t* src, long long n,
                                                            long long shift,
                                                            const uint8_t* nuc_code,
                                                            uint8_t* out, long long n_out) {
  __shared__ uint8_t code[256];
  for (int i = threadIdx.x; i < 256; i += PACK_THREADS) code[i] = nuc_code[i];
  __syncthreads();
  const long long j0 = (static_cast<long long>(blockIdx.x) * PACK_THREADS + threadIdx.x) * 8;
  if (j0 >= n_out) return;
  const long long i0 = 2 * j0;
  uint32_t in[4];
  const bool fast = shift == 0 && i0 + 16 <= n &&
                    (reinterpret_cast<uintptr_t>(src + i0) & 15) == 0;
  if (fast) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + i0);
    in[0] = v.x;
    in[1] = v.y;
    in[2] = v.z;
    in[3] = v.w;
  }
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t b = 0;
    if (j0 + k < n / 2) {
      uint32_t c0, c1;
      if (fast) {
        c0 = (in[(2 * k) >> 2] >> (((2 * k) & 3) * 8)) & 0xFF;
        c1 = (in[(2 * k + 1) >> 2] >> (((2 * k + 1) & 3) * 8)) & 0xFF;
      } else {
        long long a = i0 + 2 * k + shift;
        a %= n;
        long long c = a + 1 == n ? 0 : a + 1;
        c0 = src[a];
        c1 = src[c];
      }
      b = code[c0] | (static_cast<uint32_t>(code[c1]) << 4);
    }
    if (k < 4)
      lo |= b << (8 * k);
    else
      hi |= b << (8 * (k - 4));
  }
  if (j0 + 8 <= n_out && (reinterpret_cast<uintptr_t>(out + j0) & 7) == 0) {
    uint2 v;
    v.x = lo;
    v.y = hi;
    *reinterpret_cast<uint2*>(out + j0) = v;
  } else {
    for (int k = 0; k < 8 && j0 + k < n_out; ++k)
      out[j0 + k] = static_cast<uint8_t>(((k < 4 ? lo : hi) >> (8 * (k & 3))) & 0xFF);
  }
}

}  // namespace naf

extern "C" int naf_pack_4bit(const uint8_t* src, long long n, long long shift,
                             const uint8_t* nuc_code, uint8_t* out, long long n_out,
                             void* stream) {
  const long long threads = (n_out + 7) / 8;
  const long long blocks = (threads + naf::PACK_THREADS - 1) / naf::PACK_THREADS;
  if (blocks > 0)
    NAF_LAUNCH(naf::pack_kernel, static_cast<unsigned>(blocks), naf::PACK_THREADS, 0, stream,
               src, n, shift, nuc_code, out, n_out);
  return static_cast<int>(cudaGetLastError());
}
