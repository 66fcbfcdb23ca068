// Match-candidate kernels of the device zstd engine
// (codec/zstd_backend.py:compress_section_device, ops/matchfind.py).
//
// Replace naf_tpu/ops/matchfind.py:_candidates and _ldm_anchor_candidates,
// which the JAX package leaves to XLA (no Pallas kernel).  Between the two
// kernels the caller sorts the keys with torch.sort(stable=True), as XLA's
// argsort does there:
//
//   naf_match_keys   one 32-bit key per position of a window of `cap`
//                    bytes whose first `size` are src's and the rest zero
//                    padding (ops/matchfind.py pads to a power of two):
//                    mode 0, the 4-byte window at each position, wrapping
//                    at cap as jnp.roll does,
//                      w = d[i] | d[i+1]<<8 | d[i+2]<<16 | d[i+3]<<24,
//                      key = (w * 2654435761 mod 2^32) >> 15   (cap keys);
//                    mode 1, one key per 8-byte anchor a, from its two
//                    little-endian words w0 = d[8a..8a+3], w1 = d[8a+4..],
//                      key = (w0 * 2654435761) ^ (w1 * 2246822519) mod 2^32
//                    (cap / 8 keys).
//   naf_match_chain  over the stable sort (sk, order) of m keys, for every
//                    sorted index i and j = 1..k, the j-th nearest earlier
//                    member of i's equal-key run: c = order[i-j] when
//                    i >= j and sk[i-j] == sk[i], else none.  Each key
//                    stands for `stride` positions (1, or 8 for anchors):
//                    position q = order[i] * stride + o gets
//                    c * stride + o + wlo (none: -1) in column j-1 of row
//                    q - r0, for the q in the span [r0, r1) only; rows are
//                    `ld` int32 apart, so two passes can fill the columns
//                    of one row buffer.
//
// The window's sort covers the history, but only the span's rows are
// written: the JAX package builds [cap, k] and slices it, which at a
// 2^27-position window and k = 16 is 8 GiB.  Equal keys are contiguous in
// the sort, so the first j whose key differs ends i's run.
//
// Bound: memory.  Keys read the window's bytes and write 4 B a key; the
// chain reads order (8 B a key), the keys of the span's entries and of
// their neighbours down to each run's end, and writes the span's rows.
#include "common.cuh"

namespace naf {

constexpr int MF_THREADS = 256;
constexpr int MF_ITEMS = 16;  // keys a thread, MF_THREADS apart
constexpr uint32_t MF_MUL0 = 2654435761u;
constexpr uint32_t MF_MUL1 = 2246822519u;

__device__ __forceinline__ uint32_t window_word(const uint8_t* src, long long size,
                                                long long cap, long long j) {
  uint32_t w = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    long long q = j + t;
    if (q >= cap) q -= cap;
    w |= byte_or(src, size, q, 0) << (8 * t);
  }
  return w;
}

__global__ void __launch_bounds__(MF_THREADS) match_keys_kernel(const uint8_t* src,
                                                                long long size, long long cap,
                                                                int mode, uint32_t* keys,
                                                                long long n_keys) {
  const long long base =
      static_cast<long long>(blockIdx.x) * MF_THREADS * MF_ITEMS + threadIdx.x;
  for (int r = 0; r < MF_ITEMS; ++r) {
    const long long i = base + static_cast<long long>(r) * MF_THREADS;
    if (i >= n_keys) return;
    uint32_t key;
    if (mode == 0) {
      key = (window_word(src, size, cap, i) * MF_MUL0) >> 15;
    } else {
      key = window_word(src, size, cap, 8 * i) * MF_MUL0 ^
            window_word(src, size, cap, 8 * i + 4) * MF_MUL1;
    }
    keys[i] = key;
  }
}

__global__ void __launch_bounds__(MF_THREADS) match_chain_kernel(
    const int32_t* sk, const long long* order, long long m, int k, int stride, long long r0,
    long long r1, long long wlo, int32_t* out, int ld) {
  const long long base =
      static_cast<long long>(blockIdx.x) * MF_THREADS * MF_ITEMS + threadIdx.x;
  for (int r = 0; r < MF_ITEMS; ++r) {
    const long long i = base + static_cast<long long>(r) * MF_THREADS;
    if (i >= m) return;
    const long long q0 = order[i] * stride;
    if (q0 + stride <= r0 || q0 >= r1) continue;
    const int32_t key = sk[i];
    bool run = true;
    for (int j = 1; j <= k; ++j) {
      long long c = -1;
      if (run && i >= j && sk[i - j] == key)
        c = order[i - j];
      else
        run = false;
      for (int o = 0; o < stride; ++o) {
        const long long q = q0 + o;
        if (q < r0 || q >= r1) continue;
        out[(q - r0) * ld + (j - 1)] =
            c < 0 ? -1 : static_cast<int32_t>(c * stride + o + wlo);
      }
    }
  }
}

inline unsigned mf_blocks(long long n) {
  const long long per = static_cast<long long>(MF_THREADS) * MF_ITEMS;
  return static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace naf

extern "C" int naf_match_keys(const uint8_t* src, long long size, long long cap, int mode,
                              uint32_t* keys, void* stream) {
  const long long n_keys = mode == 0 ? cap : cap / 8;
  if (n_keys > 0)
    NAF_LAUNCH(naf::match_keys_kernel, naf::mf_blocks(n_keys), naf::MF_THREADS, 0, stream, src,
               size, cap, mode, keys, n_keys);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int naf_match_chain(const int32_t* sk, const long long* order, long long m, int k,
                               int stride, long long r0, long long r1, long long wlo,
                               int32_t* out, int ld, void* stream) {
  if (m > 0 && r1 > r0)
    NAF_LAUNCH(naf::match_chain_kernel, naf::mf_blocks(m), naf::MF_THREADS, 0, stream, sk,
               order, m, k, stride, r0, r1, wlo, out, ld);
  return static_cast<int>(cudaGetLastError());
}
