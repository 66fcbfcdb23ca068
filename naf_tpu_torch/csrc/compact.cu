// Stable stream compaction: the kept values to the front in order, zero at
// and past their count, and the count.
//
// Replaces both naf_tpu/ops/compact.py kernels, _compact_kernel
// (compact_u8_pallas) and _dense_compact_kernel (compact_u8_dense).  Their
// butterfly left-pack, 8-row merge and K=4 candidate window are ways to
// move lanes on the TPU's vector unit; they compute this same function.
// Here, per 8192-element tile: count the kept flags; one block scans the
// [tiles] counts into each tile's output offset (scan_carry_kernel, which
// also writes the total); then each tile scans its threads' counts
// (block_exclusive_scan), stages its kept values in shared memory in
// order, writes them out as one contiguous run at its offset, and writes
// zero to the positions of its own range that lie at or past the total.
// A thread none of whose 16 flags is set loads none of its values, so a
// sparse keep (record starts, header bytes) reads little of the values.
// Kept writes land below the total and zero writes at or past it, so no
// two tiles write the same element.  Templated on the value type (u8 or
// i32); both TPU wrappers launch this one kernel.
//
// Bound: memory.  Reads the keep flags twice and the values of the threads
// that keep one; writes the kept prefix and the zero tail once (n output
// elements in all).
#include "scan.cuh"

namespace naf {

__device__ __forceinline__ int count_kept(const uint8_t (&k)[SCAN_PER]) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < SCAN_PER; ++i) c += k[i] != 0;
  return c;
}

__global__ void __launch_bounds__(SCAN_THREADS) compact_count_kernel(const uint8_t* keep,
                                                                     long long n, int* counts) {
  __shared__ int buf[SCAN_THREADS];
  uint8_t k[SCAN_PER];
  load_elems<uint8_t>(keep, n, elem_start(), k, 0);
  int total;
  block_exclusive_scan<SCAN_THREADS>(count_kept(k), 0, buf, AddOp(), &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS) compact_write_kernel(const T* vals,
                                                                     const uint8_t* keep,
                                                                     long long n, const int* offs,
                                                                     int tiles, T* out) {
  __shared__ int buf[SCAN_THREADS];
  __shared__ T stage[SCAN_TILE];
  const long long start = elem_start();
  uint8_t k[SCAN_PER];
  load_elems<uint8_t>(keep, n, start, k, 0);
  const int cnt = count_kept(k);
  T v[SCAN_PER];
  if (cnt > 0) load_elems<T>(vals, n, start, v, T(0));
  int tile_cnt;
  int j = block_exclusive_scan<SCAN_THREADS>(cnt, 0, buf, AddOp(), &tile_cnt);
  if (cnt > 0) {
#pragma unroll
    for (int i = 0; i < SCAN_PER; ++i)
      if (k[i]) stage[j++] = v[i];
  }
  __syncthreads();
  const long long base = offs[blockIdx.x];
  for (int i = threadIdx.x; i < tile_cnt; i += SCAN_THREADS) out[base + i] = stage[i];
  const long long total = offs[tiles];
  const long long tile0 = static_cast<long long>(blockIdx.x) * SCAN_TILE;
  for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
    const long long p = tile0 + i;
    if (p >= total && p < n) out[p] = T(0);
  }
}

template <typename T>
int compact_launch(const void* vals, const uint8_t* keep, long long n, int* counts, int* offs,
                   void* out, int tiles, void* stream) {
  auto count = compact_count_kernel;
  auto scan_tiles = scan_carry_kernel<AddOp>;
  auto write = compact_write_kernel<T>;
  NAF_LAUNCH(count, tiles, SCAN_THREADS, 0, stream, keep, n, counts);
  NAF_LAUNCH(scan_tiles, 1, SCAN_THREADS, 0, stream, static_cast<const int*>(counts), tiles, 0,
             offs);
  NAF_LAUNCH(write, tiles, SCAN_THREADS, 0, stream, static_cast<const T*>(vals), keep, n,
             static_cast<const int*>(offs), tiles, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace naf

// out[:count] = vals[keep != 0] in order, out[count:n] = 0; offs[tiles] is
// the count.  val_bytes: 1 (u8) or 4 (i32).  counts is i32[tiles], offs
// i32[tiles + 1] scratch; tiles = ceil(n / 8192) >= 1.
extern "C" int naf_compact(const void* vals, int val_bytes, const uint8_t* keep, long long n,
                           int* counts, int* offs, void* out, int tiles, void* stream) {
  return val_bytes == 1
             ? naf::compact_launch<uint8_t>(vals, keep, n, counts, offs, out, tiles, stream)
             : naf::compact_launch<int>(vals, keep, n, counts, offs, out, tiles, stream);
}
