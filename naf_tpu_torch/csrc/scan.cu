// Inclusive i32 prefix scan, add or max, of a u8/bool or i32 stream.
//
// Replaces naf_tpu/ops/scan_fused.py:_make_scan_kernel (cumsum_i32_pallas,
// maxscan_i32_pallas), which carries the running value across its in-order
// grid in SMEM.  Here the carry goes through three launches: the total of
// each 8192-element tile, one block that scans the [tiles] totals into each
// tile's carry, and a per-tile scan (block_exclusive_scan over the threads'
// sums, then 16 elements a thread) that starts from the carry.  The max
// scan starts its carry at -2^30 as the TPU kernel does, so every output is
// at least -2^30; the add scan wraps as i32.
//
// Bound: memory.  The input is read twice (reduce and apply) and the i32
// output written once; the [tiles] carry arrays are 1/2048 of the stream.
#include "scan.cuh"

namespace naf {

template <typename T, typename Op>
__global__ void __launch_bounds__(SCAN_THREADS) scan_reduce_kernel(const T* x, long long n,
                                                                   int* totals) {
  __shared__ int buf[SCAN_THREADS];
  Op op;
  T v[SCAN_PER];
  const long long start = elem_start();
  load_elems<T>(x, n, start, v, T(0));
  int s = Op::kIdent;
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k)
    if (start + k < n) s = op(s, static_cast<int>(v[k]));
  int total;
  block_exclusive_scan<SCAN_THREADS>(s, Op::kIdent, buf, op, &total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

template <typename T, typename Op>
__global__ void __launch_bounds__(SCAN_THREADS) scan_apply_kernel(const T* x, long long n,
                                                                  const int* carry, int* out) {
  __shared__ int buf[SCAN_THREADS];
  Op op;
  T v[SCAN_PER];
  const long long start = elem_start();
  load_elems<T>(x, n, start, v, T(0));
  int s = Op::kIdent;
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k)
    if (start + k < n) s = op(s, static_cast<int>(v[k]));
  int total;
  int run = op(carry[blockIdx.x],
               block_exclusive_scan<SCAN_THREADS>(s, Op::kIdent, buf, op, &total));
  int r[SCAN_PER];
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    run = op(run, static_cast<int>(v[k]));
    r[k] = run;
  }
  store_elems<int>(out, n, start, r);
}

template <typename T, typename Op>
int scan_launch(const void* x, long long n, int init, int* totals, int* carry, int* out,
                int tiles, void* stream) {
  const T* xs = static_cast<const T*>(x);
  auto reduce = scan_reduce_kernel<T, Op>;
  auto scan_tiles = scan_carry_kernel<Op>;
  auto apply = scan_apply_kernel<T, Op>;
  NAF_LAUNCH(reduce, tiles, SCAN_THREADS, 0, stream, xs, n, totals);
  NAF_LAUNCH(scan_tiles, 1, SCAN_THREADS, 0, stream, static_cast<const int*>(totals), tiles,
             init, carry);
  NAF_LAUNCH(apply, tiles, SCAN_THREADS, 0, stream, xs, n, static_cast<const int*>(carry), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace naf

// out[i] = op(x[0..i]) for i < n, as i32.  in_bytes: 1 (u8/bool) or 4 (i32);
// op: 0 add (carry starts at 0), 1 max (carry starts at -2^30).  totals is
// i32[tiles], carry i32[tiles + 1] scratch; tiles = ceil(n / 8192) >= 1.
extern "C" int naf_scan_i32(const void* x, int in_bytes, long long n, int op, int* totals,
                            int* carry, int* out, int tiles, void* stream) {
  if (op == 0) {
    return in_bytes == 1
               ? naf::scan_launch<uint8_t, naf::AddOp>(x, n, 0, totals, carry, out, tiles, stream)
               : naf::scan_launch<int, naf::AddOp>(x, n, 0, totals, carry, out, tiles, stream);
  }
  return in_bytes == 1 ? naf::scan_launch<uint8_t, naf::MaxOp>(x, n, naf::NEG_BIG, totals, carry,
                                                               out, tiles, stream)
                       : naf::scan_launch<int, naf::MaxOp>(x, n, naf::NEG_BIG, totals, carry,
                                                           out, tiles, stream);
}
