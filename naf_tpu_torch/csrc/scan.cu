// Inclusive i32 prefix scan, add or max, of a u8/bool or i32 stream.
//
// Replaces naf_tpu/ops/scan_fused.py:_make_scan_kernel (cumsum_i32_pallas,
// maxscan_i32_pallas), which carries the running value across its in-order
// grid in SMEM.  The max scan starts its carry at -2^30 as the TPU kernel
// does, so every output is at least -2^30; the add scan wraps as i32.
//
// Bound: memory.  One launch reads the input once and writes the i32
// output once.  A block takes its 24,576-element tile by atomic ticket and
// issues every load of it (six runs a thread: one 16-byte load a u8 run,
// four an i32 run; scan.cuh) before anything waits.  It reduces each run in
// registers, scans the run totals with __shfl_up_sync warp scans and the
// warp totals in one pass over shared memory (three __syncthreads a tile),
// and gets its carry by decoupled look-back (scan.cuh) while its values
// wait in registers.  Only the stores wait for the carry.  A lane's 16
// outputs are contiguous, so stored straight they would be half-sector
// writes 64 bytes apart; each warp swizzles a run's 512 outputs through 2
// KiB of shared memory instead, so that every 16-byte store instruction
// writes 512 contiguous bytes.
//
// On an H100 the time left above a plain copy of the same bytes is a fixed
// cost a tile: the wait, with the tile's registers held, for the tiles
// before it to publish.  So the tile is as large as the registers allow at
// two blocks an SM for an i32 input (128 registers a thread; the runs'
// offsets live in shared memory to stay there), four for a u8 one.
#include "scan.cuh"

namespace naf {

// The register budget: at least this many blocks an SM (an i32 run holds
// 16 registers, a u8 run 4: 128 and 64 registers a thread).
template <typename T>
constexpr int scan_min_blocks() {
  return sizeof(T) == 1 ? 4 : 2;
}

// Slot of quad q (outputs 4q..4q+3) of lane l's run in a warp's staging
// buffer of 128 16-byte slots.  Eight lanes of a 16-byte shared access,
// whether they write slots 4l + q' of lanes 8m..8m+7 or read slots i of
// i = 32j + 8m .. 32j + 8m + 7, meet eight different 16-byte bank groups.
__device__ __forceinline__ int stage_slot(int l, int q) { return 4 * l + (q ^ ((l >> 1) & 3)); }

template <typename T, typename Op>
__global__ void __launch_bounds__(SCAN_THREADS, scan_min_blocks<T>())
    scan_kernel(const T* x, long long n, int init, unsigned* ticket, unsigned long long* status,
                int* out) {
  constexpr int W = 4 * sizeof(T);  // words of a run
  __shared__ int s_tile, s_carry;
  __shared__ int s_warp[SCAN_WARPS];
  __shared__ uint4 s_stage[SCAN_WARPS][128];  // a warp's 512 outputs of one run
  // s_ex[k][tid]: op over the warp's elements before this thread's run k
  __shared__ int s_ex[SCAN_RUNS][SCAN_THREADS];
  Op op;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int t = s_tile;
  const long long first =
      static_cast<long long>(t) * SCAN_TILE + warp * SCAN_WARP_SPAN + lane * 16;
  uint32_t r[SCAN_RUNS][W];
#pragma unroll
  for (int k = 0; k < SCAN_RUNS; ++k) load16<T>(x, n, first + k * 512, r[k]);
  int run = Op::kIdent;
#pragma unroll
  for (int k = 0; k < SCAN_RUNS; ++k) {
    int s = Op::kIdent;
#pragma unroll
    for (int i = 0; i < 16; ++i) s = op(s, static_cast<int>(elem<T>(r[k], i)));
    const int incl = warp_inclusive_scan<Op>(s, lane);
    const int up = __shfl_up_sync(FULL_WARP, incl, 1);
    s_ex[k][tid] = lane > 0 ? op(run, up) : run;
    run = op(run, __shfl_sync(FULL_WARP, incl, 31));
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();
  int agg = Op::kIdent, wpre = Op::kIdent;  // the tile's value; the warps' before this one
#pragma unroll
  for (int i = 0; i < SCAN_WARPS; ++i) {
    const int v = s_warp[i];
    if (i < warp) wpre = op(wpre, v);
    agg = op(agg, v);
  }
  if (warp == 0) {
    int base = init;
    if (t > 0) {
      if (lane == 0) store_status(status + t, status_word(ST_AGGREGATE, agg));
      base = look_back<Op>(status, t, lane);
    }
    if (lane == 0) {
      store_status(status + t, status_word(ST_PREFIX, op(base, agg)));
      s_carry = base;
    }
  }
  __syncthreads();
  const int carry = op(s_carry, wpre);
  // a whole tile goes out through the warp's stage, so that each 16-byte
  // store instruction writes 512 contiguous bytes; the last tile element
  // by element where it must
  const long long warp_first = static_cast<long long>(t) * SCAN_TILE + warp * SCAN_WARP_SPAN;
  const bool whole = static_cast<long long>(t + 1) * SCAN_TILE <= n &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  uint4* stage = s_stage[warp];
#pragma unroll
  for (int k = 0; k < SCAN_RUNS; ++k) {
    int v = op(carry, s_ex[k][tid]);
    int o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v = op(v, static_cast<int>(elem<T>(r[k], i)));
      o[i] = v;
    }
    if (whole) {
      __syncwarp();  // the stage's last run is read
#pragma unroll
      for (int q = 0; q < 4; ++q) stage[stage_slot(lane, q)] = quad(o, q);
      __syncwarp();
      uint4* dst = reinterpret_cast<uint4*>(out + warp_first + k * 512);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 32 * j + lane;
        dst[i] = stage[stage_slot(i >> 2, i & 3)];
      }
    } else {
      store16(out, n, first + k * 512, o);
    }
  }
}

template <typename T, typename Op>
int scan_launch(const void* x, long long n, int init, int* scratch, int* out, int tiles,
                void* stream) {
  auto kernel = scan_kernel<T, Op>;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + 2);
  NAF_LAUNCH(kernel, tiles, SCAN_THREADS, 0, stream, static_cast<const T*>(x), n, init, ticket,
             status, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace naf

// out[i] = op(init, x[0..i]) for i < n, as i32.  in_bytes: 1 (u8/bool) or
// 4 (i32); op: 0 add (init 0), 1 max (init -2^30).  scratch is i32[2 +
// 2 tiles], zero on entry: a ticket, a pad word, and a u64 status word per
// tile; tiles = ceil(n / 24576) >= 1, n >= 1.
extern "C" int naf_scan_i32(const void* x, int in_bytes, long long n, int op, int* scratch,
                            int* out, int tiles, void* stream) {
  if (op == 0) {
    return in_bytes == 1
               ? naf::scan_launch<uint8_t, naf::AddOp>(x, n, 0, scratch, out, tiles, stream)
               : naf::scan_launch<int, naf::AddOp>(x, n, 0, scratch, out, tiles, stream);
  }
  return in_bytes == 1
             ? naf::scan_launch<uint8_t, naf::MaxOp>(x, n, naf::NEG_BIG, scratch, out, tiles,
                                                     stream)
             : naf::scan_launch<int, naf::MaxOp>(x, n, naf::NEG_BIG, scratch, out, tiles, stream);
}
