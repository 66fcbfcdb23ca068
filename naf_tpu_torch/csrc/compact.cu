// Stable stream compaction: the kept values to the front in order, zero at
// and past their count, and the count.
//
// Replaces both naf_tpu/ops/compact.py kernels, _compact_kernel
// (compact_u8_pallas) and _dense_compact_kernel (compact_u8_dense).  Their
// butterfly left-pack, 8-row merge and K=4 candidate window are ways to
// move lanes on the TPU's vector unit; they compute this same function.
// Templated on the value type (u8 or i32); both TPU wrappers launch it.
//
// Bound: memory.  The function reads the keep flags (n bytes) and the
// values where a flag is set, and writes n output elements: the kept prefix
// and the zero tail, which is most of a sparse i32 call's bytes.  Two
// launches:
//
// - compact_kernel: one pass over the keep flags.  A block takes its tile
//   id from an atomic ticket, so every earlier tile has started, and finds
//   its output offset by the decoupled look-back of scan.cuh, with the
//   add op (its counts are unsigned adds, the same bits): it publishes its
//   kept count, then its inclusive prefix, in a 64-bit status word per
//   tile (state and value in one store), and warp 0 walks the words before
//   it, 128 a round (4 a lane), summing counts back to the nearest
//   published prefix.  No launch counts the tiles first and no
//   block scans the tile counts alone.  A tile is 32,768 elements: 256
//   threads of eight 16-flag chunks, each chunk one 16-byte load,
//   warp-striped so that a warp's loads are contiguous, all eight issued
//   before the first is used.  A chunk's flags become a 16-bit mask; its
//   count is a popcount, the thread offsets a 5-step __shfl_up_sync scan per
//   chunk, the warp offsets one pass over eight totals in shared memory:
//   four __syncthreads a tile, where the 512-wide Hillis-Steele scan took
//   eighteen.  A chunk with no flag set loads none of its values.  The
//   kept values are staged in 32 KiB of shared memory at the output's
//   alignment mod 16 bytes and written with 16-byte stores, element stores
//   only in the run's first and last slot (a u8 tile always fits; an i32
//   tile keeping more than 8,192 values is staged and written in rounds of
//   whole warps).
// - compact_fill_kernel reads the count from device memory (no host sync)
//   and fills [count, n) with 16-byte stores, grid-stride.
//
// Every output element is written once: kept values below the count by the
// tile that keeps them, zeros at and past it by the fill.  On an H100 the
// fill runs near the memory rate (640 MB in 0.21 ms) but the pass does not:
// each tile is a chain of dependent round trips (ticket, flags, look-back,
// values), and the flags in flight per SM, bounded by registers, cover
// about 1 TB/s of it whatever the tile size or occupancy tried.
#include "scan.cuh"

namespace naf {

constexpr int CT_THREADS = 256;
constexpr int CT_WARPS = CT_THREADS / 32;
constexpr int CT_CHUNKS = 8;                              // 16-flag chunks a thread
constexpr int CT_TILE = CT_THREADS * CT_CHUNKS * 16;      // 32768 elements
constexpr int WARP_SPAN = 32 * CT_CHUNKS * 16;            // elements of one warp
constexpr int STAGE_BYTES = 32768;                        // a u8 tile, 8192 i32
constexpr int FILL_THREADS = 256;
constexpr int FILL_BLOCKS = 1024;                         // most blocks of the fill

// Bit b set where byte b of the 16 flags in w is nonzero.  Per word: the
// high bit of each nonzero byte, shifted to bits 0, 8, 16, 24, and gathered
// to bits 21-24 by one multiply (the partial products never overlap).
__device__ __forceinline__ uint32_t kept_mask(const uint32_t (&w)[4]) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t hi = ((((w[i] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w[i]) & 0x80808080u) >> 7;
    m |= (((hi * 0x00204081u) >> 21) & 0xFu) << (4 * i);
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(CT_THREADS)
    compact_kernel(const T* vals, const uint8_t* keep, long long n, unsigned* ticket,
                   unsigned long long* status, int* count, T* out) {
  constexpr int V = 16 / sizeof(T);             // elements per 16-byte slot
  constexpr int CAP = STAGE_BYTES / sizeof(T);  // elements the stage holds
  static_assert(CAP >= WARP_SPAN, "a warp's kept values fit in the stage");
  NAF_EXTERN_SHARED(uint8_t, smem);  // CAP + V elements of T
  T* stage = reinterpret_cast<T*>(smem);
  __shared__ int s_tile, s_base;
  __shared__ int s_warp[CT_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int t = s_tile;
  // chunk k of a thread starts at element first + 512 k: a warp's loads
  // are contiguous, and chunk order is element order; every load is issued
  // before the first is used
  const long long first = static_cast<long long>(t) * CT_TILE + warp * WARP_SPAN + lane * 16;
  uint32_t w[CT_CHUNKS][4];
#pragma unroll
  for (int k = 0; k < CT_CHUNKS; ++k) load16<uint8_t>(keep, n, first + k * 512, w[k]);
  // per chunk: its kept mask (low 16 bits) and this thread's offset of it
  // in the warp's kept values (high 16 bits, below WARP_SPAN)
  uint32_t mo[CT_CHUNKS];
  int run = 0;
#pragma unroll
  for (int k = 0; k < CT_CHUNKS; ++k) {
    const uint32_t mk = kept_mask(w[k]);
    const int c = __popc(mk);
    const int incl = warp_inclusive_scan<AddOp>(c, lane);
    mo[k] = mk | static_cast<uint32_t>(run + incl - c) << 16;
    run += __shfl_sync(FULL_WARP, incl, 31);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();
  int agg = 0, wpre = 0;  // the tile's kept count; this warp's offset in it
#pragma unroll
  for (int i = 0; i < CT_WARPS; ++i) {
    const int x = s_warp[i];
    wpre += i < warp ? x : 0;
    agg += x;
  }
  if (warp == 0) {
    unsigned base = 0;
    if (t > 0) {
      if (lane == 0) store_status(status + t, ST_AGGREGATE | static_cast<unsigned>(agg));
      base = static_cast<unsigned>(look_back<AddOp>(status, t, lane));
    }
    if (lane == 0) {
      const unsigned incl = base + static_cast<unsigned>(agg);
      store_status(status + t, ST_PREFIX | incl);
      if (t == static_cast<int>(gridDim.x) - 1) *count = static_cast<int>(incl);
      s_base = static_cast<int>(base);
    }
  }
  __syncthreads();
  // Rounds over warps [lo, hi) whose kept values fit in the stage together:
  // one round for u8 and for a sparse i32 tile.  stage[shift + j] holds
  // out[base + j], so a 16-byte slot of the stage is one of the output.
  for (int lo = 0, pre_lo = 0; lo < CT_WARPS;) {
    int hi = lo + 1, cnt = s_warp[lo];
    while (hi < CT_WARPS && cnt + s_warp[hi] <= CAP) cnt += s_warp[hi++];
    const long long base = static_cast<long long>(s_base) + pre_lo;
    const int shift =
        static_cast<int>((reinterpret_cast<uintptr_t>(out + base) & 15) / sizeof(T));
    if (warp >= lo && warp < hi) {
      if constexpr (sizeof(T) == 1) {
        // the values of every chunk that keeps any, four chunks' loads
        // issued before the first is used (all eight at once spill)
#pragma unroll
        for (int g = 0; g < CT_CHUNKS; g += 4) {
          uint32_t v[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (mo[g + k] & 0xFFFFu) load16<T>(vals, n, first + (g + k) * 512, v[k]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if ((mo[g + k] & 0xFFFFu) == 0) continue;
            int j = shift + wpre - pre_lo + static_cast<int>(mo[g + k] >> 16);
#pragma unroll
            for (int i = 0; i < 16; ++i)
              if ((mo[g + k] >> i) & 1u) stage[j++] = elem<T>(v[k], i);
          }
        }
      } else {
        // i32: the values of the first two chunks that keep any load
        // together (a sparse keep seldom has more in one thread); a later
        // one loads when staged
        int k0 = CT_CHUNKS, k1 = CT_CHUNKS;
#pragma unroll
        for (int k = CT_CHUNKS - 1; k >= 0; --k)
          if (mo[k] & 0xFFFFu) k1 = k0, k0 = k;
        uint32_t v0[16], v1[16];
        if (k0 < CT_CHUNKS) load16<T>(vals, n, first + k0 * 512, v0);
        if (k1 < CT_CHUNKS) load16<T>(vals, n, first + k1 * 512, v1);
#pragma unroll
        for (int k = 0; k < CT_CHUNKS; ++k) {
          if ((mo[k] & 0xFFFFu) == 0) continue;
          uint32_t v[16];
          if (k == k0) {
#pragma unroll
            for (int i = 0; i < 16; ++i) v[i] = v0[i];
          } else if (k == k1) {
#pragma unroll
            for (int i = 0; i < 16; ++i) v[i] = v1[i];
          } else {
            load16<T>(vals, n, first + k * 512, v);
          }
          int j = shift + wpre - pre_lo + static_cast<int>(mo[k] >> 16);
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if ((mo[k] >> i) & 1u) stage[j++] = elem<T>(v, i);
        }
      }
    }
    __syncthreads();
    T* dst = out + base - shift;  // 16-byte aligned
    const int end = shift + cnt;
    for (int s = tid; s * V < end; s += CT_THREADS) {
      const int e0 = s * V;
      if (e0 >= shift && e0 + V <= end) {
        reinterpret_cast<uint4*>(dst)[s] = reinterpret_cast<const uint4*>(stage)[s];
      } else {
        for (int e = e0 < shift ? shift : e0; e < e0 + V && e < end; ++e) dst[e] = stage[e];
      }
    }
    pre_lo += cnt;
    lo = hi;
    if (lo < CT_WARPS) __syncthreads();  // the stage is read before the next round
  }
}

// out[count:n] = 0, count read from device memory; 16-byte stores between
// an element-wise head and tail.
template <typename T>
__global__ void __launch_bounds__(FILL_THREADS)
    compact_fill_kernel(const int* count, long long n, T* out) {
  constexpr int V = 16 / sizeof(T);
  const long long c = *count;
  if (c >= n) return;
  const long long lead = (V - static_cast<long long>(
                                  (reinterpret_cast<uintptr_t>(out + c) & 15) / sizeof(T))) % V;
  const long long a = c + lead < n ? c + lead : n;  // first element of a whole slot
  const long long slots = (n - a) / V;
  const long long tail = a + slots * V;
  uint4* q = reinterpret_cast<uint4*>(out + a);
  const uint4 zero = {0u, 0u, 0u, 0u};
  const long long stride = static_cast<long long>(gridDim.x) * FILL_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * FILL_THREADS + threadIdx.x; i < slots;
       i += stride)
    q[i] = zero;
  if (blockIdx.x == 0) {
    if (threadIdx.x < a - c) out[c + threadIdx.x] = T(0);
    if (threadIdx.x < n - tail) out[tail + threadIdx.x] = T(0);
  }
}

template <typename T>
int compact_launch(const void* vals, const uint8_t* keep, long long n, int* scratch, void* out,
                   int tiles, void* stream) {
  auto pass = compact_kernel<T>;
  auto fill = compact_fill_kernel<T>;
  const int smem = STAGE_BYTES + 16;
  cudaError_t e = cudaFuncSetAttribute(pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  int* count = scratch + 1;
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + 2);
  T* o = static_cast<T*>(out);
  const long long fill_slots = (n * static_cast<long long>(sizeof(T)) + 15) / 16;
  const long long want = (fill_slots + 4LL * FILL_THREADS - 1) / (4LL * FILL_THREADS);
  const int fill_blocks = static_cast<int>(want < FILL_BLOCKS ? want : FILL_BLOCKS);
  NAF_LAUNCH(pass, tiles, CT_THREADS, smem, stream, static_cast<const T*>(vals), keep, n, ticket,
             status, count, o);
  NAF_LAUNCH(fill, fill_blocks, FILL_THREADS, 0, stream, static_cast<const int*>(count), n, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace naf

// out[:count] = vals[keep != 0] in order, out[count:n] = 0, count at
// scratch[1].  val_bytes: 1 (u8) or 4 (i32).  scratch is i32[2 + 2 tiles],
// zero on entry: a ticket, the count, and a u64 status word per tile;
// tiles = ceil(n / 32768) >= 1, n >= 1.
extern "C" int naf_compact(const void* vals, int val_bytes, const uint8_t* keep, long long n,
                           int* scratch, void* out, int tiles, void* stream) {
  return val_bytes == 1 ? naf::compact_launch<uint8_t>(vals, keep, n, scratch, out, tiles, stream)
                        : naf::compact_launch<int>(vals, keep, n, scratch, out, tiles, stream);
}
