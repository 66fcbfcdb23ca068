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
// Both kernels are bound by bytes on this card; the note above each says
// how its design meets that.
#include "common.cuh"

namespace naf {

constexpr uint32_t MF_MUL0 = 2654435761u;
constexpr uint32_t MF_MUL1 = 2246822519u;
constexpr unsigned MF_FULL = 0xFFFFFFFFu;

constexpr int KEYS_THREADS = 256;
constexpr int KEYS_TILE = 8192;  // window bytes a block: mode 0 keys, or mode 1 keys / 8
// the tile, 8 bytes after it (the last windows' third stage word) and up to
// 15 before it (src's offset from a 16-byte boundary), in 16-byte chunks
constexpr int KEYS_CHUNKS = (15 + KEYS_TILE + 8 + 15) / 16;

constexpr int CHAIN_THREADS = 256;
constexpr int CHAIN_PAIRS = 4;  // 16-byte loads of order a thread and tile
constexpr int CHAIN_SLOTS = 2 * CHAIN_PAIRS;
constexpr int CHAIN_TILE = CHAIN_SLOTS * CHAIN_THREADS;  // 2048 sorted entries
constexpr int CHAIN_WARPS = CHAIN_THREADS / 32;
constexpr int CHAIN_UNROLL = 2;                // groups' loads in flight before a ballot

// Bytes s..s+3 of hi:lo (s in 0..3).
__device__ __forceinline__ uint32_t shifted(uint32_t lo, uint32_t hi, uint32_t s) {
  return __byte_perm(lo, hi, 0x3210u + 0x1111u * s);
}

// naf_match_keys reads the window once and writes 4 B a key (mode 0: four
// fifths of its bytes are the writes).  A block takes a tile of KEYS_TILE
// window bytes and stages them, with the 8 bytes after and up to 15 before
// (src's misalignment), in shared memory: 16-byte loads from the 16-byte
// boundary below the tile, so any src alignment reads as aligned words.
// Only a tile whose stage reaches past `size` (the window's end: the zero
// pad, the wrap at cap) or, for a misaligned src, before it stages byte by
// byte; a tile wholly in the pad stages zeros.  Every window is then
// __byte_perm of two stage words: in mode 0 a lane makes the keys of 4
// consecutive positions from 3 stage words and writes them as one 16-byte
// store, a warp 512 contiguous bytes; in mode 1 a lane makes one anchor's
// key and a warp writes 128 contiguous bytes.
__global__ void __launch_bounds__(KEYS_THREADS) match_keys_kernel(const uint8_t* src,
                                                                  long long size, long long cap,
                                                                  int mode, uint32_t* keys,
                                                                  long long n_keys) {
  __shared__ uint4 st4[KEYS_CHUNKS];
  const uint32_t* stage = reinterpret_cast<const uint32_t*>(st4);
  const int t = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * KEYS_TILE;
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  const long long s0 = b0 - a;  // window byte of stage byte 0 (b0 is a multiple of 16)
  constexpr int STAGE = KEYS_CHUNKS * 16;
  if (s0 >= 0 && s0 + STAGE <= size) {
    const uint4* g = reinterpret_cast<const uint4*>(src + s0);
    for (int c = t; c < KEYS_CHUNKS; c += KEYS_THREADS) st4[c] = g[c];
  } else if (s0 >= size && s0 + STAGE <= cap) {
    for (int c = t; c < KEYS_CHUNKS; c += KEYS_THREADS) {
      uint4 z;
      z.x = z.y = z.z = z.w = 0;
      st4[c] = z;
    }
  } else {
    uint8_t* sb = reinterpret_cast<uint8_t*>(st4);
    for (int x = t; x < STAGE; x += KEYS_THREADS) {
      long long q = s0 + x;
      if (q >= cap) q -= cap;  // the windows wrap at cap; a byte no key reads may not
      sb[x] = static_cast<uint8_t>(byte_or(src, size, q, 0));
    }
  }
  __syncthreads();
  const uint32_t sh = a & 3;
  if (mode == 0) {
    const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
#pragma unroll 4
    for (int r = 0; r < KEYS_TILE / (4 * KEYS_THREADS); ++r) {
      const int p = 4 * (r * KEYS_THREADS + t);  // tile position of the lane's first window
      const int w = (a + p) >> 2;
      const uint32_t u0 = shifted(stage[w], stage[w + 1], sh);
      const uint32_t u1 = shifted(stage[w + 1], stage[w + 2], sh);
      uint32_t k4[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) k4[b] = (shifted(u0, u1, b) * MF_MUL0) >> 15;
      const long long i = b0 + p;
      if (vec && i + 4 <= n_keys) {
        uint4 v;
        v.x = k4[0];
        v.y = k4[1];
        v.z = k4[2];
        v.w = k4[3];
        *reinterpret_cast<uint4*>(keys + i) = v;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (i + b < n_keys) keys[i + b] = k4[b];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < KEYS_TILE / (8 * KEYS_THREADS); ++r) {
      const int e = r * KEYS_THREADS + t;  // anchor of the tile
      const long long i = b0 / 8 + e;
      const int w = (a + 8 * e) >> 2;
      const uint32_t w1 = stage[w + 1];
      if (i < n_keys)
        keys[i] = shifted(stage[w], w1, sh) * MF_MUL0 ^ shifted(w1, stage[w + 2], sh) * MF_MUL1;
    }
  }
}

// Entries 2p and 2p+1 of a tile's frame into v[2r], v[2r+1] (-1: no entry);
// frame entry f is sorted index tb + f.
__device__ __forceinline__ void chain_load(const long long* order, long long m, long long tb,
                                           long long (&v)[CHAIN_SLOTS]) {
#pragma unroll
  for (int r = 0; r < CHAIN_PAIRS; ++r) {
    const long long i = tb + 2 * (r * CHAIN_THREADS + static_cast<int>(threadIdx.x));
    if (i >= 0 && i + 2 <= m) {
      const longlong2 x = *reinterpret_cast<const longlong2*>(order + i);
      v[2 * r] = x.x;
      v[2 * r + 1] = x.y;
    } else {
      v[2 * r] = i >= 0 && i < m ? order[i] : -1;
      v[2 * r + 1] = i + 1 >= 0 && i + 1 < m ? order[i + 1] : -1;
    }
  }
}

// naf_match_chain's bytes are almost all the read of `order` (8 B a key);
// only the span's share of the keys (1/64-1/81 on the engine's windows)
// has a row to write, but the rows land at scattered positions, which the
// card writes well below its streaming rate.  Persistent blocks walk tiles
// of CHAIN_TILE sorted entries, and the two phases of a tile share no lane
// state.  Phase A (filter): a thread holds CHAIN_PAIRS pairs of order from
// 16-byte loads (a scalar load where order's ends cut a pair; the tiles
// start one entry early when order is 8 bytes past a 16-byte boundary),
// tests each against the span with one unsigned compare, and appends the
// tile offsets of those in it to the block's queue in shared memory at a
// warp-scan offset (one shared atomic a warp); no lane walks a chain here.
// The loads of the block's next tile are issued before phase B (rows), so
// they are in flight meanwhile.  Phase B spreads the tile's entries over
// all the block's warps: they cluster (a run's positions in the span are
// its last members in a stable sort), so a warp's own share would leave
// the others idle.  A group of pow2(k) lanes (at most 32) takes an entry:
// lane j-1 loads sk[i-j] and order[i-j] (contiguous runs), one
// __ballot_sync finds where i's run ends, and lane j-1 writes column j-1,
// so a row's k int32 go out as one contiguous store (with stride 8, one
// store a position of the anchor; a depth over 32 takes 32 columns a
// step).
__global__ void __launch_bounds__(CHAIN_THREADS) match_chain_kernel(
    const int32_t* sk, const long long* order, long long m, int k, int stride, long long r0,
    long long r1, long long wlo, int32_t* out, int ld, long long tiles) {
  __shared__ int queue[CHAIN_TILE];  // tile offsets of the tile's entries in the span
  __shared__ int s_total[2];         // the queue's length, this tile's and the next's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // with order 8 bytes past a 16-byte boundary the frames start one entry
  // early, so that every whole pair is one aligned 16-byte load
  const long long shift = (reinterpret_cast<uintptr_t>(order) >> 3) & 1;
  // order[i] has a position in the span iff vlo <= order[i] < vhi
  const long long vlo = r0 / stride, vhi = (r1 + stride - 1) / stride, rows = r1 - r0;
  int g = 1;
  while (g < k && g < 32) g <<= 1;
  const int lg = lane & (g - 1), grp = lane / g, per = 32 / g;  // per: entries a pass
  const unsigned gmask = g == 32 ? MF_FULL : (1u << g) - 1;
  const unsigned upto = lg == 31 ? MF_FULL : (2u << lg) - 1;  // lanes 0..lg of the group
  if (tid == 0) s_total[0] = 0;
  long long v[CHAIN_SLOTS];
  long long tile = blockIdx.x;
  if (tile < tiles) chain_load(order, m, tile * CHAIN_TILE - shift, v);
  __syncthreads();
  for (int n = 0; tile < tiles; tile += gridDim.x, ++n) {
    const long long tb = tile * CHAIN_TILE - shift;
    // phase A: the slots in the span, appended at the warp's scan offset
    unsigned mask = 0;
#pragma unroll
    for (int s = 0; s < CHAIN_SLOTS; ++s)
      mask |= static_cast<unsigned>(static_cast<unsigned long long>(v[s] - vlo) <
                                    static_cast<unsigned long long>(vhi - vlo))
              << s;
    if (__any_sync(MF_FULL, mask != 0)) {
      const int mine = __popc(mask);
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(MF_FULL, incl, d);
        if (lane >= d) incl += x;
      }
      int base = 0;
      if (lane == 31) base = atomicAdd(&s_total[n & 1], incl);
      base = __shfl_sync(MF_FULL, base, 31) + incl - mine;
      for (; mask; mask &= mask - 1) {
        const int s = __ffs(mask) - 1;
        queue[base++] = 2 * ((s >> 1) * CHAIN_THREADS + tid) + (s & 1);
      }
    }
    const long long next = tile + gridDim.x;
    if (next < tiles) chain_load(order, m, next * CHAIN_TILE - shift, v);
    __syncthreads();
    // phase B: every warp of the block takes passes of the tile's entries
    const int total = s_total[n & 1];
    if (tid == 0) s_total[(n + 1) & 1] = 0;
    for (int p0 = 0; p0 * per < total; p0 += CHAIN_WARPS * CHAIN_UNROLL) {
      long long i[CHAIN_UNROLL];
      bool ended[CHAIN_UNROLL];
#pragma unroll
      for (int u = 0; u < CHAIN_UNROLL; ++u) {
        const int e = (p0 + u * CHAIN_WARPS + warp) * per + grp;
        i[u] = e < total ? tb + queue[e] : -1;
        ended[u] = false;
      }
      for (int jb = 0; jb < k; jb += g) {  // once for k <= 32
        const int j = jb + lg + 1;
        int c[CHAIN_UNROLL], row[CHAIN_UNROLL];  // c: the candidate + wlo, as its int32 bits
        bool eq[CHAIN_UNROLL];
#pragma unroll
        for (int u = 0; u < CHAIN_UNROLL; ++u) {  // every load of the passes, then the ballots
          eq[u] = false;
          c[u] = row[u] = 0;
          if (i[u] >= 0 && j <= k) {
            row[u] = static_cast<int>(order[i[u]] * stride - r0);
            if (i[u] >= j) {
              eq[u] = sk[i[u] - j] == sk[i[u]];
              c[u] = static_cast<int>(order[i[u] - j] * stride + wlo);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < CHAIN_UNROLL; ++u) {
          const unsigned brk = (~__ballot_sync(MF_FULL, eq[u]) >> (grp * g)) & gmask;
          const bool ok = !ended[u] && (brk & upto) == 0;
          ended[u] = ended[u] || brk != 0;
          if (i[u] >= 0 && j <= k)
            for (int o = 0; o < stride; ++o) {
              const long long q = row[u] + o;
              if (q >= 0 && q < rows)
                out[q * ld + (j - 1)] =
                    ok ? static_cast<int32_t>(static_cast<uint32_t>(c[u]) + o) : -1;
            }
        }
      }
    }
    __syncthreads();  // the queue is read before the next tile's filter writes it
  }
}

}  // namespace naf

extern "C" int naf_match_keys(const uint8_t* src, long long size, long long cap, int mode,
                              uint32_t* keys, void* stream) {
  const long long n_keys = mode == 0 ? cap : cap / 8;
  const long long bytes = mode == 0 ? n_keys : 8 * n_keys;
  if (n_keys > 0)
    NAF_LAUNCH(naf::match_keys_kernel,
               static_cast<unsigned>((bytes + naf::KEYS_TILE - 1) / naf::KEYS_TILE),
               naf::KEYS_THREADS, 0, stream, src, size, cap, mode, keys, n_keys);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int naf_match_chain(const int32_t* sk, const long long* order, long long m, int k,
                               int stride, long long r0, long long r1, long long wlo,
                               int32_t* out, int ld, void* stream) {
  if (m > 0 && r1 > r0) {
    const long long shift = (reinterpret_cast<uintptr_t>(order) >> 3) & 1;
    const long long tiles = (m + shift + naf::CHAIN_TILE - 1) / naf::CHAIN_TILE;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, naf::match_chain_kernel,
                                                          naf::CHAIN_THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long fill = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    NAF_LAUNCH(naf::match_chain_kernel, static_cast<unsigned>(tiles < fill ? tiles : fill),
               naf::CHAIN_THREADS, 0, stream, sk, order, m, k, stride, r0, r1, wlo, out, ld,
               tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
