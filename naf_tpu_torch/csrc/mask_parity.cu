// Mask parity apply: out[i] = ch[i] + 32 * (parity of tog[0..i] & 1), each
// byte wrapping mod 256: the case of each rendered char from the toggles at
// the masked-span bounds.  Only bit 0 of a toggle counts (two bounds that
// coincide give 2, three give 3).
//
// Replaces naf_tpu/ops/emit_fused.py:_maskapply_kernel
// (apply_mask_parity_pallas), which carries the running parity across its
// in-order grid in SMEM.
// Bound: memory.  It reads the chars and the toggles once and writes the
// output once: 3 B a byte over 3.35 TB/s.
//
// One launch; the wrapper zeroes its scratch (a ticket and a look-back
// status word a tile).  A block of 256 threads takes its 32 KiB tile by
// atomic ticket.  Each warp loads its 4,096 toggle bytes into its 4 KiB
// shared stage with 16-byte loads of 512 contiguous bytes
// (classify_stage.cuh), and each lane gathers bit 0 of its 128 bytes from
// there, 16 at a time, into a 128-bit mask whose popcount & 1 is the lane's
// parity.  The chars then go straight into the same stage.  A warp scan, a
// scan over the warp totals and a decoupled look-back on one status word a
// tile (classify.cuh:entry_value under xor) give the parity entering each
// lane, and a carry-less prefix xor of the mask from there the parity
// through each byte.  Each lane adds 32 to its odd bytes in the stage with
// __vadd4, which carries nothing from one byte into the next, and the
// output leaves through the stage, every 16-byte store instruction writing
// 512 contiguous bytes.  Nothing is written past n; a ragged or unaligned
// run takes byte loads and stores.
//
// The two-launch version it replaces read the toggles twice (4 B a byte),
// ran four torch ops between its launches to scan the tile parities, used
// a 512-wide Hillis-Steele block scan (9 rounds, two __syncthreads each) on
// one parity bit a thread, and stored each lane's 16-byte words 128 bytes
// from the next lane's (half-sector stores).  Here the toggles are read
// once, nothing runs between the scratch zeroing and the kernel, the scans
// are warp shuffles and two __syncthreads, and the stores are whole lines.
//
// Shared memory (33 KB a block) holds six blocks an SM, and 40 registers
// let all six run.  On an H100, holding a lane's 128 toggle bytes in
// registers to gather them (58 registers, four blocks an SM) ran 3-4%
// slower; loading the chars straight into registers, 512 contiguous bytes
// a warp instruction, with the parity bits shared through the stage, no
// faster; and 64 KiB tiles of 512 threads no faster.
#include "classify_stage.cuh"

namespace naf {

// Parity under xor: the look-back's value.
struct XorOp {
  __device__ static uint32_t op(uint32_t earlier, uint32_t later) { return earlier ^ later; }
};

constexpr int MP_MIN_BLOCKS = 6;  // blocks an SM, as many as shared memory holds: 40 registers

__global__ void __launch_bounds__(CL_THREADS, MP_MIN_BLOCKS)
    mask_parity_kernel(const uint8_t* ch, const uint8_t* tog, long long n, unsigned* scratch,
                       uint8_t* out) {
  __shared__ int s_tile;
  __shared__ uint32_t s_w[CL_WARPS], s_e;
  __shared__ uint4 s_stage[CL_WARPS][8 * 32];  // a warp's 4,096 bytes: the toggles, then the chars
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(scratch, 1u));
  __syncthreads();
  const int t = s_tile;
  const long long base = static_cast<long long>(t) * CL_TILE + warp * 32 * PER_THREAD;
  uint4* st = s_stage[warp];
  // bit k of tg: bit 0 of the lane's toggle byte k (toggles past n read as
  // 0), gathered from the stage 16 bytes at a time
  load_stage(tog, n, base, st, lane);
  __syncwarp();
  Bits tg{};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 v = st[cl_slot(lane, q)];
    tg.q[q >> 1] |= (gather8(v.x << 7, v.y << 7) | gather8(v.z << 7, v.w << 7) << 8)
                    << (16 * (q & 1));
  }
  __syncwarp();  // every lane has its toggles: the stage takes the chars
  load_stage(ch, n, base, st, lane);
  const WordStatus<XorOp> pst{scratch + 1};
  const uint32_t e = entry_value<CL_WARPS, XorOp>(popc(tg) & 1u, pst, t, s_w, &s_e);
  // bit k: the parity through byte k
  const Bits odd = parity_before(tg, e) ^ tg;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint4 u = st[cl_slot(lane, q)];
    const int i = q >> 1, s = 16 * (q & 1);
    u.x = __vadd4(u.x, spread4(odd, i, s) << 5);
    u.y = __vadd4(u.y, spread4(odd, i, s + 4) << 5);
    u.z = __vadd4(u.z, spread4(odd, i, s + 8) << 5);
    u.w = __vadd4(u.w, spread4(odd, i, s + 12) << 5);
    st[cl_slot(lane, q)] = u;
  }
  __syncwarp();
  store_stage(st, out, n, base, lane);
}

}  // namespace naf

// out[0:n] = ch + 32 * (the parity of tog through each byte), per byte mod
// 256 (tiles = ceil(n / 32768) >= 1).  scratch holds 1 + tiles u32, zero on
// entry: the ticket and a look-back status word a tile.
extern "C" int naf_mask_parity(const uint8_t* ch, const uint8_t* tog, long long n,
                               unsigned* scratch, uint8_t* out, int tiles, void* stream) {
  NAF_LAUNCH(naf::mask_parity_kernel, tiles, naf::CL_THREADS, 0, stream, ch, tog, n, scratch,
             out);
  return static_cast<int>(cudaGetLastError());
}
