// The standalone FASTA classify: flags u8[n] and the stream value u8[n]
// of a block, as classify_fasta_plain gives them.
//
// Replaces naf_tpu/ops/scan_fused.py:_make_fasta_kernel (classify_fasta_fused).
// Bound: memory.  It reads the block once and writes two bytes a byte.
//
// One launch; the wrapper zeroes its scratch (a ticket and a look-back
// status word a tile).  A block of 256 threads takes its 32 KiB tile by
// atomic ticket.  Each warp loads its 4,096 bytes into a 4 KiB shared
// stage with 16-byte loads of 512 contiguous bytes, and each lane takes its
// 128 contiguous bytes from there and classifies them once as bit masks
// (classify.cuh: SWAR compares and one class-table lookup a byte, the
// parser map, warp scans and a decoupled look-back on one status word a
// tile, then set/reset latches).  The stage still holds the input bytes,
// so the stream value leaves from it, patched only where a lane has an
// unexpected id or sequence byte.  The flags become bytes eight at a time:
// byte b of each of the eight flag masks, gathered by __byte_perm, is an
// 8 x 8 bit matrix whose transpose is the flags of bytes 8b .. 8b + 7.
// Both outputs leave through the stage, so that every 16-byte store
// instruction writes 512 contiguous bytes (stored straight, a lane's
// 16-byte stores would be half-sector writes 128 bytes from the next
// lane's).  Nothing is written past n.  The stage, its loads and stores
// and the flag bytes live in classify_stage.cuh, shared with the FASTQ
// classify.
//
// Registers bound the blocks an SM can hold, and with them how much of one
// tile's loads and stores overlaps another's classify and look-back: on an
// H100, four blocks an SM (64 registers) ran 20% faster than two (128).
// ptxas spills 20 bytes at 64 registers, all on the path of a warp whose
// run is ragged or unaligned (load_chunk's byte loads), none on the path
// of whole runs.
#include "classify_stage.cuh"

namespace naf {

constexpr int CL_MIN_BLOCKS = 4;  // blocks an SM: at most 64 registers

__global__ void __launch_bounds__(CL_THREADS, CL_MIN_BLOCKS)
    classify_fasta_kernel(const uint8_t* x, long long n, int pe0, int st0, const uint8_t* cls,
                          int repl_seq, int repl_name, unsigned* scratch, uint8_t* flags,
                          uint8_t* sval) {
  __shared__ Tables tb;
  __shared__ int s_tile;
  __shared__ uint32_t s_w[CL_WARPS], s_e;
  __shared__ uint4 s_stage[CL_WARPS][8 * 32];  // a warp's 4,096 bytes: the input, then each output
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(scratch, 1u));
  load_tables(&tb, cls, repl_seq, repl_name);
  const int t = s_tile;
  const long long base = static_cast<long long>(t) * CL_TILE + warp * 32 * PER_THREAD;
  const long long start = base + lane * PER_THREAD;
  uint4* st = s_stage[warp];
  uint32_t w[WORDS];
  load_warp(x, n, base, st, lane, w);
  // the byte before the lane's first: the lane before's last, or memory
  uint32_t before = __shfl_up_sync(FULL, w[WORDS - 1] >> 24, 1);
  if (lane == 0) before = byte_or(x, n, start - 1, PAD);
  const uint32_t pe_in = start == 0 ? (pe0 != 0) : ((tb.cls[before] & CLS_EOL) ? 1u : 0u);
  FastaMasks m;
  build_masks(w, tb, m);
  const FastaEvents ev = fasta_events(m, pe_in);
  const WordStatus<MapOp> mst{scratch + 1};
  const int s0 = entry_state<CL_WARPS>(ev.map, mst, t, st0, s_w, &s_e);
  const FastaClasses c = fasta_classes(m, ev.marker, s0);

  // the stream value: the input byte in the stage, or its replacement
  const Bits un = c.id_unex | c.seq_unex;
  if (any(un)) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t v[4];
      const uint4 u = st[cl_slot(lane, q)];
      v[0] = u.x;
      v[1] = u.y;
      v[2] = u.z;
      v[3] = u.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = q >> 1, s = 16 * (q & 1) + 4 * j;
        const uint32_t r = spread4(c.id_unex, i, s) * tb.repl_name |
                           spread4(c.seq_unex, i, s) * tb.repl_seq;
        v[j] = (v[j] & ~(spread4(un, i, s) * 0xFFu)) | r;
      }
      st[cl_slot(lane, q)] = uint4{v[0], v[1], v[2], v[3]};
    }
  }
  __syncwarp();
  store_stage(st, sval, n, base, lane);
  __syncwarp();

  // the flags, in the TPU kernel's bit order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t mk[8] = {c.marker.q[i], c.seq_unex.q[i], c.seq_keep.q[i], m.eol.q[i],
                            c.id_keep.q[i], c.id_unex.q[i], c.in_com.q[i], c.com_unex.q[i]};
    uint32_t f[8];
    flag_bytes(mk, f);
    st[cl_slot(lane, 2 * i)] = uint4{f[0], f[1], f[2], f[3]};
    st[cl_slot(lane, 2 * i + 1)] = uint4{f[4], f[5], f[6], f[7]};
  }
  __syncwarp();
  store_stage(st, flags, n, base, lane);
}

}  // namespace naf

// The FASTA classify of x[0:n] (tiles = ceil(n / 32768) >= 1) from the
// byte before the block being a line end (pe0) and the parser state st0:
// flags and sval u8[n] as classify_fasta_plain gives them.  scratch holds
// 1 + tiles u32, zero on entry: the ticket and a look-back status word a
// tile.
extern "C" int naf_classify_fasta(const uint8_t* x, long long n, int pe0, int st0,
                                  const uint8_t* cls, int repl_seq, int repl_name,
                                  unsigned* scratch, uint8_t* flags, uint8_t* sval, int tiles,
                                  void* stream) {
  NAF_LAUNCH(naf::classify_fasta_kernel, tiles, naf::CL_THREADS, 0, stream, x, n, pe0, st0, cls,
             repl_seq, repl_name, scratch, flags, sval);
  return static_cast<int>(cudaGetLastError());
}
