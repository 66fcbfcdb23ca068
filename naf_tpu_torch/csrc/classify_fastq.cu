// The standalone FASTQ classify: flags u8[n] and the stream/quality value
// u8[n] of a block, as classify_fastq_plain gives them.
//
// Replaces naf_tpu/ops/scan_fused.py:_make_fastq_kernel (classify_fastq_fused).
// Bound: memory.  It reads the block once and writes two bytes a byte.
//
// One launch; the wrapper zeroes its scratch (a ticket and a look-back
// status word a tile).  It runs on the FASTA classify's stage
// (classify_stage.cuh): 32 KiB ticketed tiles of 256 threads, each warp's
// 4,096 bytes loaded into 4 KiB of shared memory with 16-byte loads of 512
// contiguous bytes, each lane's 128 contiguous bytes taken from there and
// classified once as bit masks (classify_fastq.cuh: SWAR compares and one
// class-table lookup a byte; the lane and the header map of the thread in
// one word, scanned by warp shuffles and carried across tiles by a
// decoupled look-back on one status word a tile; then prefix parities and
// a set/reset latch), the FASTQ emit's classify.  The byte before a lane
// comes from the lane before.  The stage still holds the input bytes, so
// the stream/quality value leaves from it, patched only where a lane has
// an unexpected id, sequence or quality byte; the flags become bytes by
// 8 x 8 bit transposes of the eight flag masks.  Both outputs leave
// through the stage, 512 contiguous bytes a store instruction, and nothing
// is written past n.
//
// Registers: the FASTQ classify keeps eight masks across the look-back
// where the FASTA one keeps six.  On an H100, three blocks an SM (80
// registers) and four (64) ran equally fast; at 80 ptxas spills 8 bytes,
// all on the path of a warp whose run is ragged or unaligned (load_chunk's
// byte loads), while at 64 it spills 84 bytes, much of it on the path of
// whole runs.  Rebuilding the masks from the stage after the look-back, to free
// registers, was slower (a second round of table lookups, and spills).
#include "classify_fastq.cuh"
#include "classify_stage.cuh"

namespace naf {

constexpr int CQ_MIN_BLOCKS = 3;  // blocks an SM: at most 80 registers

__global__ void __launch_bounds__(CL_THREADS, CQ_MIN_BLOCKS)
    classify_fastq_kernel(const uint8_t* x, long long n, int pe0, const uint8_t* cls,
                          int repl_seq, int repl_name, int repl_qual, unsigned* scratch,
                          uint8_t* flags, uint8_t* sval) {
  __shared__ QTables tb;
  __shared__ int s_tile;
  __shared__ uint32_t s_w[CL_WARPS], s_e;
  __shared__ uint4 s_stage[CL_WARPS][8 * 32];  // a warp's 4,096 bytes: the input, then each output
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(scratch, 1u));
  load_tables(&tb, cls, repl_seq, repl_name, repl_qual);
  const int t = s_tile;
  const long long base = static_cast<long long>(t) * CL_TILE + warp * 32 * PER_THREAD;
  const long long start = base + lane * PER_THREAD;
  uint4* st = s_stage[warp];
  uint32_t w[WORDS];
  load_warp(x, n, base, st, lane, w);
  // the byte before the lane's first: the lane before's last, or memory
  uint32_t before = __shfl_up_sync(FULL, w[WORDS - 1] >> 24, 1);
  if (lane == 0) before = byte_or(x, n, start - 1, PAD);
  const uint32_t pe_in = start == 0 ? (pe0 != 0) : (before == 0x0Au ? 1u : 0u);
  FastqMasks m;
  build_masks(w, tb, m);
  const WordStatus<LaneMapOp> lst{scratch + 1};
  const uint32_t in = entry_value<CL_WARPS>(lane_map(m), lst, t, s_w, &s_e);
  const FastqClasses c = fastq_classes(m, pe_in, in);

  // the stream/quality value: the input byte in the stage, or its replacement
  const Bits un = c.id_unex | c.seq_unex | c.qual_unex;
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
                           spread4(c.seq_unex, i, s) * tb.repl_seq |
                           spread4(c.qual_unex, i, s) * tb.repl_qual;
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
    const uint32_t mk[8] = {c.rec.q[i],
                            c.seq_unex.q[i],
                            c.seq_keep.q[i],
                            m.lf.q[i],
                            c.id_keep.q[i] | c.qual_keep.q[i],
                            c.id_unex.q[i] | c.qual_unex.q[i] | c.com_unex.q[i],
                            c.in_com.q[i],
                            c.qline.q[i]};
    uint32_t f[8];
    flag_bytes(mk, f);
    st[cl_slot(lane, 2 * i)] = uint4{f[0], f[1], f[2], f[3]};
    st[cl_slot(lane, 2 * i + 1)] = uint4{f[4], f[5], f[6], f[7]};
  }
  __syncwarp();
  store_stage(st, flags, n, base, lane);
}

}  // namespace naf

// The FASTQ classify of x[0:n] (tiles = ceil(n / 32768) >= 1) from the
// byte before the block being a line end (pe0): flags and sval u8[n] as
// classify_fastq_plain gives them.  scratch holds 1 + tiles u32, zero on
// entry: the ticket and a look-back status word a tile.
extern "C" int naf_classify_fastq(const uint8_t* x, long long n, int pe0, const uint8_t* cls,
                                  int repl_seq, int repl_name, int repl_qual, unsigned* scratch,
                                  uint8_t* flags, uint8_t* sval, int tiles, void* stream) {
  NAF_LAUNCH(naf::classify_fastq_kernel, tiles, naf::CL_THREADS, 0, stream, x, n, pe0, cls,
             repl_seq, repl_name, repl_qual, scratch, flags, sval);
  return static_cast<int>(cudaGetLastError());
}
