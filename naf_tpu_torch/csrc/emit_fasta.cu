// Fused FASTA emit: classify, prefix coordinates, dense stream compaction
// and the tagged sparse record/mask/header channel of one block.
//
// Replaces naf_tpu/ops/emit_fused.py:_make_emit_kernel (emit_fasta_tiles,
// merged by emit_fasta_fused).  The TPU kernel carries seven running values
// across its in-order grid and compacts with a butterfly plus a one-hot MXU
// matmul.  A CUDA grid has no order, so the carries become scans:
//
//   pass A (classify.cu)  composed parser map per tile;
//   [scan over tiles]     parser state entering each tile;
//   pass B (summary)      per tile: stream/seq/sparse counts, unexpected
//                         counts, first/last kept case, line-length summary;
//   [scan over tiles]     each tile's stream, seq and sparse offsets and the
//                         case of the last kept byte before it;
//   pass C (write)        classify again and write sv and the sparse
//                         entries straight to their global offsets.
//
// Inside a block the same carries are block-wide scans over the threads'
// 128-byte chunks.  Compaction is a prefix count: a thread knows the offset
// of its first kept byte and writes its kept bytes in order; the tile's
// stream bytes are staged in shared memory and stored coalesced.
//
// Bound: memory.  Each pass reads the block once (1 B/B, 3 reads in all);
// pass C writes about 1 B per kept byte.  The sparse channel keeps the TPU
// kernel's cap of SP_CAP entries per 64 KiB tile, so sp_ok means the same.
#include "classify.cuh"

namespace naf {

struct Summary {
  int n_stream, n_seq, n_sp, u_id, u_com, u_seq, fsval;
  Cases cs;
  Lines ln;
};

struct SummaryOp {
  __device__ Summary operator()(const Summary& a, const Summary& b) const {
    Summary r;
    r.n_stream = a.n_stream + b.n_stream;
    r.n_seq = a.n_seq + b.n_seq;
    r.n_sp = a.n_sp + b.n_sp;
    r.u_id = a.u_id + b.u_id;
    r.u_com = a.u_com + b.u_com;
    r.u_seq = a.u_seq + b.u_seq;
    r.fsval = a.cs.has ? a.fsval : b.fsval;
    r.cs = combine(a.cs, b.cs);
    r.ln = combine(a.ln, b.ln);
    return r;
  }
};

// Offsets a pass-C thread needs from the threads before it.
struct Offsets {
  int n_stream, n_seq, n_sp;
  Cases cs;
};

struct OffsetsOp {
  __device__ Offsets operator()(const Offsets& a, const Offsets& b) const {
    Offsets r;
    r.n_stream = a.n_stream + b.n_stream;
    r.n_seq = a.n_seq + b.n_seq;
    r.n_sp = a.n_sp + b.n_sp;
    r.cs = combine(a.cs, b.cs);
    return r;
  }
};

constexpr uint32_t F_MARKER = 1, F_SEQ_UNEX = 2, F_SEQ_KEEP = 4, F_EOL = 8, F_ID_KEEP = 16,
                   F_ID_UNEX = 32, F_IN_COM = 64, F_COM_UNEX = 128;
constexpr int TAG_ID = 0, TAG_COM = 1, TAG_REC = 2, TAG_CHG = 3;
constexpr int SUMMARY_COLS = 16;  // ops/emit_fused.py reads these columns

// Per-thread summary of its chunk, for pass B.
__device__ __forceinline__ Summary chunk_summary(const Chunk& ch, const Tables& t) {
  Summary s{};
  LineWalk lw;
  classify_chunk(ch.w, ch.pe, ch.state, t, [&](int, uint32_t f, uint32_t v) {
    const bool seq_keep = f & F_SEQ_KEEP;
    const bool stream_keep = seq_keep || (f & F_ID_UNEX);
    s.n_seq += seq_keep;
    s.n_sp += (f & (F_ID_KEEP | F_IN_COM | F_MARKER)) != 0;
    s.u_id += (f & F_ID_UNEX) != 0;
    s.u_com += (f & F_COM_UNEX) != 0;
    s.u_seq += (f & F_SEQ_UNEX) != 0;
    if (stream_keep) {
      if (!s.cs.has) s.fsval = static_cast<int>(v);
      add_case(s.cs, v >= 96);
      ++s.n_stream;
    }
    lw.step(seq_keep, f & F_EOL);
  });
  s.ln = lw.finish(s.n_seq);
  return s;
}

// Pass B: one summary row per tile (columns as the host reads them).
__global__ void __launch_bounds__(THREADS) emit_summary_kernel(const uint8_t* x, long long n,
                                                               int pe0, const int* st_in,
                                                               const uint8_t* cls, int repl_seq,
                                                               int repl_name, int* summ) {
  __shared__ Tables t;
  __shared__ int map_buf[THREADS];
  __shared__ Summary buf[THREADS];
  load_tables(&t, cls, repl_seq, repl_name);
  Chunk ch;
  load_classified_chunk(ch, x, n, pe0, st_in[blockIdx.x], t, map_buf);
  Summary tot;
  block_exclusive_scan(chunk_summary(ch, t), Summary{}, buf, SummaryOp(), &tot);
  if (threadIdx.x == 0) {
    int* row = summ + static_cast<long long>(blockIdx.x) * SUMMARY_COLS;
    row[0] = tot.n_stream;
    row[1] = tot.n_seq;
    row[2] = tot.n_sp + tot.cs.chg;
    row[3] = tot.u_id;
    row[4] = tot.u_com;
    row[5] = tot.u_seq;
    row[6] = tot.cs.has;
    row[7] = tot.cs.first;
    row[8] = tot.cs.last;
    row[9] = tot.fsval;
    row[10] = tot.ln.has;
    row[11] = tot.ln.pre;
    row[12] = tot.ln.post;
    row[13] = tot.ln.mx;
    row[14] = 0;
    row[15] = 0;
  }
}

// Pass C.  tile_in rows: [parser state in, stream offset, seq offset,
// case of the last kept byte before the tile (-1 none), sparse offset];
// totals: [cnt, n_sp].  Also zeroes sv past cnt and the sparse arrays past
// n_sp, each block its own tile-sized window.
__global__ void __launch_bounds__(THREADS) emit_write_kernel(
    const uint8_t* x, long long n, int pe0, const int* tile_in, const int* totals,
    const uint8_t* cls, int repl_seq, int repl_name, int sp_cap, uint8_t* sv, int* sp_tv,
    int* sp_a) {
  __shared__ Tables t;
  __shared__ int map_buf[THREADS];
  __shared__ Offsets buf[THREADS];
  NAF_EXTERN_SHARED(uint8_t, stage);  // the tile's kept stream bytes, TILE bytes
  const int* in = tile_in + static_cast<long long>(blockIdx.x) * 5;
  const int stream_base = in[1], seq_base = in[2], prev_lower = in[3], sp_base = in[4];
  load_tables(&t, cls, repl_seq, repl_name);
  Chunk ch;
  load_classified_chunk(ch, x, n, pe0, in[0], t, map_buf);

  // counts of this chunk; case changes inside it go to cs.chg
  Offsets mine{};
  classify_chunk(ch.w, ch.pe, ch.state, t, [&](int, uint32_t f, uint32_t v) {
    const bool seq_keep = f & F_SEQ_KEEP;
    mine.n_seq += seq_keep;
    mine.n_sp += (f & (F_ID_KEEP | F_IN_COM | F_MARKER)) != 0;
    if (seq_keep || (f & F_ID_UNEX)) {
      add_case(mine.cs, v >= 96);
      ++mine.n_stream;
    }
  });
  Offsets tot;
  const Offsets before = block_exclusive_scan(mine, Offsets{}, buf, OffsetsOp(), &tot);
  // the last kept byte before the tile acts as a one-byte chunk in front
  Cases entry{prev_lower >= 0 ? 1 : 0, prev_lower, prev_lower, 0};
  const Cases prev = combine(entry, before.cs);
  int stream_i = before.n_stream;     // tile-local stream index
  int seq_i = seq_base + before.n_seq;  // global seq count before the byte
  int sp_i = before.n_sp + prev.chg;  // tile-local sparse index
  int has_prev = prev.has, prev_lw = prev.last;

  classify_chunk(ch.w, ch.pe, ch.state, t, [&](int, uint32_t f, uint32_t v) {
    const bool seq_keep = f & F_SEQ_KEEP;
    const bool stream_keep = seq_keep || (f & F_ID_UNEX);
    bool chg = false;
    if (stream_keep) {
      const int lw = v >= 96;
      chg = has_prev && lw != prev_lw;
      has_prev = 1;
      prev_lw = lw;
    }
    const bool marker = f & F_MARKER;
    const bool in_com = f & F_IN_COM;
    const bool id_keep = f & F_ID_KEEP;
    if (marker || chg || in_com || id_keep) {
      if (sp_i < sp_cap) {
        const int tag = marker ? TAG_REC : (chg ? TAG_CHG : (in_com ? TAG_COM : TAG_ID));
        const int val = (id_keep || in_com) ? ((f & F_COM_UNEX) ? t.repl_name : v) : 0;
        const long long j = static_cast<long long>(sp_base) + sp_i;
        sp_tv[j] = val | (tag << 8);
        sp_a[j] = marker ? seq_i : (chg ? stream_base + stream_i : 0);
      }
      ++sp_i;
    }
    if (stream_keep) stage[stream_i++] = static_cast<uint8_t>(v);
    seq_i += seq_keep;
  });
  __syncthreads();
  for (int j = threadIdx.x; j < tot.n_stream; j += THREADS)
    sv[static_cast<long long>(stream_base) + j] = stage[j];

  // zero sv past cnt and the sparse channel past n_sp
  const long long t0 = static_cast<long long>(blockIdx.x) * TILE;
  for (long long j = (totals[0] > t0 ? totals[0] : t0) + threadIdx.x; j < t0 + TILE; j += THREADS)
    sv[j] = 0;
  const long long s0 = static_cast<long long>(blockIdx.x) * sp_cap;
  for (long long j = (totals[1] > s0 ? totals[1] : s0) + threadIdx.x; j < s0 + sp_cap;
       j += THREADS) {
    sp_tv[j] = 0;
    sp_a[j] = 0;
  }
}

}  // namespace naf

extern "C" int naf_emit_fasta_summary(const uint8_t* x, long long n, int pe0, const int* st_in,
                                      const uint8_t* cls, int repl_seq, int repl_name, int* summ,
                                      int tiles, void* stream) {
  NAF_LAUNCH(naf::emit_summary_kernel, tiles, naf::THREADS, 0, stream, x, n, pe0, st_in, cls,
             repl_seq, repl_name, summ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int naf_emit_fasta_write(const uint8_t* x, long long n, int pe0, const int* tile_in,
                                    const int* totals, const uint8_t* cls, int repl_seq,
                                    int repl_name, int sp_cap, uint8_t* sv, int* sp_tv,
                                    int* sp_a, int tiles, void* stream) {
  const int smem = naf::TILE;
  cudaError_t e = cudaFuncSetAttribute(naf::emit_write_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  NAF_LAUNCH(naf::emit_write_kernel, tiles, naf::THREADS, smem, stream, x, n, pe0, tile_in,
             totals, cls, repl_seq, repl_name, sp_cap, sv, sp_tv, sp_a);
  return static_cast<int>(cudaGetLastError());
}
