// Fused FASTQ emit: classify, four prefix coordinates, three dense
// compactions (stream, quality, id) and the tagged sparse channel of one
// block.
//
// Replaces naf_tpu/ops/emit_fused.py:_make_emit_fastq_kernel (emit_fastq_tiles,
// merged by emit_fastq_fused).  The TPU kernel carries nine running values
// across its in-order grid (stream, seq, quality and id prefix counts, the
// EOL base, the longest line, the case encoding, the first kept byte's case
// and value) and compacts with a butterfly plus a one-hot MXU matmul.  A
// CUDA grid has no order, so the carries become scans, as in emit_fasta.cu:
//
//   pass A (classify_fastq.cu)  composed header map and LF count per tile;
//   [scan over tiles]           lane and header sub-state entering each tile;
//   pass B (summary)            per tile: stream/seq/quality/id/sparse counts,
//                               unexpected counts, first/last kept case, the
//                               first kept value, line-length summary;
//   [scan over tiles]           each tile's four offsets, its sparse offset
//                               and the case of the last kept byte before it;
//   pass C (write)              classify again and write sv, qv, iv and the
//                               sparse entries straight to their offsets.
//
// Inside a block the same carries are block-wide scans over the threads'
// 128-byte chunks.  Each dense compaction is a prefix count: a thread knows
// the offset of its first kept byte and writes its kept bytes in order into
// a tile-sized stage in shared memory, stored coalesced afterwards.  The
// sparse channel holds comment bytes, record starts (with their sequence,
// quality and id prefixes in sp_a/sp_b/sp_c) and case changes; it keeps the
// TPU kernel's 32 KiB tiles and cap of SP_CAP entries per tile, so sp_ok
// means the same.
//
// Bound: memory.  Each pass reads the block once (3 reads in all); pass C
// writes about 1 B per kept byte.
#include "classify_fastq.cuh"

namespace naf {

struct QSummary {
  int n_stream, n_seq, n_qual, n_id, n_sp, u_id, u_com, u_seq, u_qual, fsval;
  Cases cs;
  Lines ln;
};

struct QSummaryOp {
  __device__ QSummary operator()(const QSummary& a, const QSummary& b) const {
    QSummary r;
    r.n_stream = a.n_stream + b.n_stream;
    r.n_seq = a.n_seq + b.n_seq;
    r.n_qual = a.n_qual + b.n_qual;
    r.n_id = a.n_id + b.n_id;
    r.n_sp = a.n_sp + b.n_sp;
    r.u_id = a.u_id + b.u_id;
    r.u_com = a.u_com + b.u_com;
    r.u_seq = a.u_seq + b.u_seq;
    r.u_qual = a.u_qual + b.u_qual;
    r.fsval = a.cs.has ? a.fsval : b.fsval;
    r.cs = combine(a.cs, b.cs);
    r.ln = combine(a.ln, b.ln);
    return r;
  }
};

// Offsets a pass-C thread needs from the threads before it.
struct QOffsets {
  int n_stream, n_seq, n_qual, n_id, n_sp;
  Cases cs;
};

struct QOffsetsOp {
  __device__ QOffsets operator()(const QOffsets& a, const QOffsets& b) const {
    QOffsets r;
    r.n_stream = a.n_stream + b.n_stream;
    r.n_seq = a.n_seq + b.n_seq;
    r.n_qual = a.n_qual + b.n_qual;
    r.n_id = a.n_id + b.n_id;
    r.n_sp = a.n_sp + b.n_sp;
    r.cs = combine(a.cs, b.cs);
    return r;
  }
};

constexpr int Q_SUMMARY_COLS = 17;  // ops/emit_fused.py reads these columns
constexpr int Q_TILE_IN_COLS = 8;
constexpr int TAG_COM = 1, TAG_REC = 2, TAG_CHG = 3;

__device__ __forceinline__ bool stream_keep(const QByte& r) { return r.seq_keep || r.id_unex; }

// Per-thread summary of its chunk, for pass B.
__device__ __forceinline__ QSummary chunk_summary(const QChunk& ch, const QTables& t) {
  QSummary s{};
  LineWalk lw;
  classify_fastq_chunk(ch, t, [&](int, const QByte& r) {
    s.n_seq += r.seq_keep;
    s.n_qual += r.qual_keep;
    s.n_id += r.id_keep;
    s.n_sp += r.in_com || r.rec_start;
    s.u_id += r.id_unex;
    s.u_com += r.com_unex;
    s.u_seq += r.seq_unex;
    s.u_qual += r.qual_unex;
    if (stream_keep(r)) {
      if (!s.cs.has) s.fsval = static_cast<int>(r.sval);
      add_case(s.cs, r.sval >= 96);
      ++s.n_stream;
    }
    lw.step(r.seq_keep, r.is_lf);
  });
  s.ln = lw.finish(s.n_seq);
  return s;
}

// Pass B: one summary row per tile (columns as the host reads them).
// entry rows: [lane, header sub-state] entering each tile.
__global__ void __launch_bounds__(Q_THREADS) emit_fastq_summary_kernel(
    const uint8_t* x, long long n, int pe0, const int* entry, const uint8_t* cls, int repl_seq,
    int repl_name, int repl_qual, int* summ) {
  __shared__ QTables t;
  __shared__ MapLf map_buf[Q_THREADS];
  __shared__ QSummary buf[Q_THREADS];
  load_tables(&t, cls, repl_seq, repl_name, repl_qual);
  const int* in = entry + 2 * static_cast<long long>(blockIdx.x);
  QChunk ch;
  load_fastq_chunk(ch, x, n, pe0, in[0], in[1], t, map_buf);
  QSummary tot;
  block_exclusive_scan<Q_THREADS>(chunk_summary(ch, t), QSummary{}, buf, QSummaryOp(), &tot);
  if (threadIdx.x == 0) {
    int* row = summ + static_cast<long long>(blockIdx.x) * Q_SUMMARY_COLS;
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
    row[14] = tot.n_qual;
    row[15] = tot.n_id;
    row[16] = tot.u_qual;
  }
}

// Zero out[t0 + j] for j in [max(total - t0, 0), size): a block's window
// of an output past its total count.
template <typename T>
__device__ __forceinline__ void zero_past(T* out, long long total, long long t0, long long size) {
  for (long long j = (total > t0 ? total : t0) + threadIdx.x; j < t0 + size; j += Q_THREADS)
    out[j] = 0;
}

// Pass C.  tile_in rows: [lane, header sub-state, stream offset, seq offset,
// quality offset, id offset, case of the last kept byte before the tile
// (-1 none), sparse offset]; totals: [cnt, n_sp, cnt_qual, cnt_id].  Also
// zeroes sv, qv and iv past their counts and the sparse arrays past n_sp,
// each block its own tile-sized window.
__global__ void __launch_bounds__(Q_THREADS) emit_fastq_write_kernel(
    const uint8_t* x, long long n, int pe0, const int* tile_in, const int* totals,
    const uint8_t* cls, int repl_seq, int repl_name, int repl_qual, int sp_cap, uint8_t* sv,
    uint8_t* qv, uint8_t* iv, int* sp_tv, int* sp_a, int* sp_b, int* sp_c) {
  __shared__ QTables t;
  __shared__ MapLf map_buf[Q_THREADS];
  __shared__ QOffsets buf[Q_THREADS];
  NAF_EXTERN_SHARED(uint8_t, stage);  // the tile's kept sv, qv and iv bytes, Q_TILE each
  uint8_t* stage_s = stage;
  uint8_t* stage_q = stage + Q_TILE;
  uint8_t* stage_i = stage + 2 * Q_TILE;
  const int* in = tile_in + static_cast<long long>(blockIdx.x) * Q_TILE_IN_COLS;
  const int stream_base = in[2], seq_base = in[3], qual_base = in[4], id_base = in[5];
  const int prev_lower = in[6], sp_base = in[7];
  load_tables(&t, cls, repl_seq, repl_name, repl_qual);
  QChunk ch;
  load_fastq_chunk(ch, x, n, pe0, in[0], in[1], t, map_buf);

  // counts of this chunk; case changes inside it go to cs.chg
  QOffsets mine{};
  classify_fastq_chunk(ch, t, [&](int, const QByte& r) {
    mine.n_seq += r.seq_keep;
    mine.n_qual += r.qual_keep;
    mine.n_id += r.id_keep;
    mine.n_sp += r.in_com || r.rec_start;
    if (stream_keep(r)) {
      add_case(mine.cs, r.sval >= 96);
      ++mine.n_stream;
    }
  });
  QOffsets tot;
  const QOffsets before =
      block_exclusive_scan<Q_THREADS>(mine, QOffsets{}, buf, QOffsetsOp(), &tot);
  // the last kept byte before the tile acts as a one-byte chunk in front
  Cases entry_cs{prev_lower >= 0 ? 1 : 0, prev_lower, prev_lower, 0};
  const Cases prev = combine(entry_cs, before.cs);
  int stream_i = before.n_stream;  // tile-local stream index
  int qual_i = before.n_qual;      // tile-local quality index
  int id_i = before.n_id;          // tile-local id index
  int seq_g = seq_base + before.n_seq;  // global counts before the byte
  int qual_g = qual_base + before.n_qual;
  int id_g = id_base + before.n_id;
  int sp_i = before.n_sp + prev.chg;  // tile-local sparse index
  int has_prev = prev.has, prev_lw = prev.last;

  classify_fastq_chunk(ch, t, [&](int, const QByte& r) {
    const bool keep = stream_keep(r);
    bool chg = false;
    if (keep) {
      const int lw = r.sval >= 96;
      chg = has_prev && lw != prev_lw;
      has_prev = 1;
      prev_lw = lw;
    }
    if (r.rec_start || chg || r.in_com) {
      if (sp_i < sp_cap) {
        const int tag = r.rec_start ? TAG_REC : (chg ? TAG_CHG : TAG_COM);
        const int val = r.in_com ? (r.com_unex ? t.repl_name : r.sval) : 0;
        const long long j = static_cast<long long>(sp_base) + sp_i;
        sp_tv[j] = val | (tag << 8);
        sp_a[j] = r.rec_start ? seq_g : (chg ? stream_base + stream_i : 0);
        sp_b[j] = r.rec_start ? qual_g : 0;
        sp_c[j] = r.rec_start ? id_g : 0;
      }
      ++sp_i;
    }
    if (keep) stage_s[stream_i++] = static_cast<uint8_t>(r.sval);
    if (r.qual_keep) stage_q[qual_i++] = static_cast<uint8_t>(r.sval);
    if (r.id_keep) stage_i[id_i++] = static_cast<uint8_t>(r.sval);
    seq_g += r.seq_keep;
    qual_g += r.qual_keep;
    id_g += r.id_keep;
  });
  __syncthreads();
  for (int j = threadIdx.x; j < tot.n_stream; j += Q_THREADS)
    sv[static_cast<long long>(stream_base) + j] = stage_s[j];
  for (int j = threadIdx.x; j < tot.n_qual; j += Q_THREADS)
    qv[static_cast<long long>(qual_base) + j] = stage_q[j];
  for (int j = threadIdx.x; j < tot.n_id; j += Q_THREADS)
    iv[static_cast<long long>(id_base) + j] = stage_i[j];

  // zero the outputs past their counts
  const long long t0 = static_cast<long long>(blockIdx.x) * Q_TILE;
  zero_past(sv, totals[0], t0, Q_TILE);
  zero_past(qv, totals[2], t0, Q_TILE);
  zero_past(iv, totals[3], t0, Q_TILE);
  const long long s0 = static_cast<long long>(blockIdx.x) * sp_cap;
  zero_past(sp_tv, totals[1], s0, sp_cap);
  zero_past(sp_a, totals[1], s0, sp_cap);
  zero_past(sp_b, totals[1], s0, sp_cap);
  zero_past(sp_c, totals[1], s0, sp_cap);
}

}  // namespace naf

extern "C" int naf_emit_fastq_summary(const uint8_t* x, long long n, int pe0, const int* entry,
                                      const uint8_t* cls, int repl_seq, int repl_name,
                                      int repl_qual, int* summ, int tiles, void* stream) {
  NAF_LAUNCH(naf::emit_fastq_summary_kernel, tiles, naf::Q_THREADS, 0, stream, x, n, pe0, entry,
             cls, repl_seq, repl_name, repl_qual, summ);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int naf_emit_fastq_write(const uint8_t* x, long long n, int pe0, const int* tile_in,
                                    const int* totals, const uint8_t* cls, int repl_seq,
                                    int repl_name, int repl_qual, int sp_cap, uint8_t* sv,
                                    uint8_t* qv, uint8_t* iv, int* sp_tv, int* sp_a, int* sp_b,
                                    int* sp_c, int tiles, void* stream) {
  const int smem = 3 * naf::Q_TILE;
  cudaError_t e = cudaFuncSetAttribute(naf::emit_fastq_write_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  NAF_LAUNCH(naf::emit_fastq_write_kernel, tiles, naf::Q_THREADS, smem, stream, x, n, pe0,
             tile_in, totals, cls, repl_seq, repl_name, repl_qual, sp_cap, sv, qv, iv, sp_tv, sp_a,
             sp_b, sp_c);
  return static_cast<int>(cudaGetLastError());
}
