// Per-byte FASTQ classify: the device functions of the standalone FASTQ
// classify, and the tile geometry and tables that the FASTQ emit shares
// with it (emit_fastq.cu computes the same classes bit-parallel).
//
// Replaces naf_tpu/ops/scan_fused.py:_make_fastq_kernel (classify_fastq_fused).
// The TPU kernel carries three scalars across its in-order grid: the header
// sub-state, whether the previous byte was LF, and the line index mod 4 (the
// lane).  A CUDA grid has no order, so:
//   - the byte before a thread is read from memory (no prev-is-LF carry);
//   - the lane is an LF-count scan: per-thread counts, a block scan, and a
//     scan over the tiles' counts between launches;
//   - the header sub-state is the FASTA classify's 5-element monoid
//     (classify.cuh) with EOL as const ID and a non-EOL space as the space
//     map: per-thread composed maps, a block scan, and a scan over the tile
//     maps between launches (ops/scan_fused.py:entry_states).
// The input is the regular 4-line grid that parallel/block.py:
// make_blocks_fastq accepts, cut at a record start; bytes past the end read
// as LF, which keeps nothing.
//
// Flag bits (as the TPU kernel): bit0 rec_start, bit1 seq_unex, bit2
// seq_keep, bit3 is_lf, bit4 id_keep|qual_keep, bit5 id_unex|qual_unex|
// com_unex, bit6 in_com, bit7 quality-line byte.
#pragma once

#include "classify.cuh"

namespace naf {

constexpr int Q_TILE = 32768;                   // the TPU FASTQ emit's _TILE_Q
constexpr int Q_THREADS = Q_TILE / PER_THREAD;  // 256

// What a FASTQ walk knows before a byte: the byte before it is LF, the
// line index mod 4, and the header sub-state.
struct QState {
  bool pe;
  int lane;
  int s;
};

// One byte's classes, decoded (the emit reads these, not the flag byte).
struct QByte {
  bool rec_start, is_lf, id_keep, id_unex, in_com, com_unex, seq_keep, seq_unex, qual_line,
      qual_keep, qual_unex;
  uint32_t sval;
  __device__ __forceinline__ uint32_t flags() const {
    return uint32_t(rec_start) | uint32_t(seq_unex) << 1 | uint32_t(seq_keep) << 2 |
           uint32_t(is_lf) << 3 | uint32_t(id_keep || qual_keep) << 4 |
           uint32_t(id_unex || qual_unex || com_unex) << 5 | uint32_t(in_com) << 6 |
           uint32_t(qual_line) << 7;
  }
};

// Header sub-state map of one byte: EOL starts the next header at ID; a
// non-EOL space turns ID into COMMENT.
__device__ __forceinline__ int fastq_byte_map(uint32_t b, uint32_t c) {
  if (c & CLS_EOL) return 2;
  return (b == 0x09 || b == 0x20) ? 1 : 0;
}

__device__ __forceinline__ QByte classify_fastq_byte(uint32_t b, const QState& q,
                                                     const QTables& t) {
  const uint32_t c = t.cls[b];
  const bool eolc = (c & CLS_EOL) != 0;
  const bool sp = eolc || b == 0x09 || b == 0x20;
  QByte r;
  r.is_lf = b == 0x0A;
  r.rec_start = b == '@' && q.pe && q.lane == 0;
  const bool in_hdr = q.lane == 0 && !r.rec_start && !eolc;
  const bool in_id = in_hdr && q.s == ST_ID && !sp;
  r.in_com = in_hdr && q.s == ST_COM;
  r.id_unex = in_id && (c & CLS_UNEX_TEXT);
  r.id_keep = in_id && !(c & CLS_UNEX_TEXT);
  r.com_unex = r.in_com && (c & CLS_UNEX_COM);
  r.seq_keep = q.lane == 1 && !sp;
  r.seq_unex = r.seq_keep && (c & CLS_UNEX_SEQ);
  r.qual_line = q.lane == 3 && !r.is_lf;
  // a quality line's first byte is kept whatever it is (the reference's rule)
  const bool qual_rest = r.qual_line && !q.pe && !sp;
  r.qual_unex = qual_rest && (c & CLS_UNEX_QUAL);
  r.qual_keep = qual_rest || (r.qual_line && q.pe);
  r.sval = r.id_unex ? t.repl_name
                     : (r.seq_unex ? t.repl_seq : (r.qual_unex ? t.repl_qual : b));
  return r;
}

__device__ __forceinline__ void advance(QState& q, uint32_t b, const QTables& t) {
  q.s = apply_map(fastq_byte_map(b, t.cls[b]), q.s);
  q.pe = b == 0x0A;
  q.lane = (q.lane + q.pe) & 3;
}

// A chunk's (or tile's) composed header map and LF count.
struct MapLf {
  int map, lf;
};

struct MapLfOp {
  __device__ MapLf operator()(const MapLf& earlier, const MapLf& later) const {
    return MapLf{compose(later.map, earlier.map), earlier.lf + later.lf};
  }
};

__device__ __forceinline__ MapLf chunk_map_lf(const uint32_t (&w)[WORDS], const QTables& t) {
  MapLf r{0, 0};
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const uint32_t b = byte_of(w, k);
    r.map = compose(fastq_byte_map(b, t.cls[b]), r.map);
    r.lf += b == 0x0A;
  }
  return r;
}

// The thread's bytes and the state before its first byte.  lane_tile and
// st_tile are the lane and the header sub-state entering the tile; pe0
// whether the byte before the block is an EOL.  Every thread of the block
// must call this.
struct QChunk {
  uint32_t w[WORDS];
  QState q;
  long long start;
};

__device__ __forceinline__ void load_fastq_chunk(QChunk& ch, const uint8_t* x, long long n,
                                                 int pe0, int lane_tile, int st_tile,
                                                 const QTables& t, MapLf* buf) {
  ch.start = static_cast<long long>(blockIdx.x) * Q_TILE +
             static_cast<long long>(threadIdx.x) * PER_THREAD;
  load_chunk(x, n, ch.start, ch.w, PAD);
  ch.q.pe = ch.start == 0 ? pe0 != 0 : byte_or(x, n, ch.start - 1, PAD) == 0x0A;
  MapLf total;
  const MapLf before = block_exclusive_scan<Q_THREADS>(chunk_map_lf(ch.w, t), MapLf{0, 0}, buf,
                                                       MapLfOp(), &total);
  ch.q.lane = (lane_tile + before.lf) & 3;
  ch.q.s = apply_map(before.map, st_tile);
}

// Walk the thread's bytes in order, calling f(k, QByte) for each byte k.
template <typename F>
__device__ __forceinline__ void classify_fastq_chunk(const QChunk& ch, const QTables& t, F f) {
  QState q = ch.q;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const uint32_t b = byte_of(ch.w, k);
    f(k, classify_fastq_byte(b, q, t));
    advance(q, b, t);
  }
}

}  // namespace naf
