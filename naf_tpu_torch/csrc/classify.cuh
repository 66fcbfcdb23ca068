// The FASTA classify as bit masks: the parser monoid, the tables and
// padding, the 128-bit masks of a thread's bytes, and the parser state and
// classes of each byte from them.  The standalone classify (classify.cu)
// and the FASTA emit (emit_fasta.cu) both build on these; the FASTQ
// kernels (classify_fastq.cuh) share the monoid, the tables and the
// look-back's warp scans (entry_value).
//
// Replaces the classify of naf_tpu/ops/scan_fused.py:_make_fasta_kernel.
// The TPU kernel runs a Hillis-Steele compose over a 5-element transition
// monoid inside a tile and carries the parser state across its in-order
// grid in SMEM.  Here a thread's 128 bytes become masks from SWAR compares
// and one class-table lookup a byte; a marker is '>' after a line end (the
// byte before a thread is read from memory or taken from the lane before,
// so no carry is needed for it).
// The thread's composed map comes from the masks, a warp scan and the warp
// totals give the state entering each thread of a tile, and a decoupled
// look-back on one status word a tile (emit_common.cuh) the state entering
// the tile.  From that state set/reset latches give the state before each
// byte: SEQ set by a line end and reset by a marker, then COMMENT set by a
// space or tab outside SEQ and reset by a marker or a line end.
//
// Monoid elements: 0 identity, 1 space (ID -> COMMENT), 2 const ID (marker),
// 3 const COMMENT, 4 const SEQ (EOL).  Parser states: 0 ID, 1 COMMENT, 2 SEQ.
//
// Flag bits (as the TPU kernel): bit0 marker, bit1 seq_unex, bit2 seq_keep,
// bit3 is_eol, bit4 id_keep, bit5 id_unex, bit6 in_com, bit7 com_unex.
#pragma once

#include "common.cuh"
#include "emit_common.cuh"

namespace naf {

constexpr int ST_ID = 0, ST_COM = 1, ST_SEQ = 2;
constexpr uint32_t PAD = 0x0A;  // bytes past the end read as LF, which is inert

__device__ __forceinline__ int compose(int later, int earlier) {
  return later >= 2 ? later
                    : (later == 0 ? earlier : (earlier >= 2 ? (earlier > 3 ? earlier : 3) : 1));
}

__device__ __forceinline__ int apply_map(int m, int s) {
  return m >= 2 ? m - 2 : ((m == 1 && s == ST_ID) ? ST_COM : s);
}

// The composed parser map of a run of bytes; the look-back's value.
struct MapOp {
  __device__ static uint32_t op(uint32_t earlier, uint32_t later) {
    return static_cast<uint32_t>(compose(static_cast<int>(later), static_cast<int>(earlier)));
  }
};

// Tables a block keeps in shared memory.  The FASTQ kernels add the
// quality replacement in QTables; the FASTA kernels keep this layout (with
// the extra field the summary pass of an earlier FASTA emit ran 23% slower
// on the H100).
struct Tables {
  uint8_t cls[256];
  uint32_t repl_seq, repl_name;
};

struct QTables : Tables {
  uint32_t repl_qual;
};

// Every thread of the block must call this; blocks of 256 or more threads.
__device__ __forceinline__ void load_tables(Tables* t, const uint8_t* cls, int repl_seq,
                                            int repl_name) {
  if (threadIdx.x < 256) t->cls[threadIdx.x] = cls[threadIdx.x];
  if (threadIdx.x == 0) {
    t->repl_seq = static_cast<uint32_t>(repl_seq);
    t->repl_name = static_cast<uint32_t>(repl_name);
  }
  __syncthreads();
}

__device__ __forceinline__ void load_tables(QTables* t, const uint8_t* cls, int repl_seq,
                                            int repl_name, int repl_qual) {
  if (threadIdx.x == 0) t->repl_qual = static_cast<uint32_t>(repl_qual);
  load_tables(static_cast<Tables*>(t), cls, repl_seq, repl_name);
}

// The masks a thread's classify starts from.
struct FastaMasks {
  Bits eol, gt, sp_tab, low, un_text, un_com, un_seq;
};

__device__ __forceinline__ void build_masks(const uint32_t (&w)[WORDS], const Tables& t,
                                            FastaMasks& m) {
  uint32_t cw[WORDS], unex = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const uint32_t v = w[k];
    cw[k] = t.cls[v & 0xFFu] | t.cls[(v >> 8) & 0xFFu] << 8 | t.cls[(v >> 16) & 0xFFu] << 16 |
            uint32_t(t.cls[v >> 24]) << 24;
    unex |= cw[k];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m.eol.q[i] = m.gt.q[i] = m.sp_tab.q[i] = m.low.q[i] = m.un_text.q[i] = m.un_com.q[i] =
        m.un_seq.q[i] = 0;
  // words k and k + 1 give bits 4k .. 4k + 7
#pragma unroll
  for (int k = 0; k < WORDS; k += 2) {
    const uint32_t v0 = w[k], v1 = w[k + 1], c0 = cw[k], c1 = cw[k + 1];
    const int i = k >> 3, s = 4 * (k & 7);
    m.gt.q[i] |= gather8(__vcmpeq4(v0, 0x3E3E3E3Eu), __vcmpeq4(v1, 0x3E3E3E3Eu)) << s;
    m.sp_tab.q[i] |= gather8(__vcmpeq4(v0, 0x20202020u) | __vcmpeq4(v0, 0x09090909u),
                             __vcmpeq4(v1, 0x20202020u) | __vcmpeq4(v1, 0x09090909u)) << s;
    m.low.q[i] |= gather8(__vcmpgeu4(v0, 0x60606060u), __vcmpgeu4(v1, 0x60606060u)) << s;
    m.eol.q[i] |= gather8(c0 << 4, c1 << 4) << s;  // CLS_EOL, bit 3
  }
  // the unexpected classes, where some byte of the thread has one
  if (unex & ((CLS_UNEX_SEQ | CLS_UNEX_TEXT | CLS_UNEX_COM) * 0x01010101u)) {
#pragma unroll
    for (int k = 0; k < WORDS; k += 2) {
      const uint32_t c0 = cw[k], c1 = cw[k + 1];
      const int i = k >> 3, s = 4 * (k & 7);
      m.un_seq.q[i] |= gather8(c0 << 7, c1 << 7) << s;   // CLS_UNEX_SEQ, bit 0
      m.un_text.q[i] |= gather8(c0 << 6, c1 << 6) << s;  // CLS_UNEX_TEXT, bit 1
      m.un_com.q[i] |= gather8(c0 << 5, c1 << 5) << s;   // CLS_UNEX_COM, bit 2
    }
  }
}

// The parser's events in a thread's bytes: a marker resets the state to
// ID, a line end to SEQ, and a space or tab turns ID into COMMENT.
__device__ __forceinline__ Bits fasta_reset(const FastaMasks& m, const Bits& marker) {
  return marker | m.eol;
}
__device__ __forceinline__ Bits fasta_space(const FastaMasks& m) { return m.sp_tab & ~m.eol; }

// The markers of a thread's bytes and their composed parser map.  pe_in:
// the byte before the thread's first one is a line end.
struct FastaEvents {
  Bits marker;
  uint32_t map;
};

__device__ __forceinline__ FastaEvents fasta_events(const FastaMasks& m, uint32_t pe_in) {
  FastaEvents e;
  e.marker = m.gt & later(m.eol, pe_in);
  const Bits reset = fasta_reset(m, e.marker), space = fasta_space(m);
  e.map = any(space) ? 1u : 0u;
  if (any(reset)) {
    const int r = highest(reset);
    e.map = bit(m.eol, r) ? 4u : (popc(space) > below(space, r + 1) ? 3u : 2u);
  }
  return e;
}

// The value entering this thread of a tile of NW warps, under a
// look-back op (MapOp here, LaneMapOp for FASTQ), from the thread's own
// value v: a warp scan, then every warp scans the warp totals (lane i warp
// i), and warp 0 publishes the tile's total in st and takes the totals
// before it by look-back.  The value before the block is the op's
// identity, 0.  s_w (NW words) and s_e are shared; every thread of the
// block must call this.
template <int NW, typename Op>
__device__ __forceinline__ uint32_t entry_value(uint32_t v, const WordStatus<Op>& st, int t,
                                                uint32_t* s_w, uint32_t* s_e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc = Op::op(o, inc);
  }
  uint32_t ex = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) ex = 0;
  if (lane == 31) s_w[warp] = inc;
  __syncthreads();
  uint32_t wm = lane < NW ? s_w[lane] : 0u;
#pragma unroll
  for (int d = 1; d < NW; d <<= 1) {
    const uint32_t o = __shfl_up_sync(FULL, wm, d);
    if (lane >= d) wm = Op::op(o, wm);
  }
  const uint32_t tile = __shfl_sync(FULL, wm, NW - 1);
  uint32_t pre = __shfl_sync(FULL, wm, (warp + 31) & 31);
  if (warp == 0) pre = 0;
  if (warp == 0) {
    uint32_t e = 0;
    if (t > 0) {
      if (lane == 0) st.publish(t, LB_AGG, tile);
      e = look_back(st, t, lane, 0);
    }
    if (lane == 0) {
      st.publish(t, LB_PREFIX, Op::op(e, tile));
      *s_e = e;
    }
  }
  __syncthreads();
  return Op::op(Op::op(*s_e, pre), ex);
}

// The parser state entering this thread, from its composed map and the
// state st0 entering the block.
template <int NW>
__device__ __forceinline__ int entry_state(uint32_t map, const WordStatus<MapOp>& mst, int t,
                                           int st0, uint32_t* s_w, uint32_t* s_e) {
  return apply_map(static_cast<int>(entry_value<NW>(map, mst, t, s_w, s_e)), st0);
}

// The classes of a thread's bytes (classify_fasta_plain's masks but
// is_eol, which is m.eol), from the parser state s0 before its first byte.
struct FastaClasses {
  Bits marker, seq_keep, seq_unex, id_keep, id_unex, in_com, com_unex;
};

__device__ __forceinline__ FastaClasses fasta_classes(const FastaMasks& m, const Bits& marker,
                                                      int s0) {
  const uint32_t c_seq = s0 == ST_SEQ ? 1u : 0u, c_com = s0 == ST_COM ? 1u : 0u;
  const Bits in_seq = later(latch(m.eol, marker, c_seq), c_seq);
  const Bits in_com_st =
      later(latch(fasta_space(m) & ~in_seq, fasta_reset(m, marker), c_com), c_com);
  const Bits text = ~marker & ~in_seq;  // an ID or COMMENT byte
  const Bits sp = m.eol | m.sp_tab;
  const Bits in_id = text & ~in_com_st & ~sp;
  FastaClasses c;
  c.marker = marker;
  c.in_com = text & in_com_st & ~m.eol;
  c.id_unex = in_id & m.un_text;
  c.id_keep = in_id & ~m.un_text;
  c.com_unex = c.in_com & m.un_com;
  c.seq_keep = in_seq & ~marker & ~sp;
  c.seq_unex = c.seq_keep & m.un_seq;
  return c;
}

}  // namespace naf
