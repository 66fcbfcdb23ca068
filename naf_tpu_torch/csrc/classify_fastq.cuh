// The FASTQ classify as bit masks: the tile geometry of the FASTQ emit,
// the 128-bit masks of a thread's bytes, the lane-and-header look-back
// value, and the classes of each byte from them.  The standalone classify
// (classify_fastq.cu) and the FASTQ emit (emit_fastq.cu) both build on
// these.
//
// Replaces the classify of naf_tpu/ops/scan_fused.py:_make_fastq_kernel
// (classify_fastq_fused).  The TPU kernel carries three scalars across its
// in-order grid: the header sub-state, whether the previous byte was LF,
// and the line index mod 4 (the lane).  A CUDA grid has no order, so:
//   - the byte before a thread is read from memory or taken from the lane
//     before (no prev-is-LF carry);
//   - the lane and the header sub-state are one 5-bit value a run of
//     bytes (LaneMapOp): the LF count mod 4, and the composed header map
//     of the FASTA classify's monoid (classify.cuh) with EOL as const ID
//     and a non-EOL space as the space map.  Warp scans, the warp totals
//     and a decoupled look-back on one status word a tile give the value
//     entering each thread;
//   - from there, prefix parities of the LF mask give each byte's lane
//     (line index bit 0, then bit 1 from the LFs at odd indices), and a
//     set/reset latch the header's ID/COMMENT split.
// The input is the regular 4-line grid that parallel/block.py:
// make_blocks_fastq accepts, cut at a record start; bytes past the end read
// as LF, which keeps nothing.  A quality line's first byte is kept
// whatever it is (the reference's rule).
//
// Flag bits (as the TPU kernel): bit0 rec_start, bit1 seq_unex, bit2
// seq_keep, bit3 is_lf, bit4 id_keep|qual_keep, bit5 id_unex|qual_unex|
// com_unex, bit6 in_com, bit7 quality-line byte.
#pragma once

#include "classify.cuh"

namespace naf {

constexpr int Q_TILE = 32768;                   // the TPU FASTQ emit's _TILE_Q
constexpr int Q_THREADS = Q_TILE / PER_THREAD;  // 256

// The masks a thread's FASTQ classify starts from.
struct FastqMasks {
  Bits lf, eol, sp_tab, at, low, un_text, un_com, un_seq, un_qual;
};

__device__ __forceinline__ void build_masks(const uint32_t (&w)[WORDS], const QTables& t,
                                            FastqMasks& m) {
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
    m.lf.q[i] = m.eol.q[i] = m.sp_tab.q[i] = m.at.q[i] = m.low.q[i] = m.un_text.q[i] =
        m.un_com.q[i] = m.un_seq.q[i] = m.un_qual.q[i] = 0;
  // words k and k + 1 give bits 4k .. 4k + 7
#pragma unroll
  for (int k = 0; k < WORDS; k += 2) {
    const uint32_t v0 = w[k], v1 = w[k + 1], c0 = cw[k], c1 = cw[k + 1];
    const int i = k >> 3, s = 4 * (k & 7);
    m.lf.q[i] |= gather8(__vcmpeq4(v0, 0x0A0A0A0Au), __vcmpeq4(v1, 0x0A0A0A0Au)) << s;
    m.at.q[i] |= gather8(__vcmpeq4(v0, 0x40404040u), __vcmpeq4(v1, 0x40404040u)) << s;
    m.sp_tab.q[i] |= gather8(__vcmpeq4(v0, 0x20202020u) | __vcmpeq4(v0, 0x09090909u),
                             __vcmpeq4(v1, 0x20202020u) | __vcmpeq4(v1, 0x09090909u)) << s;
    m.low.q[i] |= gather8(__vcmpgeu4(v0, 0x60606060u), __vcmpgeu4(v1, 0x60606060u)) << s;
    m.eol.q[i] |= gather8(c0 << 4, c1 << 4) << s;  // CLS_EOL, bit 3
  }
  // the unexpected classes, where some byte of the thread has one
  if (unex & ~(CLS_EOL * 0x01010101u)) {
#pragma unroll
    for (int k = 0; k < WORDS; k += 2) {
      const uint32_t c0 = cw[k], c1 = cw[k + 1];
      const int i = k >> 3, s = 4 * (k & 7);
      m.un_seq.q[i] |= gather8(c0 << 7, c1 << 7) << s;   // CLS_UNEX_SEQ, bit 0
      m.un_text.q[i] |= gather8(c0 << 6, c1 << 6) << s;  // CLS_UNEX_TEXT, bit 1
      m.un_com.q[i] |= gather8(c0 << 5, c1 << 5) << s;   // CLS_UNEX_COM, bit 2
      m.un_qual.q[i] |= gather8(c0 << 3, c1 << 3) << s;  // CLS_UNEX_QUAL, bit 4
    }
  }
}

// Line index mod 4 (bits 0-1) and composed header map (bits 2-4) of a run
// of bytes; the look-back's value.
struct LaneMapOp {
  __device__ static uint32_t op(uint32_t earlier, uint32_t later) {
    return ((earlier + later) & 3u) |
           static_cast<uint32_t>(compose(static_cast<int>(later >> 2),
                                         static_cast<int>(earlier >> 2))) << 2;
  }
};

// The LaneMapOp value of a thread's bytes.
__device__ __forceinline__ uint32_t lane_map(const FastqMasks& m) {
  uint32_t map = any(m.sp_tab) ? 1u : 0u;
  if (any(m.eol)) {
    const int e = highest(m.eol);
    map = popc(m.sp_tab) > below(m.sp_tab, e + 1) ? 3u : 2u;
  }
  return (static_cast<uint32_t>(popc(m.lf)) & 3u) | map << 2;
}

// The classes of a thread's bytes (classify_fastq_masks' masks but is_lf,
// which is m.lf), from the LaneMapOp value `in` of the bytes before it
// (lane and header map from ID at the block start) and whether the byte
// before it is LF (pe_in).
struct FastqClasses {
  Bits rec, id_keep, id_unex, in_com, com_unex, seq_keep, seq_unex, qline, qual_keep, qual_unex;
};

__device__ __forceinline__ FastqClasses fastq_classes(const FastqMasks& m, uint32_t pe_in,
                                                      uint32_t in) {
  const uint32_t lane0 = in & 3u;
  const uint32_t com0 = apply_map(static_cast<int>(in >> 2), ST_ID) == ST_COM ? 1u : 0u;
  const Bits b0 = parity_before(m.lf, lane0 & 1u);
  const Bits b1 = parity_before(m.lf & b0, lane0 >> 1);
  const Bits l0 = ~(b0 | b1), l1 = b0 & ~b1, l3 = b0 & b1;
  const Bits pe = later(m.lf, pe_in);
  const Bits com = later(latch(m.sp_tab, m.eol, com0), com0);
  const Bits sp = m.eol | m.sp_tab;
  FastqClasses c;
  c.rec = m.at & pe & l0;
  const Bits hdr = l0 & ~c.rec & ~m.eol;
  const Bits id = hdr & ~com & ~sp;
  c.in_com = hdr & com;
  c.id_unex = id & m.un_text;
  c.id_keep = id & ~m.un_text;
  c.com_unex = c.in_com & m.un_com;
  c.seq_keep = l1 & ~sp;
  c.seq_unex = c.seq_keep & m.un_seq;
  c.qline = l3 & ~m.lf;
  const Bits qrest = c.qline & ~pe & ~sp;
  c.qual_unex = qrest & m.un_qual;
  c.qual_keep = qrest | (c.qline & pe);
  return c;
}

}  // namespace naf
