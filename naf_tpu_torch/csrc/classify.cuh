// Per-byte FASTA classify: the device functions of the standalone classify,
// and the parser monoid, tables and padding that the FASTA emit shares with
// it (emit_fasta.cu computes the same classes bit-parallel).
//
// Replaces naf_tpu/ops/scan_fused.py:_make_fasta_kernel.  The TPU kernel
// runs a Hillis-Steele compose over a 5-element transition monoid inside a
// tile and carries the parser state across its in-order grid in SMEM.  Here
// a thread composes the maps of its 128 bytes serially, the block scans the
// thread maps, and the tile maps are scanned between launches, so every tile
// starts from its true entry state whatever order the blocks run in.  The
// byte before a thread is read from memory: no prev-is-EOL carry is needed.
//
// Monoid elements: 0 identity, 1 space (ID -> COMMENT), 2 const ID (marker),
// 3 const COMMENT, 4 const SEQ (EOL).  Parser states: 0 ID, 1 COMMENT, 2 SEQ.
//
// Flag bits (as the TPU kernel): bit0 marker, bit1 seq_unex, bit2 seq_keep,
// bit3 is_eol, bit4 id_keep, bit5 id_unex, bit6 in_com, bit7 com_unex.
#pragma once

#include "common.cuh"

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

struct ComposeOp {
  __device__ int operator()(int earlier, int later) const { return compose(later, earlier); }
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
                                            int repl_name, int repl_qual = 0) {
  if (threadIdx.x == 0) t->repl_qual = static_cast<uint32_t>(repl_qual);
  load_tables(static_cast<Tables*>(t), cls, repl_seq, repl_name);
}

__device__ __forceinline__ bool is_space(uint32_t b, uint32_t c) {
  return (c & CLS_EOL) || b == 0x09 || b == 0x20;
}

__device__ __forceinline__ int byte_map(uint32_t b, uint32_t c, bool pe) {
  if (b == '>' && pe) return 2;
  if (c & CLS_EOL) return 4;
  return is_space(b, c) ? 1 : 0;
}

// Classify byte b given the parser state before it; returns the flag byte
// and sets *sval to the (replaced) stream value.
__device__ __forceinline__ uint32_t classify_byte(uint32_t b, bool pe, int sb, const Tables& t,
                                                  uint32_t* sval) {
  const uint32_t c = t.cls[b];
  const bool is_eol = (c & CLS_EOL) != 0;
  const bool sp = is_space(b, c);
  const bool marker = b == '>' && pe;
  const bool in_id = !marker && sb == ST_ID && !sp;
  const bool in_com = !marker && sb == ST_COM && !is_eol;
  const bool in_seq = !marker && sb == ST_SEQ;
  const bool id_unex = in_id && (c & CLS_UNEX_TEXT);
  const bool id_keep = in_id && !(c & CLS_UNEX_TEXT);
  const bool com_unex = in_com && (c & CLS_UNEX_COM);
  const bool seq_keep = in_seq && !sp;
  const bool seq_unex = seq_keep && (c & CLS_UNEX_SEQ);
  *sval = id_unex ? t.repl_name : (seq_unex ? t.repl_seq : b);
  return uint32_t(marker) | uint32_t(seq_unex) << 1 | uint32_t(seq_keep) << 2 |
         uint32_t(is_eol) << 3 | uint32_t(id_keep) << 4 | uint32_t(id_unex) << 5 |
         uint32_t(in_com) << 6 | uint32_t(com_unex) << 7;
}

// Composed map of the thread's 128 bytes; pe is whether the byte before
// the first one is an EOL.
__device__ __forceinline__ int chunk_map(const uint32_t (&w)[WORDS], bool pe, const Tables& t) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const uint32_t b = byte_of(w, k);
    const uint32_t c = t.cls[b];
    acc = compose(byte_map(b, c, pe), acc);
    pe = (c & CLS_EOL) != 0;
  }
  return acc;
}

// Walk the thread's bytes from parser state s, calling f(k, flags, sval)
// for each byte k in order.
template <typename F>
__device__ __forceinline__ void classify_chunk(const uint32_t (&w)[WORDS], bool pe, int s,
                                               const Tables& t, F f) {
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const uint32_t b = byte_of(w, k);
    uint32_t sval;
    const uint32_t flags = classify_byte(b, pe, s, t, &sval);
    f(k, flags, sval);
    const uint32_t c = t.cls[b];
    s = apply_map(byte_map(b, c, pe), s);
    pe = (c & CLS_EOL) != 0;
  }
}

// Prologue of the standalone classify: tables to shared memory,
// the thread's bytes to registers, the thread's entry parser state.
// st_tile is the parser state entering the tile; pe0 whether the byte
// before the block is an EOL.  Every thread of the block must call this.
struct Chunk {
  uint32_t w[WORDS];
  bool pe;    // byte before the thread's first byte is an EOL
  int state;  // parser state before the thread's first byte
  long long start;
};

__device__ __forceinline__ void load_classified_chunk(Chunk& ch, const uint8_t* x, long long n,
                                                      int pe0, int st_tile, const Tables& t,
                                                      int* map_buf) {
  ch.start = static_cast<long long>(blockIdx.x) * TILE +
             static_cast<long long>(threadIdx.x) * PER_THREAD;
  load_chunk(x, n, ch.start, ch.w, PAD);
  ch.pe = ch.start == 0 ? pe0 != 0 : (t.cls[byte_or(x, n, ch.start - 1, PAD)] & CLS_EOL) != 0;
  int total;
  const int prefix = block_exclusive_scan(chunk_map(ch.w, ch.pe, t), 0, map_buf, ComposeOp(),
                                          &total);
  ch.state = apply_map(prefix, st_tile);
}

}  // namespace naf
