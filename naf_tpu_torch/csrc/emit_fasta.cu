// Fused FASTA emit: classify, prefix coordinates, dense stream compaction
// and the tagged sparse record/mask/header channel of one block, with the
// block's scalars.
//
// Replaces naf_tpu/ops/emit_fused.py:_make_emit_kernel (emit_fasta_tiles,
// merged by emit_fasta_fused).  The TPU kernel carries seven running values
// across its in-order grid (the parser state, the stream, sequence and
// sparse prefix counts, the EOL base, the longest line, the case of the
// last kept byte) and compacts with a butterfly plus a one-hot MXU matmul.
// A CUDA grid has no order.
//
// Bound: memory.  The function reads the block once and writes the stream
// up to its count, the used sparse entries and the zero fill the contract
// asks for (sv past cnt, the sparse arrays past n_sp): 0.0806 ms for the
// kept bytes of phase 2's FASTA block on an H100, 0.0913 ms with every
// output at its full size.
//
// Two launches, in the pattern of the FASTQ emit (emit_fastq.cu), with the
// helpers of emit_common.cuh:
//
// - emit_fasta_kernel, one pass over the block.  A block takes its 64 KiB
//   tile by atomic ticket; each of its 512 threads loads its 128 bytes
//   (eight 16-byte loads) and classifies them once, bit-parallel: 128-bit
//   masks from SWAR compares (__vcmpeq4) and one class-table lookup a
//   byte (the three unexpected-byte masks only where the thread has such a
//   byte).  A marker is '>' after a line end (the byte before a thread is
//   read from memory, so no carry is needed for it); the parser state
//   before each byte comes from set/reset latches: SEQ set by a line end
//   and reset by a marker, then COMMENT set by a space or tab outside SEQ
//   and reset by a marker or a line end.  The latches start from the state
//   entering the thread, which is the composed 5-element parser map
//   (classify.cuh) of the bytes before it: a warp scan, the warp totals,
//   and across tiles the first decoupled look-back, one 32-bit status word
//   a tile published as soon as the tile's masks are built.  A second,
//   chained look-back carries the stream and sequence counts, the capped
//   sparse offset and the case of the last kept byte (CaseAgg: a tile's
//   capped count stays pending until the case before it is known).  Inside
//   the tile the scans are __shfl_up_sync warp scans over packed 16-bit
//   fields (a warp's 4,096 bytes fit), then every warp scans the sixteen
//   warp totals in 32-bit fields (a tile can keep 65,536 bytes).  Counts come
//   from __popc, line lengths from a walk over the set line-end bits.  The
//   kept bytes go to a 64 KiB shared stage at their scanned offsets, at
//   sv's alignment (one predicated store a byte at a popcount offset: no
//   branch, no running cursor), and leave with 16-byte stores; the staging
//   reads the thread's 32-byte runs that keep a byte again through the
//   read-only cache.  The sparse entries go to their scanned offsets below
//   the cap, in byte order.  The tile writes a record for the block
//   scalars; the last tile writes the counts.
// - emit_fasta_fill_kernel zeroes sv past cnt and sp_tv, sp_a past n_sp,
//   read from device memory (no host sync), with 16-byte stores; its block
//   0 also folds the tile records into the scalars (longest line, first
//   kept case and value, unexpected counts, sp_ok).
//
// Against the three-pass design it replaces: five serial byte walks of
// each thread's bytes become one mask build; the 512-wide Hillis-Steele
// block scans (two __syncthreads a round) become warp shuffles; the scans
// over the tile summaries between launches (about 30 torch ops) become the
// look-backs; byte staging at a running cursor becomes stores at popcount
// offsets; each output element is written once, the zero fill in its own
// launch.  On an H100 the pass runs one block an SM (92 registers, no
// spill); the staging takes about a third of it, and the look-backs
// nothing measurable.  Two blocks an SM (64 registers) were faster but
// spilled; staging whole words (__byte_perm into aligned 32-bit stores)
// was slower.  The sparse channel keeps the TPU kernel's 64 KiB tiles and
// cap of sp_cap entries a tile, so sp_ok means the same.
#include "classify.cuh"
#include "emit_common.cuh"

namespace naf {

constexpr int FE_WARPS = THREADS / 32;
constexpr int FE_STAGE = TILE + 16;  // the kept stream bytes of a tile, at sv's alignment
using FAgg = CaseAgg<2>;              // stream and sequence counts
using FLayout = EmitLayout<2, 3>;     // unexpected id, comment and sequence bytes

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

// The composed parser map of a run of bytes; the first look-back's value.
struct MapOp {
  __device__ static uint32_t op(uint32_t earlier, uint32_t later) {
    return static_cast<uint32_t>(compose(static_cast<int>(later), static_cast<int>(earlier)));
  }
};

// Packed counts of a run of bytes inside a warp (at most 4,096 bytes, so
// each field fits 16 bits): a stream | seq << 16, c the sparse entries and
// the kept bytes' case runs as cases_op takes them.
struct P2 {
  uint32_t a, c;
};

__device__ __forceinline__ P2 shfl_up(const P2& v, int d) {
  return P2{__shfl_up_sync(FULL, v.a, d), __shfl_up_sync(FULL, v.c, d)};
}

// Counts of a run of bytes inside a tile, in 32-bit fields: the stream,
// sequence and sparse counts, and the case runs in bits 16-18 of cs.
struct Run {
  uint32_t stream, seq, sp, cs;
};

__device__ __forceinline__ Run unpack(const P2& v) {
  return Run{v.a & 0xFFFFu, v.a >> 16, v.c & 0xFFFFu, v.c & (7u << 16)};
}

// x followed by y, with the change at y's first kept byte.
__device__ __forceinline__ Run run_op(const Run& x, const Run& y) {
  const uint32_t c = cases_op(x.cs, y.cs);
  return Run{x.stream + y.stream, x.seq + y.seq, x.sp + y.sp + (c & 0xFFFFu), c & (7u << 16)};
}

__device__ __forceinline__ Run shfl(const Run& v, int src) {
  return Run{__shfl_sync(FULL, v.stream, src), __shfl_sync(FULL, v.seq, src),
             __shfl_sync(FULL, v.sp, src), __shfl_sync(FULL, v.cs, src)};
}

__device__ __forceinline__ Run shfl_up(const Run& v, int d) {
  return Run{__shfl_up_sync(FULL, v.stream, d), __shfl_up_sync(FULL, v.seq, d),
             __shfl_up_sync(FULL, v.sp, d), __shfl_up_sync(FULL, v.cs, d)};
}

__global__ void __launch_bounds__(THREADS) emit_fasta_kernel(
    const uint8_t* x, long long n, int pe0, int st0, const uint8_t* cls, int repl_seq,
    int repl_name, int sp_cap, int* scratch, int* scal, uint8_t* sv, int* sp_tv, int* sp_a) {
  __shared__ Tables tb;
  __shared__ int s_tile, s_fsval;
  __shared__ uint32_t s_w1[FE_WARPS], s_e1;
  __shared__ P2 s_w2[FE_WARPS];
  __shared__ uint32_t s_un[FE_WARPS][2];
  __shared__ Lines s_ln[FE_WARPS];
  // the tile's stream, seq and sparse offsets; the case before it (has,
  // last); a change at its first kept byte
  __shared__ int s_base[6];
  NAF_EXTERN_SHARED(uint8_t, stage);  // FE_STAGE bytes: the kept stream bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = static_cast<int>(gridDim.x);
  uint32_t* status = reinterpret_cast<uint32_t*>(scratch + LB_HEAD);
  const CountStatus<2> cst{status};
  const WordStatus<MapOp> mst{status + static_cast<long long>(tiles) * LB_STATUS};
  int* recs = scratch + LB_HEAD + static_cast<long long>(tiles) * (LB_STATUS + 1);
  if (tid == 0) {
    s_tile = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u));
    s_fsval = 0;
  }
  load_tables(&tb, cls, repl_seq, repl_name);
  const int t = s_tile;
  const long long start =
      static_cast<long long>(t) * TILE + static_cast<long long>(tid) * PER_THREAD;
  uint32_t w[WORDS];
  load_chunk(x, n, start, w, PAD);
  const uint32_t pe_in =
      start == 0 ? (pe0 != 0) : ((tb.cls[byte_or(x, n, start - 1, PAD)] & CLS_EOL) ? 1u : 0u);
  FastaMasks m;
  build_masks(w, tb, m);

  // 1. the parser state entering the thread: a marker resets it to ID, a
  // line end to SEQ, and a space or tab turns ID into COMMENT
  const Bits marker = m.gt & later(m.eol, pe_in);
  const Bits reset = marker | m.eol;
  const Bits space = m.sp_tab & ~m.eol;
  uint32_t map = any(space) ? 1u : 0u;
  if (any(reset)) {
    const int r = highest(reset);
    map = bit(m.eol, r) ? 4u : (popc(space) > below(space, r + 1) ? 3u : 2u);
  }
  uint32_t inc1 = map;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(FULL, inc1, d);
    if (lane >= d) inc1 = MapOp::op(o, inc1);
  }
  uint32_t ex1 = __shfl_up_sync(FULL, inc1, 1);
  if (lane == 0) ex1 = 0;
  if (lane == 31) s_w1[warp] = inc1;
  __syncthreads();
  // the warps before this one and the whole tile: every warp scans the
  // warp totals, lane i warp i
  uint32_t wm = lane < FE_WARPS ? s_w1[lane] : 0u;
#pragma unroll
  for (int d = 1; d < FE_WARPS; d <<= 1) {
    const uint32_t o = __shfl_up_sync(FULL, wm, d);
    if (lane >= d) wm = MapOp::op(o, wm);
  }
  const uint32_t tile1 = __shfl_sync(FULL, wm, FE_WARPS - 1);
  uint32_t pre1 = __shfl_sync(FULL, wm, (warp + 31) & 31);
  if (warp == 0) pre1 = 0;
  if (warp == 0) {
    uint32_t e = 0;
    if (t > 0) {
      if (lane == 0) mst.publish(t, LB_AGG, tile1);
      e = look_back(mst, t, lane, sp_cap);
    }
    if (lane == 0) {
      mst.publish(t, LB_PREFIX, MapOp::op(e, tile1));
      s_e1 = e;
    }
  }
  __syncthreads();
  const int s0 = apply_map(static_cast<int>(MapOp::op(MapOp::op(s_e1, pre1), ex1)), st0);

  // 2. the classify, bit-parallel (classify.cuh:classify_byte), from the
  // state before each byte
  const uint32_t c_seq = s0 == ST_SEQ ? 1u : 0u, c_com = s0 == ST_COM ? 1u : 0u;
  const Bits in_seq = later(latch(m.eol, marker, c_seq), c_seq);
  const Bits in_com_st = later(latch(space & ~in_seq, reset, c_com), c_com);
  const Bits text = ~marker & ~in_seq;  // an ID or COMMENT byte
  const Bits sp = m.eol | m.sp_tab;
  const Bits in_id = text & ~in_com_st & ~sp;
  const Bits in_com = text & in_com_st & ~m.eol;
  const Bits id_unex = in_id & m.un_text, id_keep = in_id & ~m.un_text;
  const Bits com_unex = in_com & m.un_com;
  const Bits seq_keep = in_seq & ~marker & ~sp, seq_unex = seq_keep & m.un_seq;
  const Bits keep = seq_keep | id_unex;  // the stream
  const Bits lower = (m.low & ~id_unex & ~seq_unex) | when(tb.repl_name >= 96, id_unex) |
                     when(tb.repl_seq >= 96, seq_unex);
  const Bits chg_in = case_changes(keep, lower);  // after the thread's first kept byte
  const Bits spm_in = marker | in_com | id_keep;  // the other sparse entries
  const int kfirst = lowest(keep);
  const uint32_t has = kfirst < 128 ? 1u : 0u;
  const uint32_t first = has ? bit(lower, kfirst) : 0u;
  const uint32_t last = has ? bit(lower, highest(keep)) : 0u;

  // 3. the tile's counts: warp scans, then the warp totals
  P2 inc2{static_cast<uint32_t>(popc(keep) | popc(seq_keep) << 16),
          static_cast<uint32_t>(popc(spm_in) + popc(chg_in)) | has << 16 | first << 17 |
              last << 18};
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const P2 o = shfl_up(inc2, d);
    if (lane >= d) inc2 = P2{o.a + inc2.a, cases_op(o.c, inc2.c)};
  }
  P2 ex2 = shfl_up(inc2, 1);
  if (lane == 0) ex2 = P2{0u, 0u};
  uint32_t un0 = static_cast<uint32_t>(popc(id_unex) | popc(com_unex) << 16);
  uint32_t un1 = static_cast<uint32_t>(popc(seq_unex));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    un0 += __shfl_xor_sync(FULL, un0, d);
    un1 += __shfl_xor_sync(FULL, un1, d);
  }
  const Lines wl = warp_lines(thread_lines(seq_keep, m.eol), lane);
  if (lane == 31) s_w2[warp] = inc2;
  if (lane == 0) {
    s_un[warp][0] = un0;
    s_un[warp][1] = un1;
    s_ln[warp] = wl;
  }
  __syncthreads();
  Run wr = lane < FE_WARPS ? unpack(s_w2[lane]) : Run{0u, 0u, 0u, 0u};
#pragma unroll
  for (int d = 1; d < FE_WARPS; d <<= 1) {
    const Run o = shfl_up(wr, d);
    if (lane >= d) wr = run_op(o, wr);
  }
  const Run tot = shfl(wr, FE_WARPS - 1);
  Run pre2 = shfl(wr, (warp + 31) & 31);
  if (warp == 0) pre2 = Run{0u, 0u, 0u, 0u};
  const Run ex = run_op(pre2, unpack(ex2));
  const uint32_t has_before = ex.cs >> 16 & 1u;  // a kept byte before the thread, in the tile
  if (has && !has_before)
    s_fsval = bit(id_unex, kfirst) ? tb.repl_name
                                   : (bit(seq_unex, kfirst) ? tb.repl_seq : x[start + kfirst]);
  __syncthreads();

  // 4. the counts before the tile; the tile's record
  if (warp == 0) {
    const uint32_t n2[2] = {tot.stream, tot.seq};
    const FAgg own = own_agg(n2, tot.sp, tot.cs, sp_cap);
    FAgg e = CountStatus<2>::identity();
    if (t > 0) {
      if (lane == 0) cst.publish(t, LB_AGG, own);
      e = look_back(cst, t, lane, sp_cap);
    }
    if (lane == 0) {
      const TileBase<2> base = tile_base(e, own, tot.sp, tot.cs, sp_cap);
      cst.publish(t, LB_PREFIX, base.inc);
      s_base[0] = static_cast<int>(e.n[0]);
      s_base[1] = static_cast<int>(e.n[1]);
      s_base[2] = static_cast<int>(base.sp);
      s_base[3] = static_cast<int>(base.eh);
      s_base[4] = static_cast<int>(base.el);
      s_base[5] = static_cast<int>(base.bchg);
      Lines ln = s_ln[0];
#pragma unroll
      for (int i = 1; i < FE_WARPS; ++i) ln = combine(ln, s_ln[i]);
      uint32_t u[3] = {0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < FE_WARPS; ++i) {
        u[0] += s_un[i][0] & 0xFFFFu;
        u[1] += s_un[i][0] >> 16;
        u[2] += s_un[i][1];
      }
      FLayout::put_record(recs + static_cast<long long>(t) * FLayout::REC,
                          static_cast<int>(tot.seq), ln, u, base.nt, tot.cs, s_fsval);
      if (t == tiles - 1) {
        scal[0] = static_cast<int>(base.inc.n[0]);
        scal[1] = static_cast<int>(base.inc.n[1]);
        scal[FLayout::S_NSP] = static_cast<int>(base.inc.s);
      }
    }
  }
  __syncthreads();

  // 5. the sparse entries, in byte order from the thread's offset
  const uint32_t eh_t = has_before ? 1u : static_cast<uint32_t>(s_base[3]);
  const uint32_t el_t = has_before ? ex.cs >> 18 & 1u : static_cast<uint32_t>(s_base[4]);
  const Bits chg = has && eh_t && el_t != first ? with_bit(chg_in, kfirst) : chg_in;
  const Bits spm = spm_in | chg;
  int i_sp = static_cast<int>(ex.sp) + (has_before ? s_base[5] : 0);
  const long long sp0 = s_base[2];
  const int stream_g = s_base[0] + static_cast<int>(ex.stream);
  const int seq_g = s_base[1] + static_cast<int>(ex.seq);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t mm = spm.q[q];
    while (mm && i_sp < sp_cap) {
      const int j = __ffs(static_cast<int>(mm)) - 1;
      mm &= mm - 1;
      const int p = 32 * q + j;
      const long long o = sp0 + i_sp++;
      int tag, val = 0, a = 0;
      if (marker.q[q] >> j & 1u) {
        tag = TAG_REC;
        a = seq_g + below(seq_keep, p);
      } else if (chg.q[q] >> j & 1u) {
        tag = TAG_CHG;
        a = stream_g + below(keep, p);
      } else {
        tag = in_com.q[q] >> j & 1u ? TAG_COM : TAG_ID;
        val = (com_unex.q[q] >> j & 1u) ? repl_name : x[start + p];
      }
      sp_tv[o] = val | tag << 8;
      sp_a[o] = a;
    }
  }

  // 6. the kept bytes to the stage, at sv's alignment
  const int ts = static_cast<int>(tot.stream);
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(sv + s_base[0]) & 15);
  int os = sh + static_cast<int>(ex.stream);
  const uint32_t rn = tb.repl_name, rs = tb.repl_seq;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t ks = keep.q[q];
    if (ks) {
      uint32_t b32[8];
      load32(x, n, start + 32 * q, b32);
      const uint32_t un = id_unex.q[q], us = seq_unex.q[q];
      // one predicated store a kept byte, at its offset; no branch
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        uint32_t v = (b32[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        if ((un | us) >> j & 1u) v = un >> j & 1u ? rn : rs;
        if (ks >> j & 1u) stage[os + __popc(ks & ((1u << j) - 1u))] = static_cast<uint8_t>(v);
      }
    }
    os += __popc(ks);
  }
  __syncthreads();
  copy_out<THREADS>(stage, sv + s_base[0] - sh, sh, sh + ts);
}

__global__ void __launch_bounds__(FILL_THREADS) emit_fasta_fill_kernel(
    int* scal, const int* recs, int tiles, int sp_cap, uint8_t* sv, int* sp_tv, int* sp_a) {
  const long long sp_size = static_cast<long long>(tiles) * sp_cap;
  fill_zero(sv, scal[0], static_cast<long long>(tiles) * TILE);
  const long long n_sp = scal[FLayout::S_NSP];
  fill_zero(sp_tv, n_sp, sp_size);
  fill_zero(sp_a, n_sp, sp_size);
  if (blockIdx.x == 0) FLayout::block_scalars(scal, recs, tiles, sp_cap);
}

}  // namespace naf

// i32 words of the scratch that naf_emit_fasta takes for `tiles` tiles.
extern "C" int naf_emit_fasta_scratch(int tiles) {
  return naf::LB_HEAD + tiles * (naf::LB_STATUS + 1 + naf::FLayout::REC);
}

// The FASTA emit of x[0:n] (tiles = ceil(n / 65536) >= 1) from the byte
// before the block being a line end (pe0) and the parser state st0: sv
// u8[tiles * 65536] and sp_tv, sp_a i32[tiles * sp_cap] as emit_fasta_plain
// gives them, and scal i32[10] (cnt, cnt_seq, n_sp, sp_ok, unex_id,
// unex_com, unex_seq, longest, first_lower, first_sval).  scratch holds
// naf_emit_fasta_scratch(tiles) i32, zero on entry: the ticket, the tiles'
// statuses and records.
extern "C" int naf_emit_fasta(const uint8_t* x, long long n, int pe0, int st0, const uint8_t* cls,
                              int repl_seq, int repl_name, int sp_cap, int* scratch, int* scal,
                              uint8_t* sv, int* sp_tv, int* sp_a, int tiles, void* stream) {
  const int* recs = scratch + naf::LB_HEAD + static_cast<long long>(tiles) * (naf::LB_STATUS + 1);
  const cudaError_t e = cudaFuncSetAttribute(
      naf::emit_fasta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, naf::FE_STAGE);
  if (e != cudaSuccess) return static_cast<int>(e);
  NAF_LAUNCH(naf::emit_fasta_kernel, tiles, naf::THREADS, naf::FE_STAGE, stream, x, n, pe0, st0,
             cls, repl_seq, repl_name, sp_cap, scratch, scal, sv, sp_tv, sp_a);
  NAF_LAUNCH(naf::emit_fasta_fill_kernel,
             naf::fill_blocks(static_cast<long long>(tiles) * naf::TILE), naf::FILL_THREADS, 0,
             stream, scal, recs, tiles, sp_cap, sv, sp_tv, sp_a);
  return static_cast<int>(cudaGetLastError());
}
