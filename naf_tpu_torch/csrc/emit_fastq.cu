// Fused FASTQ emit: classify, four prefix coordinates, three dense
// compactions (stream, quality, id) and the tagged sparse channel of one
// block, with the block's scalars.
//
// Replaces naf_tpu/ops/emit_fused.py:_make_emit_fastq_kernel (emit_fastq_tiles,
// merged by emit_fastq_fused).  The TPU kernel carries nine running values
// across its in-order grid (stream, seq, quality and id prefix counts, the
// EOL base, the longest line, the case encoding, the first kept byte's case
// and value) and compacts with a butterfly plus a one-hot MXU matmul.  A
// CUDA grid has no order.
//
// Bound: memory.  The function reads the block once and writes each dense
// stream up to its count, the used sparse entries and the zero fill the
// contract asks for (sv, qv, iv past their counts, the sparse arrays past
// n_sp): 0.0964 ms for the kept bytes of phase 2's FASTQ block on an H100,
// 0.2372 ms with every output at its full size.
//
// Two launches:
//
// - emit_fastq_kernel, one pass over the block.  A block takes its 32 KiB
//   tile by atomic ticket; each of its 256 threads loads its 128 bytes
//   (eight 16-byte loads) and classifies them once, bit-parallel: 128-bit
//   masks from SWAR compares (__vcmpeq4) and one class-table lookup a
//   byte, two words' flags gathered by one multiply (the four
//   unexpected-byte masks only where the thread has such a byte).  Lanes
//   come from the LF mask by prefix parities (line index bit 0, then bit 1
//   from the LFs at odd indices); the header's ID/COMMENT split and the
//   kept bytes' case runs from set/reset latches (log-step fills); counts
//   from __popc; line lengths from a walk over the set LF bits (about one
//   an 80-byte line).  The quality line's first byte is kept whatever it
//   is.  The tile's carries come from two decoupled look-backs (Merrill and
//   Garland, 2016) chained in the one launch: first the line index mod 4
//   and the composed header map, one 32-bit status word a tile, published
//   as soon as the tile's masks are built; then the four counts, the
//   capped sparse offset and the case of the last kept byte, published
//   payload first, then a fence, then the flag.  A tile's own capped sparse
//   count depends on the case before it (a change at its first kept byte),
//   so its aggregate keeps that count pending, resolved by whoever combines
//   it with what comes before.  Inside the tile the scans are
//   __shfl_up_sync warp scans over packed 16-bit fields and one pass over
//   eight warp totals.  The kept bytes go to a 32 KiB shared stage at their
//   scanned offsets, each stream at its output's alignment (one predicated
//   store a byte at a popcount offset: no branch, no running cursor), and
//   leave with 16-byte stores.  The staging reads the thread's 32-byte runs
//   that keep a byte again through the read-only cache, so that the loaded
//   words are not live across the look-backs (with them live, 24 bytes
//   spilled).  The tile writes a record for the block scalars; the last
//   tile writes the counts.
// - emit_fastq_fill_kernel zeroes sv, qv, iv and the four sparse arrays
//   past their counts, read from device memory (no host sync), with
//   16-byte stores; its block 0 also folds the tile records into the
//   scalars (longest line, first kept case and value, unexpected counts,
//   sp_ok).
//
// Against the three-pass design it replaces: (1) six serial byte walks of
// each 128-byte chunk become one mask build; (2) the four 256-wide
// Hillis-Steele block scans (two __syncthreads a round) become warp
// shuffles; (3) byte staging at a running cursor becomes stores at
// popcount offsets; (4) each output element is written once, the zero fill
// in its own launch at 16 bytes a thread; (5) no walk state lives across
// bytes and nothing spills; (6) no torch op runs between the launches (the
// wrapper only zeroes the scratch).  On an H100 the pass is bound by the
// per-tile instruction chain at two blocks an SM (128 registers): a third
// block an SM (80 registers, 96 bytes spilled) or one (241 registers) is
// slower, and the look-backs cost no measurable time.  The sparse channel
// keeps the TPU kernel's 32 KiB tiles and cap of sp_cap entries a tile,
// so sp_ok means the same.  The FASTQ masks, the lane-and-header value
// and the classes live in classify_fastq.cuh, shared with the standalone
// FASTQ classify; the mask operations, the look-backs, the staging copy
// and the fill launch's helpers in emit_common.cuh, shared with the FASTA
// emit.  Section 1 keeps its own scan of the warp totals: with the
// classify's entry_value (classify.cuh) in its place the pass ran as fast
// but at 127 registers, not 128.
#include "classify_fastq.cuh"
#include "emit_common.cuh"

namespace naf {

constexpr int QE_WARPS = Q_THREADS / 32;
constexpr int QE_STAGE = Q_TILE + 96;   // dense stage: three streams, each 16-byte aligned
using QAgg = CaseAgg<4>;                 // stream, seq, quality and id counts
using QLayout = EmitLayout<4, 4>;        // unexpected id, comment, sequence and quality bytes

// ---------------------------------------------------------------------------
// carries
// ---------------------------------------------------------------------------

// Packed counts of a run of bytes inside a tile, each field below 2^16:
// a stream | seq << 16, b quality | id << 16, c the sparse entries | has
// << 16 | first << 17 | last << 18 (the kept stream bytes' case runs; the
// change at the run's first kept byte is not in c).
struct Q3 {
  uint32_t a, b, c;
};

__device__ __forceinline__ Q3 q3_op(const Q3& x, const Q3& y) {
  return Q3{x.a + y.a, x.b + y.b, cases_op(x.c, y.c)};
}

__device__ __forceinline__ Q3 shfl_up(const Q3& v, int d) {
  return Q3{__shfl_up_sync(FULL, v.a, d), __shfl_up_sync(FULL, v.b, d),
            __shfl_up_sync(FULL, v.c, d)};
}

__global__ void __launch_bounds__(Q_THREADS) emit_fastq_kernel(
    const uint8_t* x, long long n, int pe0, const uint8_t* cls, int repl_seq, int repl_name,
    int repl_qual, int sp_cap, int* scratch, int* scal, uint8_t* sv, uint8_t* qv, uint8_t* iv,
    int* sp_tv, int* sp_a, int* sp_b, int* sp_c) {
  __shared__ QTables tb;
  __shared__ int s_tile, s_fsval;
  __shared__ uint32_t s_w1[QE_WARPS], s_e1;
  __shared__ Q3 s_w2[QE_WARPS];
  __shared__ uint32_t s_un[QE_WARPS][2];
  __shared__ Lines s_ln[QE_WARPS];
  // the tile's stream, seq, quality, id and sparse offsets; the case
  // before it (has, last); a change at its first kept byte
  __shared__ int s_base[8];
  NAF_EXTERN_SHARED(uint8_t, stage);  // QE_STAGE bytes: the kept sv, qv and iv bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = static_cast<int>(gridDim.x);
  uint32_t* status = reinterpret_cast<uint32_t*>(scratch + LB_HEAD);
  const CountStatus<4> cst{status};
  const WordStatus<LaneMapOp> mst{status + static_cast<long long>(tiles) * LB_STATUS};
  int* recs = scratch + LB_HEAD + static_cast<long long>(tiles) * (LB_STATUS + 1);
  if (tid == 0) {
    s_tile = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u));
    s_fsval = 0;
  }
  load_tables(&tb, cls, repl_seq, repl_name, repl_qual);
  const int t = s_tile;
  const long long start =
      static_cast<long long>(t) * Q_TILE + static_cast<long long>(tid) * PER_THREAD;
  uint32_t w[WORDS];
  load_chunk(x, n, start, w, PAD);
  const uint32_t pe_in =
      start == 0 ? (pe0 != 0) : (byte_or(x, n, start - 1, PAD) == 0x0Au ? 1u : 0u);
  FastqMasks m;
  build_masks(w, tb, m);

  // 1. line index mod 4 and header map entering the thread
  uint32_t inc1 = lane_map(m);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(FULL, inc1, d);
    if (lane >= d) inc1 = LaneMapOp::op(o, inc1);
  }
  uint32_t ex1 = __shfl_up_sync(FULL, inc1, 1);
  if (lane == 0) ex1 = 0;
  if (lane == 31) s_w1[warp] = inc1;
  __syncthreads();
  uint32_t pre1 = 0, tile1 = 0;
#pragma unroll
  for (int i = 0; i < QE_WARPS; ++i) {
    if (i < warp) pre1 = LaneMapOp::op(pre1, s_w1[i]);
    tile1 = LaneMapOp::op(tile1, s_w1[i]);
  }
  if (warp == 0) {
    uint32_t e = 0;
    if (t > 0) {
      if (lane == 0) mst.publish(t, LB_AGG, tile1);
      e = look_back(mst, t, lane, sp_cap);
    }
    if (lane == 0) {
      mst.publish(t, LB_PREFIX, LaneMapOp::op(e, tile1));
      s_e1 = e;
    }
  }
  __syncthreads();
  const uint32_t in1 = LaneMapOp::op(LaneMapOp::op(s_e1, pre1), ex1);

  // 2. the classify, bit-parallel (classify_fastq.cuh)
  const FastqClasses cl = fastq_classes(m, pe_in, in1);
  const Bits rec = cl.rec, in_com = cl.in_com, id_unex = cl.id_unex, id_keep = cl.id_keep;
  const Bits com_unex = cl.com_unex, seq_keep = cl.seq_keep, seq_unex = cl.seq_unex;
  const Bits qual_keep = cl.qual_keep, qual_unex = cl.qual_unex;
  const Bits keep = seq_keep | id_unex;  // the stream
  const Bits lower = (m.low & ~id_unex & ~seq_unex) | when(tb.repl_name >= 96, id_unex) |
                     when(tb.repl_seq >= 96, seq_unex);
  // case changes after the thread's first kept byte
  const Bits chg_in = case_changes(keep, lower);
  const int kfirst = lowest(keep);
  const uint32_t has = kfirst < 128 ? 1u : 0u;
  const uint32_t first = has ? bit(lower, kfirst) : 0u;
  const uint32_t last = has ? bit(lower, highest(keep)) : 0u;

  // 3. the tile's counts: warp scans, then the warp totals
  const Q3 mine{static_cast<uint32_t>(popc(keep) | popc(seq_keep) << 16),
                static_cast<uint32_t>(popc(qual_keep) | popc(id_keep) << 16),
                static_cast<uint32_t>(popc(in_com | rec) + popc(chg_in)) | has << 16 |
                    first << 17 | last << 18};
  Q3 inc2 = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Q3 o = shfl_up(inc2, d);
    if (lane >= d) inc2 = q3_op(o, inc2);
  }
  Q3 ex2 = shfl_up(inc2, 1);
  if (lane == 0) ex2 = Q3{0u, 0u, 0u};
  uint32_t un0 = static_cast<uint32_t>(popc(id_unex) | popc(com_unex) << 16);
  uint32_t un1 = static_cast<uint32_t>(popc(seq_unex) | popc(qual_unex) << 16);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    un0 += __shfl_xor_sync(FULL, un0, d);
    un1 += __shfl_xor_sync(FULL, un1, d);
  }
  const Lines wl = warp_lines(thread_lines(seq_keep, m.lf), lane);
  if (lane == 31) s_w2[warp] = inc2;
  if (lane == 0) {
    s_un[warp][0] = un0;
    s_un[warp][1] = un1;
    s_ln[warp] = wl;
  }
  __syncthreads();
  Q3 tot{0u, 0u, 0u}, pre2{0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < QE_WARPS; ++i) {
    if (i < warp) pre2 = q3_op(pre2, s_w2[i]);
    tot = q3_op(tot, s_w2[i]);
  }
  ex2 = q3_op(pre2, ex2);
  const uint32_t has_before = ex2.c >> 16 & 1u;  // a kept byte before the thread, in the tile
  if (has && !has_before)
    s_fsval = bit(id_unex, kfirst) ? tb.repl_name
                                   : (bit(seq_unex, kfirst) ? tb.repl_seq : x[start + kfirst]);
  __syncthreads();

  // 4. the counts before the tile; the tile's record
  if (warp == 0) {
    const uint32_t sp_int = tot.c & 0xFFFFu;
    const uint32_t n4[4] = {tot.a & 0xFFFFu, tot.a >> 16, tot.b & 0xFFFFu, tot.b >> 16};
    const QAgg own = own_agg(n4, sp_int, tot.c, sp_cap);
    QAgg e = CountStatus<4>::identity();
    if (t > 0) {
      if (lane == 0) cst.publish(t, LB_AGG, own);
      e = look_back(cst, t, lane, sp_cap);
    }
    if (lane == 0) {
      const TileBase<4> tbase = tile_base(e, own, sp_int, tot.c, sp_cap);
      cst.publish(t, LB_PREFIX, tbase.inc);
#pragma unroll
      for (int i = 0; i < 4; ++i) s_base[i] = static_cast<int>(e.n[i]);
      s_base[4] = static_cast<int>(tbase.sp);
      s_base[5] = static_cast<int>(tbase.eh);
      s_base[6] = static_cast<int>(tbase.el);
      s_base[7] = static_cast<int>(tbase.bchg);
      Lines ln = s_ln[0];
#pragma unroll
      for (int i = 1; i < QE_WARPS; ++i) ln = combine(ln, s_ln[i]);
      uint32_t u0 = 0, u1 = 0;
#pragma unroll
      for (int i = 0; i < QE_WARPS; ++i) {
        u0 += s_un[i][0];
        u1 += s_un[i][1];
      }
      const uint32_t u[4] = {u0 & 0xFFFFu, u0 >> 16, u1 & 0xFFFFu, u1 >> 16};
      QLayout::put_record(recs + static_cast<long long>(t) * QLayout::REC,
                          static_cast<int>(own.n[1]), ln, u, tbase.nt, tot.c, s_fsval);
      if (t == tiles - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) scal[i] = static_cast<int>(tbase.inc.n[i]);
        scal[QLayout::S_NSP] = static_cast<int>(tbase.inc.s);
      }
    }
  }
  __syncthreads();

  // 5. the sparse entries, in byte order from the thread's offset
  const uint32_t eh_t = has_before ? 1u : static_cast<uint32_t>(s_base[5]);
  const uint32_t el_t = has_before ? ex2.c >> 18 & 1u : static_cast<uint32_t>(s_base[6]);
  const Bits chg = has && eh_t && el_t != first ? with_bit(chg_in, kfirst) : chg_in;
  const Bits spm = in_com | rec | chg;
  int i_sp = static_cast<int>(ex2.c & 0xFFFFu) + (has_before ? s_base[7] : 0);
  const long long sp0 = s_base[4];
  const int stream_g = s_base[0] + static_cast<int>(ex2.a & 0xFFFFu);
  const int seq_g = s_base[1] + static_cast<int>(ex2.a >> 16);
  const int qual_g = s_base[2] + static_cast<int>(ex2.b & 0xFFFFu);
  const int id_g = s_base[3] + static_cast<int>(ex2.b >> 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t mm = spm.q[q];
    while (mm && i_sp < sp_cap) {
      const int j = __ffs(static_cast<int>(mm)) - 1;
      mm &= mm - 1;
      const int p = 32 * q + j;
      const long long o = sp0 + i_sp++;
      int tag = TAG_COM, val = 0, a = 0, b = 0, c = 0;
      if (rec.q[q] >> j & 1u) {
        tag = TAG_REC;
        a = seq_g + below(seq_keep, p);
        b = qual_g + below(qual_keep, p);
        c = id_g + below(id_keep, p);
      } else if (chg.q[q] >> j & 1u) {
        tag = TAG_CHG;
        a = stream_g + below(keep, p);
      } else {
        val = (com_unex.q[q] >> j & 1u) ? repl_name : x[start + p];
      }
      sp_tv[o] = val | tag << 8;
      sp_a[o] = a;
      sp_b[o] = b;
      sp_c[o] = c;
    }
  }

  // 6. the kept bytes to the stage, each stream at its output's alignment
  const int ts = static_cast<int>(tot.a & 0xFFFFu), tq = static_cast<int>(tot.b & 0xFFFFu),
            ti = static_cast<int>(tot.b >> 16);
  const int sh_s = static_cast<int>(reinterpret_cast<uintptr_t>(sv + s_base[0]) & 15);
  const int sh_q = static_cast<int>(reinterpret_cast<uintptr_t>(qv + s_base[2]) & 15);
  const int sh_i = static_cast<int>(reinterpret_cast<uintptr_t>(iv + s_base[3]) & 15);
  const int r_q = round16(sh_s + ts), r_i = r_q + round16(sh_q + tq);
  int os = sh_s + static_cast<int>(ex2.a & 0xFFFFu);
  int oq = r_q + sh_q + static_cast<int>(ex2.b & 0xFFFFu);
  int oi = r_i + sh_i + static_cast<int>(ex2.b >> 16);
  const uint32_t rn = tb.repl_name, rs = tb.repl_seq, rq = tb.repl_qual;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t ks = keep.q[q], kq = qual_keep.q[q], ki = id_keep.q[q], kk = ks | kq | ki;
    if (kk) {
      uint32_t b32[8];
      load32(x, n, start + 32 * q, b32);
      const uint32_t un = id_unex.q[q], us = seq_unex.q[q], uq = qual_unex.q[q];
      const uint32_t ur = un | us | uq;
      // one predicated store a kept byte, at its stream's offset; no branch
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t lm = (1u << j) - 1u;
        uint32_t v = (b32[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        if (ur >> j & 1u) v = un >> j & 1u ? rn : (us >> j & 1u ? rs : rq);
        const int d = ks >> j & 1u ? os + __popc(ks & lm)
                                   : (kq >> j & 1u ? oq + __popc(kq & lm) : oi + __popc(ki & lm));
        if (kk >> j & 1u) stage[d] = static_cast<uint8_t>(v);
      }
    }
    os += __popc(ks);
    oq += __popc(kq);
    oi += __popc(ki);
  }
  __syncthreads();
  copy_out<Q_THREADS>(stage, sv + s_base[0] - sh_s, sh_s, sh_s + ts);
  copy_out<Q_THREADS>(stage + r_q, qv + s_base[2] - sh_q, sh_q, sh_q + tq);
  copy_out<Q_THREADS>(stage + r_i, iv + s_base[3] - sh_i, sh_i, sh_i + ti);
}

__global__ void __launch_bounds__(FILL_THREADS) emit_fastq_fill_kernel(
    int* scal, const int* recs, int tiles, int sp_cap, uint8_t* sv, uint8_t* qv, uint8_t* iv,
    int* sp_tv, int* sp_a, int* sp_b, int* sp_c) {
  const long long size = static_cast<long long>(tiles) * Q_TILE;
  const long long sp_size = static_cast<long long>(tiles) * sp_cap;
  fill_zero(sv, scal[0], size);
  fill_zero(qv, scal[2], size);
  fill_zero(iv, scal[3], size);
  const long long n_sp = scal[QLayout::S_NSP];
  fill_zero(sp_tv, n_sp, sp_size);
  fill_zero(sp_a, n_sp, sp_size);
  fill_zero(sp_b, n_sp, sp_size);
  fill_zero(sp_c, n_sp, sp_size);
  if (blockIdx.x == 0) QLayout::block_scalars(scal, recs, tiles, sp_cap);
}

}  // namespace naf

// i32 words of the scratch that naf_emit_fastq takes for `tiles` tiles.
extern "C" int naf_emit_fastq_scratch(int tiles) {
  return naf::LB_HEAD + tiles * (naf::LB_STATUS + 1 + naf::QLayout::REC);
}

// The FASTQ emit of x[0:n] (tiles = ceil(n / 32768) >= 1): sv, qv, iv
// u8[tiles * 32768] and sp_* i32[tiles * sp_cap] as emit_fastq_plain gives
// them, and scal i32[13] (cnt, cnt_seq, cnt_qual, cnt_id, n_sp, sp_ok,
// unex_id, unex_com, unex_seq, unex_qual, longest, first_lower,
// first_sval).  scratch holds naf_emit_fastq_scratch(tiles) i32, zero on
// entry: the ticket, the tiles' statuses and records.
extern "C" int naf_emit_fastq(const uint8_t* x, long long n, int pe0, const uint8_t* cls,
                              int repl_seq, int repl_name, int repl_qual, int sp_cap,
                              int* scratch, int* scal, uint8_t* sv, uint8_t* qv, uint8_t* iv,
                              int* sp_tv, int* sp_a, int* sp_b, int* sp_c, int tiles,
                              void* stream) {
  const int* recs = scratch + naf::LB_HEAD + static_cast<long long>(tiles) * (naf::LB_STATUS + 1);
  NAF_LAUNCH(naf::emit_fastq_kernel, tiles, naf::Q_THREADS, naf::QE_STAGE, stream, x, n, pe0,
             cls, repl_seq, repl_name, repl_qual, sp_cap, scratch, scal, sv, qv, iv, sp_tv, sp_a,
             sp_b, sp_c);
  NAF_LAUNCH(naf::emit_fastq_fill_kernel,
             naf::fill_blocks(static_cast<long long>(tiles) * naf::Q_TILE), naf::FILL_THREADS, 0,
             stream, scal, recs, tiles, sp_cap, sv, qv, iv, sp_tv, sp_a, sp_b, sp_c);
  return static_cast<int>(cudaGetLastError());
}
