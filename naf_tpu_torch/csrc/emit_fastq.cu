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
// so sp_ok means the same.
#include "classify_fastq.cuh"

namespace naf {

constexpr int QE_WARPS = Q_THREADS / 32;
constexpr int QE_STAGE = Q_TILE + 96;   // dense stage: three streams, each 16-byte aligned
constexpr int QE_HEAD = 16;             // i32 words before the status words (the ticket)
constexpr int QE_STATUS = 16;           // u32 words of a tile's count status
constexpr int QE_REC = 13;              // i32 columns of a tile's record
constexpr int QE_FILL_THREADS = 256;
constexpr int QE_FILL_BLOCKS = 1024;
constexpr unsigned QE_FULL = 0xFFFFFFFFu;
constexpr unsigned QE_AGG = 1, QE_PREFIX = 2;  // states of a status
constexpr int TAG_COM = 1, TAG_REC = 2, TAG_CHG = 3;

// ---------------------------------------------------------------------------
// 128-bit masks of a thread's bytes: bit k of the mask is byte k
// ---------------------------------------------------------------------------

struct Bits {
  uint32_t q[4];
};

__device__ __forceinline__ Bits operator&(Bits a, const Bits& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.q[i] &= b.q[i];
  return a;
}
__device__ __forceinline__ Bits operator|(Bits a, const Bits& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.q[i] |= b.q[i];
  return a;
}
__device__ __forceinline__ Bits operator^(Bits a, const Bits& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.q[i] ^= b.q[i];
  return a;
}
__device__ __forceinline__ Bits operator~(Bits a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.q[i] = ~a.q[i];
  return a;
}
__device__ __forceinline__ Bits when(bool c, const Bits& a) {
  Bits r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.q[i] = c ? a.q[i] : 0u;
  return r;
}
__device__ __forceinline__ int popc(const Bits& a) {
  return __popc(a.q[0]) + __popc(a.q[1]) + __popc(a.q[2]) + __popc(a.q[3]);
}
__device__ __forceinline__ bool any(const Bits& a) {
  return (a.q[0] | a.q[1] | a.q[2] | a.q[3]) != 0;
}
// Set bits below bit p, 0 <= p <= 128.
__device__ __forceinline__ int below(const Bits& a, int p) {
  int r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = p - 32 * i;
    r += __popc(a.q[i] & (s >= 32 ? QE_FULL : (s <= 0 ? 0u : (1u << s) - 1u)));
  }
  return r;
}
// Bit p, for a p known only at run time.
__device__ __forceinline__ uint32_t bit(const Bits& a, int p) {
  const uint32_t w = p < 64 ? (p < 32 ? a.q[0] : a.q[1]) : (p < 96 ? a.q[2] : a.q[3]);
  return (w >> (p & 31)) & 1u;
}
// Lowest and highest set bit (128 and -1 when none).
__device__ __forceinline__ int lowest(const Bits& a) {
  int r = 128;
#pragma unroll
  for (int i = 3; i >= 0; --i)
    if (a.q[i]) r = 32 * i + __ffs(static_cast<int>(a.q[i])) - 1;
  return r;
}
__device__ __forceinline__ int highest(const Bits& a) {
  int r = -1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (a.q[i]) r = 32 * i + 31 - __clz(static_cast<int>(a.q[i]));
  return r;
}
// Shifted one byte later, c entering at bit 0.
__device__ __forceinline__ Bits later(const Bits& a, uint32_t c) {
  Bits r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.q[i] = a.q[i] << 1 | (i ? a.q[i - 1] >> 31 : c);
  return r;
}
// Bit k: c xor the parity of a's bits below k.
__device__ __forceinline__ Bits parity_before(const Bits& a, uint32_t c) {
  Bits r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = a.q[i];
    x ^= x << 1;
    x ^= x << 2;
    x ^= x << 4;
    x ^= x << 8;
    x ^= x << 16;
    x ^= c ? QE_FULL : 0u;
    r.q[i] = x << 1 | c;
    c = x >> 31;
  }
  return r;
}
// Set/reset latch, s and r disjoint: bit k is set when the last set or
// reset bit at or before k is a set bit, or when neither came and c.
__device__ __forceinline__ Bits latch(const Bits& s, const Bits& r, uint32_t c) {
  Bits out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t p = ~r.q[i];
    uint32_t g = s.q[i] | (c & p & 1u);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      g |= (g << d) & p;
      p &= p << d;
    }
    out.q[i] = g;
    c = g >> 31;
  }
  return out;
}

// The high bits of the bytes of two words as 8 bits, x's bytes lowest: one
// multiply gathers both (no two partial products meet).
__device__ __forceinline__ uint32_t gather8(uint32_t x, uint32_t y) {
  return ((((x & 0x80808080u) >> 7 | (y & 0x80808080u) >> 3) * 0x00204081u) >> 21) & 0xFFu;
}

// The masks a thread's classify starts from.
struct RawMasks {
  Bits lf, eol, sp_tab, at, low, un_text, un_com, un_seq, un_qual;
};

__device__ __forceinline__ void build_masks(const uint32_t (&w)[WORDS], const QTables& t,
                                            RawMasks& m) {
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

// ---------------------------------------------------------------------------
// carries
// ---------------------------------------------------------------------------

// Line index mod 4 (bits 0-1) and composed header map (bits 2-4) of a run
// of bytes; the first look-back's value.
__device__ __forceinline__ uint32_t map_lf_op(uint32_t earlier, uint32_t later) {
  return ((earlier + later) & 3u) |
         static_cast<uint32_t>(compose(static_cast<int>(later >> 2),
                                       static_cast<int>(earlier >> 2))) << 2;
}

// What the counts look-back carries over a run of tiles: the stream,
// sequence, quality and id counts, and the sparse count capped per tile.
// A tile's capped count depends on whether its first kept stream byte
// changes case against the byte before the run, so the run's first tile
// that keeps a stream byte stays pending: f holds its raw count (bits
// 0-15) and the run's has (16), first (17) and last (18) kept case, and
// pending (19); s the rest of the run's capped count.
struct QAgg {
  uint32_t n[4];
  uint32_t s, f;
};

__device__ __forceinline__ QAgg agg_op(const QAgg& a, const QAgg& b, int cap) {
  QAgg r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.n[i] = a.n[i] + b.n[i];
  const uint32_t ah = a.f >> 16 & 1u, bh = b.f >> 16 & 1u;
  r.s = a.s + b.s;
  if (!bh) {
    r.f = a.f;
  } else if (!ah) {
    r.f = b.f;
  } else {
    if (b.f >> 19 & 1u) {
      const int raw = static_cast<int>(b.f & 0xFFFFu) + ((a.f >> 18 & 1u) != (b.f >> 17 & 1u));
      r.s += static_cast<uint32_t>(raw < cap ? raw : cap);
    }
    r.f = (a.f & 0xBFFFFu) | (b.f & (1u << 18));  // a's pending count and first case
  }
  return r;
}

// The capped sparse count of a run with nothing kept before it.
__device__ __forceinline__ uint32_t resolved(const QAgg& a, int cap) {
  const int raw = static_cast<int>(a.f & 0xFFFFu);
  return a.s + ((a.f >> 19 & 1u) ? static_cast<uint32_t>(raw < cap ? raw : cap) : 0u);
}

__device__ __forceinline__ QAgg shfl_down(const QAgg& v, int d) {
  QAgg r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.n[i] = __shfl_down_sync(QE_FULL, v.n[i], d);
  r.s = __shfl_down_sync(QE_FULL, v.s, d);
  r.f = __shfl_down_sync(QE_FULL, v.f, d);
  return r;
}

__device__ __forceinline__ uint32_t shfl_down(uint32_t v, int d) {
  return __shfl_down_sync(QE_FULL, v, d);
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

__device__ __forceinline__ void store_volatile(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

// Status of the first look-back: one word a tile, state in bits 30-31.
struct MapLfStatus {
  uint32_t* w;
  __device__ uint32_t peek(int j) const { return load_volatile(w + j); }
  __device__ static uint32_t state(uint32_t word) { return word >> 30; }
  __device__ uint32_t value(int, uint32_t word) const { return word & 0x1Fu; }
  __device__ void publish(int j, uint32_t st, uint32_t v) const {
    store_volatile(w + j, st << 30 | v);
  }
  __device__ static uint32_t op(uint32_t a, uint32_t b, int) { return map_lf_op(a, b); }
  __device__ static uint32_t identity() { return 0u; }
};

// Status of the counts look-back: QE_STATUS words a tile, the state word,
// the aggregate (1-6) and the inclusive prefix (7-12), each written before
// the state that names it, with a fence between.
struct CountStatus {
  uint32_t* w;
  __device__ uint32_t peek(int j) const { return load_volatile(w + j * QE_STATUS); }
  __device__ static uint32_t state(uint32_t word) { return word; }
  __device__ QAgg value(int j, uint32_t st) const {
    const uint32_t* p = w + j * QE_STATUS + (st == QE_PREFIX ? 7 : 1);
    QAgg r;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.n[i] = load_volatile(p + i);
    r.s = load_volatile(p + 4);
    r.f = load_volatile(p + 5);
    return r;
  }
  __device__ void publish(int j, uint32_t st, const QAgg& v) const {
    uint32_t* p = w + j * QE_STATUS + (st == QE_PREFIX ? 7 : 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) store_volatile(p + i, v.n[i]);
    store_volatile(p + 4, v.s);
    store_volatile(p + 5, v.f);
    __threadfence();
    store_volatile(w + j * QE_STATUS, st);
  }
  __device__ static QAgg op(const QAgg& a, const QAgg& b, int cap) { return agg_op(a, b, cap); }
  __device__ static QAgg identity() { return QAgg{{0u, 0u, 0u, 0u}, 0u, 0u}; }
};

// What the tiles before tile t > 0 carry, by the 32 lanes of one warp:
// each round reads the status of the 32 tiles below `top` (lane l tile
// top - l), waits until each has published, and combines them in tile
// order from the nearest back to the nearest inclusive prefix; with no
// prefix among them, it moves down.
template <typename S>
__device__ __forceinline__ auto look_back(const S& st, int t, int lane, int cap) {
  auto excl = S::identity();
  for (int top = t - 1;; top -= 32) {
    const int j = top - lane;
    uint32_t word = j >= 0 ? st.peek(j) : 0u;
    uint32_t state = j >= 0 ? S::state(word) : QE_PREFIX;
    while (__any_sync(QE_FULL, state == 0)) {
      if (state == 0) {
        word = st.peek(j);
        state = S::state(word);
      }
    }
    __threadfence();
    auto v = j >= 0 ? st.value(j, word) : S::identity();
    const unsigned pre = __ballot_sync(QE_FULL, state == QE_PREFIX);
    const int stop = pre ? __ffs(static_cast<int>(pre)) - 1 : 32;
    if (lane > stop) v = S::identity();
    // lane l + d holds earlier tiles than lane l
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const auto o = shfl_down(v, d);
      if (lane + d < 32) v = S::op(o, v, cap);
    }
    // lane 0 holds the round's run, and returns the carry
    excl = S::op(v, excl, cap);
    if (pre) break;
  }
  return excl;
}

// Packed counts of a run of bytes inside a tile, each field below 2^16:
// a stream | seq << 16, b quality | id << 16, c the sparse entries | has
// << 16 | first << 17 | last << 18 (the kept stream bytes' case runs; the
// change at the run's first kept byte is not in c).
struct Q3 {
  uint32_t a, b, c;
};

__device__ __forceinline__ Q3 q3_op(const Q3& x, const Q3& y) {
  const uint32_t hx = x.c >> 16 & 1u, hy = y.c >> 16 & 1u;
  const uint32_t sp = (x.c & 0xFFFFu) + (y.c & 0xFFFFu) +
                      (hx && hy && (x.c >> 18 & 1u) != (y.c >> 17 & 1u));
  const uint32_t first = hx ? x.c >> 17 & 1u : y.c >> 17 & 1u;
  const uint32_t last = hy ? y.c >> 18 & 1u : x.c >> 18 & 1u;
  return Q3{x.a + y.a, x.b + y.b, sp | (hx | hy) << 16 | first << 17 | last << 18};
}

__device__ __forceinline__ Q3 shfl_up(const Q3& v, int d) {
  return Q3{__shfl_up_sync(QE_FULL, v.a, d), __shfl_up_sync(QE_FULL, v.b, d),
            __shfl_up_sync(QE_FULL, v.c, d)};
}

__device__ __forceinline__ Lines shfl_down(const Lines& v, int d) {
  return Lines{__shfl_down_sync(QE_FULL, v.total, d), __shfl_down_sync(QE_FULL, v.has, d),
               __shfl_down_sync(QE_FULL, v.pre, d), __shfl_down_sync(QE_FULL, v.post, d),
               __shfl_down_sync(QE_FULL, v.mx, d)};
}

// Lines of a run of lanes' Lines, lane 0's the whole warp's (lane l + d
// holds later bytes than lane l).
__device__ __forceinline__ Lines warp_lines(Lines v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Lines o = shfl_down(v, d);
    if (lane + d < 32) v = combine(v, o);
  }
  return v;
}

// Line summary of the kept sequence bytes between LFs of a thread's bytes.
__device__ __forceinline__ Lines thread_lines(const Bits& seq, const Bits& lf) {
  Lines ln{popc(seq), 0, 0, 0, 0};
  int from = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t m = lf.q[i];
    while (m) {
      const int p = 32 * i + __ffs(static_cast<int>(m)) - 1;
      m &= m - 1;
      const int len = below(seq, p) - below(seq, from);
      if (!ln.has) {
        ln.has = 1;
        ln.pre = len;
      } else if (len > ln.mx) {
        ln.mx = len;
      }
      from = p + 1;
    }
  }
  ln.post = ln.total - below(seq, from);
  if (!ln.has) ln.pre = ln.total;
  return ln;
}

__device__ __forceinline__ Bits with_bit(Bits a, int p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.q[i] |= (p >> 5) == i ? 1u << (p & 31) : 0u;
  return a;
}

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// The 32 bytes x[start:start+32] again, through the read-only cache: the
// tile's bytes were loaded a few microseconds before, so these mostly hit
// L1 or L2 (bytes at and past n read as 0, and are never kept).
__device__ __forceinline__ void load32(const uint8_t* x, long long n, long long start,
                                       uint32_t (&r)[8]) {
  const uint8_t* p = x + start;
  if (start + 32 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) v |= byte_or(x, n, start + 4 * i + k, 0u) << (8 * k);
      r[i] = v;
    }
  }
}

// out[lo:end] = st[lo:end], out 16-byte aligned: 16-byte stores between
// element-wise ends.
__device__ __forceinline__ void copy_out(const uint8_t* st, uint8_t* out, int lo, int end) {
  for (int s = threadIdx.x; s * 16 < end; s += Q_THREADS) {
    const int e0 = s * 16;
    if (e0 >= lo && e0 + 16 <= end) {
      reinterpret_cast<uint4*>(out)[s] = reinterpret_cast<const uint4*>(st)[s];
    } else {
      for (int e = e0 > lo ? e0 : lo; e < e0 + 16 && e < end; ++e) out[e] = st[e];
    }
  }
}

// The tile record's columns: the tile's kept sequence bytes, its Lines
// (has, pre, post, mx), its unexpected id, comment, sequence and quality
// bytes, its sparse entries before the cap, whether it keeps a stream
// byte, the first one's case and value.
constexpr int R_SEQ = 0, R_LINES = 1, R_UNEX = 5, R_SP = 9, R_HAS = 10, R_LOWER = 11, R_SVAL = 12;
// scal: cnt, cnt_seq, cnt_qual, cnt_id, n_sp, sp_ok, unex_id, unex_com,
// unex_seq, unex_qual, longest, first_lower, first_sval
constexpr int S_NSP = 4, S_OK = 5, S_UNEX = 6, S_LONGEST = 10, S_FIRST = 11;

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
  uint32_t* status = reinterpret_cast<uint32_t*>(scratch + QE_HEAD);
  const CountStatus cst{status};
  const MapLfStatus mst{status + static_cast<long long>(tiles) * QE_STATUS};
  int* recs = scratch + QE_HEAD + static_cast<long long>(tiles) * (QE_STATUS + 1);
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
  RawMasks m;
  build_masks(w, tb, m);

  // 1. line index mod 4 and header map entering the thread
  uint32_t map = any(m.sp_tab) ? 1u : 0u;
  if (any(m.eol)) {
    const int e = highest(m.eol);
    map = popc(m.sp_tab) > below(m.sp_tab, e + 1) ? 3u : 2u;
  }
  uint32_t inc1 = (static_cast<uint32_t>(popc(m.lf)) & 3u) | map << 2;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(QE_FULL, inc1, d);
    if (lane >= d) inc1 = map_lf_op(o, inc1);
  }
  uint32_t ex1 = __shfl_up_sync(QE_FULL, inc1, 1);
  if (lane == 0) ex1 = 0;
  if (lane == 31) s_w1[warp] = inc1;
  __syncthreads();
  uint32_t pre1 = 0, tile1 = 0;
#pragma unroll
  for (int i = 0; i < QE_WARPS; ++i) {
    if (i < warp) pre1 = map_lf_op(pre1, s_w1[i]);
    tile1 = map_lf_op(tile1, s_w1[i]);
  }
  if (warp == 0) {
    uint32_t e = 0;
    if (t > 0) {
      if (lane == 0) mst.publish(t, QE_AGG, tile1);
      e = look_back(mst, t, lane, sp_cap);
    }
    if (lane == 0) {
      mst.publish(t, QE_PREFIX, map_lf_op(e, tile1));
      s_e1 = e;
    }
  }
  __syncthreads();
  const uint32_t in1 = map_lf_op(map_lf_op(s_e1, pre1), ex1);
  const uint32_t lane0 = in1 & 3u;
  const uint32_t com0 = apply_map(static_cast<int>(in1 >> 2), ST_ID) == ST_COM ? 1u : 0u;

  // 2. the classify, bit-parallel (classify_fastq.cuh:classify_fastq_byte)
  const Bits b0 = parity_before(m.lf, lane0 & 1u);
  const Bits b1 = parity_before(m.lf & b0, lane0 >> 1);
  const Bits l0 = ~(b0 | b1), l1 = b0 & ~b1, l3 = b0 & b1;
  const Bits pe = later(m.lf, pe_in);
  const Bits com = later(latch(m.sp_tab, m.eol, com0), com0);
  const Bits sp = m.eol | m.sp_tab;
  const Bits rec = m.at & pe & l0;
  const Bits hdr = l0 & ~rec & ~m.eol;
  const Bits id = hdr & ~com & ~sp;
  const Bits in_com = hdr & com;
  const Bits id_unex = id & m.un_text, id_keep = id & ~m.un_text;
  const Bits com_unex = in_com & m.un_com;
  const Bits seq_keep = l1 & ~sp, seq_unex = seq_keep & m.un_seq;
  const Bits qline = l3 & ~m.lf;
  const Bits qrest = qline & ~pe & ~sp;
  const Bits qual_unex = qrest & m.un_qual;
  const Bits qual_keep = qrest | (qline & pe);
  const Bits keep = seq_keep | id_unex;  // the stream
  const Bits lower = (m.low & ~id_unex & ~seq_unex) | when(tb.repl_name >= 96, id_unex) |
                     when(tb.repl_seq >= 96, seq_unex);
  const Bits kl = keep & lower;
  // case changes after the thread's first kept byte
  const Bits chg_in = keep & later(latch(keep, Bits{}, 0u), 0u) &
                      (lower ^ later(latch(kl, keep & ~kl, 0u), 0u));
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
    un0 += __shfl_xor_sync(QE_FULL, un0, d);
    un1 += __shfl_xor_sync(QE_FULL, un1, d);
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
    const uint32_t th = tot.c >> 16 & 1u, sp_int = tot.c & 0xFFFFu;
    QAgg own{{tot.a & 0xFFFFu, tot.a >> 16, tot.b & 0xFFFFu, tot.b >> 16}, 0u, 0u};
    if (th) {
      own.f = sp_int | (tot.c & (7u << 16)) | 1u << 19;
    } else {
      own.s = sp_int < static_cast<uint32_t>(sp_cap) ? sp_int : static_cast<uint32_t>(sp_cap);
    }
    QAgg e = CountStatus::identity();
    if (t > 0) {
      if (lane == 0) cst.publish(t, QE_AGG, own);
      e = look_back(cst, t, lane, sp_cap);
    }
    if (lane == 0) {
      const uint32_t base_sp = resolved(e, sp_cap);
      const uint32_t eh = e.f >> 16 & 1u, el = e.f >> 18 & 1u;
      const uint32_t bchg = eh && th && el != (tot.c >> 17 & 1u) ? 1u : 0u;
      const int nt = static_cast<int>(sp_int + bchg);
      QAgg inc;
#pragma unroll
      for (int i = 0; i < 4; ++i) inc.n[i] = e.n[i] + own.n[i];
      inc.s = base_sp + static_cast<uint32_t>(nt < sp_cap ? nt : sp_cap);
      inc.f = (eh | th) << 16 | (eh ? e.f >> 17 & 1u : tot.c >> 17 & 1u) << 17 |
              (th ? tot.c >> 18 & 1u : el) << 18;
      cst.publish(t, QE_PREFIX, inc);
#pragma unroll
      for (int i = 0; i < 4; ++i) s_base[i] = static_cast<int>(e.n[i]);
      s_base[4] = static_cast<int>(base_sp);
      s_base[5] = static_cast<int>(eh);
      s_base[6] = static_cast<int>(el);
      s_base[7] = static_cast<int>(bchg);
      Lines ln = s_ln[0];
#pragma unroll
      for (int i = 1; i < QE_WARPS; ++i) ln = combine(ln, s_ln[i]);
      uint32_t u0 = 0, u1 = 0;
#pragma unroll
      for (int i = 0; i < QE_WARPS; ++i) {
        u0 += s_un[i][0];
        u1 += s_un[i][1];
      }
      int* r = recs + static_cast<long long>(t) * QE_REC;
      r[R_SEQ] = static_cast<int>(own.n[1]);
      r[R_LINES] = ln.has;
      r[R_LINES + 1] = ln.pre;
      r[R_LINES + 2] = ln.post;
      r[R_LINES + 3] = ln.mx;
      r[R_UNEX] = static_cast<int>(u0 & 0xFFFFu);
      r[R_UNEX + 1] = static_cast<int>(u0 >> 16);
      r[R_UNEX + 2] = static_cast<int>(u1 & 0xFFFFu);
      r[R_UNEX + 3] = static_cast<int>(u1 >> 16);
      r[R_SP] = nt;
      r[R_HAS] = static_cast<int>(th);
      r[R_LOWER] = static_cast<int>(tot.c >> 17 & 1u);
      r[R_SVAL] = s_fsval;
      if (t == tiles - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) scal[i] = static_cast<int>(inc.n[i]);
        scal[S_NSP] = static_cast<int>(inc.s);
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
  copy_out(stage, sv + s_base[0] - sh_s, sh_s, sh_s + ts);
  copy_out(stage + r_q, qv + s_base[2] - sh_q, sh_q, sh_q + tq);
  copy_out(stage + r_i, iv + s_base[3] - sh_i, sh_i, sh_i + ti);
}

// out[c:n] = 0: 16-byte stores between an element-wise head and tail,
// grid-stride.
template <typename T>
__device__ __forceinline__ void fill_zero(T* out, long long c, long long n) {
  constexpr int V = 16 / sizeof(T);
  if (c >= n) return;
  const long long lead =
      (V - static_cast<long long>((reinterpret_cast<uintptr_t>(out + c) & 15) / sizeof(T))) % V;
  const long long a = c + lead < n ? c + lead : n;
  const long long slots = (n - a) / V;
  const long long tail = a + slots * V;
  uint4* q = reinterpret_cast<uint4*>(out + a);
  const uint4 zero = {0u, 0u, 0u, 0u};
  const long long stride = static_cast<long long>(gridDim.x) * QE_FILL_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * QE_FILL_THREADS + threadIdx.x;
       i < slots; i += stride)
    q[i] = zero;
  if (blockIdx.x == 0) {
    if (threadIdx.x < a - c) out[c + threadIdx.x] = T(0);
    if (threadIdx.x < n - tail) out[tail + threadIdx.x] = T(0);
  }
}

// The block scalars from the tile records, by one block: each thread folds
// a run of tiles in order, then the warps, then the eight warp results.
__device__ __forceinline__ void block_scalars(int* scal, const int* recs, int tiles, int cap) {
  __shared__ Lines s_ln[QE_WARPS];
  __shared__ int s_u[QE_WARPS][5];
  __shared__ int s_first[QE_WARPS][3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = static_cast<int>(static_cast<long long>(tiles) * tid / QE_FILL_THREADS);
  const int hi = static_cast<int>(static_cast<long long>(tiles) * (tid + 1) / QE_FILL_THREADS);
  Lines ln{0, 0, 0, 0, 0};
  int u[4] = {0, 0, 0, 0}, mx_sp = 0, f_has = 0, f_lower = 0, f_sval = 0;
  for (int j = lo; j < hi; ++j) {
    const int* r = recs + static_cast<long long>(j) * QE_REC;
    ln = combine(ln, Lines{r[R_SEQ], r[R_LINES], r[R_LINES + 1], r[R_LINES + 2],
                           r[R_LINES + 3]});
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] += r[R_UNEX + i];
    mx_sp = r[R_SP] > mx_sp ? r[R_SP] : mx_sp;
    if (!f_has && r[R_HAS]) {
      f_has = 1;
      f_lower = r[R_LOWER];
      f_sval = r[R_SVAL];
    }
  }
  ln = warp_lines(ln, lane);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] += __shfl_xor_sync(QE_FULL, u[i], d);
    const int o = __shfl_xor_sync(QE_FULL, mx_sp, d);
    mx_sp = o > mx_sp ? o : mx_sp;
  }
  const unsigned fb = __ballot_sync(QE_FULL, f_has);
  const int src = fb ? __ffs(static_cast<int>(fb)) - 1 : 0;
  f_lower = __shfl_sync(QE_FULL, f_lower, src);
  f_sval = __shfl_sync(QE_FULL, f_sval, src);
  if (lane == 0) {
    s_ln[warp] = ln;
#pragma unroll
    for (int i = 0; i < 4; ++i) s_u[warp][i] = u[i];
    s_u[warp][4] = mx_sp;
    s_first[warp][0] = fb != 0;
    s_first[warp][1] = f_lower;
    s_first[warp][2] = f_sval;
  }
  __syncthreads();
  if (tid == 0) {
    Lines all = s_ln[0];
    int su[4] = {0, 0, 0, 0}, smx = 0, fw = -1;
    for (int i = 0; i < QE_WARPS; ++i) {
      if (i) all = combine(all, s_ln[i]);
      for (int k = 0; k < 4; ++k) su[k] += s_u[i][k];
      smx = s_u[i][4] > smx ? s_u[i][4] : smx;
      if (fw < 0 && s_first[i][0]) fw = i;
    }
    scal[S_OK] = smx <= cap;
    for (int k = 0; k < 4; ++k) scal[S_UNEX + k] = su[k];
    int longest = all.mx > all.pre ? all.mx : all.pre;
    scal[S_LONGEST] = all.post > longest ? all.post : longest;
    scal[S_FIRST] = fw < 0 ? 0 : 1 + s_first[fw][1];
    scal[S_FIRST + 1] = fw < 0 ? 0 : s_first[fw][2];
  }
}

__global__ void __launch_bounds__(QE_FILL_THREADS) emit_fastq_fill_kernel(
    int* scal, const int* recs, int tiles, int sp_cap, uint8_t* sv, uint8_t* qv, uint8_t* iv,
    int* sp_tv, int* sp_a, int* sp_b, int* sp_c) {
  const long long size = static_cast<long long>(tiles) * Q_TILE;
  const long long sp_size = static_cast<long long>(tiles) * sp_cap;
  fill_zero(sv, scal[0], size);
  fill_zero(qv, scal[2], size);
  fill_zero(iv, scal[3], size);
  const long long n_sp = scal[S_NSP];
  fill_zero(sp_tv, n_sp, sp_size);
  fill_zero(sp_a, n_sp, sp_size);
  fill_zero(sp_b, n_sp, sp_size);
  fill_zero(sp_c, n_sp, sp_size);
  if (blockIdx.x == 0) block_scalars(scal, recs, tiles, sp_cap);
}

}  // namespace naf

// i32 words of the scratch that naf_emit_fastq takes for `tiles` tiles.
extern "C" int naf_emit_fastq_scratch(int tiles) {
  return naf::QE_HEAD + tiles * (naf::QE_STATUS + 1 + naf::QE_REC);
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
  const int* recs = scratch + naf::QE_HEAD + static_cast<long long>(tiles) * (naf::QE_STATUS + 1);
  const long long slots = static_cast<long long>(tiles) * naf::Q_TILE / 16;
  const long long want = (slots + 4LL * naf::QE_FILL_THREADS - 1) / (4LL * naf::QE_FILL_THREADS);
  const int fill_blocks = static_cast<int>(want < naf::QE_FILL_BLOCKS ? want : naf::QE_FILL_BLOCKS);
  NAF_LAUNCH(naf::emit_fastq_kernel, tiles, naf::Q_THREADS, naf::QE_STAGE, stream, x, n, pe0,
             cls, repl_seq, repl_name, repl_qual, sp_cap, scratch, scal, sv, qv, iv, sp_tv, sp_a,
             sp_b, sp_c);
  NAF_LAUNCH(naf::emit_fastq_fill_kernel, fill_blocks, naf::QE_FILL_THREADS, 0, stream, scal,
             recs, tiles, sp_cap, sv, qv, iv, sp_tv, sp_a, sp_b, sp_c);
  return static_cast<int>(cudaGetLastError());
}
