// Device pieces that the FASTA and FASTQ emits (emit_fasta.cu,
// emit_fastq.cu) share, the first two also with the FASTA classify
// (classify.cuh, classify.cu): 128-bit masks of a thread's bytes, the
// decoupled look-back (Merrill and Garland, 2016) with its status words and the
// pending-count aggregate of the per-tile sparse cap, warp-level line
// summaries, the copy of a staged tile to its output, and the fill launch's
// zero fill and fold of the tile records into the block scalars.
//
// Both emits run one pass over the block: a block takes its tile by atomic
// ticket, classifies each thread's 128 bytes once as bit masks, carries
// across tiles by two look-backs chained in the launch (a parser map in one
// status word a tile, published as soon as the masks are built; then the
// counts, published payload first, then a fence, then the state), and
// writes a record a tile.  A second launch zeroes the outputs past their
// counts and folds the records into the scalars.
#pragma once

#include "common.cuh"

namespace naf {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t LB_AGG = 1, LB_PREFIX = 2;  // states of a look-back status
constexpr int LB_HEAD = 16;    // i32 words of an emit's scratch before the statuses (the ticket)
constexpr int LB_STATUS = 16;  // u32 words of a tile's counts status
constexpr int FILL_THREADS = 256;
constexpr int FILL_BLOCKS = 1024;
constexpr int TAG_ID = 0, TAG_COM = 1, TAG_REC = 2, TAG_CHG = 3;

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
    r += __popc(a.q[i] & (s >= 32 ? FULL : (s <= 0 ? 0u : (1u << s) - 1u)));
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
__device__ __forceinline__ Bits with_bit(Bits a, int p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.q[i] |= (p >> 5) == i ? 1u << (p & 31) : 0u;
  return a;
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
    x ^= c ? FULL : 0u;
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
// Case changes among the kept bytes after the first kept one: a kept byte
// whose case differs from the kept byte before it.
__device__ __forceinline__ Bits case_changes(const Bits& keep, const Bits& lower) {
  const Bits kl = keep & lower;
  return keep & later(latch(keep, Bits{}, 0u), 0u) &
         (lower ^ later(latch(kl, keep & ~kl, 0u), 0u));
}

// The high bits of the bytes of two words as 8 bits, x's bytes lowest: one
// multiply gathers both (no two partial products meet).
__device__ __forceinline__ uint32_t gather8(uint32_t x, uint32_t y) {
  return ((((x & 0x80808080u) >> 7 | (y & 0x80808080u) >> 3) * 0x00204081u) >> 21) & 0xFFu;
}

// ---------------------------------------------------------------------------
// counts inside a tile
// ---------------------------------------------------------------------------

// Sparse entries (bits 0-15) and kept-byte case runs (has 16, first 17,
// last 18) of two runs of at most 65,535 bytes, x before y; the change at
// y's first kept byte is counted when x keeps a byte.
__device__ __forceinline__ uint32_t cases_op(uint32_t x, uint32_t y) {
  const uint32_t hx = x >> 16 & 1u, hy = y >> 16 & 1u;
  const uint32_t sp = (x & 0xFFFFu) + (y & 0xFFFFu) + (hx && hy && (x >> 18 & 1u) != (y >> 17 & 1u));
  const uint32_t first = hx ? x >> 17 & 1u : y >> 17 & 1u;
  const uint32_t last = hy ? y >> 18 & 1u : x >> 18 & 1u;
  return sp | (hx | hy) << 16 | first << 17 | last << 18;
}

__device__ __forceinline__ Lines shfl_down(const Lines& v, int d) {
  return Lines{__shfl_down_sync(FULL, v.total, d), __shfl_down_sync(FULL, v.has, d),
               __shfl_down_sync(FULL, v.pre, d), __shfl_down_sync(FULL, v.post, d),
               __shfl_down_sync(FULL, v.mx, d)};
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

// Line summary of the kept sequence bytes between line ends (set bits of
// eol) of a thread's bytes.
__device__ __forceinline__ Lines thread_lines(const Bits& seq, const Bits& eol) {
  Lines ln{popc(seq), 0, 0, 0, 0};
  int from = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t m = eol.q[i];
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

// ---------------------------------------------------------------------------
// the look-back
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

__device__ __forceinline__ void store_volatile(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

__device__ __forceinline__ uint32_t shfl_down(uint32_t v, int d) {
  return __shfl_down_sync(FULL, v, d);
}

// Status of a look-back whose value fits 30 bits: one word a tile, state in
// bits 30-31; Op::op(earlier, later) combines two values.
template <typename Op>
struct WordStatus {
  uint32_t* w;
  __device__ uint32_t peek(int j) const { return load_volatile(w + j); }
  __device__ static uint32_t state(uint32_t word) { return word >> 30; }
  __device__ uint32_t value(int, uint32_t word) const { return word & 0x3FFFFFFFu; }
  __device__ void publish(int j, uint32_t st, uint32_t v) const {
    store_volatile(w + j, st << 30 | v);
  }
  __device__ static uint32_t op(uint32_t a, uint32_t b, int) { return Op::op(a, b); }
  __device__ static uint32_t identity() { return 0u; }
};

// What the counts look-back carries over a run of tiles: N counts, and the
// sparse count capped per tile.  A tile's capped count depends on whether
// its first kept stream byte changes case against the byte before the run,
// so the run's first tile that keeps a stream byte stays pending: f holds
// its raw count (bits 0-16: a 64 KiB tile can have 65,536 entries) and the
// run's has (17), first (18) and last (19) kept case, and pending (20); s
// the rest of the run's capped count.
constexpr uint32_t AGG_RAW = (1u << 17) - 1u;
constexpr int AGG_HAS = 17, AGG_FIRST = 18, AGG_LAST = 19, AGG_PENDING = 20;

template <int N>
struct CaseAgg {
  uint32_t n[N];
  uint32_t s, f;
};

__device__ __forceinline__ uint32_t capped(uint32_t raw, int cap) {
  return raw < static_cast<uint32_t>(cap) ? raw : static_cast<uint32_t>(cap);
}

template <int N>
__device__ __forceinline__ CaseAgg<N> agg_op(const CaseAgg<N>& a, const CaseAgg<N>& b, int cap) {
  CaseAgg<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.n[i] = a.n[i] + b.n[i];
  const uint32_t ah = a.f >> AGG_HAS & 1u, bh = b.f >> AGG_HAS & 1u;
  r.s = a.s + b.s;
  if (!bh) {
    r.f = a.f;
  } else if (!ah) {
    r.f = b.f;
  } else {
    if (b.f >> AGG_PENDING & 1u)
      r.s += capped((b.f & AGG_RAW) + ((a.f >> AGG_LAST & 1u) != (b.f >> AGG_FIRST & 1u)), cap);
    // a's pending count and first case, b's last case
    r.f = (a.f & ~(1u << AGG_LAST)) | (b.f & (1u << AGG_LAST));
  }
  return r;
}

// The capped sparse count of a run with nothing kept before it.
template <int N>
__device__ __forceinline__ uint32_t resolved(const CaseAgg<N>& a, int cap) {
  return a.s + ((a.f >> AGG_PENDING & 1u) ? capped(a.f & AGG_RAW, cap) : 0u);
}

template <int N>
__device__ __forceinline__ CaseAgg<N> shfl_down(const CaseAgg<N>& v, int d) {
  CaseAgg<N> r;
#pragma unroll
  for (int i = 0; i < N; ++i) r.n[i] = __shfl_down_sync(FULL, v.n[i], d);
  r.s = __shfl_down_sync(FULL, v.s, d);
  r.f = __shfl_down_sync(FULL, v.f, d);
  return r;
}

// Status of the counts look-back: LB_STATUS words a tile, the state word,
// the aggregate (from word 1) and the inclusive prefix (from word 1 + N +
// 2), each written before the state that names it, with a fence between.
template <int N>
struct CountStatus {
  static_assert(1 + 2 * (N + 2) <= LB_STATUS, "a tile's status outgrows its words");
  uint32_t* w;
  __device__ uint32_t peek(int j) const { return load_volatile(w + j * LB_STATUS); }
  __device__ static uint32_t state(uint32_t word) { return word; }
  __device__ CaseAgg<N> value(int j, uint32_t st) const {
    const uint32_t* p = w + j * LB_STATUS + (st == LB_PREFIX ? N + 3 : 1);
    CaseAgg<N> r;
#pragma unroll
    for (int i = 0; i < N; ++i) r.n[i] = load_volatile(p + i);
    r.s = load_volatile(p + N);
    r.f = load_volatile(p + N + 1);
    return r;
  }
  __device__ void publish(int j, uint32_t st, const CaseAgg<N>& v) const {
    uint32_t* p = w + j * LB_STATUS + (st == LB_PREFIX ? N + 3 : 1);
#pragma unroll
    for (int i = 0; i < N; ++i) store_volatile(p + i, v.n[i]);
    store_volatile(p + N, v.s);
    store_volatile(p + N + 1, v.f);
    __threadfence();
    store_volatile(w + j * LB_STATUS, st);
  }
  __device__ static CaseAgg<N> op(const CaseAgg<N>& a, const CaseAgg<N>& b, int cap) {
    return agg_op(a, b, cap);
  }
  __device__ static CaseAgg<N> identity() { return CaseAgg<N>{}; }
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
    uint32_t state = j >= 0 ? S::state(word) : LB_PREFIX;
    while (__any_sync(FULL, state == 0)) {
      if (state == 0) {
        word = st.peek(j);
        state = S::state(word);
      }
    }
    __threadfence();
    auto v = j >= 0 ? st.value(j, word) : S::identity();
    const unsigned pre = __ballot_sync(FULL, state == LB_PREFIX);
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

// What a tile learns from the counts carried before it (e), given its own
// counts n, its sparse entries sp (without a change at its first kept
// byte) and its case runs cs (has, first, last in bits 16-18, as
// cases_op): its sparse offset, the case of the last kept byte before it
// (eh, el), whether its first kept byte is a change (bchg), its raw sparse
// count nt, and the inclusive prefix it publishes.
template <int N>
struct TileBase {
  uint32_t sp, eh, el, bchg;
  int nt;
  CaseAgg<N> inc;
};

template <int N>
__device__ __forceinline__ CaseAgg<N> own_agg(const uint32_t (&n)[N], uint32_t sp, uint32_t cs,
                                             int cap) {
  CaseAgg<N> own;
#pragma unroll
  for (int i = 0; i < N; ++i) own.n[i] = n[i];
  if (cs >> 16 & 1u) {
    own.s = 0u;
    own.f = sp | (cs >> 16 & 7u) << AGG_HAS | 1u << AGG_PENDING;
  } else {
    own.s = capped(sp, cap);
    own.f = 0u;
  }
  return own;
}

template <int N>
__device__ __forceinline__ TileBase<N> tile_base(const CaseAgg<N>& e, const CaseAgg<N>& own,
                                                uint32_t sp, uint32_t cs, int cap) {
  TileBase<N> b;
  const uint32_t th = cs >> 16 & 1u, tf = cs >> 17 & 1u, tl = cs >> 18 & 1u;
  b.sp = resolved(e, cap);
  b.eh = e.f >> AGG_HAS & 1u;
  b.el = e.f >> AGG_LAST & 1u;
  b.bchg = b.eh && th && b.el != tf ? 1u : 0u;
  b.nt = static_cast<int>(sp + b.bchg);
#pragma unroll
  for (int i = 0; i < N; ++i) b.inc.n[i] = e.n[i] + own.n[i];
  b.inc.s = b.sp + capped(static_cast<uint32_t>(b.nt), cap);
  b.inc.f = (b.eh | th) << AGG_HAS | (b.eh ? e.f >> AGG_FIRST & 1u : tf) << AGG_FIRST |
            (th ? tl : b.el) << AGG_LAST;
  return b;
}

// ---------------------------------------------------------------------------
// staging and the fill launch
// ---------------------------------------------------------------------------

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

// out[lo:end] = st[lo:end], out 16-byte aligned, by a block of NT
// threads: 16-byte stores between element-wise ends.
template <int NT>
__device__ __forceinline__ void copy_out(const uint8_t* st, uint8_t* out, int lo, int end) {
  for (int s = threadIdx.x; s * 16 < end; s += NT) {
    const int e0 = s * 16;
    if (e0 >= lo && e0 + 16 <= end) {
      reinterpret_cast<uint4*>(out)[s] = reinterpret_cast<const uint4*>(st)[s];
    } else {
      for (int e = e0 > lo ? e0 : lo; e < e0 + 16 && e < end; ++e) out[e] = st[e];
    }
  }
}

// out[c:n] = 0: 16-byte stores between an element-wise head and tail,
// grid-stride over the fill launch.
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
  const long long stride = static_cast<long long>(gridDim.x) * FILL_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * FILL_THREADS + threadIdx.x;
       i < slots; i += stride)
    q[i] = zero;
  if (blockIdx.x == 0) {
    if (threadIdx.x < a - c) out[c + threadIdx.x] = T(0);
    if (threadIdx.x < n - tail) out[tail + threadIdx.x] = T(0);
  }
}

// Blocks of the fill launch over `bytes` bytes of output.
inline int fill_blocks(long long bytes) {
  const long long want = (bytes / 16 + 4LL * FILL_THREADS - 1) / (4LL * FILL_THREADS);
  return static_cast<int>(want < FILL_BLOCKS ? want : FILL_BLOCKS);
}

// The layout of an emit's tile records and scalars, for N dense counts and
// U unexpected-byte counts.  A record: the tile's kept sequence bytes, its
// Lines (has, pre, post, mx), its U unexpected counts, its raw sparse count,
// whether it keeps a stream byte, the first one's case and value.  The
// scalars: the N counts, n_sp, sp_ok, the U unexpected counts, longest,
// first_lower, first_sval.
template <int N, int U>
struct EmitLayout {
  static constexpr int R_SEQ = 0, R_LINES = 1, R_UNEX = 5, R_SP = 5 + U, R_HAS = 6 + U,
                       R_LOWER = 7 + U, R_SVAL = 8 + U, REC = 9 + U;
  static constexpr int S_NSP = N, S_OK = N + 1, S_UNEX = N + 2, S_LONGEST = N + 2 + U,
                       S_FIRST = N + 3 + U, SCALARS = N + 5 + U;

  __device__ static void put_record(int* r, int seq, const Lines& ln, const uint32_t (&u)[U],
                                    int nt, uint32_t cs, int sval) {
    r[R_SEQ] = seq;
    r[R_LINES] = ln.has;
    r[R_LINES + 1] = ln.pre;
    r[R_LINES + 2] = ln.post;
    r[R_LINES + 3] = ln.mx;
#pragma unroll
    for (int i = 0; i < U; ++i) r[R_UNEX + i] = static_cast<int>(u[i]);
    r[R_SP] = nt;
    r[R_HAS] = static_cast<int>(cs >> 16 & 1u);
    r[R_LOWER] = static_cast<int>(cs >> 17 & 1u);
    r[R_SVAL] = sval;
  }

  // The block scalars from the tile records, by one block of FILL_THREADS:
  // each thread folds a run of tiles in order, then the warps, then the
  // warp results.
  __device__ static void block_scalars(int* scal, const int* recs, int tiles, int cap) {
    constexpr int W = FILL_THREADS / 32;
    __shared__ Lines s_ln[W];
    __shared__ int s_u[W][U + 1];
    __shared__ int s_first[W][3];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lo = static_cast<int>(static_cast<long long>(tiles) * tid / FILL_THREADS);
    const int hi = static_cast<int>(static_cast<long long>(tiles) * (tid + 1) / FILL_THREADS);
    Lines ln{0, 0, 0, 0, 0};
    int u[U] = {}, mx_sp = 0, f_has = 0, f_lower = 0, f_sval = 0;
    for (int j = lo; j < hi; ++j) {
      const int* r = recs + static_cast<long long>(j) * REC;
      ln = combine(ln, Lines{r[R_SEQ], r[R_LINES], r[R_LINES + 1], r[R_LINES + 2],
                             r[R_LINES + 3]});
#pragma unroll
      for (int i = 0; i < U; ++i) u[i] += r[R_UNEX + i];
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
      for (int i = 0; i < U; ++i) u[i] += __shfl_xor_sync(FULL, u[i], d);
      const int o = __shfl_xor_sync(FULL, mx_sp, d);
      mx_sp = o > mx_sp ? o : mx_sp;
    }
    const unsigned fb = __ballot_sync(FULL, f_has);
    const int src = fb ? __ffs(static_cast<int>(fb)) - 1 : 0;
    f_lower = __shfl_sync(FULL, f_lower, src);
    f_sval = __shfl_sync(FULL, f_sval, src);
    if (lane == 0) {
      s_ln[warp] = ln;
#pragma unroll
      for (int i = 0; i < U; ++i) s_u[warp][i] = u[i];
      s_u[warp][U] = mx_sp;
      s_first[warp][0] = fb != 0;
      s_first[warp][1] = f_lower;
      s_first[warp][2] = f_sval;
    }
    __syncthreads();
    if (tid == 0) {
      Lines all = s_ln[0];
      int su[U] = {}, smx = 0, fw = -1;
      for (int i = 0; i < W; ++i) {
        if (i) all = combine(all, s_ln[i]);
        for (int k = 0; k < U; ++k) su[k] += s_u[i][k];
        smx = s_u[i][U] > smx ? s_u[i][U] : smx;
        if (fw < 0 && s_first[i][0]) fw = i;
      }
      scal[S_OK] = smx <= cap;
      for (int k = 0; k < U; ++k) scal[S_UNEX + k] = su[k];
      int longest = all.mx > all.pre ? all.mx : all.pre;
      scal[S_LONGEST] = all.post > longest ? all.post : longest;
      scal[S_FIRST] = fw < 0 ? 0 : 1 + s_first[fw][1];
      scal[S_FIRST + 1] = fw < 0 ? 0 : s_first[fw][2];
    }
  }
};

}  // namespace naf
