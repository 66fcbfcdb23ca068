// naf_tpu_torch's copy of naf_tpu/native/naf_zstd.cpp, the candidate
// serializers of the device match-finder engine (naf_zstd_compress_cand_k,
// _cand, _cand_stream) included; everything is unchanged but two comments
// that named a checkout path.  native/host.py builds it with naf_native.cpp
// into the port's one host library.
//
// naf_zstd — a from-scratch zstd *encoder* emitting RFC 8878 frames.
//
// This is the native entropy stack of SURVEY.md §7 step 6: the framework's
// own compressor for the hot SEQ/QUAL sections, independent of libzstd.
// Any spec-conformant zstd decoder (including the reference unnaf's
// vendored libzstd) decodes its output, so archives written with this
// engine remain fully reference-compatible.
//
// Design: greedy hash-table LZ77 match finding (the data-parallel half —
// the same per-position hashing/scoring the Pallas device kernel computes),
// then the inherently-serial bitstream packing: 128 KB blocks, Huffman
// literals (canonical 11-bit code, direct or FSE-compressed weights, 1 or
// 4 backward streams), sequences coded with the spec's PREDEFINED FSE
// distributions (RFC 8878 §3.1.1.3.2.2).  Incompressible blocks fall back
// to raw blocks, literal-only blocks cover pure-entropy data.
//
// The implementation follows the procedures *as specified in RFC 8878*
// (FSE state machine, interleaved backward bitstream, code/baseline
// tables); it shares no code with libzstd.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>

extern "C" {

// ---------------------------------------------------------------------------
// predefined distributions (RFC 8878 §3.1.1.3.2.2)
// ---------------------------------------------------------------------------

static const int16_t LL_NORM[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
    -1, -1, -1, -1};
static const int16_t ML_NORM[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    -1, -1, -1, -1, -1};
static const int16_t OF_NORM[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

static const int LL_LOG = 6, ML_LOG = 6, OF_LOG = 5;

// literal-length codes >= 16: baselines and extra bits (RFC table)
static const uint32_t LL_BASE[20] = {
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[20] = {
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// match-length codes >= 32 (match length value >= 35)
static const uint32_t ML_BASE[21] = {
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
    2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[21] = {
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

static inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// FSE encoder tables (FSE_buildCTable equivalent, built from the normalized
// counts above; procedure per the FSE/zstd specification)
// ---------------------------------------------------------------------------

static const int FSE_MAX_LOG = 9;     // dynamic tables up to 512 states

struct FseEnc {
  uint16_t next_state[1 << FSE_MAX_LOG];
  int32_t delta_nb_bits[64];        // per symbol (alphabets <= 53)
  int32_t delta_find_state[64];
  int table_log;
};

static void fse_build(const int16_t *norm, int n_sym, int table_log,
                      FseEnc *e) {
  const int table_size = 1 << table_log;
  const int mask = table_size - 1;
  const int step = (table_size >> 1) + (table_size >> 3) + 3;

  uint8_t table_symbol[1 << FSE_MAX_LOG];
  int high_threshold = table_size - 1;
  int cumul[64 + 2];
  cumul[0] = 0;
  for (int s = 0; s < n_sym; s++) {
    if (norm[s] == -1) {
      cumul[s + 1] = cumul[s] + 1;
      table_symbol[high_threshold--] = (uint8_t)s;
    } else {
      cumul[s + 1] = cumul[s] + norm[s];
    }
  }
  int position = 0;
  for (int s = 0; s < n_sym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      table_symbol[position] = (uint8_t)s;
      position = (position + step) & mask;
      while (position > high_threshold) position = (position + step) & mask;
    }
  }
  int cumul_tmp[64 + 2];
  std::memcpy(cumul_tmp, cumul, sizeof(cumul));
  for (int u = 0; u < table_size; u++) {
    uint8_t s = table_symbol[u];
    e->next_state[cumul_tmp[s]++] = (uint16_t)(table_size + u);
  }
  int total = 0;
  for (int s = 0; s < n_sym; s++) {
    if (norm[s] == 0) {
      e->delta_nb_bits[s] = ((table_log + 1) << 16) - (1 << table_log);
      e->delta_find_state[s] = 0;
    } else if (norm[s] == -1 || norm[s] == 1) {
      e->delta_nb_bits[s] = (table_log << 16) - (1 << table_log);
      e->delta_find_state[s] = total - 1;
      total += 1;
    } else {
      int max_bits_out = table_log - highbit32((uint32_t)(norm[s] - 1));
      int min_state_plus = norm[s] << max_bits_out;
      e->delta_nb_bits[s] = (max_bits_out << 16) - min_state_plus;
      e->delta_find_state[s] = total - norm[s];
      total += norm[s];
    }
  }
  e->table_log = table_log;
}

static FseEnc g_ll, g_ml, g_of;
static bool g_fse_ready = false;

static void fse_init_all() {
  if (g_fse_ready) return;
  fse_build(LL_NORM, 36, LL_LOG, &g_ll);
  fse_build(ML_NORM, 53, ML_LOG, &g_ml);
  fse_build(OF_NORM, 29, OF_LOG, &g_of);
  g_fse_ready = true;
}

// ---------------------------------------------------------------------------
// bit writer (LSB-first accumulate; decoder reads back-to-front)
// ---------------------------------------------------------------------------

struct BitW {
  uint8_t *out;
  uint64_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  inline void add(uint32_t val, int bits) {
    // word-at-a-time flush: one unaligned 8-byte store per add instead of
    // a byte loop (bit layout identical; every caller's buffer carries
    // >= 8 bytes of headroom past its bound checks).  The invariant
    // nbits <= 7 on entry keeps acc within 64 bits for bits <= 32.
    acc |= (uint64_t)(val & ((bits < 32 ? (1u << bits) : 0u) - 1)) << nbits;
    nbits += bits;
    std::memcpy(out + pos, &acc, 8);
    int fl = nbits >> 3;
    pos += fl;
    acc >>= fl * 8;
    nbits &= 7;
  }
  inline void add64(uint64_t val, int bits) {
    // up to 51 payload bits per accumulate (nbits <= 7 on entry keeps the
    // top within 64): one acc chain step per symbol QUAD instead of pair
    acc |= (val & (((uint64_t)1 << bits) - 1)) << nbits;
    nbits += bits;
    std::memcpy(out + pos, &acc, 8);
    int fl = nbits >> 3;
    pos += fl;
    acc >>= fl * 8;
    nbits &= 7;
  }
  inline uint64_t close() {
    add(1, 1);                       // end-of-stream marker bit
    if (nbits) { out[pos++] = (uint8_t)acc; acc = 0; nbits = 0; }
    return pos;
  }
};

struct FseState {
  uint32_t value;
  const FseEnc *t;
  inline void init(int symbol) {
    int nb = (t->delta_nb_bits[symbol] + (1 << 15)) >> 16;
    value = (uint32_t)((nb << 16) - t->delta_nb_bits[symbol]);
    value = t->next_state[(value >> nb) + t->delta_find_state[symbol]];
  }
  inline void encode(BitW &bw, int symbol) {
    uint32_t nb = (value + (uint32_t)t->delta_nb_bits[symbol]) >> 16;
    bw.add(value, (int)nb);
    value = t->next_state[(value >> nb) + t->delta_find_state[symbol]];
  }
  inline void flush(BitW &bw) { bw.add(value, t->table_log); }
};

// ---------------------------------------------------------------------------
// Huffman literals (RFC 8878 §4.2): canonical code limited to 11 bits,
// weights emitted directly (4-bit) or FSE-compressed (two interleaved
// states), 1 or 4 backward bitstreams.
// ---------------------------------------------------------------------------

static const int HUF_MAX_BITS = 11;

struct HufCode { uint16_t val; uint8_t nbits; };

// build code lengths <= HUF_MAX_BITS; returns max symbol used + 1, or 0 if
// not applicable (fewer than 2 distinct symbols)
static int huf_build(uint32_t *count, HufCode *codes, int *max_bits_out) {
  int alphabet = 0;
  int distinct = 0;
  for (int s = 0; s < 256; s++) {
    if (count[s]) { alphabet = s + 1; distinct++; }
  }
  if (distinct < 2) return 0;

  uint32_t cnt[256];
  uint8_t depth[256];
  {
    // two-queue Huffman over (count, node) pairs
    struct Node { uint64_t w; int l, r, sym; };
    Node nodes[512];
    int leaf_idx[256], n_leaves = 0;
    for (int s = 0; s < alphabet; s++)
      cnt[s] = count[s];
    for (int s = 0; s < alphabet; s++)
      if (cnt[s]) {
        nodes[n_leaves] = {cnt[s], -1, -1, s};
        leaf_idx[n_leaves] = n_leaves;
        n_leaves++;
      }
    // sort leaves by weight (insertion sort fine for 256)
    for (int i = 1; i < n_leaves; i++) {
      Node t = nodes[i];
      int j = i - 1;
      while (j >= 0 && nodes[j].w > t.w) { nodes[j + 1] = nodes[j]; j--; }
      nodes[j + 1] = t;
    }
    (void)leaf_idx;
    int n_nodes = n_leaves;
    int q1 = 0;            // next unconsumed leaf
    int q2 = n_leaves;     // internal nodes appended [q2, n_nodes)
    int q2h = n_leaves;
    auto take = [&]() -> int {
      bool leaf_ok = q1 < n_leaves;
      bool int_ok = q2h < n_nodes;
      if (leaf_ok && (!int_ok || nodes[q1].w <= nodes[q2h].w)) return q1++;
      return q2h++;
    };
    (void)q2;
    while ((n_leaves - q1) + (n_nodes - q2h) > 1) {
      int a = take(), b = take();
      nodes[n_nodes] = {nodes[a].w + nodes[b].w, a, b, -1};
      n_nodes++;
    }
    // depths via DFS from root
    int root = n_nodes - 1;
    struct { int node, d; } stack[512];
    int sp = 0;
    stack[sp++] = {root, 0};
    int maxd = 0;
    while (sp) {
      auto fr = stack[--sp];
      const Node &nd = nodes[fr.node];
      if (nd.sym >= 0) {
        depth[nd.sym] = (uint8_t)(fr.d ? fr.d : 1);
        if (fr.d > maxd) maxd = fr.d;
      } else {
        stack[sp++] = {nd.l, fr.d + 1};
        stack[sp++] = {nd.r, fr.d + 1};
      }
    }
    (void)maxd;
  }

  // limit to HUF_MAX_BITS: clamp, then repair the Kraft sum exactly
  {
    const int target = 1 << HUF_MAX_BITS;
    int64_t kraft = 0;
    for (int s = 0; s < alphabet; s++)
      if (count[s]) {
        if (depth[s] > HUF_MAX_BITS) depth[s] = HUF_MAX_BITS;
        kraft += 1 << (HUF_MAX_BITS - depth[s]);
      }
    while (kraft > target) {
      int64_t need = kraft - target;
      int best = -1;
      for (int s = 0; s < alphabet; s++) {
        if (!count[s] || depth[s] >= HUF_MAX_BITS) continue;
        int64_t red = 1 << (HUF_MAX_BITS - depth[s] - 1);
        if (red <= need && (best < 0 || count[s] < count[best])) best = s;
      }
      if (best < 0) {
        for (int s = 0; s < alphabet; s++) {
          if (!count[s] || depth[s] >= HUF_MAX_BITS) continue;
          if (best < 0 || depth[s] > depth[best]) best = s;
        }
        if (best < 0) return 0;   // cannot happen with >= 2 symbols
      }
      kraft -= 1 << (HUF_MAX_BITS - depth[best] - 1);
      depth[best]++;
    }
    while (kraft < target) {
      int best = -1;
      for (int s = 0; s < alphabet; s++) {
        if (!count[s] || depth[s] <= 1) continue;
        int64_t gain = 1 << (HUF_MAX_BITS - depth[s]);
        if (kraft + gain <= target &&
            (best < 0 || count[s] > count[best])) best = s;
      }
      if (best < 0) return 0;     // depth-11 symbols guarantee granularity 1
      kraft += 1 << (HUF_MAX_BITS - depth[best]);
      depth[best]--;
    }
  }

  int maxb = 0;
  for (int s = 0; s < alphabet; s++)
    if (count[s] && depth[s] > maxb) maxb = depth[s];
  // canonical value assignment (smallest values to longest codes, symbol
  // order within a length class)
  uint16_t nb_per_rank[16] = {0}, val_per_rank[16] = {0};
  for (int s = 0; s < alphabet; s++)
    if (count[s]) nb_per_rank[depth[s]]++;
  uint16_t min = 0;
  for (int b = maxb; b > 0; b--) {
    val_per_rank[b] = min;
    min = (uint16_t)((min + nb_per_rank[b]) >> 1);
  }
  for (int s = 0; s < alphabet; s++) {
    if (count[s]) {
      codes[s].nbits = depth[s];
      codes[s].val = val_per_rank[depth[s]]++;
    } else {
      codes[s].nbits = 0;
      codes[s].val = 0;
    }
  }
  *max_bits_out = maxb;
  return alphabet;
}

// FSE normalization of the weight histogram (max table log 6)
static int fse_normalize(const uint32_t *count, int n_sym, int total,
                         int table_log, int16_t *norm) {
  int table_size = 1 << table_log;
  int distributed = 0;
  int largest = 0;
  for (int s = 0; s < n_sym; s++) {
    if (count[s] == 0) { norm[s] = 0; continue; }
    int64_t p = ((int64_t)count[s] * table_size) / total;
    if (p == 0) p = (int64_t)count[s] * table_size * 2 >= total ? 1 : -1;
    norm[s] = (int16_t)p;
    distributed += p > 0 ? (int)p : 1;
    if (norm[s] > norm[largest]) largest = s;
  }
  int delta = table_size - distributed;
  // adjust on the most probable symbol
  if (norm[largest] + delta < 1) return -1;
  norm[largest] = (int16_t)(norm[largest] + delta);
  // a 100% symbol is not representable as an FSE stream (all state
  // transitions would read 0 bits); callers must use RLE/direct forms
  if (norm[largest] >= table_size) return -1;
  return 0;
}

// FSE_writeNCount equivalent: table description, forward LSB-first stream
static int fse_write_ncount(const int16_t *norm, int n_sym, int table_log,
                            uint8_t *dst, int cap) {
  uint64_t bit_stream = (uint64_t)(table_log - 5);
  int bit_count = 4;
  int w = 0;
  int remaining = (1 << table_log) + 1;
  int threshold = 1 << table_log;
  int nb_bits = table_log + 1;
  bool previous_is0 = false;
  int s = 0;
  while (remaining > 1 && s < n_sym) {
    if (previous_is0) {
      int start = s;
      while (s < n_sym && norm[s] == 0) s++;
      if (s == n_sym) return -1;
      while (s >= start + 24) {
        start += 24;
        bit_stream |= 0xFFFFull << bit_count;
        bit_count += 16;
        while (bit_count > 16) {
          if (w + 2 > cap) return -1;
          dst[w++] = (uint8_t)bit_stream;
          dst[w++] = (uint8_t)(bit_stream >> 8);
          bit_stream >>= 16; bit_count -= 16;
        }
      }
      while (s >= start + 3) {
        start += 3;
        bit_stream |= 3ull << bit_count;
        bit_count += 2;
      }
      bit_stream |= (uint64_t)(s - start) << bit_count;
      bit_count += 2;
    }
    int count = norm[s++];
    int max = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count++;                       // +1 encoding
    if (count >= threshold) count += max;
    bit_stream |= (uint64_t)count << bit_count;
    bit_count += nb_bits;
    bit_count -= (count < max);
    previous_is0 = (count == 1);
    if (remaining < 1) return -1;
    while (remaining < threshold) { nb_bits--; threshold >>= 1; }
    while (bit_count > 16) {
      if (w + 2 > cap) return -1;
      dst[w++] = (uint8_t)bit_stream;
      dst[w++] = (uint8_t)(bit_stream >> 8);
      bit_stream >>= 16; bit_count -= 16;
    }
  }
  if (remaining != 1) return -1;
  while (bit_count > 0) {
    if (w + 1 > cap) return -1;
    dst[w++] = (uint8_t)bit_stream;
    bit_stream >>= 8; bit_count -= 8;
  }
  return w;
}

// FSE-compress the weight bytes with two interleaved states
static int fse_compress_weights(const uint8_t *w8, int n, uint8_t *dst,
                                int cap) {
  uint32_t count[16] = {0};
  int max_sym = 0;
  for (int i = 0; i < n; i++) {
    count[w8[i]]++;
    if (w8[i] > max_sym) max_sym = w8[i];
  }
  if (n < 4) return -1;
  int table_log = 6;
  while ((1 << (table_log - 1)) > n) table_log--;   // don't over-size
  if (table_log < 5) table_log = 5;   // header stores accuracy_log - 5
  int16_t norm[16];
  if (fse_normalize(count, max_sym + 1, n, table_log, norm) != 0) return -1;
  int hdr = fse_write_ncount(norm, max_sym + 1, table_log, dst, cap);
  if (hdr < 0) return -1;
  FseEnc enc;
  fse_build(norm, max_sym + 1, table_log, &enc);
  if (hdr + n + 16 > cap) return -1;    // worst case ~1 byte per weight
  BitW bw{dst + hdr};
  FseState s1{0, &enc}, s2{0, &enc};
  int ip = n;
  if (n & 1) {
    s1.init(w8[--ip]);
    s2.init(w8[--ip]);
    s1.encode(bw, w8[--ip]);
  } else {
    s2.init(w8[--ip]);
    s1.init(w8[--ip]);
  }
  while (ip > 0) {
    s2.encode(bw, w8[--ip]);
    s1.encode(bw, w8[--ip]);
  }
  s2.flush(bw);
  s1.flush(bw);
  uint64_t bits = bw.close();
  // the tree-description header byte encodes this size and must be < 128
  if (hdr + (int)bits >= 128) return -1;
  return hdr + (int)bits;
}

// encode one Huffman stream (backward bitstream) of src into dst
static uint64_t huf_stream(const uint8_t *src, uint32_t n,
                           const HufCode *codes, uint8_t *dst) {
  BitW bw{dst};
  int i = (int)n - 1;
  for (; i >= 3; i -= 4) {   // quad symbols: one accumulate per 4 codes
    const HufCode &c1 = codes[src[i]];
    const HufCode &c2 = codes[src[i - 1]];
    const HufCode &c3 = codes[src[i - 2]];
    const HufCode &c4 = codes[src[i - 3]];
    int n1 = c1.nbits, n12 = n1 + c2.nbits, n123 = n12 + c3.nbits;
    uint64_t v = (uint64_t)c1.val | ((uint64_t)c2.val << n1)
                 | ((uint64_t)c3.val << n12) | ((uint64_t)c4.val << n123);
    bw.add64(v, n123 + c4.nbits);
  }
  for (; i >= 1; i -= 2) {   // pair tail
    const HufCode &c1 = codes[src[i]];
    const HufCode &c2 = codes[src[i - 1]];
    bw.add((uint32_t)c1.val | ((uint32_t)c2.val << c1.nbits),
           c1.nbits + c2.nbits);
  }
  if (i == 0) {
    const HufCode &c = codes[src[0]];
    bw.add(c.val, c.nbits);
  }
  return bw.close();
}

// NAF_ZSTD_DEC_STATS=1 also times the encoder's stages (shared dump)
static thread_local uint64_t g_enc_ns_hist = 0, g_enc_ns_huf = 0;
bool nz_stats_on();                      // fwd (defined with the dec stats)
uint64_t nz_now_ns();

// write a full Compressed_Literals_Block; returns bytes or 0 if raw is better
static uint64_t write_huf_literals(const uint8_t *lits, uint32_t n,
                                   uint8_t *dst, uint64_t cap) {
  if (n < 64) return 0;
  uint64_t t0 = nz_stats_on() ? nz_now_ns() : 0;
  // 4-way split histogram over 8-byte loads: a single count[] serializes
  // on same-counter increments (store->load forwarding) on skewed data
  uint32_t c4[4][256] = {{0}};
  {
    uint32_t i = 0;
    for (; i + 8 <= n; i += 8) {
      uint64_t v;
      std::memcpy(&v, lits + i, 8);
      c4[0][(uint8_t)v]++;
      c4[1][(uint8_t)(v >> 8)]++;
      c4[2][(uint8_t)(v >> 16)]++;
      c4[3][(uint8_t)(v >> 24)]++;
      c4[0][(uint8_t)(v >> 32)]++;
      c4[1][(uint8_t)(v >> 40)]++;
      c4[2][(uint8_t)(v >> 48)]++;
      c4[3][(uint8_t)(v >> 56)]++;
    }
    for (; i < n; i++) c4[0][lits[i]]++;
  }
  uint32_t count[256];
  for (int s = 0; s < 256; s++)
    count[s] = c4[0][s] + c4[1][s] + c4[2][s] + c4[3][s];
  if (t0) {
    g_enc_ns_hist += nz_now_ns() - t0;
    t0 = nz_now_ns();
  }
  HufCode codes[256];
  int max_bits;
  int alphabet = huf_build(count, codes, &max_bits);
  if (alphabet == 0) return 0;

  // weights: symbols 0 .. alphabet-2 explicit, last implicit
  uint8_t weights[256];
  for (int s = 0; s < alphabet - 1; s++)
    weights[s] = codes[s].nbits ? (uint8_t)(max_bits + 1 - codes[s].nbits) : 0;
  int n_weights = alphabet - 1;

  uint8_t tree[600];
  int tree_n;
  int fse_n = fse_compress_weights(weights, n_weights, tree + 1, 560);
  int direct_n = 1 + (n_weights + 1) / 2;
  if (fse_n > 0 && fse_n < 128 &&
      (n_weights > 128 || 1 + fse_n < direct_n)) {
    tree[0] = (uint8_t)fse_n;
    tree_n = 1 + fse_n;
  } else if (n_weights <= 128) {
    tree[0] = (uint8_t)(127 + n_weights);
    int t = 1;
    for (int i = 0; i < n_weights; i += 2) {
      uint8_t hi = weights[i];
      uint8_t lo = (i + 1 < n_weights) ? weights[i + 1] : 0;
      tree[t++] = (uint8_t)((hi << 4) | lo);
    }
    tree_n = t;
  } else {
    return 0;
  }

  // encode streams into scratch, then assemble with exact-size header
  static thread_local uint8_t streams[(256 << 10) + 1024];
  uint64_t comp;
  uint64_t s_sz[4] = {0, 0, 0, 0};
  bool four = n > 1023;
  if (!four) {
    comp = huf_stream(lits, n, codes, streams);
  } else {
    uint32_t part = (n + 3) / 4;
    uint64_t off = 0;
    for (int k = 0; k < 4; k++) {
      uint32_t a = part * k;
      uint32_t b = k == 3 ? n : part * (k + 1);
      s_sz[k] = huf_stream(lits + a, b - a, codes, streams + off);
      if (s_sz[k] > 65535) return 0;
      off += s_sz[k];
    }
    comp = off + 6;                // + jump table
  }
  if (t0) g_enc_ns_huf += nz_now_ns() - t0;
  uint64_t total_comp = (uint64_t)tree_n + comp;

  uint64_t w = 0;
  if (!four) {
    if (n > 1023 || total_comp > 1023) return 0;
    uint32_t h = 2u | (0u << 2) | (n << 4) | ((uint32_t)total_comp << 14);
    if (w + 3 + total_comp > cap) return 0;
    dst[w++] = (uint8_t)h; dst[w++] = (uint8_t)(h >> 8);
    dst[w++] = (uint8_t)(h >> 16);
  } else if (n <= 16383 && total_comp <= 16383) {
    uint64_t h = 2u | (2u << 2) | ((uint64_t)n << 4)
        | ((uint64_t)total_comp << 18);
    if (w + 4 + total_comp > cap) return 0;
    dst[w++] = (uint8_t)h; dst[w++] = (uint8_t)(h >> 8);
    dst[w++] = (uint8_t)(h >> 16); dst[w++] = (uint8_t)(h >> 24);
  } else {
    uint64_t h = 2u | (3u << 2) | ((uint64_t)n << 4)
        | ((uint64_t)total_comp << 22);
    if (w + 5 + total_comp > cap) return 0;
    dst[w++] = (uint8_t)h; dst[w++] = (uint8_t)(h >> 8);
    dst[w++] = (uint8_t)(h >> 16); dst[w++] = (uint8_t)(h >> 24);
    dst[w++] = (uint8_t)(h >> 32);
  }
  std::memcpy(dst + w, tree, tree_n);
  w += tree_n;
  if (four) {
    dst[w++] = (uint8_t)s_sz[0]; dst[w++] = (uint8_t)(s_sz[0] >> 8);
    dst[w++] = (uint8_t)s_sz[1]; dst[w++] = (uint8_t)(s_sz[1] >> 8);
    dst[w++] = (uint8_t)s_sz[2]; dst[w++] = (uint8_t)(s_sz[2] >> 8);
    std::memcpy(dst + w, streams, s_sz[0] + s_sz[1] + s_sz[2] + s_sz[3]);
    w += s_sz[0] + s_sz[1] + s_sz[2] + s_sz[3];
  } else {
    std::memcpy(dst + w, streams, comp);
    w += comp;
  }
  if (w >= n) return 0;           // raw literals are smaller
  return w;
}

// ---------------------------------------------------------------------------
// sequence code mapping
// ---------------------------------------------------------------------------

static inline int ll_code(uint32_t ll, uint32_t *extra, int *bits) {
  if (ll < 16) { *extra = 0; *bits = 0; return (int)ll; }
  for (int i = 19; i >= 0; i--) {
    if (ll >= LL_BASE[i]) {
      *extra = ll - LL_BASE[i];
      *bits = LL_BITS[i];
      return 16 + i;
    }
  }
  *extra = 0; *bits = 0; return 15;   // unreachable
}

static inline int ml_code(uint32_t ml, uint32_t *extra, int *bits) {
  if (ml < 35) { *extra = 0; *bits = 0; return (int)(ml - 3); }
  for (int i = 20; i >= 0; i--) {
    if (ml >= ML_BASE[i]) {
      *extra = ml - ML_BASE[i];
      *bits = ML_BITS[i];
      return 32 + i;
    }
  }
  *extra = 0; *bits = 0; return 31;   // unreachable
}

// ---------------------------------------------------------------------------
// repeat offsets (RFC 8878 §3.1.1.5): Offset_Value 1-3 name recent offsets,
// with the shifted meaning when Literals_Length == 0.  The encoder tracks
// the same state machine the decoder replays.
// ---------------------------------------------------------------------------

struct RepState { uint32_t r[3] = {1, 4, 8}; };

// actual distance named by offset_value `v` at literal length `ll`
static inline uint32_t rep_distance(const RepState &rs, uint32_t v,
                                    uint32_t ll) {
  if (ll) return rs.r[v - 1];
  if (v == 1) return rs.r[1];
  if (v == 2) return rs.r[2];
  return rs.r[0] - 1;
}

// encode distance `off` -> offset_value, updating the rep state exactly as
// the decoder will
static inline uint32_t offset_value(RepState &rs, uint32_t off, uint32_t ll) {
  uint32_t r0 = rs.r[0], r1 = rs.r[1], r2 = rs.r[2];
  if (ll) {
    if (off == r0) return 1;
    if (off == r1) { rs.r[0] = r1; rs.r[1] = r0; return 2; }
    if (off == r2) { rs.r[0] = r2; rs.r[1] = r0; rs.r[2] = r1; return 3; }
  } else {
    if (off == r1) { rs.r[0] = r1; rs.r[1] = r0; return 1; }
    if (off == r2) { rs.r[0] = r2; rs.r[1] = r0; rs.r[2] = r1; return 2; }
    if (off == r0 - 1) { rs.r[0] = r0 - 1; rs.r[1] = r0; rs.r[2] = r1; return 3; }
  }
  rs.r[0] = off; rs.r[1] = r0; rs.r[2] = r1;
  return off + 3;
}

// ---------------------------------------------------------------------------
// per-block dynamic FSE sequence tables (FSE_Compressed_Mode): histogram the
// codes, normalize, and pick the cheaper of {predefined, RLE, dynamic} per
// channel — the decisive ratio lever over predefined-only coding.
// ---------------------------------------------------------------------------

struct ChanPlan {
  int mode;              // 0 predefined, 1 RLE, 2 FSE dynamic
  const FseEnc *enc;     // mode 0/2
  uint8_t rle_sym;
  uint8_t ncount[128];
  int ncount_n;
};

static inline int ilog2(uint32_t v) { return v ? highbit32(v) : 0; }

static void plan_channel(const uint32_t *count, int n_sym, uint32_t n_seqs,
                         const int16_t *pre_norm, int pre_n,
                         const FseEnc *pre,
                         int pre_log, int max_log, FseEnc *dyn,
                         ChanPlan *cp) {
  int distinct = 0, only = 0;
  for (int s = 0; s < n_sym; s++)
    if (count[s]) { distinct++; only = s; }
  if (distinct <= 1) {
    cp->mode = 1;                      // RLE: 1-byte table, 0 bits/symbol
    cp->rle_sym = (uint8_t)only;
    cp->enc = nullptr;
    cp->ncount_n = 0;
    return;
  }

  // predefined cost (bits): norm <= 0 counts as full table_log bits.
  // Symbols beyond the predefined table (possible on the OF channel with
  // --long 29|30) make the predefined mode unusable: never read pre_norm
  // out of bounds, and force the dynamic table to win.
  int64_t pre_bits = 0;
  bool pre_ok = pre != nullptr;
  for (int s = 0; s < n_sym; s++)
    if (count[s]) {
      if (s >= pre_n) { pre_ok = false; continue; }
      int nb = pre_norm[s] > 0 ? pre_log - ilog2((uint32_t)pre_norm[s])
                               : pre_log;
      pre_bits += (int64_t)count[s] * nb;
    }
  if (!pre_ok) pre_bits = INT64_MAX / 2;

  // dynamic table: accuracy log fitted to the sequence count
  int tl = max_log;
  while (tl > 5 && (1u << (tl - 2)) > n_seqs) tl--;
  int16_t norm[64];
  cp->mode = 0; cp->enc = pre; cp->ncount_n = 0;
  if (fse_normalize(count, n_sym, (int)n_seqs, tl, norm) != 0) return;
  uint8_t nc[128];
  int nc_n = fse_write_ncount(norm, n_sym, tl, nc, sizeof(nc));
  if (nc_n < 0) return;
  int64_t dyn_bits = (int64_t)nc_n * 8;
  for (int s = 0; s < n_sym; s++)
    if (count[s]) {
      int p = norm[s] > 0 ? norm[s] : 1;
      dyn_bits += (int64_t)count[s] * (tl - ilog2((uint32_t)p));
    }
  if (dyn_bits + 32 < pre_bits) {
    fse_build(norm, n_sym, tl, dyn);
    cp->mode = 2;
    cp->enc = dyn;
    std::memcpy(cp->ncount, nc, nc_n);
    cp->ncount_n = nc_n;
  }
}

// ---------------------------------------------------------------------------
// block serialization
// ---------------------------------------------------------------------------

struct Seq { uint32_t lit_len, match_len, ofv; };   // ofv = offset_value

// serialize one compressed block body; returns size or 0 if not profitable
static uint64_t write_compressed_block(const Seq *seqs, uint32_t n_seqs,
                                       const uint8_t *literals,
                                       uint32_t lit_n, uint64_t raw_size,
                                       uint8_t *dst, uint64_t dst_cap) {
  fse_init_all();
  uint64_t w = write_huf_literals(literals, lit_n, dst, dst_cap);
  if (w == 0) {
    // raw literals section
    if (lit_n < 32) {
      if (w + 1 + lit_n > dst_cap) return 0;
      dst[w++] = (uint8_t)(lit_n << 3);               // type 0, format 00
    } else if (lit_n < 4096) {
      if (w + 2 + lit_n > dst_cap) return 0;
      uint32_t h = 0 | (1u << 2) | (lit_n << 4);      // format 01, 12 bits
      dst[w++] = (uint8_t)h;
      dst[w++] = (uint8_t)(h >> 8);
    } else {
      if (w + 3 + lit_n > dst_cap) return 0;
      uint32_t h = 0 | (3u << 2) | (lit_n << 4);      // format 11, 20 bits
      dst[w++] = (uint8_t)h;
      dst[w++] = (uint8_t)(h >> 8);
      dst[w++] = (uint8_t)(h >> 16);
    }
    std::memcpy(dst + w, literals, lit_n);
    w += lit_n;
  }

  if (n_seqs == 0) {
    // literals-only block (pure entropy coding, e.g. random packed DNA)
    if (w + 1 >= raw_size || w + 1 > dst_cap) return 0;
    dst[w++] = 0;                 // Number_of_Sequences = 0, nothing follows
    return w;
  }

  // histograms of the three code streams
  uint32_t cll[36] = {0}, cml[53] = {0}, cof[32] = {0};
  int max_ofc = 0;
  for (uint32_t i = 0; i < n_seqs; i++) {
    uint32_t x; int b;
    cll[ll_code(seqs[i].lit_len, &x, &b)]++;
    cml[ml_code(seqs[i].match_len, &x, &b)]++;
    int oc = highbit32(seqs[i].ofv);
    cof[oc]++;
    if (oc > max_ofc) max_ofc = oc;
  }

  static thread_local FseEnc dll, dml, dof;
  ChanPlan pll, pml, pof;
  plan_channel(cll, 36, n_seqs, LL_NORM, 36, &g_ll, LL_LOG, 9, &dll, &pll);
  plan_channel(cml, 53, n_seqs, ML_NORM, 53, &g_ml, ML_LOG, 9, &dml, &pml);
  // the predefined OF table only covers codes <= 28
  if (max_ofc > 28) {
    plan_channel(cof, max_ofc + 1, n_seqs, OF_NORM, 29, nullptr, OF_LOG, 8,
                 &dof, &pof);
    if (pof.mode == 0 && pof.enc == nullptr) return 0;  // can't represent
  } else {
    plan_channel(cof, 29, n_seqs, OF_NORM, 29, &g_of, OF_LOG, 8, &dof, &pof);
  }

  // sequences header
  if (w + 3 + 3 * 128 + 16 > dst_cap) return 0;
  if (n_seqs < 128) {
    dst[w++] = (uint8_t)n_seqs;
  } else if (n_seqs < 0x7F00) {
    dst[w++] = (uint8_t)((n_seqs >> 8) + 0x80);
    dst[w++] = (uint8_t)n_seqs;
  } else {
    dst[w++] = 0xFF;
    dst[w++] = (uint8_t)(n_seqs - 0x7F00);
    dst[w++] = (uint8_t)((n_seqs - 0x7F00) >> 8);
  }
  // modes byte: LL<<6 | OF<<4 | ML<<2 (0 predef, 1 RLE, 2 FSE)
  dst[w++] = (uint8_t)((pll.mode << 6) | (pof.mode << 4) | (pml.mode << 2));
  // table descriptions in LL, OF, ML order
  if (pll.mode == 1) dst[w++] = pll.rle_sym;
  else if (pll.mode == 2) { std::memcpy(dst + w, pll.ncount, pll.ncount_n); w += pll.ncount_n; }
  if (pof.mode == 1) dst[w++] = pof.rle_sym;
  else if (pof.mode == 2) { std::memcpy(dst + w, pof.ncount, pof.ncount_n); w += pof.ncount_n; }
  if (pml.mode == 1) dst[w++] = pml.rle_sym;
  else if (pml.mode == 2) { std::memcpy(dst + w, pml.ncount, pml.ncount_n); w += pml.ncount_n; }

  // the interleaved backward FSE bitstream (RFC 8878 §3.1.1.3.2.1.2;
  // write order mirrors the specified decode order exactly; RLE channels
  // carry no state bits)
  BitW bw{dst + w};

  const Seq &last = seqs[n_seqs - 1];
  uint32_t ll_x, ml_x; int ll_b, ml_b;
  int llc = ll_code(last.lit_len, &ll_x, &ll_b);
  int mlc = ml_code(last.match_len, &ml_x, &ml_b);
  int ofc = highbit32(last.ofv);
  uint32_t of_x = last.ofv - (1u << ofc);

  FseState sll{0, pll.enc}, sml{0, pml.enc}, sof{0, pof.enc};
  if (pml.mode != 1) sml.init(mlc);
  if (pof.mode != 1) sof.init(ofc);
  if (pll.mode != 1) sll.init(llc);
  bw.add(ll_x, ll_b);
  bw.add(ml_x, ml_b);
  bw.add(of_x, ofc);

  for (int i = (int)n_seqs - 2; i >= 0; i--) {
    const Seq &q = seqs[i];
    int llc2 = ll_code(q.lit_len, &ll_x, &ll_b);
    int mlc2 = ml_code(q.match_len, &ml_x, &ml_b);
    int ofc2 = highbit32(q.ofv);
    uint32_t of_x2 = q.ofv - (1u << ofc2);
    if (pof.mode != 1) sof.encode(bw, ofc2);
    if (pml.mode != 1) sml.encode(bw, mlc2);
    if (pll.mode != 1) sll.encode(bw, llc2);
    bw.add(ll_x, ll_b);
    bw.add(ml_x, ml_b);
    bw.add(of_x2, ofc2);
    if (w + bw.pos + 24 > dst_cap) return 0;
  }
  if (pml.mode != 1) sml.flush(bw);
  if (pof.mode != 1) sof.flush(bw);
  if (pll.mode != 1) sll.flush(bw);
  uint64_t bits_len = bw.close();
  w += bits_len;
  if (w >= raw_size) return 0;       // not profitable
  return w;
}

// ---------------------------------------------------------------------------
// match finders.  Two strategies share the emission/rep machinery:
//   greedy  — single-probe hash4 table (levels <= 2 and negative levels,
//             with skip acceleration on incompressible stretches);
//   lazy    — hash chains with bounded depth and 1- or 2-step lazy
//             evaluation (levels >= 3), the ratio workhorse.
// An optional long-distance table (8-byte hashes, sparse insertion) serves
// --long windows at any level.  Levels map to {window, chain log, depth,
// lazy steps} like libzstd's cParams, but the table is our own.
// ---------------------------------------------------------------------------

static inline uint32_t read32(const uint8_t *p) {
  uint32_t v; std::memcpy(&v, p, 4); return v;
}
static inline uint64_t read64(const uint8_t *p) {
  uint64_t v; std::memcpy(&v, p, 8); return v;
}

struct LevelCfg {
  int strat;       // 0 greedy, 1 lazy chains
  int wlog;        // window log (offset cap)
  int hlog;        // hash4 table log
  int clog;        // chain ring log (strat 1)
  int depth;       // chain walk bound
  uint32_t mm;     // min match for new offsets
  int lazy;        // lazy steps (0..2)
  int accel;       // greedy skip acceleration (negative levels)
  bool ldm;        // long-distance table on
  bool full_rep;   // greedy: check all three repeat offsets
};

static LevelCfg cfg_for(int level, int wlog_override) {
  LevelCfg c;
  if (level < 1) {
    long long a = -(long long)level;
    c = {0, 21, 17, 0, 0, 6, 0, (int)(a > 60 ? 8 : 1 + a / 8), false, false};
  } else if (level <= 1)  c = {0, 21, 17, 0, 0, 5, 0, 0, false, false};
  else if (level <= 2)    c = {0, 21, 18, 0, 0, 5, 0, 0, false, true};
  else if (level <= 4)    c = {1, 21, 17, 16, 8, 4, 1, 0, false};
  else if (level <= 6)    c = {1, 22, 18, 17, 16, 4, 1, 0, false};
  else if (level <= 9)    c = {1, 23, 19, 18, 48, 4, 1, 0, false};
  else if (level <= 12)   c = {1, 24, 20, 19, 96, 4, 2, 0, false};
  else if (level <= 15)   c = {1, 25, 21, 20, 256, 4, 2, 0, false};
  else if (level <= 17)   c = {2, 26, 20, 21, 512, 3, 0, 0, false};
  else if (level <= 20)   c = {2, 27, 20, 22, 1024, 3, 0, 0, false};
  else                    c = {2, 27, 20, 23, 2048, 3, 0, 0, false};
  if (wlog_override > 0) {
    c.wlog = wlog_override < 10 ? 10 : (wlog_override > 30 ? 30 : wlog_override);
    if (c.wlog >= 24) c.ldm = true;   // --long: long-distance matching
  }
  return c;
}

static const int LDM_LOG = 20;
static const uint32_t LDM_MINMATCH = 32;

struct Tables {
  int32_t *hash;          // 1 << hlog, pos-base+1
  int32_t *chain;         // 1 << clog ring, pos-base+1 (strat 1)
  int32_t *ldm;           // 1 << LDM_LOG, pos-base+1 (ldm only)
  int32_t *stat;          // 1 << STAT_LOG, pos-base+1 (strat 2 price pass)
  int32_t *bt;            // 2 << clog ring, child links (strat 2 tree)
  int32_t *h3;            // 1 << 16, pos-base+1 (strat 2, 3-byte seeds)
  // Epoch origin for stored positions: tables hold pos-base+1 so entries
  // stay positive past 2 GB of input.  Set to lo_limit at every history
  // reset (tables are zeroed there, so all live entries share one epoch);
  // an empty slot (0) decodes to base-1 < lo_limit and fails every lo
  // bound check.
  uint64_t base = 0;
};

static inline uint32_t hash4_log(uint32_t v, int hlog) {
  return (v * 2654435761u) >> (32 - hlog);
}

// 5-byte hash for the fast greedy path: min-match there is 5, so a 5-byte
// seed avoids extends that a 4-byte hash would propose and then reject
static inline uint32_t hash5_log(uint64_t v, int hlog) {
  return (uint32_t)(((v << 24) * 0x9E3779B185EBCA87ull) >> (64 - hlog));
}

static inline uint32_t hash3_16(uint32_t v) {
  return ((v & 0xFFFFFFu) * 506832829u) >> 16;
}
static inline uint32_t hash8_ldm(uint64_t v) {
  return (uint32_t)((v * 0x9E3779B185EBCA87ull) >> (64 - LDM_LOG));
}

// extend a candidate match [cand, pos); returns length (0 if no 4-byte seed)
static inline uint64_t extend(const uint8_t *src, uint64_t cand, uint64_t pos,
                              uint64_t end) {
  if (read32(src + cand) != read32(src + pos)) return 0;
  uint64_t m = 4;
  const uint64_t room = end - pos;
  while (m + 8 <= room) {
    uint64_t a = read64(src + cand + m), b = read64(src + pos + m);
    if (a != b) return m + (__builtin_ctzll(a ^ b) >> 3);
    m += 8;
  }
  while (m < room && src[cand + m] == src[pos + m]) m++;
  return m;
}

// like extend but without the 4-byte seed gate: exact common length from 0
// (3-byte matches are legal zstd and worth pricing at high levels)
static inline uint64_t extend_raw(const uint8_t *src, uint64_t cand,
                                  uint64_t pos, uint64_t end) {
  uint64_t m = 0;
  const uint64_t room = end - pos;
  while (m + 8 <= room) {
    uint64_t a = read64(src + cand + m), b = read64(src + pos + m);
    if (a != b) return m + (__builtin_ctzll(a ^ b) >> 3);
    m += 8;
  }
  while (m < room && src[cand + m] == src[pos + m]) m++;
  return m;
}

// longest rep-offset match at pos (distances from the CURRENT rep state,
// considering both the ll>0 and ll==0 views); returns (len, distance)
static inline uint64_t best_rep(const uint8_t *src, uint64_t pos,
                                uint64_t end, const RepState &rs,
                                uint32_t ll_nonzero, uint32_t *dist) {
  uint64_t best = 0;
  uint32_t cand_d[3];
  if (ll_nonzero) {
    cand_d[0] = rs.r[0]; cand_d[1] = rs.r[1]; cand_d[2] = rs.r[2];
  } else {
    cand_d[0] = rs.r[1]; cand_d[1] = rs.r[2]; cand_d[2] = rs.r[0] - 1;
  }
  for (int k = 0; k < 3; k++) {
    uint32_t d = cand_d[k];
    if (d == 0 || d > pos) continue;
    if (read32(src + pos - d) != read32(src + pos)) continue;
    uint64_t m = extend(src, pos - d, pos, end);
    if (m > best) { best = m; *dist = d; }
  }
  return best;
}

// chain search: longest match, ties to smaller offset; returns length
static inline uint64_t chain_search(const uint8_t *src, uint64_t pos,
                                    uint64_t end, uint64_t lo_limit,
                                    const LevelCfg &cfg, Tables &t,
                                    uint32_t *off_out) {
  const uint32_t cmask = (1u << cfg.clog) - 1;
  const uint64_t window = 1ull << cfg.wlog;
  uint64_t lo = pos > window ? pos - window : 0;
  if (lo < lo_limit) lo = lo_limit;
  uint32_t h = hash5_log(read64(src + pos), cfg.hlog);
  int64_t cand = (int64_t)t.hash[h] - 1 + (int64_t)t.base;
  // the caller inserts pos before searching; skip the self-entry
  if (cand == (int64_t)pos)
    cand = (int64_t)t.chain[pos & cmask] - 1 + (int64_t)t.base;
  uint64_t best = 0;
  int64_t best_sc = 0;
  int depth = cfg.depth;
  while (cand >= (int64_t)lo && depth-- > 0) {
    if (cand >= (int64_t)pos) break;   // stale ring entry
    // fast reject: compare the byte just past the current best
    if (src[cand + best] == src[pos + best]) {
      uint64_t m = extend(src, (uint64_t)cand, pos, end);
      if (m > best) {
        // price the offset: walking nearest-first, a farther candidate
        // must be LONGER to win, and short matches at large offsets are
        // rejected outright (they cost more bits than their literals and
        // break rep continuity — same gate as the fast greedy path)
        uint32_t off = (uint32_t)(pos - (uint64_t)cand);
        uint32_t hb = (uint32_t)highbit32(off | 1);
        int64_t sc = (int64_t)(m << 3) - hb;
        if ((hb <= 12 || 2 * m >= (uint64_t)hb + 2)
            && (m >= 5 || hb <= 8) && sc > best_sc) {
          best = m;
          best_sc = sc;
          *off_out = off;
          if (pos + m >= end) break;
        }
      }
    }
    int64_t nxt = (int64_t)t.chain[cand & cmask] - 1 + (int64_t)t.base;
    if (nxt >= cand) break;          // stale ring entry (wrapped)
    cand = nxt;
  }
  return best;
}

static inline void chain_insert(const uint8_t *src, uint64_t pos,
                                const LevelCfg &cfg, Tables &t) {
  const uint32_t cmask = (1u << cfg.clog) - 1;
  uint32_t h = hash5_log(read64(src + pos), cfg.hlog);
  t.chain[pos & cmask] = t.hash[h];
  t.hash[h] = (int32_t)(pos - t.base + 1);
}

// long-distance probe/insert (8-byte hashes, sparse)
uint64_t naf_ldm_probes = 0, naf_ldm_hits = 0, naf_ldm_cand = 0,
         naf_ldm_ins = 0;   // debug counters

static inline uint64_t ldm_search(const uint8_t *src, uint64_t pos,
                                  uint64_t end, uint64_t lo_limit,
                                  const LevelCfg &cfg, Tables &t,
                                  uint32_t *off_out) {
  if (!cfg.ldm || pos + 8 > end) return 0;
  naf_ldm_probes++;
  const uint64_t window = 1ull << cfg.wlog;
  uint64_t lo = pos > window ? pos - window : 0;
  if (lo < lo_limit) lo = lo_limit;
  uint32_t h = hash8_ldm(read64(src + pos));
  int64_t cand = (int64_t)t.ldm[h] - 1 + (int64_t)t.base;
  if (cand < (int64_t)lo || cand >= (int64_t)pos) return 0;
  naf_ldm_cand++;
  uint64_t m = extend(src, (uint64_t)cand, pos, end);
  if (m < LDM_MINMATCH) return 0;
  naf_ldm_hits++;
  *off_out = (uint32_t)(pos - (uint64_t)cand);
  return m;
}

static inline void ldm_insert(const uint8_t *src, uint64_t pos, uint64_t end,
                              const LevelCfg &cfg, Tables &t) {
  // sparse stride-16 insertion: long history survives in the 1M-slot table
  // (dense insertion would evict it); any long repeat contains plenty of
  // stride-aligned anchors, and one hit latches the whole match
  if (!cfg.ldm || (pos & 15) != 0 || pos + 8 > end) return;
  naf_ldm_ins++;
  t.ldm[hash8_ldm(read64(src + pos))] = (int32_t)(pos - t.base + 1);
}

// match score: favors long matches and cheap (small/rep) offsets
static inline int64_t score(uint64_t m, uint32_t ofv) {
  return (int64_t)(m << 3) - highbit32(ofv | 1);
}

// collect sequences for src[block_start, block_end); history from
// src[lo_limit, block_start).  Updates the rep state across blocks.
static uint32_t find_sequences(const uint8_t *src, uint64_t block_start,
                               uint64_t block_end, uint64_t lo_limit,
                               const LevelCfg &cfg, Tables &t, RepState &rs,
                               Seq *seqs, uint32_t max_seqs,
                               uint8_t *literals, uint32_t *lit_total) {
  uint64_t pos = block_start, anchor = block_start;
  uint32_t n = 0, lit_n = 0;
  const uint64_t limit = block_end >= 12 ? block_end - 12 : 0;
  const uint64_t window = 1ull << cfg.wlog;

  auto emit = [&](uint64_t at, uint64_t m, uint32_t off) {
    uint32_t ll = (uint32_t)(at - anchor);
    std::memcpy(literals + lit_n, src + anchor, ll);
    lit_n += ll;
    seqs[n].lit_len = ll;
    seqs[n].match_len = (uint32_t)m;
    seqs[n].ofv = offset_value(rs, off, ll);
    n++;
    anchor = at + m;
  };

  if (cfg.strat == 0 && !cfg.ldm && !cfg.full_rep) {
    // fast greedy (levels <= 1 and negative levels without --long): the
    // libzstd-fast shape — 5-byte hash, primary-rep-first, and skip
    // acceleration that strides through literal runs (the reference's
    // speed identity at low levels, README.md:4; BENCH_r03 measured this
    // loop's predecessor at 73 MB/s vs 633 for the linked library)
    const uint32_t accel_mult = cfg.accel ? (uint32_t)cfg.accel : 1;
    // software-pipelined: the NEXT probe's hash + table slot are computed
    // before the current position's checks, hiding the dependent-load
    // latency chain (hash -> index -> load) that otherwise serializes the
    // per-position walk
    uint32_t h0 = pos < limit ? hash5_log(read64(src + pos), cfg.hlog) : 0;
    while (pos < limit && n < max_seqs) {
      uint32_t run = (uint32_t)(pos - anchor);
      uint64_t nxt = pos + 1 + (run >> 8) * accel_mult;
      uint32_t h1 = nxt < limit ? hash5_log(read64(src + nxt), cfg.hlog) : 0;
      __builtin_prefetch(t.hash + h1);
      int64_t cand = (int64_t)t.hash[h0] - 1 + (int64_t)t.base;
      t.hash[h0] = (int32_t)(pos - t.base + 1);

      // primary-rep only (rep code 0 under zstd's ll==0 shift): the
      // libzstd-fast discipline — one predictable compare per position
      // instead of best_rep's three-candidate walk.  Secondary reps are
      // a ratio refinement the >=2 levels keep (full_rep / lazy paths).
      uint32_t rep_d = run ? rs.r[0] : rs.r[1];
      {
        uint64_t m = 0;
        if (rep_d && rep_d <= pos &&
            read32(src + pos - rep_d) == read32(src + pos))
          m = extend(src, pos - rep_d, pos, block_end);
        if (m >= 4) {
          emit(pos, m, rep_d);
          pos = anchor;
          h0 = pos < limit ? hash5_log(read64(src + pos), cfg.hlog) : 0;
          continue;
        }
      }
      if (cand >= (int64_t)lo_limit && pos - (uint64_t)cand <= window) {
        uint64_t m = extend(src, (uint64_t)cand, pos, block_end);
        uint32_t off = (uint32_t)(pos - (uint64_t)cand);
        // offset-priced acceptance: a 5-byte match at a 2^20 offset costs
        // more bits than its literals on 4-bit-packed data, and the noise
        // matches it would emit also break rep continuity and keep the
        // skip accelerator from ever engaging on incompressible spans
        uint32_t hb = (uint32_t)highbit32(off | 1);
        if (m >= cfg.mm && (hb <= 12 || 2 * m >= (uint64_t)hb + 2)) {
          emit(pos, m, off);
          if (pos + m < limit) {
            uint64_t i1 = pos + (m >> 1), i2 = pos + m - 2;
            t.hash[hash5_log(read64(src + i1), cfg.hlog)] =
                (int32_t)(i1 - t.base + 1);
            t.hash[hash5_log(read64(src + i2), cfg.hlog)] =
                (int32_t)(i2 - t.base + 1);
          }
          pos = anchor;
          h0 = pos < limit ? hash5_log(read64(src + pos), cfg.hlog) : 0;
          continue;
        }
      }
      pos = nxt;
      h0 = h1;
    }
  } else if (cfg.strat == 0) {
    // greedy hash4 with rep checks (the --long / full-rep configuration)
    uint32_t skip = 0;
    // seed width follows min-match: a 4-byte hash on low-entropy data keeps
    // the single-slot table pinned to nearby noise recurrences (4-grams on
    // nibble noise recur every ~64 KB), so a megabyte-back true repeat is
    // never proposed; a 5-byte seed reaches it a constant fraction of the
    // time and one huge extend then carries the rest via rep offsets
    const bool seed5 = cfg.mm >= 5;
    auto hseed = [&](uint64_t p) {
      return seed5 ? hash5_log(read64(src + p), cfg.hlog)
                   : hash4_log(read32(src + p), cfg.hlog);
    };
    while (pos < limit && n < max_seqs) {
      uint32_t h = hseed(pos);
      int64_t cand = (int64_t)t.hash[h] - 1 + (int64_t)t.base;
      t.hash[h] = (int32_t)(pos - t.base + 1);

      // level 1 checks only the primary repeat offset (speed); level 2 and
      // the lazy strategy check all three
      uint32_t rep_d;
      uint64_t m_rep;
      if (cfg.full_rep) {
        rep_d = 0;
        m_rep = best_rep(src, pos, block_end, rs,
                         (uint32_t)(pos - anchor), &rep_d);
      } else {
        rep_d = pos - anchor ? rs.r[0] : rs.r[1];
        m_rep = 0;
        if (rep_d && rep_d <= pos &&
            read32(src + pos - rep_d) == read32(src + pos))
          m_rep = extend(src, pos - rep_d, pos, block_end);
      }
      uint64_t m_h = 0;
      uint32_t off_h = 0;
      if (cand >= (int64_t)lo_limit && pos - (uint64_t)cand <= window) {
        m_h = extend(src, (uint64_t)cand, pos, block_end);
        off_h = (uint32_t)(pos - (uint64_t)cand);
      }
      uint32_t off_l = 0;
      // probe BEFORE inserting: an aligned position's insert would land in
      // its twin's slot (same content, same hash) and self-evict it
      uint64_t m_l = ldm_search(src, pos, block_end, lo_limit, cfg, t, &off_l);
      ldm_insert(src, pos, block_end, cfg, t);
      if (m_l > m_h + 4) { m_h = m_l; off_h = off_l; }
      // offset-priced acceptance (same gate as the fast path): a min-match
      // hit at a 2^20 offset costs more bits than its literals on packed
      // noise and breaks rep continuity.  LDM matches (>=32 B) always pass.
      if (m_h) {
        uint32_t hb = (uint32_t)highbit32(off_h | 1);
        if (!(hb <= 12 || 2 * m_h >= (uint64_t)hb + 2)) m_h = 0;
      }

      if (m_rep >= 4 && m_rep + 1 >= m_h) {
        emit(pos, m_rep, rep_d);
        pos = anchor;
        skip = 0;
      } else if (m_h >= cfg.mm) {
        emit(pos, m_h, off_h);
        if (m_h > 2 && pos + m_h < limit) {
          uint64_t ins = pos + (m_h >> 1);
          t.hash[hseed(ins)] = (int32_t)(ins - t.base + 1);
          t.hash[hseed(pos + m_h - 2)] =
              (int32_t)(pos + m_h - 2 - t.base + 1);
        }
        pos = anchor;
        skip = 0;
      } else {
        pos += 1 + (cfg.accel ? ((uint32_t)(pos - anchor) >> 8) * cfg.accel
                              : 0);
        (void)skip;
      }
    }
  } else {
    // lazy chain matcher
    while (pos < limit && n < max_seqs) {
      chain_insert(src, pos, cfg, t);

      uint32_t rep_d = 0, off = 0;
      uint64_t m_rep = best_rep(src, pos, block_end, rs,
                                (uint32_t)(pos - anchor), &rep_d);
      uint64_t m = chain_search(src, pos, block_end, lo_limit, cfg, t, &off);
      uint32_t off_l = 0;
      // probe BEFORE inserting: an aligned position's insert would land in
      // its twin's slot (same content, same hash) and self-evict it
      uint64_t m_l = ldm_search(src, pos, block_end, lo_limit, cfg, t, &off_l);
      ldm_insert(src, pos, block_end, cfg, t);
      if (m_l > m + 4) { m = m_l; off = off_l; }

      bool use_rep = m_rep >= 3 && score(m_rep, 1) >= score(m, off + 3);
      if (use_rep) { m = m_rep; }
      else if (m < cfg.mm) { pos++; continue; }
      // offset-priced acceptance (same gate as the fast path): a short
      // match at a large offset costs more bits than its literals on
      // 4-bit-packed data and breaks rep continuity
      // (offset pricing lives inside chain_search now; LDM matches are
      // always >= 32 bytes and never fail it)

      uint64_t at = pos;
      for (int step = 0; step < cfg.lazy && at + 1 < limit; step++) {
        uint64_t nx = at + 1;
        chain_insert(src, nx, cfg, t);
        uint32_t rep_d2 = 0, off2 = 0;
        uint64_t m_rep2 = best_rep(src, nx, block_end, rs,
                                   (uint32_t)(nx - anchor), &rep_d2);
        uint64_t m2 = chain_search(src, nx, block_end, lo_limit, cfg, t,
                                   &off2);
        bool rep2 = m_rep2 >= 3 && score(m_rep2, 1) >= score(m2, off2 + 3);
        uint64_t cand_m = rep2 ? m_rep2 : m2;
        uint32_t cand_off = rep2 ? rep_d2 : off2;
        int64_t cur = score(m, use_rep ? 1 : off + 3) ;
        int64_t nxt = score(cand_m, rep2 ? 1 : off2 + 3) - 4; // switch bias
        if (cand_m >= cfg.mm && nxt > cur) {
          at = nx; m = cand_m; off = cand_off; use_rep = rep2;
          if (use_rep) rep_d = rep_d2;
        } else {
          break;
        }
      }

      emit(at, m, use_rep ? rep_d : off);
      // insert positions inside the match (bounded work)
      uint64_t stop = at + m < limit ? at + m : limit;
      uint64_t ins = at + 1;
      uint64_t stride = cfg.depth >= 96 ? 1 : 2;
      for (; ins < stop; ins += stride) chain_insert(src, ins, cfg, t);
      pos = anchor;
    }
  }

  uint32_t tail = (uint32_t)(block_end - anchor);
  std::memcpy(literals + lit_n, src + anchor, tail);
  lit_n += tail;
  *lit_total = lit_n;
  return n;
}

// ---------------------------------------------------------------------------
// optimal parser (strat 2, levels >= 16): two-pass price-model dynamic
// program.  Pass 1 runs a cheap greedy matcher over the block (private hash
// table so the real chain history is untouched) purely to histogram the
// literal bytes and LL/ML/OF code streams; those histograms become bit
// prices.  Pass 2 walks every block position, collects the Pareto frontier
// of chain/LDM matches plus the three repeat offsets, and relaxes a
// shortest-path DP over "estimated compressed bits", tracking the exact
// rep-offset state per node so rep encodings price (and replay) correctly.
// Parity target: the reference's high-compression claim at -16..-22
// (the reference's Compress.md:23-34, CHANGELOG.md:41-42 "state of the art
// compression strength on high compression levels").
// ---------------------------------------------------------------------------

static const uint64_t BLOCK_MAX = 128 << 10;
static const int STAT_LOG = 17;

struct OptCosts {
  uint16_t lit[256];      // 1/8-bit units per literal byte
  uint16_t llsym[36];     // LL code symbol cost (extra bits priced apart)
  uint16_t mlsym[53];
  uint16_t ofsym[32];
};

static uint16_t bit_cost8(uint64_t total, uint32_t c, int cap8) {
  if (total == 0 || c == 0) return (uint16_t)cap8;
  double bits = log2((double)total / (double)c);
  int v = (int)(bits * 8.0 + 0.5);
  if (v < 2) v = 2;
  if (v > cap8) v = cap8;
  return (uint16_t)v;
}

// price of the LL channel for a literal run of length l (symbol + extra)
static inline uint32_t ll_price(const OptCosts &oc, uint32_t l) {
  uint32_t x; int b;
  int c = ll_code(l, &x, &b);
  return oc.llsym[c] + 8u * (uint32_t)b;
}

static inline uint32_t ml_price(const OptCosts &oc, uint32_t m) {
  uint32_t x; int b;
  int c = ml_code(m, &x, &b);
  return oc.mlsym[c] + 8u * (uint32_t)b;
}

static inline uint32_t of_price(const OptCosts &oc, uint32_t ofv) {
  int c = highbit32(ofv);
  return oc.ofsym[c] + 8u * (uint32_t)c;
}

struct MatchCand { uint32_t off, len; };
static const int OPT_CACHE_K = 8;   // cached chain candidates per position

// Pareto frontier of matches at pos: nearest-first chain walk keeps only
// candidates strictly longer than everything nearer, so offsets ascend with
// length (a farther offset never dominates at shorter lengths); an LDM
// probe contributes the long-distance tail.
static inline int chain_matches(const uint8_t *src, uint64_t pos,
                                uint64_t end, uint64_t lo_limit,
                                const LevelCfg &cfg, Tables &t,
                                MatchCand *out, int max_out, uint64_t suff,
                                uint64_t seed_len) {
  const uint32_t cmask = (1u << cfg.clog) - 1;
  const uint64_t window = 1ull << cfg.wlog;
  uint64_t lo = pos > window ? pos - window : 0;
  if (lo < lo_limit) lo = lo_limit;
  uint32_t h = hash4_log(read32(src + pos), cfg.hlog);
  int64_t cand = (int64_t)t.hash[h] - 1 + (int64_t)t.base;
  if (cand == (int64_t)pos)
    cand = (int64_t)t.chain[pos & cmask] - 1 + (int64_t)t.base;
  int n = 0;
  // seed_len: a rep candidate of this length already exists and is always
  // cheaper, so only strictly longer chain matches can improve the parse
  uint64_t best = cfg.mm > 1 ? cfg.mm - 1 : 1;
  if (seed_len > best) best = seed_len;
  int depth = cfg.depth;
  while (cand >= (int64_t)lo && depth-- > 0 && n < max_out) {
    if (cand >= (int64_t)pos) break;
    if (src[cand + best] == src[pos + best]) {
      uint64_t m = extend(src, (uint64_t)cand, pos, end);
      if (m > best) {
        out[n].off = (uint32_t)(pos - (uint64_t)cand);
        out[n].len = (uint32_t)m;
        n++;
        best = m;
        // a sufficiently long match ends the walk (btopt sufficient_len
        // analog: deeper entries rarely improve past this, and the walk
        // is the dominant cost on match-dense streams)
        if (m >= suff || pos + m >= end) break;
      }
    }
    int64_t nxt = (int64_t)t.chain[cand & cmask] - 1 + (int64_t)t.base;
    if (nxt >= cand) break;
    cand = nxt;
  }
  uint32_t off_l = 0;
  uint64_t m_l = ldm_search(src, pos, end, lo_limit, cfg, t, &off_l);
  if (m_l > best && n < max_out) {
    out[n].off = off_l;
    out[n].len = (uint32_t)m_l;
    n++;
  }
  return n;
}

// binary-tree matchfinder (strat 2): each hash bucket's positions form a
// binary search tree ordered by suffix lexicographic order.  Inserting a
// position walks down the tree splitting it into a < and a > subtree while
// recording the best match at each step — the canonical LZMA/zstd
// high-level matchfinder: per-step compares start at the common-prefix
// floor, so dense short-match data (quality streams) costs O(1) amortized
// per step instead of a full re-extend like a hash chain.
static inline int bt_matches(const uint8_t *src, uint64_t pos, uint64_t end,
                             uint64_t lo_limit, const LevelCfg &cfg,
                             Tables &t, MatchCand *out, int max_out,
                             uint64_t suff, uint64_t seed_len) {
  const uint32_t cmask = (1u << cfg.clog) - 1;
  // matches are NOT re-verified (the common-prefix floors prove them), so
  // every reachable node must still own its child slots: cap the search
  // window at ring-1 so no live node's slot can have been reused by a
  // newer position (slots recycle every 1<<clog); longer-range matches are
  // the (verified) LDM probe's job
  uint64_t window = 1ull << cfg.wlog;
  const uint64_t ring1 = (1ull << cfg.clog) - 1;
  if (window > ring1) window = ring1;
  uint64_t lo = pos > window ? pos - window : 0;
  if (lo < lo_limit) lo = lo_limit;
  uint32_t h = hash4_log(read32(src + pos), cfg.hlog);
  int64_t cur = (int64_t)t.hash[h] - 1 + (int64_t)t.base;
  t.hash[h] = (int32_t)(pos - t.base + 1);
  int32_t *p_smaller = &t.bt[2 * (pos & cmask)];
  int32_t *p_greater = &t.bt[2 * (pos & cmask) + 1];
  uint64_t len_s = 0, len_g = 0;       // common-prefix floors per side
  uint64_t best = cfg.mm > 1 ? cfg.mm - 1 : 1;
  if (seed_len > best) best = seed_len;
  const uint64_t room = end - pos;
  int n = 0;
  int depth = cfg.depth;
  for (;;) {
    if (depth-- <= 0 || cur < (int64_t)lo || cur >= (int64_t)pos) {
      *p_smaller = 0;
      *p_greater = 0;                  // cut: subtree beyond reach is lost
      break;
    }
    uint64_t m = len_s < len_g ? len_s : len_g;
    const uint8_t *a = src + (uint64_t)cur;
    const uint8_t *b = src + pos;
    while (m < room && a[m] == b[m]) m++;
    if (m > best && n < max_out) {
      out[n].off = (uint32_t)(pos - (uint64_t)cur);
      out[n].len = (uint32_t)m;
      n++;
      best = m;
    }
    int32_t *kids = &t.bt[2 * ((uint64_t)cur & cmask)];
    if (m >= room || best >= suff) {
      // tie up to the block bound (ordering undecidable) or good enough:
      // stop here; cutting keeps the BST ordering invariant sound, and
      // only the unexplored remainder of this bucket is forgotten
      *p_smaller = 0;
      *p_greater = 0;
      break;
    }
    if (a[m] < b[m]) {
      *p_smaller = (int32_t)((uint64_t)cur - t.base + 1);
      p_smaller = &kids[1];            // larger side of cur stays below us
      cur = (int64_t)kids[1] - 1 + (int64_t)t.base;
      len_s = m;
    } else {
      *p_greater = (int32_t)((uint64_t)cur - t.base + 1);
      p_greater = &kids[0];
      cur = (int64_t)kids[0] - 1 + (int64_t)t.base;
      len_g = m;
    }
  }
  uint32_t off_l = 0;
  uint64_t m_l = ldm_search(src, pos, end, lo_limit, cfg, t, &off_l);
  if (m_l > best && n < max_out) {
    out[n].off = off_l;
    out[n].len = (uint32_t)m_l;
    n++;
  }
  return n;
}

static const int32_t OPT_INF = INT32_MAX / 2;

struct OptNodes {                      // SoA; ~4 MB thread_local
  int32_t price[BLOCK_MAX + 1];
  int32_t from[BLOCK_MAX + 1];        // predecessor block position
  uint32_t mlen[BLOCK_MAX + 1];       // 0 = literal step
  uint32_t moff[BLOCK_MAX + 1];       // raw distance when mlen > 0
  uint16_t litlen[BLOCK_MAX + 1];     // literal run ending here (capped)
  RepState rs[BLOCK_MAX + 1];         // rep state after arriving here
};

static uint32_t find_sequences_opt(const uint8_t *src, uint64_t block_start,
                                   uint64_t block_end, uint64_t lo_limit,
                                   const LevelCfg &cfg, Tables &t,
                                   RepState &rs, Seq *seqs,
                                   uint32_t max_seqs, uint8_t *literals,
                                   uint32_t *lit_total) {
  const uint32_t bsz = (uint32_t)(block_end - block_start);
  const uint64_t limit = block_end >= 12 ? block_end - 12 : 0;
  const uint32_t limit_rel =
      limit > block_start ? (uint32_t)(limit - block_start) : 0;

  // ---- pass 1: cheap greedy scan for price statistics ------------------
  static thread_local Seq p1_seqs[BLOCK_MAX / 3 + 16];
  static thread_local uint8_t p1_lits[BLOCK_MAX + 16];
  OptCosts oc;
  {
    LevelCfg c1 = cfg;
    c1.strat = 0; c1.depth = 0; c1.lazy = 0; c1.ldm = false;
    c1.full_rep = true; c1.hlog = STAT_LOG;
    Tables t1{t.stat, nullptr, nullptr, nullptr, nullptr, nullptr, t.base};
    RepState rs1 = rs;                 // stats only; real state untouched
    uint32_t p1_lit = 0;
    uint32_t p1_n = find_sequences(src, block_start, block_end, lo_limit,
                                   c1, t1, rs1, p1_seqs,
                                   (uint32_t)(BLOCK_MAX / 3), p1_lits,
                                   &p1_lit);
    uint32_t clit[256] = {0};
    for (uint32_t i = 0; i < p1_lit; i++) clit[p1_lits[i]]++;
    uint32_t cll[36] = {0}, cml[53] = {0}, cof[32] = {0};
    for (uint32_t i = 0; i < p1_n; i++) {
      uint32_t x; int b;
      cll[ll_code(p1_seqs[i].lit_len, &x, &b)]++;
      cml[ml_code(p1_seqs[i].match_len, &x, &b)]++;
      cof[highbit32(p1_seqs[i].ofv)]++;
    }
    for (int i = 0; i < 256; i++)
      oc.lit[i] = bit_cost8(p1_lit, clit[i], 11 * 8);
    // +1 smoothing: codes the greedy pass never used stay plausible
    uint64_t sll = p1_n + 36, sml = p1_n + 53, sof = p1_n + 32;
    for (int i = 0; i < 36; i++)
      oc.llsym[i] = bit_cost8(sll, cll[i] + 1, 9 * 8);
    for (int i = 0; i < 53; i++)
      oc.mlsym[i] = bit_cost8(sml, cml[i] + 1, 9 * 8);
    for (int i = 0; i < 32; i++)
      oc.ofsym[i] = bit_cost8(sof, cof[i] + 1, 8 * 8);
  }

  // ---- pass 2: DP over positions ---------------------------------------
  // Iteration 1 collects chain/LDM candidates (cached per position) and
  // parses with the pass-1 prices; at deep levels a second DP re-runs on
  // the cached candidates with prices re-estimated from iteration 1's own
  // parse (btultra2-style refinement) — candidate search dominates cost,
  // so the refinement pass is nearly free.
  static thread_local OptNodes nd;
  static thread_local uint32_t cc_off[BLOCK_MAX][OPT_CACHE_K];
  static thread_local uint32_t cc_len[BLOCK_MAX][OPT_CACHE_K];
  static thread_local uint8_t cc_n[BLOCK_MAX];
  static thread_local uint32_t c3_off[BLOCK_MAX];   // hash3 candidate
  static thread_local uint32_t c3_len[BLOCK_MAX];
  static thread_local uint32_t bt_at[BLOCK_MAX / 3 + 16];
  static thread_local uint32_t bt_len[BLOCK_MAX / 3 + 16];
  static thread_local uint32_t bt_off[BLOCK_MAX / 3 + 16];

  const uint64_t suff = cfg.depth >= 2048 ? 512
                        : cfg.depth >= 1024 ? 128 : 64;
  const int iters = cfg.depth >= 1024 ? 3 : 2;
  uint32_t nbt = 0;

  // best parse across refinement iterations, judged by the ACTUAL encoded
  // block size (price models drift between iterations; trial-serializing
  // is cheap next to match finding and makes extra iterations monotone)
  static thread_local uint32_t bb_at[BLOCK_MAX / 3 + 16];
  static thread_local uint32_t bb_len[BLOCK_MAX / 3 + 16];
  static thread_local uint32_t bb_off[BLOCK_MAX / 3 + 16];
  static thread_local uint8_t trial_body[BLOCK_MAX + (BLOCK_MAX >> 2) + 4096];
  uint32_t best_nbt = 0;
  uint64_t best_sz = UINT64_MAX;

  for (int iter = 0; iter < iters; iter++) {
    for (uint32_t i = 0; i <= bsz; i++) nd.price[i] = OPT_INF;
    nd.price[0] = 0;
    nd.from[0] = -1;
    nd.mlen[0] = 0;
    nd.litlen[0] = 0;
    nd.rs[0] = rs;

    MatchCand mc[24];
    for (uint32_t p = 0; p < bsz; p++) {
      if (nd.price[p] >= OPT_INF) continue;
      const uint64_t pos = block_start + p;
      const int32_t base_price = nd.price[p];
      const uint32_t lp = nd.litlen[p];

      // literal step (incremental LL channel delta keeps paths comparable)
      {
        uint32_t lp1 = lp < 65535 ? lp + 1 : 65535;
        int32_t np = base_price + oc.lit[src[pos]]
                   + (int32_t)ll_price(oc, lp1) - (int32_t)ll_price(oc, lp);
        if (np < nd.price[p + 1]) {
          nd.price[p + 1] = np;
          nd.from[p + 1] = (int32_t)p;
          nd.mlen[p + 1] = 0;
          nd.litlen[p + 1] = (uint16_t)lp1;
          nd.rs[p + 1] = nd.rs[p];
        }
      }

      if (p >= limit_rel) continue;
      if (iter == 0) ldm_insert(src, pos, block_end, cfg, t);

      auto relax = [&](uint32_t off, uint32_t l_lo, uint32_t l_hi) {
        // price a window of lengths; for wide ranges only the extremes
        // matter (interior lengths are dominated by shorter-cheaper or
        // longer-reaches-farther) — bounded work on runs/long matches
        if (l_hi > bsz - p) l_hi = bsz - p;
        if (l_hi < l_lo) return;
        uint32_t lo_end = l_hi - l_lo >= 40 ? l_lo + 23 : l_hi;
        for (uint32_t pass = 0; pass < 2; pass++) {
          uint32_t a = pass == 0 ? l_lo : (lo_end >= l_hi - 15 ? l_hi + 1
                                                               : l_hi - 15);
          uint32_t b = pass == 0 ? lo_end : l_hi;
          for (uint32_t l = a; l <= b; l++) {
            RepState nrs = nd.rs[p];
            uint32_t ofv = offset_value(nrs, off, lp);
            int32_t np = base_price + (int32_t)ll_price(oc, lp)
                       + (int32_t)ml_price(oc, l)
                       + (int32_t)of_price(oc, ofv);
            uint32_t q = p + l;
            if (np < nd.price[q]) {
              nd.price[q] = np;
              nd.from[q] = (int32_t)p;
              nd.mlen[q] = l;
              nd.moff[q] = off;
              nd.litlen[q] = 0;
              nd.rs[q] = nrs;
            }
          }
        }
      };

      // repeat-offset candidates (distance view depends on lp; always
      // recomputed live — they are path-state-dependent and cheap)
      uint64_t rep_best = 0;
      {
        const RepState &prs = nd.rs[p];
        uint32_t cand_d[3];
        if (lp) {
          cand_d[0] = prs.r[0]; cand_d[1] = prs.r[1]; cand_d[2] = prs.r[2];
        } else {
          cand_d[0] = prs.r[1]; cand_d[1] = prs.r[2];
          cand_d[2] = prs.r[0] - 1;
        }
        for (int k = 0; k < 3; k++) {
          uint32_t d = cand_d[k];
          if (d == 0 || d > pos - lo_limit) continue;
          uint64_t m = extend_raw(src, pos - d, pos, block_end);
          if (m >= 3) {              // 3-byte rep matches are legal zstd
            relax(d, 3, (uint32_t)m);
            if (m > rep_best) rep_best = m;
          }
        }
      }

      // 3-byte hash probe (verified via extend_raw): the short-match mass
      // on quality-like streams that a 4-byte seed can never see
      if (iter == 0) {
        c3_len[p] = 0;
        uint32_t h3i = hash3_16(read32(src + pos));
        int64_t c3 = (int64_t)t.h3[h3i] - 1 + (int64_t)t.base;
        t.h3[h3i] = (int32_t)(pos - t.base + 1);
        uint64_t win3 = 1ull << cfg.wlog;
        uint64_t lo3 = pos > win3 ? pos - win3 : 0;
        if (lo3 < lo_limit) lo3 = lo_limit;
        if (c3 >= (int64_t)lo3 && c3 < (int64_t)pos) {
          uint64_t m3 = extend_raw(src, (uint64_t)c3, pos, block_end);
          if (m3 >= 3) {
            c3_off[p] = (uint32_t)(pos - (uint64_t)c3);
            c3_len[p] = (uint32_t)m3;
          }
        }
      }
      if (c3_len[p] >= 3 && c3_len[p] > rep_best)
        relax(c3_off[p], 3, c3_len[p]);

      // chain + LDM candidates: ascending (offset, length) frontier; for
      // candidate i only lengths above the previous frontier length are
      // not dominated by a nearer offset
      int nm;
      if (iter == 0) {
        nm = bt_matches(src, pos, block_end, lo_limit, cfg, t, mc, 24,
                        suff, rep_best);
        int keep = nm <= OPT_CACHE_K ? nm : OPT_CACHE_K;
        cc_n[p] = (uint8_t)keep;
        // cap: keep the nearest K-1 plus the longest (frontier tail)
        for (int i2 = 0; i2 < keep; i2++) {
          int s = (nm <= OPT_CACHE_K || i2 < keep - 1) ? i2 : nm - 1;
          cc_off[p][i2] = mc[s].off;
          cc_len[p][i2] = mc[s].len;
        }
      } else {
        nm = cc_n[p];
        for (int i2 = 0; i2 < nm; i2++) {
          mc[i2].off = cc_off[p][i2];
          mc[i2].len = cc_len[p][i2];
        }
      }
      uint32_t prev_len = cfg.mm > 1 ? cfg.mm - 1 : 1;
      for (int i2 = 0; i2 < nm; i2++) {
        if (mc[i2].len <= prev_len) continue;
        relax(mc[i2].off, prev_len + 1 < cfg.mm ? cfg.mm : prev_len + 1,
              mc[i2].len);
        prev_len = mc[i2].len;
      }
    }

    // backtrack this iteration's parse
    nbt = 0;
    {
      uint32_t q = bsz;
      while (q > 0) {
        if (nd.mlen[q] > 0) {
          bt_at[nbt] = (uint32_t)nd.from[q];
          bt_len[nbt] = nd.mlen[q];
          bt_off[nbt] = nd.moff[q];
          nbt++;
          q = (uint32_t)nd.from[q];
        } else {
          q--;
        }
      }
    }

    // trial-serialize: actual block bytes under this parse
    {
      static thread_local Seq tr_seqs[BLOCK_MAX / 3 + 16];
      static thread_local uint8_t tr_lits[BLOCK_MAX + 16];
      RepState rs_t = rs;
      uint64_t anchor_t = block_start;
      uint32_t tn = 0, tl = 0;
      for (uint32_t i = nbt; i-- > 0;) {
        uint64_t at = block_start + bt_at[i];
        uint32_t ll = (uint32_t)(at - anchor_t);
        std::memcpy(tr_lits + tl, src + anchor_t, ll);
        tl += ll;
        tr_seqs[tn].lit_len = ll;
        tr_seqs[tn].match_len = bt_len[i];
        tr_seqs[tn].ofv = offset_value(rs_t, bt_off[i], ll);
        tn++;
        anchor_t = at + bt_len[i];
      }
      std::memcpy(tr_lits + tl, src + anchor_t,
                  (size_t)(block_end - anchor_t));
      tl += (uint32_t)(block_end - anchor_t);
      uint64_t sz = write_compressed_block(tr_seqs, tn, tr_lits, tl, bsz,
                                           trial_body, sizeof(trial_body));
      uint64_t eff = sz ? sz : bsz;       // 0 => raw block wins
      if (eff < best_sz) {
        best_sz = eff;
        best_nbt = nbt;
        std::memcpy(bb_at, bt_at, nbt * sizeof(uint32_t));
        std::memcpy(bb_len, bt_len, nbt * sizeof(uint32_t));
        std::memcpy(bb_off, bt_off, nbt * sizeof(uint32_t));
      }
    }

    if (iter + 1 < iters) {
      // re-estimate prices from THIS parse's actual code streams
      uint32_t clit[256] = {0}, cll[36] = {0}, cml[53] = {0}, cof[32] = {0};
      uint64_t lit_total2 = 0;
      RepState rs2 = rs;
      uint64_t anchor2 = block_start;
      for (uint32_t i = nbt; i-- > 0;) {
        uint64_t at = block_start + bt_at[i];
        uint32_t ll = (uint32_t)(at - anchor2);
        for (uint32_t j = 0; j < ll; j++) clit[src[anchor2 + j]]++;
        lit_total2 += ll;
        uint32_t x; int b;
        cll[ll_code(ll, &x, &b)]++;
        cml[ml_code(bt_len[i], &x, &b)]++;
        cof[highbit32(offset_value(rs2, bt_off[i], ll))]++;
        anchor2 = at + bt_len[i];
      }
      for (uint64_t j = anchor2; j < block_end; j++) clit[src[j]]++;
      lit_total2 += block_end - anchor2;
      uint32_t nseq2 = nbt;
      for (int i = 0; i < 256; i++)
        oc.lit[i] = bit_cost8(lit_total2, clit[i], 11 * 8);
      uint64_t sll = nseq2 + 36, sml = nseq2 + 53, sof = nseq2 + 32;
      for (int i = 0; i < 36; i++)
        oc.llsym[i] = bit_cost8(sll, cll[i] + 1, 9 * 8);
      for (int i = 0; i < 53; i++)
        oc.mlsym[i] = bit_cost8(sml, cml[i] + 1, 9 * 8);
      for (int i = 0; i < 32; i++)
        oc.ofsym[i] = bit_cost8(sof, cof[i] + 1, 8 * 8);
    }
  }

  uint64_t anchor = block_start;
  uint32_t n = 0, lit_n = 0;
  for (uint32_t i = best_nbt; i-- > 0 && n < max_seqs;) {
    uint64_t at = block_start + bb_at[i];
    uint32_t ll = (uint32_t)(at - anchor);
    std::memcpy(literals + lit_n, src + anchor, ll);
    lit_n += ll;
    seqs[n].lit_len = ll;
    seqs[n].match_len = bb_len[i];
    seqs[n].ofv = offset_value(rs, bb_off[i], ll);
    n++;
    anchor = at + bb_len[i];
  }
  uint32_t tail = (uint32_t)(block_end - anchor);
  std::memcpy(literals + lit_n, src + anchor, tail);
  lit_n += tail;
  *lit_total = lit_n;
  return n;
}

// ---------------------------------------------------------------------------
// public API: compress `src` into ONE complete zstd frame
// ---------------------------------------------------------------------------

static uint64_t write_frame_header(uint8_t *dst, uint64_t n) {
  uint64_t w = 0;
  dst[w++] = 0x28; dst[w++] = 0xB5; dst[w++] = 0x2F; dst[w++] = 0xFD;
  // single-segment frames: Window_Size = Frame_Content_Size, so any offset
  // within the frame is legal (the reference decoder allows max window)
  if (n < 256) {
    dst[w++] = 0x20;
    dst[w++] = (uint8_t)n;
  } else if (n <= 65535 + 256) {
    dst[w++] = 0x60;
    uint64_t v = n - 256;
    dst[w++] = (uint8_t)v; dst[w++] = (uint8_t)(v >> 8);
  } else if (n <= 0xFFFFFFFFull) {
    dst[w++] = 0xA0;
    dst[w++] = (uint8_t)n; dst[w++] = (uint8_t)(n >> 8);
    dst[w++] = (uint8_t)(n >> 16); dst[w++] = (uint8_t)(n >> 24);
  } else {
    dst[w++] = 0xE0;
    for (int i = 0; i < 8; i++) dst[w++] = (uint8_t)(n >> (8 * i));
  }
  return w;
}

// Compress src[0, n) as a chain of zstd blocks appended at dst (which
// already holds any frame header).  `mark_last` sets the last-block bit on
// the final block; `rs` seeds the repeat-offset state (all-zero = "fresh
// part": rep coding stays off until real offsets establish the state on
// both sides, which makes the chain decodable after ANY predecessor —
// the invariant single-frame block stitching relies on).  Returns bytes
// appended, or UINT64_MAX on overflow.
static uint64_t compress_block_chain(const uint8_t *src, uint64_t n,
                                     uint8_t *dst, uint64_t dst_cap,
                                     LevelCfg cfg, RepState rs,
                                     int mark_last) {
  uint64_t w = 0;
  // tables (hash4 is thread-local; chains/ldm allocated when used)
  static thread_local int32_t tl_hash[1 << 20];
  if (cfg.hlog > 20) cfg.hlog = 20;
  Tables t{tl_hash, nullptr, nullptr, nullptr, nullptr, nullptr};
  std::memset(t.hash, 0, sizeof(int32_t) << cfg.hlog);
  int32_t *alloc_chain = nullptr, *alloc_ldm = nullptr,
          *alloc_stat = nullptr, *alloc_bt = nullptr;
  if (cfg.strat >= 1) {
    uint64_t ring = 1ull << cfg.clog;
    if (ring > n + 16) {               // don't over-allocate for small input
      int cl = cfg.clog;
      while (cl > 10 && (1ull << (cl - 1)) > n + 16) cl--;
      cfg.clog = cl;
      ring = 1ull << cl;
    }
    if (cfg.strat == 1) {
      alloc_chain = new int32_t[ring]();
      t.chain = alloc_chain;
    } else {
      alloc_bt = new int32_t[2 * ring]();
      t.bt = alloc_bt;
      alloc_stat = new int32_t[(1 << STAT_LOG) + (1 << 16)]();
      t.stat = alloc_stat;
      t.h3 = alloc_stat + (1 << STAT_LOG);
    }
  }
  if (cfg.ldm) {
    alloc_ldm = new int32_t[1 << LDM_LOG]();
    t.ldm = alloc_ldm;
  }

  // per-block scratch (worst case per 128K block)
  static thread_local Seq seqs[BLOCK_MAX / 3 + 16];
  static thread_local uint8_t literals[BLOCK_MAX + 16];
  static thread_local uint8_t body[BLOCK_MAX + (BLOCK_MAX >> 2) + 4096];

  uint64_t pos = 0;
  uint64_t lo_limit = 0;       // match-history floor (2 GB table reset)
  while (pos < n) {
    if (pos - lo_limit >= (1ull << 31) - (BLOCK_MAX * 2)) {
      // int32 position tables can't reach past 2 GB: reset history
      std::memset(t.hash, 0, sizeof(int32_t) << cfg.hlog);
      if (t.chain) std::memset(t.chain, 0, sizeof(int32_t) << cfg.clog);
      if (t.ldm) std::memset(t.ldm, 0, sizeof(int32_t) << LDM_LOG);
      if (t.stat) std::memset(t.stat, 0, sizeof(int32_t) << STAT_LOG);
      if (t.bt) std::memset(t.bt, 0, 2 * (sizeof(int32_t) << cfg.clog));
      if (t.h3) std::memset(t.h3, 0, sizeof(int32_t) << 16);
      lo_limit = pos;
      t.base = pos;             // new epoch: stored entries stay positive
    }
    uint64_t bsz = n - pos < BLOCK_MAX ? n - pos : BLOCK_MAX;
    int last = (pos + bsz == n && mark_last) ? 1 : 0;
    uint32_t lit_n = 0;
    RepState rs_block = rs;       // committed only if the block is kept
    uint32_t n_seqs =
        cfg.strat == 2
            ? find_sequences_opt(src, pos, pos + bsz, lo_limit, cfg, t,
                                 rs_block, seqs, (uint32_t)(BLOCK_MAX / 3),
                                 literals, &lit_n)
            : find_sequences(src, pos, pos + bsz, lo_limit, cfg, t,
                             rs_block, seqs, (uint32_t)(BLOCK_MAX / 3),
                             literals, &lit_n);
    uint64_t bodysz = write_compressed_block(seqs, n_seqs, literals, lit_n,
                                             bsz, body, sizeof(body));
    if (w + 3 + (bodysz ? bodysz : bsz) > dst_cap) {
      delete[] alloc_chain; delete[] alloc_ldm; delete[] alloc_stat;
      delete[] alloc_bt;
      return UINT64_MAX;
    }
    if (bodysz) {
      rs = rs_block;
      uint32_t hdr = (uint32_t)last | (2u << 1) | ((uint32_t)bodysz << 3);
      dst[w++] = (uint8_t)hdr; dst[w++] = (uint8_t)(hdr >> 8);
      dst[w++] = (uint8_t)(hdr >> 16);
      std::memcpy(dst + w, body, bodysz);
      w += bodysz;
    } else {
      // raw block: the decoder's rep state is NOT advanced by raw blocks,
      // so ours must stay at the pre-block value too (rs unchanged)
      uint32_t hdr = (uint32_t)last | (0u << 1) | ((uint32_t)bsz << 3);
      dst[w++] = (uint8_t)hdr; dst[w++] = (uint8_t)(hdr >> 8);
      dst[w++] = (uint8_t)(hdr >> 16);
      std::memcpy(dst + w, src + pos, bsz);
      w += bsz;
    }
    pos += bsz;
  }
  delete[] alloc_chain;
  delete[] alloc_ldm;
  delete[] alloc_stat;
  delete[] alloc_bt;
  return w;
}

// level: zstd-style (-131072 .. 22); window_log: 0 = by level, else 10..30
// (--long).  Returns frame length, 0 on overflow.
uint64_t naf_zstd_compress_ex(const uint8_t *src, uint64_t n,
                              uint8_t *dst, uint64_t dst_cap,
                              int32_t level, int32_t window_log) {
  fse_init_all();
  LevelCfg cfg = cfg_for(level, window_log);
  uint64_t w = write_frame_header(dst, n);
  if (n == 0) {
    dst[w++] = 0x01; dst[w++] = 0x00; dst[w++] = 0x00;
    return w;
  }
  uint64_t c = compress_block_chain(src, n, dst + w, dst_cap - w,
                                    cfg, RepState{}, 1);
  if (c == UINT64_MAX) return 0;
  return w + c;
}

// One PART of a stitched single frame: a bare zstd block chain with no
// frame header and no last-block bit, whose decode is independent of the
// decoder state at the stitch point — matches stay inside the part, rep
// state starts invalid (all-zero) so no sequence references the
// predecessor's rep offsets, and every block writes its own entropy tables
// (write_compressed_block never emits Repeat/Treeless modes).  The host
// stitches parts with stitch_section_frame (codec/zstd_backend.py) into
// ONE reference-decodable frame per section (SURVEY §2.4's block-data-
// parallel design; the reference decoder injects a single frame magic per
// section, unnaf/src/input.c:278, so per-part FRAMES are
// not an option).  Returns bytes written, 0 on overflow.
uint64_t naf_zstd_compress_part(const uint8_t *src, uint64_t n,
                                uint8_t *dst, uint64_t dst_cap,
                                int32_t level, int32_t window_log) {
  if (n == 0) return 0;
  fse_init_all();
  LevelCfg cfg = cfg_for(level, window_log);
  RepState rs;
  rs.r[0] = rs.r[1] = rs.r[2] = 0;
  uint64_t c = compress_block_chain(src, n, dst, dst_cap, cfg, rs, 0);
  return c == UINT64_MAX ? 0 : c;
}

// effective match-window log for (level, --long): the stitcher sizes the
// stitched frame's Window_Descriptor from min(max part, 1 << this)
int32_t naf_zstd_window_log_for(int32_t level, int32_t window_log) {
  return (int32_t)cfg_for(level, window_log).wlog;
}

// legacy entry (level 1); the caller-supplied scratch is accepted for ABI
// compatibility
uint64_t naf_zstd_compress(const uint8_t *src, uint64_t n,
                           uint8_t *dst, uint64_t dst_cap,
                           int32_t *scratch_table) {
  (void)scratch_table;
  return naf_zstd_compress_ex(src, n, dst, dst_cap, 1, 0);
}

uint64_t naf_zstd_scratch_bytes(void) { return sizeof(int32_t) << 17; }

// ---------------------------------------------------------------------------
// candidate-driven variant: the device kernel (ops/matchfind.py) proposes
// match candidates per position; this serializer verifies, extends, and
// packs — the host side of the device/host split from SURVEY §7 step 6.
// cand[p] holds up to K int32 candidate positions (closest-first, -1 = none)
// when stride K > 1, or one per position when K == 1.
// ---------------------------------------------------------------------------

// Estimated literal entropy (bits*8 per byte, clamped [8, 64]) of a span —
// the acceptance price for candidate matches.  Packed DNA nibble-pairs run
// ~4 bits/byte, so a 5-byte match at a 2^18 offset is a net LOSS vs
// literals; without this gate the greedy serializer drowns random regions
// in genuine-but-harmful short matches (16-value alphabet => 4-byte windows
// recur every ~64 KB by chance).
static uint32_t lit_entropy_x8(const uint8_t *src, uint64_t lo, uint64_t hi) {
  uint64_t count[256] = {0};
  uint64_t n = hi - lo;
  uint64_t step = n > (1 << 20) ? 16 : 1;    // sample large spans
  uint64_t total = 0;
  for (uint64_t i = lo; i < hi; i += step) { count[src[i]]++; total++; }
  if (total < 64) return 64;
  double h = 0.0;
  for (int s = 0; s < 256; s++) {
    if (!count[s]) continue;
    double p = (double)count[s] / (double)total;
    h -= p * std::log2(p);
  }
  int v = (int)(h * 8.0 + 0.5);
  return (uint32_t)(v < 8 ? 8 : v > 64 ? 64 : v);
}

static uint32_t find_sequences_cand(const uint8_t *src, const int32_t *cand,
                                    int32_t k_cand, uint64_t cand_lo,
                                    uint64_t block_start, uint64_t block_end,
                                    RepState &rs, uint32_t lit_h8,
                                    Seq *seqs, uint32_t max_seqs,
                                    uint8_t *literals, uint32_t *lit_total) {
  uint64_t pos = block_start, anchor = block_start;
  uint32_t n = 0, lit_n = 0;
  const uint64_t limit = block_end >= 12 ? block_end - 12 : 0;
  while (pos < limit && n < max_seqs) {
    uint32_t rep_d = 0;
    uint64_t m_rep = best_rep(src, pos, block_end, rs,
                              (uint32_t)(pos - anchor), &rep_d);
    if (m_rep * lit_h8 <= 14u * 8u) m_rep = 0;   // rep not worth a sequence
    uint64_t best = 0;
    uint32_t off = 0;
    int64_t best_sc = INT64_MIN;
    for (int32_t k = 0; k < k_cand; k++) {
      int64_t c = cand[(pos - cand_lo) * k_cand + k];
      if (c < 0 || (uint64_t)c >= pos) continue;
      uint64_t m = extend(src, (uint64_t)c, pos, block_end);
      if (m < 3) continue;
      // accept only if the match beats coding its bytes as literals:
      // ~24-bit sequence overhead + offset extra bits vs m * H(literals)
      uint32_t ofb = highbit32((uint32_t)(pos - (uint64_t)c) | 1);
      if (m * lit_h8 <= (24u + ofb) * 8u) continue;
      // price-aware pick: with deep chains a farther candidate one byte
      // longer must still beat the near one after offset-bit cost
      int64_t sc = (int64_t)(m * lit_h8) - (int64_t)(ofb * 8u);
      if (sc > best_sc) {
        best_sc = sc;
        best = m;
        off = (uint32_t)(pos - (uint64_t)c);
      }
    }
    if (m_rep >= 3 && m_rep + 1 >= best) {
      uint32_t ll = (uint32_t)(pos - anchor);
      std::memcpy(literals + lit_n, src + anchor, ll);
      lit_n += ll;
      seqs[n].lit_len = ll;
      seqs[n].match_len = (uint32_t)m_rep;
      seqs[n].ofv = offset_value(rs, rep_d, ll);
      n++;
      pos += m_rep; anchor = pos;
    } else if (best >= 5) {
      uint32_t ll = (uint32_t)(pos - anchor);
      std::memcpy(literals + lit_n, src + anchor, ll);
      lit_n += ll;
      seqs[n].lit_len = ll;
      seqs[n].match_len = (uint32_t)best;
      seqs[n].ofv = offset_value(rs, off, ll);
      n++;
      pos += best; anchor = pos;
    } else {
      pos++;
    }
  }
  uint32_t tail = (uint32_t)(block_end - anchor);
  std::memcpy(literals + lit_n, src + anchor, tail);
  lit_n += tail;
  *lit_total = lit_n;
  return n;
}

uint64_t naf_zstd_compress_cand_k(const uint8_t *src, uint64_t n,
                                  const int32_t *cand, int32_t k_cand,
                                  uint8_t *dst, uint64_t dst_cap) {
  fse_init_all();
  uint64_t w = write_frame_header(dst, n);
  if (n == 0) {
    dst[w++] = 0x01; dst[w++] = 0x00; dst[w++] = 0x00;
    return w;
  }
  static thread_local Seq seqs[BLOCK_MAX / 3 + 16];
  static thread_local uint8_t literals[BLOCK_MAX + 16];
  static thread_local uint8_t body[BLOCK_MAX + (BLOCK_MAX >> 2) + 4096];
  RepState rs;
  uint32_t lit_h8 = lit_entropy_x8(src, 0, n);
  uint64_t pos = 0;
  while (pos < n) {
    uint64_t bsz = n - pos < BLOCK_MAX ? n - pos : BLOCK_MAX;
    int last = (pos + bsz == n) ? 1 : 0;
    uint32_t lit_n = 0;
    RepState rs_block = rs;
    uint32_t n_seqs = find_sequences_cand(src, cand, k_cand, 0,
                                          pos, pos + bsz,
                                          rs_block, lit_h8, seqs,
                                          (uint32_t)(BLOCK_MAX / 3),
                                          literals, &lit_n);
    uint64_t bodysz = write_compressed_block(seqs, n_seqs, literals, lit_n,
                                             bsz, body, sizeof(body));
    if (w + 3 + (bodysz ? bodysz : bsz) > dst_cap) return 0;
    if (bodysz) {
      rs = rs_block;
      uint32_t hdr = (uint32_t)last | (2u << 1) | ((uint32_t)bodysz << 3);
      dst[w++] = (uint8_t)hdr; dst[w++] = (uint8_t)(hdr >> 8);
      dst[w++] = (uint8_t)(hdr >> 16);
      std::memcpy(dst + w, body, bodysz);
      w += bodysz;
    } else {
      uint32_t hdr = (uint32_t)last | ((uint32_t)bsz << 3);
      dst[w++] = (uint8_t)hdr; dst[w++] = (uint8_t)(hdr >> 8);
      dst[w++] = (uint8_t)(hdr >> 16);
      std::memcpy(dst + w, src + pos, bsz);
      w += bsz;
    }
    pos += bsz;
  }
  return w;
}

uint64_t naf_zstd_compress_cand(const uint8_t *src, uint64_t n,
                                const int32_t *cand,
                                uint8_t *dst, uint64_t dst_cap) {
  return naf_zstd_compress_cand_k(src, n, cand, 1, dst, dst_cap);
}

// Chunked candidate serializer: emits the compressed blocks covering
// [lo, hi) of a single frame over src[0..n).  `cand` holds k_cand ABSOLUTE
// candidate positions per row for positions [lo, hi) only, so the caller's
// candidate buffer is span-sized, not input-sized — the bounded-memory
// contract of `tnaf --engine device` (device proposes per-span, host
// serializes incrementally).  `rep` is the persistent uint32[3]
// repeat-offset state carried between calls (reset internally when
// lo == 0).  Writes the frame header when lo == 0, marks the final block
// when hi == n; `lo` must be a multiple of the 128 KB block size.
// Returns bytes written to dst, 0 on overflow / bad arguments.
uint64_t naf_zstd_compress_cand_stream(const uint8_t *src, uint64_t n,
                                       uint64_t lo, uint64_t hi,
                                       const int32_t *cand, int32_t k_cand,
                                       uint32_t *rep,
                                       uint8_t *dst, uint64_t dst_cap) {
  fse_init_all();
  uint64_t w = 0;
  if (lo == 0) {
    if (dst_cap < 32) return 0;
    w = write_frame_header(dst, n);
    rep[0] = 1; rep[1] = 4; rep[2] = 8;
    if (n == 0) {
      dst[w++] = 0x01; dst[w++] = 0x00; dst[w++] = 0x00;
      return w;
    }
  }
  if (hi > n || lo >= hi || (lo % BLOCK_MAX) != 0) return 0;
  static thread_local Seq seqs[BLOCK_MAX / 3 + 16];
  static thread_local uint8_t literals[BLOCK_MAX + 16];
  static thread_local uint8_t body[BLOCK_MAX + (BLOCK_MAX >> 2) + 4096];
  RepState rs;
  rs.r[0] = rep[0]; rs.r[1] = rep[1]; rs.r[2] = rep[2];
  uint32_t lit_h8 = lit_entropy_x8(src, lo, hi);
  uint64_t pos = lo;
  while (pos < hi) {
    uint64_t bsz = hi - pos < BLOCK_MAX ? hi - pos : BLOCK_MAX;
    int last = (pos + bsz == n) ? 1 : 0;
    uint32_t lit_n = 0;
    RepState rs_block = rs;
    uint32_t n_seqs = find_sequences_cand(src, cand, k_cand, lo,
                                          pos, pos + bsz,
                                          rs_block, lit_h8, seqs,
                                          (uint32_t)(BLOCK_MAX / 3),
                                          literals, &lit_n);
    uint64_t bodysz = write_compressed_block(seqs, n_seqs, literals, lit_n,
                                             bsz, body, sizeof(body));
    if (w + 3 + (bodysz ? bodysz : bsz) > dst_cap) return 0;
    if (bodysz) {
      rs = rs_block;
      uint32_t hdr = (uint32_t)last | (2u << 1) | ((uint32_t)bodysz << 3);
      dst[w++] = (uint8_t)hdr; dst[w++] = (uint8_t)(hdr >> 8);
      dst[w++] = (uint8_t)(hdr >> 16);
      std::memcpy(dst + w, body, bodysz);
      w += bodysz;
    } else {
      uint32_t hdr = (uint32_t)last | ((uint32_t)bsz << 3);
      dst[w++] = (uint8_t)hdr; dst[w++] = (uint8_t)(hdr >> 8);
      dst[w++] = (uint8_t)(hdr >> 16);
      std::memcpy(dst + w, src + pos, bsz);
      w += bsz;
    }
    pos += bsz;
  }
  rep[0] = rs.r[0]; rep[1] = rs.r[1]; rep[2] = rs.r[2];
  return w;
}

// ===========================================================================
// From-scratch zstd DECODER (RFC 8878) — the decode half of the native
// entropy stack.  Reference parity target: the reference's only third-party
// dependency covers both directions (unnaf/src/input.c:260-292 streaming
// decompression); this completes the framework-owns-its-core story the
// encoder above started.  Handles multi-frame streams, skippable frames,
// raw/RLE/compressed blocks, 1- and 4-stream Huffman literals (direct and
// FSE-compressed weights, treeless repeats), predefined/RLE/dynamic/repeat
// sequence tables, repeat offsets, and cross-block history within a frame.
// Fuzzed against library zstd in tests/test_native_engine.py.
// ===========================================================================

// ---- forward bit reader (FSE table descriptions, direct Huffman weights) --

struct FwdBits {
  const uint8_t *p;
  uint64_t nbytes;
  uint64_t pos = 0;                      // bit position

  inline uint32_t peek(int nb) const {
    uint64_t b0 = pos >> 3;
    uint64_t acc = 0;
    if (b0 + 8 <= nbytes) {                // hot path: one unaligned load
      std::memcpy(&acc, p + b0, 8);
    } else {
      for (int k = 0; k < 8; k++)
        if (b0 + k < nbytes) acc |= (uint64_t)p[b0 + k] << (8 * k);
    }
    return (uint32_t)((acc >> (pos & 7)) & (((uint64_t)1 << nb) - 1));
  }
  inline uint32_t read(int nb) {
    uint32_t v = peek(nb);
    pos += nb;
    return v;
  }
};

// ---- backward bit reader (Huffman streams, FSE streams, sequences) --------
// zstd bitstreams are written LSB-first and read back from the END; the last
// byte carries a 1-bit sentinel at its highest set position.  Reads past the
// logical start yield zero bits (the FSE tail convention); `bits` going
// negative past that marks corruption.

struct BackBits {
  const uint8_t *p;
  uint64_t nbytes;
  int64_t bits = -1;                     // payload bits remaining

  bool init() {
    if (nbytes == 0 || p[nbytes - 1] == 0) return false;   // no sentinel
    bits = (int64_t)(nbytes - 1) * 8 + highbit32(p[nbytes - 1]);
    return true;
  }
  inline uint32_t peek_at(int64_t at, int nb) const {
    if (nb == 0) return 0;
    int64_t b0 = at >> 3;                // arithmetic shift: floor for <0
    uint64_t acc = 0;
    if (b0 >= 0 && (uint64_t)(b0 + 8) <= nbytes) {   // one unaligned load
      std::memcpy(&acc, p + b0, 8);
    } else {
      for (int k = 0; k < 8; k++) {
        int64_t bi = b0 + k;
        if (bi >= 0 && (uint64_t)bi < nbytes)
          acc |= (uint64_t)p[bi] << (8 * k);
      }
    }
    int sh = (int)(at - (b0 << 3));      // 0..7
    return (uint32_t)((acc >> sh) & (((uint64_t)1 << nb) - 1));
  }
  inline uint32_t read(int nb) {         // consume nb bits from the top
    bits -= nb;
    return peek_at(bits, nb);
  }
  inline uint32_t peek(int nb) const { return peek_at(bits - nb, nb); }
};

// ---- FSE decode tables ----------------------------------------------------

struct FseDecEntry { uint16_t base; uint8_t sym; uint8_t nb; };

struct FseDec {
  FseDecEntry t[1 << FSE_MAX_LOG];
  int log = 0;
};

static bool fse_dec_build(const int16_t *norm, int n_sym, int tlog,
                          FseDec &d) {
  if (tlog > FSE_MAX_LOG || n_sym > 256) return false;
  int size = 1 << tlog;
  d.log = tlog;
  int high = size - 1;
  uint16_t sym_next[256];
  for (int s = 0; s < n_sym; s++) {
    if (norm[s] == -1) {
      if (high < 0) return false;
      d.t[high--].sym = (uint8_t)s;
      sym_next[s] = 1;
    } else {
      sym_next[s] = (uint16_t)norm[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < n_sym; s++)
    for (int i = 0; i < norm[s]; i++) {
      d.t[pos].sym = (uint8_t)s;
      do { pos = (pos + step) & mask; } while (pos > high);
    }
  if (pos != 0) return false;            // table description corrupt
  for (int i = 0; i < size; i++) {
    uint8_t s = d.t[i].sym;
    uint16_t c = sym_next[s]++;
    int nb = tlog - (c ? highbit32(c) : 0);
    d.t[i].nb = (uint8_t)nb;
    d.t[i].base = (uint16_t)(((uint32_t)c << nb) - size);
  }
  return true;
}

// NCount (FSE table description) reader -> normalized counts.  Returns bytes
// consumed from `p`, or -1 on corruption.  RFC 8878 §4.1.1.
static int64_t read_ncount(const uint8_t *p, uint64_t n, int16_t *norm,
                           int *n_sym_out, int *tlog_out, int max_log,
                           int max_sym) {
  if (n < 1) return -1;
  FwdBits fb{p, n};
  int acclog = (int)fb.read(4) + 5;
  if (acclog > max_log) return -1;
  int size = 1 << acclog;
  int remaining = size + 1;
  int threshold = size;
  int nbbits = acclog + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int rep;
      do {
        rep = (int)fb.read(2);
        for (int i = 0; i < rep && sym <= max_sym; i++) norm[sym++] = 0;
      } while (rep == 3 && sym <= max_sym);
      prev0 = false;
      continue;
    }
    int max = 2 * threshold - 1 - remaining;
    int val = (int)fb.peek(nbbits);
    int count;
    if ((val & (threshold - 1)) < max) {
      count = val & (threshold - 1);
      fb.pos += nbbits - 1;
    } else {
      count = val & (2 * threshold - 1);
      if (count >= threshold) count -= max;
      fb.pos += nbbits;
    }
    count--;                             // stored value is count+1; -1 = "<1"
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = (count == 0);
    while (remaining < threshold) { nbbits--; threshold >>= 1; }
  }
  if (remaining != 1 || fb.pos > n * 8) return -1;
  for (int s = sym; s <= max_sym; s++) norm[s] = 0;
  *n_sym_out = sym;
  *tlog_out = acclog;
  return (int64_t)((fb.pos + 7) >> 3);
}

// ---- Huffman decode table -------------------------------------------------

struct HufDec {
  // fused entry: symbol | nbits << 8 — one load per decoded symbol instead
  // of two dependent ones (the literals loop is the decoder's hot spot)
  uint16_t e[1 << HUF_MAX_BITS];
  // pair table (libzstd X2 idea): for short-code tables (maxbits <= 6)
  // index by 2*maxbits bits and emit TWO symbols per lookup — halves the
  // load->shift dependency chain the literals loop is bound by.
  // e2[v] = s1 | s2 << 8 | (nb1 + nb2) << 16; table <= 16 KiB (L1-resident)
  uint32_t e2[1 << 12];
  int log = 0;
  int log2x = 0;                         // 2 * log when the pair table is on
  bool valid = false;
};

// Build the single-level decode table from explicit weights (last weight
// implicit per spec).  `w` holds n explicit weights.
static bool huf_dec_build(const uint8_t *w, int n, HufDec &d) {
  if (n < 1 || n > 255) return false;
  uint32_t total = 0;
  int count[HUF_MAX_BITS + 2] = {0};
  for (int i = 0; i < n; i++) {
    if (w[i] > HUF_MAX_BITS) return false;
    if (w[i]) total += 1u << (w[i] - 1);
    count[w[i]]++;
  }
  if (total == 0) return false;
  int maxbits = highbit32(total) + 1;
  if (maxbits > HUF_MAX_BITS) return false;
  uint32_t rest = (1u << maxbits) - total;
  if (rest == 0 || (rest & (rest - 1))) return false;   // must be a power of 2
  int last_w = highbit32(rest) + 1;
  uint8_t wlast = (uint8_t)last_w;
  count[wlast]++;
  int n_sym = n + 1;

  // start offset per weight: weight w occupies 1 << (w-1) entries per symbol
  uint32_t start[HUF_MAX_BITS + 2];
  uint32_t cum = 0;
  for (int v = 1; v <= maxbits; v++) {
    start[v] = cum;
    cum += (uint32_t)count[v] << (v - 1);
  }
  if (cum != (1u << maxbits)) return false;
  for (int s = 0; s < n_sym; s++) {
    uint8_t ws = (s < n) ? w[s] : wlast;
    if (ws == 0) continue;
    uint32_t len = 1u << (ws - 1);
    uint16_t en = (uint16_t)(s | ((maxbits + 1 - ws) << 8));
    for (uint32_t i = 0; i < len; i++) d.e[start[ws] + i] = en;
    start[ws] += len;
  }
  d.log = maxbits;
  d.log2x = 0;
  if (maxbits <= 6) {
    int L = maxbits, mask1 = (1 << L) - 1;
    for (uint32_t v = 0; v < (1u << (2 * L)); v++) {
      uint16_t e1 = d.e[v >> L];
      int nb1 = e1 >> 8;
      uint16_t e2 = d.e[(v >> (L - nb1)) & mask1];
      d.e2[v] = (uint32_t)(uint8_t)e1 | ((uint32_t)(uint8_t)e2 << 8)
                | ((uint32_t)(nb1 + (e2 >> 8)) << 16);
    }
    d.log2x = 2 * L;
  }
  d.valid = true;
  return true;
}

// Huffman tree description -> weights -> table.  Returns bytes consumed or -1.
static int64_t huf_read_table(const uint8_t *p, uint64_t n, HufDec &d) {
  if (n < 1) return -1;
  uint8_t hb = p[0];
  uint8_t w[256];
  int nw;
  int64_t consumed;
  if (hb >= 128) {                       // direct 4-bit weights
    nw = hb - 127;
    uint64_t bytes = ((uint64_t)nw + 1) / 2;
    if (1 + bytes > n) return -1;
    for (int i = 0; i < nw; i++) {
      uint8_t b = p[1 + i / 2];
      w[i] = (i & 1) ? (b & 0xF) : (b >> 4);
    }
    consumed = 1 + (int64_t)bytes;
  } else {                               // FSE-compressed weights
    uint64_t csize = hb;
    if (1 + csize > n) return -1;
    int16_t norm[256];
    int nsym, tlog;
    int64_t hdr = read_ncount(p + 1, csize, norm, &nsym, &tlog, 6, 255);
    if (hdr < 0 || (uint64_t)hdr > csize) return -1;
    FseDec fd;
    if (!fse_dec_build(norm, nsym, tlog, fd)) return -1;
    BackBits bb{p + 1 + hdr, csize - (uint64_t)hdr};
    if (!bb.init()) return -1;
    uint32_t s1 = bb.read(fd.log), s2 = bb.read(fd.log);
    if (bb.bits < 0) return -1;
    nw = 0;
    // two interleaved states; when an update drains the stream the OTHER
    // state emits one final symbol (canonical FSE 2-state termination)
    while (nw < 254) {
      w[nw++] = fd.t[s1].sym;
      s1 = fd.t[s1].base + bb.read(fd.t[s1].nb);
      if (bb.bits < 0) { w[nw++] = fd.t[s2].sym; break; }
      w[nw++] = fd.t[s2].sym;
      s2 = fd.t[s2].base + bb.read(fd.t[s2].nb);
      if (bb.bits < 0) { w[nw++] = fd.t[s1].sym; break; }
    }
    if (nw >= 254 && bb.bits >= 0) return -1;   // weights overrun
    consumed = 1 + (int64_t)csize;
  }
  if (!huf_dec_build(w, nw, d)) return -1;
  return consumed;
}

// Decode one Huffman bitstream into exactly `count` bytes.
static bool huf_stream_decode(const uint8_t *p, uint64_t n, const HufDec &d,
                              uint8_t *out, uint32_t count) {
  BackBits bb{p, n};
  if (!bb.init()) return false;
  const int log = d.log;
  const uint32_t mask = (1u << log) - 1;
  uint32_t i = 0;
  // fast loop: one unaligned 8-byte window per ~4-5 symbols instead of the
  // per-symbol reload in peek_at (the decoder's dominant cost; same
  // word-at-a-time trick as the encoder's BitW)
  while (bb.bits >= 64 && i + 6 <= count) {
    // window [base, base+64) with base+64 >= bits guaranteed: the load
    // covers the top, and symbols decode until fewer than `log` bits of
    // window remain below the cursor (~4 symbols per load at log 11)
    int64_t b0 = (bb.bits >> 3) - 7;
    uint64_t acc;
    std::memcpy(&acc, p + b0, 8);
    const int64_t base = b0 << 3;
    const int64_t floor_bits = base + log;
    while (bb.bits >= floor_bits && i < count) {
      uint16_t en = d.e[(uint32_t)(acc >> (bb.bits - log - base)) & mask];
      out[i++] = (uint8_t)en;
      bb.bits -= en >> 8;
    }
  }
  for (; i < count; i++) {               // tail: bounds-checked path
    uint16_t en = d.e[bb.peek(log)];
    out[i] = (uint8_t)en;
    bb.bits -= en >> 8;
  }
  return bb.bits >= 0;
}

// Lockstep decode of the 4 literal streams: four independent dependency
// chains per iteration (the single-stream loop is latency-bound on the
// table lookup chain; interleaving is where libzstd's 4X speed lives).
static bool huf_stream_decode4(const uint8_t *q[4], const uint64_t qn[4],
                               const HufDec &d, uint8_t *outp[4],
                               const uint32_t cnt[4]) {
  BackBits bb[4] = {{q[0], qn[0]}, {q[1], qn[1]}, {q[2], qn[2]},
                    {q[3], qn[3]}};
  for (int k = 0; k < 4; k++)
    if (!bb[k].init()) return false;
  const int log = d.log;
  const uint32_t mask = (1u << log) - 1;
  const uint16_t *E = d.e;
  // named per-stream registers: an indexed acc[4]/cur[4] formulation makes
  // g++ spill the dependency chain to the stack, putting a store+load in
  // series with every symbol — named locals keep the four chains in
  // registers (the same reason libzstd's 4X loop is macro-unrolled)
  uint64_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  uint8_t *o0 = outp[0], *o1 = outp[1], *o2 = outp[2], *o3 = outp[3];
  // rounds per reload: 4 pair lookups (8 symbols, <= 48 bits) via the X2
  // table, 8 short-code symbols (log <= 7; 8*7 = 56 exactly fits the
  // usable window), or 4 tall ones (44 + 11 < 56)
  // every fast-loop iteration writes a fixed symbol block per stream
  // (8 for the pair/short paths, 4 tall); a stream shorter than that
  // margin must never enter the loop or later rounds overrun its output
  // slice (heap overflow on crafted tiny-count archives — found in the
  // round-5 review).  `o <= f` with f = o + cnt - margin then bounds
  // writes at cnt - margin + block <= cnt.
  const bool fast8 = cnt[0] >= 10 && cnt[1] >= 10 && cnt[2] >= 10 &&
                     cnt[3] >= 10;
  const bool fast4 = cnt[0] >= 6 && cnt[1] >= 6 && cnt[2] >= 6 &&
                     cnt[3] >= 6;
  if (d.log2x && fast8) {
    const int L2 = d.log2x;
    const uint32_t m2 = (1u << L2) - 1;
    const uint32_t *E2 = d.e2;
    const uint8_t *f0 = o0 + cnt[0] - 10;
    const uint8_t *f1 = o1 + cnt[1] - 10;
    const uint8_t *f2 = o2 + cnt[2] - 10;
    const uint8_t *f3 = o3 + cnt[3] - 10;
    while (bb[0].bits >= 64 && bb[1].bits >= 64 && bb[2].bits >= 64 &&
           bb[3].bits >= 64 && o0 <= f0 && o1 <= f1 && o2 <= f2 &&
           o3 <= f3) {
      int64_t b;
      b = (bb[0].bits >> 3) - 7; std::memcpy(&a0, q[0] + b, 8);
      c0 = bb[0].bits - (b << 3);
      b = (bb[1].bits >> 3) - 7; std::memcpy(&a1, q[1] + b, 8);
      c1 = bb[1].bits - (b << 3);
      b = (bb[2].bits >> 3) - 7; std::memcpy(&a2, q[2] + b, 8);
      c2 = bb[2].bits - (b << 3);
      b = (bb[3].bits >> 3) - 7; std::memcpy(&a3, q[3] + b, 8);
      c3 = bb[3].bits - (b << 3);
#define NZ_PSTEP(A, C, O)                                              \
  {                                                                    \
    uint32_t en = E2[(uint32_t)(A >> (C - L2)) & m2];                  \
    uint16_t two = (uint16_t)en;                                       \
    std::memcpy(O, &two, 2);                                           \
    O += 2;                                                            \
    C -= en >> 16;                                                     \
  }
#define NZ_PROUND NZ_PSTEP(a0, c0, o0) NZ_PSTEP(a1, c1, o1)            \
                  NZ_PSTEP(a2, c2, o2) NZ_PSTEP(a3, c3, o3)
      NZ_PROUND NZ_PROUND NZ_PROUND NZ_PROUND
#undef NZ_PROUND
#undef NZ_PSTEP
      bb[0].bits = (((bb[0].bits >> 3) - 7) << 3) + c0;
      bb[1].bits = (((bb[1].bits >> 3) - 7) << 3) + c1;
      bb[2].bits = (((bb[2].bits >> 3) - 7) << 3) + c2;
      bb[3].bits = (((bb[3].bits >> 3) - 7) << 3) + c3;
    }
  } else if (log <= 7 && fast8) {
    const uint8_t *f0 = o0 + cnt[0] - 10;
    const uint8_t *f1 = o1 + cnt[1] - 10;
    const uint8_t *f2 = o2 + cnt[2] - 10;
    const uint8_t *f3 = o3 + cnt[3] - 10;
    while (bb[0].bits >= 64 && bb[1].bits >= 64 && bb[2].bits >= 64 &&
           bb[3].bits >= 64 && o0 <= f0 && o1 <= f1 && o2 <= f2 &&
           o3 <= f3) {
      int64_t b;
      b = (bb[0].bits >> 3) - 7; std::memcpy(&a0, q[0] + b, 8);
      c0 = bb[0].bits - (b << 3);
      b = (bb[1].bits >> 3) - 7; std::memcpy(&a1, q[1] + b, 8);
      c1 = bb[1].bits - (b << 3);
      b = (bb[2].bits >> 3) - 7; std::memcpy(&a2, q[2] + b, 8);
      c2 = bb[2].bits - (b << 3);
      b = (bb[3].bits >> 3) - 7; std::memcpy(&a3, q[3] + b, 8);
      c3 = bb[3].bits - (b << 3);
#define NZ_STEP(A, C, O)                                               \
  {                                                                    \
    uint16_t en = E[(uint32_t)(A >> (C - log)) & mask];                \
    *O++ = (uint8_t)en;                                                \
    C -= en >> 8;                                                      \
  }
#define NZ_ROUND NZ_STEP(a0, c0, o0) NZ_STEP(a1, c1, o1)               \
                 NZ_STEP(a2, c2, o2) NZ_STEP(a3, c3, o3)
      NZ_ROUND NZ_ROUND NZ_ROUND NZ_ROUND
      NZ_ROUND NZ_ROUND NZ_ROUND NZ_ROUND
      bb[0].bits = (((bb[0].bits >> 3) - 7) << 3) + c0;
      bb[1].bits = (((bb[1].bits >> 3) - 7) << 3) + c1;
      bb[2].bits = (((bb[2].bits >> 3) - 7) << 3) + c2;
      bb[3].bits = (((bb[3].bits >> 3) - 7) << 3) + c3;
    }
  } else if (fast4) {
    const uint8_t *f0 = o0 + cnt[0] - 6;
    const uint8_t *f1 = o1 + cnt[1] - 6;
    const uint8_t *f2 = o2 + cnt[2] - 6;
    const uint8_t *f3 = o3 + cnt[3] - 6;
    while (bb[0].bits >= 64 && bb[1].bits >= 64 && bb[2].bits >= 64 &&
           bb[3].bits >= 64 && o0 <= f0 && o1 <= f1 && o2 <= f2 &&
           o3 <= f3) {
      int64_t b;
      b = (bb[0].bits >> 3) - 7; std::memcpy(&a0, q[0] + b, 8);
      c0 = bb[0].bits - (b << 3);
      b = (bb[1].bits >> 3) - 7; std::memcpy(&a1, q[1] + b, 8);
      c1 = bb[1].bits - (b << 3);
      b = (bb[2].bits >> 3) - 7; std::memcpy(&a2, q[2] + b, 8);
      c2 = bb[2].bits - (b << 3);
      b = (bb[3].bits >> 3) - 7; std::memcpy(&a3, q[3] + b, 8);
      c3 = bb[3].bits - (b << 3);
      NZ_ROUND NZ_ROUND NZ_ROUND NZ_ROUND
#undef NZ_ROUND
#undef NZ_STEP
      bb[0].bits = (((bb[0].bits >> 3) - 7) << 3) + c0;
      bb[1].bits = (((bb[1].bits >> 3) - 7) << 3) + c1;
      bb[2].bits = (((bb[2].bits >> 3) - 7) << 3) + c2;
      bb[3].bits = (((bb[3].bits >> 3) - 7) << 3) + c3;
    }
  }
  uint32_t i[4] = {(uint32_t)(o0 - outp[0]), (uint32_t)(o1 - outp[1]),
                   (uint32_t)(o2 - outp[2]), (uint32_t)(o3 - outp[3])};
  bool good = true;
  for (int k = 0; k < 4; k++) {
    for (; i[k] < cnt[k]; i[k]++) {
      uint16_t en = d.e[bb[k].peek(log)];
      outp[k][i[k]] = (uint8_t)en;
      bb[k].bits -= en >> 8;
    }
    good &= bb[k].bits >= 0;
  }
  return good;
}


// NAF_ZSTD_DEC_STATS=1: accumulate per-stage wall time + volume counters
// (stderr dump from naf_zstd_dec_stats_dump) — decode-path tuning aid only.
static thread_local uint64_t g_dec_ns_lits = 0, g_dec_ns_seq = 0;
static thread_local uint64_t g_dec_lit_bytes = 0, g_dec_nseq = 0,
    g_dec_match_bytes = 0;
static thread_local uint64_t g_dec_ns_table = 0, g_dec_lit1 = 0;
static bool dec_stats_on() {
  static int on = -1;
  if (on < 0) {
    const char *e = getenv("NAF_ZSTD_DEC_STATS");
    on = (e && *e == '1') ? 1 : 0;
  }
  return on == 1;
}
static inline uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}
bool nz_stats_on() { return dec_stats_on(); }
uint64_t nz_now_ns() { return now_ns(); }
extern "C" void naf_zstd_dec_stats_dump() {
  fprintf(stderr,
          "dec stats: lits %.1f ms (%llu B, %llu single-stream, table "
          "%.1f ms), seq %.1f ms (%llu seqs, %llu match B)\n",
          g_dec_ns_lits / 1e6, (unsigned long long)g_dec_lit_bytes,
          (unsigned long long)g_dec_lit1, g_dec_ns_table / 1e6,
          g_dec_ns_seq / 1e6, (unsigned long long)g_dec_nseq,
          (unsigned long long)g_dec_match_bytes);
  g_dec_ns_lits = g_dec_ns_seq = 0;
  g_dec_lit_bytes = g_dec_nseq = g_dec_match_bytes = 0;
  g_dec_ns_table = g_dec_lit1 = 0;
  fprintf(stderr, "enc stats: hist %.1f ms, huf streams %.1f ms\n",
          g_enc_ns_hist / 1e6, g_enc_ns_huf / 1e6);
  g_enc_ns_hist = g_enc_ns_huf = 0;
}

// ---- literals section -----------------------------------------------------

static const uint32_t LITS_MAX = 1u << 17;   // 128 KB block maximum

// Literals-section header fields (RFC 8878 sec 3.1.1.3.1).  ONE parse
// shared by decode_literals and the literal-only peek below — a divergence
// between two copies would fail valid archives outright.
struct LitHdr {
  int type;       // 0 raw, 1 RLE, 2 compressed, 3 treeless
  int streams;    // 1 or 4 (compressed/treeless only)
  uint32_t rsize; // regenerated size
  uint32_t csize; // compressed payload size (compressed/treeless)
  int64_t hdr;    // header bytes
};

static bool parse_lit_header(const uint8_t *p, uint64_t n, LitHdr &h) {
  if (n < 1) return false;
  uint8_t b0 = p[0];
  h.type = b0 & 3;
  int sf = (b0 >> 2) & 3;
  h.streams = 4;
  h.csize = 0;
  if (h.type <= 1) {
    if (sf == 0 || sf == 2) { h.rsize = b0 >> 3; h.hdr = 1; }
    else if (sf == 1) {
      if (n < 2) return false;
      h.rsize = (b0 >> 4) | ((uint32_t)p[1] << 4);
      h.hdr = 2;
    } else {
      if (n < 3) return false;
      h.rsize = (b0 >> 4) | ((uint32_t)p[1] << 4) | ((uint32_t)p[2] << 12);
      h.hdr = 3;
    }
    return true;
  }
  if (sf == 0 || sf == 1) {
    if (n < 3) return false;
    h.rsize = (b0 >> 4) | (((uint32_t)p[1] & 0x3F) << 4);
    h.csize = ((uint32_t)p[1] >> 6) | ((uint32_t)p[2] << 2);
    h.hdr = 3;
    if (sf == 0) h.streams = 1;
  } else if (sf == 2) {
    if (n < 4) return false;
    h.rsize = (b0 >> 4) | ((uint32_t)p[1] << 4)
              | (((uint32_t)p[2] & 3) << 12);
    h.csize = ((uint32_t)p[2] >> 2) | ((uint32_t)p[3] << 6);
    h.hdr = 4;
  } else {
    if (n < 5) return false;
    h.rsize = (b0 >> 4) | ((uint32_t)p[1] << 4)
              | (((uint32_t)p[2] & 0x3F) << 12);
    h.csize = ((uint32_t)p[2] >> 6) | ((uint32_t)p[3] << 2)
              | ((uint32_t)p[4] << 10);
    h.hdr = 5;
  }
  return true;
}

// Size in bytes of the whole literals section at `p` WITHOUT decoding it,
// or -1.  Lets decode_block peek the sequence count first and decode
// literal-only blocks straight into the destination.
static int64_t lits_section_size(const uint8_t *p, uint64_t n) {
  LitHdr h;
  if (!parse_lit_header(p, n, h)) return -1;
  if (h.type == 0) return h.hdr + h.rsize;
  if (h.type == 1) return h.hdr + 1;
  return h.hdr + h.csize;
}

// Decode the literals section at `p` (within a compressed block of size n).
// Fills `lits`/`lit_n` (writing at most `out_cap` bytes); updates the frame
// Huffman table.  Returns bytes consumed or -1.
static int64_t decode_literals(const uint8_t *p, uint64_t n, uint8_t *lits,
                               uint32_t *lit_n, HufDec &huf,
                               uint64_t out_cap = ~(uint64_t)0) {
  LitHdr lh;
  if (!parse_lit_header(p, n, lh)) return -1;
  if (lh.type <= 1) {                    // Raw / RLE
    uint32_t rsize = lh.rsize;
    int64_t hdr = lh.hdr;
    if (rsize > LITS_MAX || rsize > out_cap) return -1;
    if (lh.type == 0) {
      if ((uint64_t)hdr + rsize > n) return -1;
      std::memcpy(lits, p + hdr, rsize);
      *lit_n = rsize;
      return hdr + rsize;
    }
    if ((uint64_t)hdr + 1 > n) return -1;
    std::memset(lits, p[hdr], rsize);
    *lit_n = rsize;
    return hdr + 1;
  }

  // Compressed (2) / Treeless (3)
  int type = lh.type;
  uint32_t rsize = lh.rsize, csize = lh.csize;
  int64_t hdr = lh.hdr;
  int streams = lh.streams;
  if (rsize > LITS_MAX || rsize > out_cap || (uint64_t)hdr + csize > n)
    return -1;
  const uint8_t *q = p + hdr;
  uint64_t qn = csize;
  if (type == 2) {                       // new Huffman table
    uint64_t tt0 = dec_stats_on() ? now_ns() : 0;
    int64_t tree = huf_read_table(q, qn, huf);
    if (tt0) g_dec_ns_table += now_ns() - tt0;
    if (tree < 0 || (uint64_t)tree > qn) return -1;
    q += tree;
    qn -= tree;
  } else if (!huf.valid) {
    return -1;                           // treeless with no prior table
  }
  if (streams == 1) {
    if (!huf_stream_decode(q, qn, huf, lits, rsize)) return -1;
    g_dec_lit1 += rsize;
  } else {
    if (qn < 6) return -1;
    uint32_t s1 = q[0] | ((uint32_t)q[1] << 8);
    uint32_t s2 = q[2] | ((uint32_t)q[3] << 8);
    uint32_t s3 = q[4] | ((uint32_t)q[5] << 8);
    uint64_t rest = qn - 6;
    if ((uint64_t)s1 + s2 + s3 > rest) return -1;
    uint32_t r123 = (rsize + 3) / 4;
    if (3 * r123 > rsize) return -1;     // stream 4 must be non-negative
    const uint8_t *q1 = q + 6, *q2 = q1 + s1, *q3 = q2 + s2, *q4 = q3 + s3;
    uint64_t s4 = rest - s1 - s2 - s3;
    const uint8_t *qs[4] = {q1, q2, q3, q4};
    const uint64_t qns[4] = {s1, s2, s3, s4};
    uint8_t *outs[4] = {lits, lits + r123, lits + 2 * r123, lits + 3 * r123};
    const uint32_t cnts[4] = {r123, r123, r123, rsize - 3 * r123};
    if (!huf_stream_decode4(qs, qns, huf, outs, cnts)) return -1;
  }
  *lit_n = rsize;
  return hdr + csize;
}

// ---- sequences ------------------------------------------------------------

// full decode-side code tables (RFC 8878 §3.1.1.3.2.1.1)
static const uint32_t DLL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t DLL_BITS[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t DML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
    2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t DML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct DecFrameCtx {
  HufDec huf;
  FseDec ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
};

static FseDec g_pre_ll, g_pre_of, g_pre_ml;
static bool g_pre_ready = false;

static bool pre_tables_init() {
  if (g_pre_ready) return true;
  if (!fse_dec_build(LL_NORM, 36, LL_LOG, g_pre_ll)) return false;
  if (!fse_dec_build(OF_NORM, 29, OF_LOG, g_pre_of)) return false;
  if (!fse_dec_build(ML_NORM, 53, ML_LOG, g_pre_ml)) return false;
  g_pre_ready = true;
  return true;
}

// Set up one sequence channel's decode table per its 2-bit mode.  Returns
// bytes consumed from `p` or -1.
static int64_t setup_channel(int mode, const uint8_t *p, uint64_t n,
                             FseDec &d, bool &have, const FseDec &pre,
                             int max_log, int max_sym) {
  switch (mode) {
    case 0:                              // predefined
      d = pre;
      have = true;
      return 0;
    case 1: {                            // RLE: one byte = the only symbol
      if (n < 1 || p[0] > max_sym) return -1;
      d.log = 0;
      d.t[0].sym = p[0];
      d.t[0].nb = 0;
      d.t[0].base = 0;
      have = true;
      return 1;
    }
    case 2: {                            // FSE-compressed description
      int16_t norm[256];
      int nsym, tlog;
      int64_t hdr = read_ncount(p, n, norm, &nsym, &tlog, max_log, max_sym);
      if (hdr < 0) return -1;
      if (!fse_dec_build(norm, nsym, tlog, d)) return -1;
      have = true;
      return hdr;
    }
    default:                             // repeat previous table
      return have ? 0 : -1;
  }
}

// Decode one compressed block's content into dst at `pos`.  `frame_base` is
// the frame's first output offset (matches may not reach before it).
// Returns bytes written or -1.
static int64_t decode_block(const uint8_t *p, uint64_t n, uint8_t *dst,
                            uint64_t pos, uint64_t cap, uint64_t frame_base,
                            DecFrameCtx &fc) {
  static thread_local uint8_t lits[LITS_MAX + 64];
  uint32_t lit_n = 0;
  const bool st = dec_stats_on();
  uint64_t t0 = st ? now_ns() : 0;

  // literal-only fast path: peek the sequence count past the (undecoded)
  // literals section; nseq == 0 lets literals decode STRAIGHT into dst,
  // dropping the lits-buffer round trip (a full extra copy per block)
  int64_t lsec = lits_section_size(p, n);
  if (lsec >= 0 && (uint64_t)lsec < n && p[lsec] == 0) {
    int64_t used0 = decode_literals(p, n, dst + pos, &lit_n, fc.huf,
                                    cap - pos);
    if (st) {
      g_dec_ns_lits += now_ns() - t0;
      g_dec_lit_bytes += lit_n;
    }
    if (used0 != lsec) return -1;
    return (int64_t)lit_n;
  }

  int64_t used = decode_literals(p, n, lits, &lit_n, fc.huf);
  if (st) {
    g_dec_ns_lits += now_ns() - t0;
    g_dec_lit_bytes += lit_n;
    t0 = now_ns();
  }
  if (used < 0) return -1;
  p += used;
  n -= used;

  if (n < 1) return -1;
  uint32_t nseq;
  if (p[0] < 128) {
    nseq = p[0];
    p += 1; n -= 1;
  } else if (p[0] < 255) {
    if (n < 2) return -1;
    nseq = (((uint32_t)p[0] - 128) << 8) + p[1];
    p += 2; n -= 2;
  } else {
    if (n < 3) return -1;
    nseq = p[1] + ((uint32_t)p[2] << 8) + 0x7F00;
    p += 3; n -= 3;
  }

  uint64_t out = pos;
  if (nseq == 0) {                       // literals only
    if (out + lit_n > cap) return -1;
    std::memcpy(dst + out, lits, lit_n);
    return (int64_t)lit_n;
  }

  if (n < 1 || !pre_tables_init()) return -1;
  uint8_t modes = p[0];
  if (modes & 3) return -1;              // reserved bits must be zero
  p += 1; n -= 1;
  int64_t c;
  c = setup_channel((modes >> 6) & 3, p, n, fc.ll, fc.have_ll, g_pre_ll,
                    9, 35);
  if (c < 0) return -1;
  p += c; n -= c;
  c = setup_channel((modes >> 4) & 3, p, n, fc.of, fc.have_of, g_pre_of,
                    8, 31);
  if (c < 0) return -1;
  p += c; n -= c;
  c = setup_channel((modes >> 2) & 3, p, n, fc.ml, fc.have_ml, g_pre_ml,
                    9, 52);
  if (c < 0) return -1;
  p += c; n -= c;

  BackBits bb{p, n};
  if (!bb.init()) return -1;
  uint32_t s_ll = bb.read(fc.ll.log);
  uint32_t s_of = bb.read(fc.of.log);
  uint32_t s_ml = bb.read(fc.ml.log);
  if (bb.bits < 0) return -1;

  uint32_t lit_pos = 0;
  // windowed fast reads: one 8-byte load per <=56-bit read group instead
  // of a bounds-checked reload per field (the sequence loop was the
  // decoder's second bottleneck after Huffman literals)
  uint64_t w_acc = 0;
  int64_t w_base = 0;
  auto refill = [&]() {
    int64_t b0 = (bb.bits >> 3) - 7;
    std::memcpy(&w_acc, p + b0, 8);
    w_base = b0 << 3;
  };
  auto rdf = [&](int nb) -> uint32_t {
    bb.bits -= nb;
    return (uint32_t)(w_acc >> (bb.bits - w_base)) &
           (((uint32_t)1 << nb) - 1);
  };
  for (uint32_t i = 0; i < nseq; i++) {
    uint8_t ofc = fc.of.t[s_of].sym;
    uint8_t mlc = fc.ml.t[s_ml].sym;
    uint8_t llc = fc.ll.t[s_ll].sym;
    if (ofc > 31 || mlc > 52 || llc > 35) return -1;
    // bit order: OF, ML, LL extras (RFC 8878 §3.1.1.4), then the LL, ML,
    // OF state updates — the rep logic between them consumes no bits, so
    // both groups read together under one pair of window refills
    uint64_t ofv;
    uint32_t ml, ll;
    uint32_t ns_ll = s_ll, ns_ml = s_ml, ns_of = s_of;
    if (bb.bits >= 160) {
      refill();                          // group 1: <= 31+16 = 47 bits
      ofv = ((uint64_t)1 << ofc) + rdf(ofc);
      ml = DML_BASE[mlc] + rdf(DML_BITS[mlc]);
      refill();                          // group 2: <= 16+9+9+8 = 42 bits
      ll = DLL_BASE[llc] + rdf(DLL_BITS[llc]);
      if (i + 1 < nseq) {
        ns_ll = fc.ll.t[s_ll].base + rdf(fc.ll.t[s_ll].nb);
        ns_ml = fc.ml.t[s_ml].base + rdf(fc.ml.t[s_ml].nb);
        ns_of = fc.of.t[s_of].base + rdf(fc.of.t[s_of].nb);
      }
    } else {
      ofv = ((uint64_t)1 << ofc) + bb.read(ofc);
      ml = DML_BASE[mlc] + bb.read(DML_BITS[mlc]);
      ll = DLL_BASE[llc] + bb.read(DLL_BITS[llc]);
      if (i + 1 < nseq) {
        ns_ll = fc.ll.t[s_ll].base + bb.read(fc.ll.t[s_ll].nb);
        ns_ml = fc.ml.t[s_ml].base + bb.read(fc.ml.t[s_ml].nb);
        ns_of = fc.of.t[s_of].base + bb.read(fc.of.t[s_of].nb);
      }
    }
    if (bb.bits < 0) return -1;

    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      fc.rep[2] = fc.rep[1];
      fc.rep[1] = fc.rep[0];
      fc.rep[0] = (uint32_t)offset;
    } else {
      uint32_t idx = (uint32_t)ofv - 1 + (ll == 0 ? 1 : 0);   // 0..3
      if (idx == 0) {
        offset = fc.rep[0];
      } else {
        offset = (idx == 3) ? (uint64_t)fc.rep[0] - 1 : fc.rep[idx];
        if (offset == 0) return -1;
        if (idx == 1) {
          fc.rep[1] = fc.rep[0];
        } else {
          fc.rep[2] = fc.rep[1];
          fc.rep[1] = fc.rep[0];
        }
        fc.rep[0] = (uint32_t)offset;
      }
    }

    s_ll = ns_ll;                        // states were read above, in order
    s_ml = ns_ml;
    s_of = ns_of;

    // execute: literals then match copy (overlap-aware)
    if (lit_pos + ll > lit_n || out + ll + ml > cap) return -1;
    std::memcpy(dst + out, lits + lit_pos, ll);
    lit_pos += ll;
    out += ll;
    if (ml) {
      if (offset > out - frame_base) return -1;
      const uint8_t *msrc = dst + out - offset;
      uint8_t *mdst = dst + out;
      uint64_t rem = ml;
      if (offset >= 8) {
        // wide copy overshoots by up to 7 bytes — the `out + ll + ml`
        // bound above reserves cap headroom and later writes overwrite
        do {
          std::memcpy(mdst, msrc, 8);
          mdst += 8; msrc += 8;
        } while (rem > 8 && (rem -= 8));
      } else {
        // overlap (offset < 8): extend the pattern byte-wise to K = the
        // smallest multiple of the period >= 8, then wide copies at
        // distance K preserve the period — short rep matches on quality
        // streams otherwise decode byte-at-a-time with a mispredicted
        // branch per byte
        uint64_t K = offset;
        while (K < 8) K += offset;            // <= 14
        uint64_t head = rem < K ? rem : K;
        for (uint64_t i2 = 0; i2 < head; i2++) mdst[i2] = msrc[i2];
        if (rem > K) {
          uint8_t *w2 = mdst + K;
          const uint8_t *s2 = mdst;
          uint64_t done = K;
          while (done < rem) {
            std::memcpy(w2, s2, 8);
            w2 += 8; s2 += 8; done += 8;
          }
        }
      }
      out += ml;
    }
  }
  if (bb.bits < 0) return -1;
  uint32_t tail = lit_n - lit_pos;
  if (out + tail > cap) return -1;
  std::memcpy(dst + out, lits + lit_pos, tail);
  out += tail;
  if (st) {
    g_dec_ns_seq += now_ns() - t0;
    g_dec_nseq += nseq;
    g_dec_match_bytes += (out - pos) - lit_n;
  }
  return (int64_t)(out - pos);
}

// ---- frame / stream decode ------------------------------------------------

static const uint64_t DEC_ERR = ~(uint64_t)0;

// XXH64 (seed 0) for Content_Checksum verification — the dedicated
// algorithm zstd specifies (RFC 8878 §3.1.1; xxhash spec constants).
static const uint64_t XP1 = 0x9E3779B185EBCA87ull;
static const uint64_t XP2 = 0xC2B2AE3D27D4EB4Full;
static const uint64_t XP3 = 0x165667B19E3779F9ull;
static const uint64_t XP4 = 0x85EBCA77C2B2AE63ull;
static const uint64_t XP5 = 0x27D4EB2F165667C5ull;

static inline uint64_t xrotl(uint64_t v, int r) {
  return (v << r) | (v >> (64 - r));
}
static inline uint64_t xread64(const uint8_t *p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
static inline uint64_t xround(uint64_t acc, uint64_t input) {
  return xrotl(acc + input * XP2, 31) * XP1;
}
static inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * XP1 + XP4;
}

static uint64_t xxh64(const uint8_t *p, uint64_t len) {
  const uint8_t *end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = XP1 + XP2, v2 = XP2, v3 = 0, v4 = (uint64_t)0 - XP1;
    const uint8_t *lim = end - 32;
    do {
      v1 = xround(v1, xread64(p));
      v2 = xround(v2, xread64(p + 8));
      v3 = xround(v3, xread64(p + 16));
      v4 = xround(v4, xread64(p + 24));
      p += 32;
    } while (p <= lim);
    h = xrotl(v1, 1) + xrotl(v2, 7) + xrotl(v3, 12) + xrotl(v4, 18);
    h = xmerge(h, v1); h = xmerge(h, v2);
    h = xmerge(h, v3); h = xmerge(h, v4);
  } else {
    h = XP5;
  }
  h += len;
  while (p + 8 <= end) {
    h = xrotl(h ^ xround(0, xread64(p)), 27) * XP1 + XP4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    h = xrotl(h ^ ((uint64_t)v * XP1), 23) * XP2 + XP3;
    p += 4;
  }
  while (p < end) {
    h = xrotl(h ^ (*p * XP5), 11) * XP1;
    p++;
  }
  h ^= h >> 33; h *= XP2; h ^= h >> 29; h *= XP3; h ^= h >> 32;
  return h;
}

// Decode a complete stream of zstd frames (incl. skippable frames) into dst.
// Returns total bytes written, or UINT64_MAX on any parse error / overflow.
uint64_t naf_zstd_decompress(const uint8_t *src, uint64_t n,
                             uint8_t *dst, uint64_t cap) {
  uint64_t pos = 0, out = 0;
  while (pos < n) {
    if (n - pos < 4) return DEC_ERR;
    uint32_t magic = read32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {   // skippable frame
      if (n - pos < 8) return DEC_ERR;
      uint32_t sk = read32(src + pos + 4);
      if (n - pos < 8ull + sk) return DEC_ERR;
      pos += 8ull + sk;
      continue;
    }
    if (magic != 0xFD2FB528u) return DEC_ERR;
    pos += 4;

    if (pos >= n) return DEC_ERR;
    uint8_t fhd = src[pos++];
    int fcs_flag = fhd >> 6;
    bool single = (fhd >> 5) & 1;
    if (fhd & 0x08) return DEC_ERR;      // reserved bit
    bool checksum = (fhd >> 2) & 1;
    int did_flag = fhd & 3;

    uint64_t window = 0;
    if (!single) {
      if (pos >= n) return DEC_ERR;
      uint8_t wd = src[pos++];
      uint64_t base = 1ull << (10 + (wd >> 3));
      window = base + (base >> 3) * (wd & 7);
    }
    static const int DID_BYTES[4] = {0, 1, 2, 4};
    for (int i = 0; i < DID_BYTES[did_flag]; i++) {
      if (pos >= n) return DEC_ERR;
      if (src[pos++] != 0) return DEC_ERR;   // dictionaries unsupported
    }
    uint64_t fcs = 0;
    bool have_fcs = false;
    int fcs_bytes = (fcs_flag == 0) ? (single ? 1 : 0) : (1 << fcs_flag);
    if (fcs_bytes) {
      if (n - pos < (uint64_t)fcs_bytes) return DEC_ERR;
      for (int i = 0; i < fcs_bytes; i++)
        fcs |= (uint64_t)src[pos + i] << (8 * i);
      if (fcs_bytes == 2) fcs += 256;
      pos += fcs_bytes;
      have_fcs = true;
    }
    if (single) window = fcs;

    DecFrameCtx fc;
    uint64_t frame_base = out;
    uint64_t block_max = window && window < (128ull << 10) ? window
                                                           : (128ull << 10);
    bool last = false;
    while (!last) {
      if (n - pos < 3) return DEC_ERR;
      uint32_t bh = src[pos] | ((uint32_t)src[pos + 1] << 8)
                  | ((uint32_t)src[pos + 2] << 16);
      pos += 3;
      last = bh & 1;
      int btype = (bh >> 1) & 3;
      uint64_t bsize = bh >> 3;
      if (btype == 0) {                  // raw
        if (n - pos < bsize || out + bsize > cap) return DEC_ERR;
        std::memcpy(dst + out, src + pos, bsize);
        out += bsize;
        pos += bsize;
      } else if (btype == 1) {           // RLE
        if (pos >= n || out + bsize > cap) return DEC_ERR;
        std::memset(dst + out, src[pos], bsize);
        out += bsize;
        pos += 1;
      } else if (btype == 2) {           // compressed
        if (bsize > block_max + 32 || n - pos < bsize) return DEC_ERR;
        int64_t w = decode_block(src + pos, bsize, dst, out, cap,
                                 frame_base, fc);
        if (w < 0 || (uint64_t)w > block_max) return DEC_ERR;
        out += w;
        pos += bsize;
      } else {
        return DEC_ERR;
      }
    }
    if (checksum) {
      if (n - pos < 4) return DEC_ERR;
      uint32_t want = read32(src + pos);
      pos += 4;
      // Content_Checksum = low 32 bits of XXH64(content, 0) (RFC 8878
      // §3.1.1): verify, so length-preserving corruption is rejected like
      // a compliant decoder would (advisor finding r3)
      if ((uint32_t)xxh64(dst + frame_base, out - frame_base) != want)
        return DEC_ERR;
    }
    if (have_fcs && out - frame_base != fcs) return DEC_ERR;
  }
  return out;
}

}  // extern "C"
