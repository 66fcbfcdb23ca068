// naf_tpu_torch's copy of naf_tpu/native/naf_native.cpp — host-side hot loops.
//
// The device path (CUDA kernels under csrc/) handles device-resident data;
// this library is the *host runtime*: a fused
// single-pass FASTA/FASTQ scanner (classification + replacement + length
// accounting + case-mask RLE + 4-bit packing in one traversal) and fused
// decode renderers (nibble unpack + mask + line wrap + record assembly).
//
// Semantics replicate the reference NAF tools bug-for-bug (see
// naf_tpu/pipeline/parser.py for the commented spec and the file:line
// citations into the reference sources); the Python/numpy implementation is the
// oracle these loops are property-tested against.
//
// Plain C ABI (loaded with ctypes by native/host.py). All output buffers are
// caller-allocated with documented worst-case capacities.
//
// The original's multithreaded render (naf_render_mt) is left out: it drops
// the tail of the output on some inputs (three records of 700,007 chars at
// 8 threads end in NUL bytes).  The port renders on one host thread.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>
#include <algorithm>
#ifdef __AVX2__
#include <immintrin.h>
#endif

extern "C" {

// 64K pair-pack LUT: two ASCII chars -> one packed byte (lo nibble first)
static uint8_t g_pack_pair[65536];

// ---------------------------------------------------------------------------
// tables (built at init)
// ---------------------------------------------------------------------------

static uint8_t g_nuc_code[256];
static uint16_t g_codes_to_nucs_dna[256];
static uint16_t g_codes_to_nucs_rna[256];
static bool g_is_eol[256];
static bool g_is_space[256];
static bool g_unex_text[256];
static bool g_unex_comment[256];
static bool g_unex_qual[256];
static bool g_unex_by_type[4][256];
static bool g_tables_ready = false;

static const char DNA_CHARS[17] = "-TGKCYSBAWRDMHVN";

void naf_init_tables(void) {
  if (g_tables_ready) return;
  for (int i = 0; i < 256; i++) g_nuc_code[i] = 15;
  for (int code = 0; code < 16; code++) {
    unsigned char ch = (unsigned char)DNA_CHARS[code];
    g_nuc_code[ch] = (uint8_t)code;
    if (ch >= 'A' && ch <= 'Z') g_nuc_code[ch + 32] = (uint8_t)code;
  }
  g_nuc_code[(unsigned)'U'] = g_nuc_code[(unsigned)'T'];
  g_nuc_code[(unsigned)'u'] = g_nuc_code[(unsigned)'t'];

  for (int b = 0; b < 256; b++) {
    unsigned char lo = (unsigned char)DNA_CHARS[b & 15];
    unsigned char hi = (unsigned char)DNA_CHARS[b >> 4];
    g_codes_to_nucs_dna[b] = (uint16_t)(lo | (hi << 8));
    unsigned char lo_r = (b & 15) == 1 ? 'U' : lo;
    unsigned char hi_r = (b >> 4) == 1 ? 'U' : hi;
    g_codes_to_nucs_rna[b] = (uint16_t)(lo_r | (hi_r << 8));
  }

  for (int i = 0; i < 256; i++) {
    g_is_eol[i] = (i >= 0x0A && i <= 0x0D);
    g_is_space[i] = (i == 0x09 || (i >= 0x0A && i <= 0x0D) || i == 0x20);
    g_unex_text[i] = !((i >= 33 && i <= 126) || (i >= 128 && i <= 254));
    g_unex_comment[i] = !((i >= 32 && i <= 126) || (i >= 128 && i <= 254));
    g_unex_qual[i] = !(i >= 33 && i <= 126);
  }

  // nucleotide / protein alphabets
  const char *dna = "ABCDGHKMNRSTVWY";
  const char *rna = "ABCDGHKMNRSUVWY";
  for (int i = 0; i < 256; i++) {
    g_unex_by_type[0][i] = true;
    g_unex_by_type[1][i] = true;
    g_unex_by_type[2][i] = true;
    g_unex_by_type[3][i] = g_unex_text[i];
  }
  for (const char *p = dna; *p; p++) {
    g_unex_by_type[0][(unsigned char)*p] = false;
    g_unex_by_type[0][(unsigned char)(*p + 32)] = false;
  }
  for (const char *p = rna; *p; p++) {
    g_unex_by_type[1][(unsigned char)*p] = false;
    g_unex_by_type[1][(unsigned char)(*p + 32)] = false;
  }
  for (int c = 'A'; c <= 'Z'; c++) {
    g_unex_by_type[2][c] = false;
    g_unex_by_type[2][c + 32] = false;
  }
  g_unex_by_type[0][(unsigned)'-'] = false;
  g_unex_by_type[1][(unsigned)'-'] = false;
  g_unex_by_type[2][(unsigned)'-'] = false;
  g_unex_by_type[2][(unsigned)'*'] = false;

  for (int c2 = 0; c2 < 256; c2++)
    for (int c1 = 0; c1 < 256; c1++)
      g_pack_pair[c1 | (c2 << 8)] =
          (uint8_t)(g_nuc_code[c1] | (g_nuc_code[c2] << 4));
  g_tables_ready = true;
}

// ---------------------------------------------------------------------------
// scan result (shared by FASTA and FASTQ scanners)
// ---------------------------------------------------------------------------

// Error codes
enum {
  NAF_OK = 0,
  NAF_ERR_STRICT_ID = 1,
  NAF_ERR_STRICT_COMMENT = 2,
  NAF_ERR_STRICT_SEQ = 3,
  NAF_ERR_STRICT_QUAL = 4,
  NAF_ERR_FQ_NO_SEQ = 10,     // truncated: last sequence has no sequence data
  NAF_ERR_FQ_NO_QUAL = 11,    // truncated: last sequence has no quality
  NAF_ERR_FQ_NO_PLUS = 12,    // can't find '+' line
  NAF_ERR_FQ_NO_AT = 13,      // Can't find '@' after sequence
  NAF_ERR_FQ_LEN = 14,        // quality length mismatch
  NAF_ERR_FQ_NOT_WF = 15,     // not well-formed FASTQ input
};

// scan flags (streaming continuation support)
enum {
  NAF_F_CONT_SEQ = 1,        // resume mid-record in the SEQ state (FASTA)
  NAF_F_NO_MASK_FLUSH = 2,   // export the trailing mask run instead of flushing
  NAF_F_PACK_CARRY = 4,      // pack_carry_in holds a pending low nibble
  NAF_F_ALLOW_PARTIAL = 8,   // FASTQ: stop after last complete record
};

typedef struct {
  // caller-allocated outputs; capacities: seq,ids,comments,qual >= n + 2;
  // packed >= n/2 + 2; lengths >= n/2 + 2 entries; mask >= n + 2
  uint8_t *seq;        uint64_t seq_len;
  uint8_t *packed;     uint64_t packed_len;   // includes trailing parity byte
  uint8_t *ids;        uint64_t ids_len;      // '\0' after every record
  uint8_t *comments;   uint64_t comments_len;
  uint8_t *qual;       uint64_t qual_len;
  uint64_t *lengths;   uint64_t n_records;
  uint8_t *mask_units; uint64_t n_mask_units;
  uint64_t longest_line;
  uint64_t hist_id[257];
  uint64_t hist_comment[257];
  uint64_t hist_seq[257];
  uint64_t hist_qual[257];
  // error reporting
  int32_t error;
  uint64_t error_record;   // 1-based record number for the message
  uint32_t error_char;
  uint64_t error_a, error_b;  // lengths for the mismatch message
  // --- streaming carry state (inputs honored when `flags` bits set) -------
  int32_t flags;           // in: NAF_F_* bits
  int32_t prev_eol_in;     // in (CONT_SEQ): was the byte before this chunk EOL
  int32_t mask_on_in;      // in (CONT or chunk>0): current mask state
  uint64_t mask_run_in;    // in: carried run length
  uint64_t len_carry_in;   // in (CONT_SEQ): chars already in the open record
  uint64_t line_carry_in;  // in (CONT_SEQ): chars already on the open line
  uint32_t pack_carry_in;  // in (PACK_CARRY): pending low nibble (char parity odd)
  int32_t end_state;       // out: 0 done-at-record-boundary, 3 mid-sequence,
                           //      1 mid-id, 2 mid-comment (CONT unsupported)
  int32_t mask_tail_on;    // out (NO_MASK_FLUSH): trailing run state
  uint64_t mask_tail_run;  // out: trailing run length
  uint64_t consumed;       // out (ALLOW_PARTIAL): bytes up to last full record
  uint64_t end_line_len;   // out: chars on the line open at EOF
} NafScan;

// ---------------------------------------------------------------------------
// SIMD span classification: decompose a byte set into nibble lookups
// (simdjson-style pshufb set membership) so "find the next special byte"
// runs 32 bytes per step instead of 1.
// ---------------------------------------------------------------------------

struct SpanClass {
  bool ok = false;
  uint8_t lo[16], hi[16];
  // plain[c] true for unconditional data bytes; representable iff the
  // 16 high-nibble row patterns collapse to <= 8 distinct nonzero ones
  bool build(const bool *plain) {
    uint16_t rows[16] = {0};
    for (int c = 0; c < 256; c++)
      if (plain[c]) rows[c >> 4] |= (uint16_t)(1u << (c & 15));
    uint16_t pats[8];
    int np = 0;
    uint8_t rowbit[16] = {0};
    for (int h = 0; h < 16; h++) {
      if (!rows[h]) continue;
      int k = -1;
      for (int j = 0; j < np; j++)
        if (pats[j] == rows[h]) { k = j; break; }
      if (k < 0) {
        if (np == 8) { ok = false; return false; }
        pats[np] = rows[h];
        k = np++;
      }
      rowbit[h] = (uint8_t)(1u << k);
    }
    for (int h = 0; h < 16; h++) hi[h] = rowbit[h];
    for (int l = 0; l < 16; l++) {
      uint8_t m = 0;
      for (int j = 0; j < np; j++)
        if (pats[j] & (1u << l)) m |= (uint8_t)(1u << j);
      lo[l] = m;
    }
    ok = true;
    return true;
  }
};

// span finder with hoisted SIMD registers (one init per scanner run, not
// per line)
struct SpanScanner {
  const bool *plain = nullptr;
  bool simd = false;
#ifdef __AVX2__
  __m256i lo_v, hi_v;
#endif
  void init(const bool *p, const SpanClass &sc) {
    plain = p;
    simd = sc.ok;
#ifdef __AVX2__
    lo_v = _mm256_broadcastsi128_si256(
        _mm_loadu_si128((const __m128i *)sc.lo));
    hi_v = _mm256_broadcastsi128_si256(
        _mm_loadu_si128((const __m128i *)sc.hi));
#else
    simd = false;
#endif
  }
  // first index >= i with a special (non-plain) byte, or n
  inline uint64_t find(const uint8_t *data, uint64_t i, uint64_t n) const {
#ifdef __AVX2__
    if (simd) {
      const __m256i m0f = _mm256_set1_epi8(0x0F);
      const __m256i zero = _mm256_setzero_si256();
      while (i + 32 <= n) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(data + i));
        __m256i lm = _mm256_shuffle_epi8(lo_v, _mm256_and_si256(v, m0f));
        __m256i hm = _mm256_shuffle_epi8(
            hi_v, _mm256_and_si256(_mm256_srli_epi16(v, 4), m0f));
        uint32_t special = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(_mm256_and_si256(lm, hm), zero));
        if (special) return i + (uint64_t)__builtin_ctz(special);
        i += 32;
      }
    }
#endif
    while (i < n && plain[data[i]]) i++;
    return i;
  }
};

// mask RLE emitter
struct MaskState {
  bool on = false;
  uint64_t run = 0;
  uint8_t *units;
  uint64_t n = 0;
  inline void emit(uint64_t len) {
    while (len >= 255) { units[n++] = 255; len -= 255; }
    units[n++] = (uint8_t)len;
  }
  inline void push(uint8_t c) {
    bool lower = c >= 96;
    if (lower != on) { emit(run); run = 0; on = lower; }
    run++;
  }
  // bulk RLE over a span of sequence bytes; unsigned >= 96 test matches
  // the reference's `*c >= 96` for the full byte range (well-formed mode
  // spans can carry bytes >= 0x80)
  inline void span(const uint8_t *p, uint64_t len) {
    uint64_t k = 0;
#ifdef __AVX2__
    const __m256i t96 = _mm256_set1_epi8((char)96);
    for (; k + 32 <= len; k += 32) {
      __m256i v = _mm256_loadu_si256((const __m256i *)(p + k));
      uint32_t m = (uint32_t)_mm256_movemask_epi8(
          _mm256_cmpeq_epi8(_mm256_max_epu8(v, t96), v));
      if (m == 0) {                          // all unmasked
        if (on) { emit(run); run = 0; on = false; }
        run += 32;
        continue;
      }
      if (m == 0xFFFFFFFFu) {                // all masked
        if (!on) { emit(run); run = 0; on = true; }
        run += 32;
        continue;
      }
      uint32_t rem = 32;
      while (rem) {
        bool bit = (m & 1u) != 0;
        uint32_t x = bit ? ~m : m;
        uint32_t t = x ? (uint32_t)__builtin_ctz(x) : 32;
        if (t > rem) t = rem;
        if (bit != on) { emit(run); run = 0; on = bit; }
        run += t;
        m >>= t;
        rem -= t;
      }
    }
#endif
    while (k < len) {
      bool low = p[k] >= 96;
      if (low != on) { emit(run); run = 0; on = low; }
      uint64_t s = k;
      if (low) { while (k < len && p[k] >= 96) k++; }
      else     { while (k < len && p[k] <  96) k++; }
      run += k - s;
    }
  }
  inline void finish() {
    if (run > 0) { emit(run); run = 0; }
  }
};

struct PackState {
  uint8_t *out;
  uint64_t n = 0;
  bool parity = false;
  inline void push(uint8_t code) {
    if (parity) { out[n - 1] |= (uint8_t)(code << 4); parity = false; }
    else { out[n++] = code; parity = true; }
  }
  // bulk pack a span of chars.  `validated` spans contain only alphabet
  // bytes (robust mode already replaced everything else), so the IUPAC
  // code is a function of (row in {2,4,5,6,7}, low nibble) and vectorizes
  // with two pshufb tables; unvalidated (well-formed mode) spans use the
  // 64K pair LUT.
  inline void span(const uint8_t *p, uint64_t len, bool validated) {
    uint64_t k = 0;
    if (parity && len) { push(g_nuc_code[p[0]]); k = 1; }
#ifdef __AVX2__
    if (validated) {
      // lo-nibble code tables for rows 4/6 (A..O) and 5/7 (P.._)
      alignas(32) static const uint8_t TA[16] = {
          15, 8, 7, 4, 11, 15, 15, 2, 13, 15, 15, 3, 15, 12, 15, 15};
      alignas(32) static const uint8_t TB[16] = {
          15, 15, 10, 6, 1, 1, 14, 9, 15, 5, 15, 15, 15, 15, 15, 15};
      // row selector: 0xFF where high nibble is 5 or 7
      alignas(32) static const uint8_t SB[16] = {
          0, 0, 0, 0, 0, 0xFF, 0, 0xFF, 0, 0, 0, 0, 0, 0, 0, 0};
      // dash row (high nibble 2 => code 0)
      alignas(32) static const uint8_t DM[16] = {
          0xFF, 0xFF, 0, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
          0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF};
      const __m256i ta = _mm256_broadcastsi128_si256(
          _mm_load_si128((const __m128i *)TA));
      const __m256i tb = _mm256_broadcastsi128_si256(
          _mm_load_si128((const __m128i *)TB));
      const __m256i sb = _mm256_broadcastsi128_si256(
          _mm_load_si128((const __m128i *)SB));
      const __m256i dm = _mm256_broadcastsi128_si256(
          _mm_load_si128((const __m128i *)DM));
      const __m256i m0f = _mm256_set1_epi8(0x0F);
      const __m256i mff = _mm256_set1_epi16(0x00FF);
      auto codes_of = [&](__m256i v) {
        __m256i lo = _mm256_and_si256(v, m0f);
        __m256i hi = _mm256_and_si256(_mm256_srli_epi16(v, 4), m0f);
        __m256i ca = _mm256_shuffle_epi8(ta, lo);
        __m256i cb = _mm256_shuffle_epi8(tb, lo);
        __m256i sel = _mm256_shuffle_epi8(sb, hi);
        __m256i mask = _mm256_shuffle_epi8(dm, hi);
        return _mm256_and_si256(_mm256_blendv_epi8(ca, cb, sel), mask);
      };
      while (k + 64 <= len) {
        __m256i c0 = codes_of(_mm256_loadu_si256((const __m256i *)(p + k)));
        __m256i c1 = codes_of(
            _mm256_loadu_si256((const __m256i *)(p + k + 32)));
        __m256i w0 = _mm256_and_si256(
            _mm256_or_si256(c0, _mm256_srli_epi16(c0, 4)), mff);
        __m256i w1 = _mm256_and_si256(
            _mm256_or_si256(c1, _mm256_srli_epi16(c1, 4)), mff);
        __m256i r = _mm256_packus_epi16(w0, w1);
        r = _mm256_permute4x64_epi64(r, 0xD8);
        _mm256_storeu_si256((__m256i *)(out + n), r);
        n += 32;
        k += 64;
      }
    }
#else
    (void)validated;
#endif
    for (; k + 1 < len; k += 2) {
      uint16_t pair;
      std::memcpy(&pair, p + k, 2);          // little-endian load
      out[n++] = g_pack_pair[pair];
    }
    if (k < len) push(g_nuc_code[p[k]]);
  }
};

// ---------------------------------------------------------------------------
// FASTA scanner: data points at the byte AFTER the first '>' marker.
// seq_type: 0 dna, 1 rna, 2 protein, 3 text. 4-bit packing only for 0/1.
// ---------------------------------------------------------------------------

int32_t naf_scan_fasta(const uint8_t *data, uint64_t n, int32_t seq_type,
                       int32_t strict, int32_t well_formed, int32_t do_mask,
                       int32_t do_upper, NafScan *r) {
  naf_init_tables();
  const bool *unex_seq = g_unex_by_type[seq_type];
  bool unex_seq_text_fasta[256];
  if (seq_type == 3) {
    std::memcpy(unex_seq_text_fasta, g_unex_by_type[3], 256);
    unex_seq_text_fasta[(unsigned)'>'] = true;  // ennaf.c:478
    unex_seq = unex_seq_text_fasta;
  }
  const uint8_t repl = seq_type <= 1 ? 'N' : (seq_type == 2 ? 'X' : '?');
  const bool nuc = seq_type <= 1;
  const bool wf = well_formed != 0;

  // span fast path: bytes that are unconditionally sequence data.  Record
  // starts ('>' after EOL) are checked before span entry, and EOLs are never
  // plain, so no state transition can hide inside a span.
  bool plain_seq[256];
  for (int k = 0; k < 256; k++)
    plain_seq[k] = wf ? (k != '\n') : (!g_is_space[k] && !unex_seq[k]);
  if (!wf && seq_type == 3) plain_seq[(unsigned)'>'] = true;
  SpanClass sc_seq_cls;
  sc_seq_cls.build(plain_seq);
  SpanScanner sc_seq;
  sc_seq.init(plain_seq, sc_seq_cls);

  const int32_t fl = r->flags;
  MaskState mask; mask.units = r->mask_units;
  if (fl & NAF_F_NO_MASK_FLUSH) {
    mask.on = r->mask_on_in != 0;
    mask.run = r->mask_run_in;
  }
  PackState pack; pack.out = r->packed;
  if (fl & NAF_F_PACK_CARRY) {
    pack.out[0] = (uint8_t)(r->pack_carry_in & 0x0F);
    pack.n = 1;
    pack.parity = true;
  }
  uint64_t seq_n = 0, ids_n = 0, com_n = 0;
  uint64_t n_rec = 0;
  uint64_t cur_len = 0, line_len = 0, longest = 0;

  enum { ID, COMMENT, SEQ } state = ID;
  bool prev_eol = false;
  if (fl & NAF_F_CONT_SEQ) {
    state = SEQ;
    prev_eol = r->prev_eol_in != 0;
    cur_len = r->len_carry_in;
    line_len = r->line_carry_in;
  }

  auto push_seq = [&](uint8_t c, bool counted) {
    r->seq[seq_n++] = c;
    if (do_mask) mask.push(c);
    if (nuc) pack.push(g_nuc_code[c]);
    if (counted) { cur_len++; line_len++; }
  };

  uint64_t i = 0;
  for (; i < n; i++) {
    uint8_t c = data[i];
    switch (state) {
      case ID:
        if (wf ? (c == '\n' || c == ' ') : g_is_space[c]) {
          r->ids[ids_n++] = 0;
          bool eol = wf ? (c == '\n') : g_is_eol[c];
          if (eol) { r->comments[com_n++] = 0; state = SEQ; }
          else state = COMMENT;
        } else if (!wf && g_unex_text[c]) {
          r->hist_id[c]++;
          if (strict) { r->error = NAF_ERR_STRICT_ID; r->error_record = n_rec + 1; r->error_char = c; goto fail; }
          push_seq('?', false);   // reference quirk: goes to the seq stream
        } else {
          r->ids[ids_n++] = c;
        }
        break;
      case COMMENT:
        if (wf ? (c == '\n') : g_is_eol[c]) {
          r->comments[com_n++] = 0;
          state = SEQ;
        } else if (!wf && g_unex_comment[c]) {
          r->hist_comment[c]++;
          if (strict) { r->error = NAF_ERR_STRICT_COMMENT; r->error_record = n_rec + 1; r->error_char = c; goto fail; }
          r->comments[com_n++] = '?';
        } else {
          r->comments[com_n++] = c;
        }
        break;
      case SEQ:
        if (c == '>' && prev_eol) {
          // finalize record, start next
          r->lengths[n_rec++] = cur_len;
          cur_len = 0;
          state = ID;
        } else if (plain_seq[c]) {
          uint64_t j = sc_seq.find(data, i + 1, n);
          uint64_t len = j - i;
          std::memcpy(r->seq + seq_n, data + i, len);
          if (do_mask) mask.span(data + i, len);
          if (nuc) pack.span(data + i, len, !wf);
          seq_n += len; cur_len += len; line_len += len;
          i = j - 1;
          prev_eol = false;
          continue;
        } else if (wf ? (c == '\n') : g_is_eol[c]) {
          if (line_len > longest) longest = line_len;
          line_len = 0;
        } else if (!wf && g_is_space[c]) {
          // dropped
        } else if (wf) {
          push_seq(c, true);
        } else if (unex_seq[c]) {
          if (seq_type == 3 && c == '>') {
            push_seq(c, true);    // text keeps mid-line '>'
          } else {
            r->hist_seq[c]++;
            if (strict) { r->error = NAF_ERR_STRICT_SEQ; r->error_record = n_rec + 1; r->error_char = c; goto fail; }
            push_seq(repl, true);
          }
        } else {
          push_seq(c, true);
        }
        break;
    }
    prev_eol = wf ? (c == '\n') : g_is_eol[c];
  }

  // EOF
  if (state == ID) { r->ids[ids_n++] = 0; r->comments[com_n++] = 0; }
  else if (state == COMMENT) { r->comments[com_n++] = 0; }
  if (line_len > longest) longest = line_len;
  r->lengths[n_rec++] = cur_len;
  r->end_state = (int32_t)state;
  r->end_line_len = line_len;

  if (do_mask) {
    if (fl & NAF_F_NO_MASK_FLUSH) {
      r->mask_tail_on = mask.on ? 1 : 0;
      r->mask_tail_run = mask.run;
    } else {
      mask.finish();
    }
  }
  if (pack.parity) pack.parity = false;  // trailing low-nibble byte already in place

  if (do_upper && !nuc) {
    for (uint64_t k = 0; k < seq_n; k++) {
      uint8_t c = r->seq[k];
      if (c >= 'a' && c <= 'z') r->seq[k] = c - 32;
    }
  }

  r->seq_len = seq_n;
  r->packed_len = pack.n;
  r->ids_len = ids_n;
  r->comments_len = com_n;
  r->qual_len = 0;
  r->n_records = n_rec;
  r->n_mask_units = mask.n;
  r->longest_line = longest;
  r->error = NAF_OK;
  return NAF_OK;

fail:
  return r->error;
}

// ---------------------------------------------------------------------------
// Multithreaded FASTA scan.
//
// The input splits at record starts ('>' preceded by EOL), each chunk runs
// the single-thread scanner into chunk-local buffers, and the outputs merge:
// plain concatenation for seq/ids/comments/lengths (records never span
// chunks), nibble-shifted stitch for the packed stream (a chunk whose char
// prefix is odd re-aligns by one nibble), and run-carry merge for the mask
// RLE (boundary runs of equal case state coalesce).  This is the host-side
// twin of the device block pipeline's carry algebra (parallel/block.py).
//
// Any per-chunk error falls back to the sequential scanner so error messages
// and orderings match the reference exactly.
// ---------------------------------------------------------------------------

struct ChunkOut {
  NafScan r{};
  uint8_t *seq = nullptr, *packed = nullptr, *ids = nullptr,
          *comments = nullptr, *mask = nullptr, *qual = nullptr;
  uint64_t *lengths = nullptr;
  ~ChunkOut() {
    delete[] seq; delete[] packed; delete[] ids;
    delete[] comments; delete[] mask; delete[] qual; delete[] lengths;
  }
};

// append one run of `len` to the unit stream (255-continuation encoding)
static inline void emit_units(uint8_t *units, uint64_t &n, uint64_t len) {
  while (len >= 255) { units[n++] = 255; len -= 255; }
  units[n++] = (uint8_t)len;
}

int32_t naf_scan_fasta_mt(const uint8_t *data, uint64_t n, int32_t seq_type,
                          int32_t strict, int32_t well_formed,
                          int32_t do_mask, int32_t do_upper,
                          int32_t n_threads, NafScan *r) {
  naf_init_tables();
  const int32_t in_flags = r->flags;
  const bool ext_mask_carry = (in_flags & NAF_F_NO_MASK_FLUSH) != 0;
  const uint64_t carry_char = (in_flags & NAF_F_PACK_CARRY) ? 1 : 0;
  uint32_t T = (uint32_t)std::max(1, n_threads);
  uint32_t hw = std::thread::hardware_concurrency();
  if (hw) T = std::min(T, hw * 2);
  if (T <= 1 || n < (1 << 21))
    return naf_scan_fasta(data, n, seq_type, strict, well_formed, do_mask,
                          do_upper, r);

  // chunk boundaries at record starts
  const bool *eol_tab = g_is_eol;
  std::vector<uint64_t> cuts{0};
  for (uint32_t t = 1; t < T; t++) {
    uint64_t target = std::max((uint64_t)t * (n / T), cuts.back());
    uint64_t cut = n;
    const uint8_t *p = data + target;
    const uint8_t *end = data + n;
    while (p < end) {
      const uint8_t *gt = (const uint8_t *)memchr(p, '>', end - p);
      if (!gt) break;
      uint64_t idx = (uint64_t)(gt - data);
      bool prev_eol = idx > 0 &&
          (well_formed ? data[idx - 1] == '\n' : eol_tab[data[idx - 1]]);
      if (prev_eol) { cut = idx; break; }
      p = gt + 1;
    }
    if (cut > cuts.back() && cut < n) cuts.push_back(cut);
  }
  cuts.push_back(n);
  uint32_t C = (uint32_t)cuts.size() - 1;
  if (C <= 1)
    return naf_scan_fasta(data, n, seq_type, strict, well_formed, do_mask,
                          do_upper, r);

  std::vector<ChunkOut> outs(C);
  std::vector<int32_t> errs(C, 0);
  {
    std::vector<std::thread> th;
    for (uint32_t c = 0; c < C; c++) {
      th.emplace_back([&, c]() {
        uint64_t a = cuts[c], b = cuts[c + 1];
        // chunks after the first start AT their '>' marker byte
        const uint8_t *p = data + a + (c > 0 ? 1 : 0);
        uint64_t m = b - a - (c > 0 ? 1 : 0);
        ChunkOut &o = outs[c];
        o.seq = new uint8_t[m + 2];
        o.packed = new uint8_t[m / 2 + 2];
        o.ids = new uint8_t[m + 2];
        o.comments = new uint8_t[m + 2];
        o.mask = new uint8_t[do_mask ? m + 4 : 1];
        o.lengths = new uint64_t[m / 2 + 4];
        o.r.seq = o.seq; o.r.packed = o.packed; o.r.ids = o.ids;
        o.r.comments = o.comments; o.r.mask_units = o.mask;
        o.r.lengths = o.lengths;
        // inner chunks never flush their trailing mask run: the merge below
        // coalesces tails directly.  Record-structure carries (CONT_SEQ,
        // open-record length, line length) go to chunk 0 only; the mask and
        // pack carries are applied at merge time instead (a carried-in
        // masked state would break the alternating-group walk).
        o.r.flags = NAF_F_NO_MASK_FLUSH;
        if (c == 0 && (in_flags & NAF_F_CONT_SEQ)) {
          o.r.flags |= NAF_F_CONT_SEQ;
          o.r.prev_eol_in = r->prev_eol_in;
          o.r.len_carry_in = r->len_carry_in;
          o.r.line_carry_in = r->line_carry_in;
        }
        errs[c] = naf_scan_fasta(p, m, seq_type, strict, well_formed,
                                 do_mask, do_upper, &o.r);
      });
    }
    for (auto &x : th) x.join();
  }
  for (uint32_t c = 0; c < C; c++)
    if (errs[c] != 0)   // rare: rerun sequentially for exact error semantics
      return naf_scan_fasta(data, n, seq_type, strict, well_formed, do_mask,
                            do_upper, r);

  // ---- merge ------------------------------------------------------------
  std::vector<uint64_t> seq_off(C + 1), ids_off(C + 1), com_off(C + 1),
      len_off(C + 1);
  for (uint32_t c = 0; c < C; c++) {
    seq_off[c + 1] = seq_off[c] + outs[c].r.seq_len;
    ids_off[c + 1] = ids_off[c] + outs[c].r.ids_len;
    com_off[c + 1] = com_off[c] + outs[c].r.comments_len;
    len_off[c + 1] = len_off[c] + outs[c].r.n_records;
  }

  {
    std::vector<std::thread> th;
    for (uint32_t c = 0; c < C; c++) {
      th.emplace_back([&, c]() {
        const ChunkOut &o = outs[c];
        std::memcpy(r->seq + seq_off[c], o.seq, o.r.seq_len);
        std::memcpy(r->ids + ids_off[c], o.ids, o.r.ids_len);
        std::memcpy(r->comments + com_off[c], o.comments, o.r.comments_len);
        std::memcpy(r->lengths + len_off[c], o.lengths,
                    o.r.n_records * sizeof(uint64_t));
        // packed stitch: chunk char-offset parity decides alignment
        uint64_t off = carry_char + seq_off[c];
        uint64_t m = o.r.seq_len;
        if (m == 0) return;
        const uint8_t *src = o.packed;
        if ((off & 1) == 0) {
          uint8_t *dst = r->packed + off / 2;
          std::memcpy(dst, src, (m + 1) / 2);
        } else {
          // first char's nibble joins the previous chunk's last byte — done
          // serially after the join (that byte is written by another thread)
          uint8_t *dst = r->packed + off / 2 + 1;
          uint64_t rem = m - 1;           // chars after the first
          uint64_t full = rem / 2;
          for (uint64_t j = 0; j < full; j++)
            dst[j] = (uint8_t)((src[j] >> 4) | ((src[j + 1] & 0x0F) << 4));
          if (rem & 1) dst[full] = (uint8_t)(src[full] >> 4);
        }
      });
    }
    for (auto &x : th) x.join();
  }
  // serial boundary fixup: odd-offset chunks OR their first char's code into
  // the high nibble of the byte shared with the previous chunk
  if (carry_char)
    r->packed[0] = (uint8_t)(r->pack_carry_in & 0x0F);
  for (uint32_t c = 0; c < C; c++) {
    uint64_t off = carry_char + seq_off[c];
    if ((off & 1) == 0 || outs[c].r.seq_len == 0) continue;
    r->packed[off / 2] = (uint8_t)((r->packed[off / 2] & 0x0F) |
                                   ((outs[c].packed[0] & 0x0F) << 4));
  }
  // sequential: histograms, longest, counts
  std::memset(r->hist_id, 0, sizeof(r->hist_id));
  std::memset(r->hist_comment, 0, sizeof(r->hist_comment));
  std::memset(r->hist_seq, 0, sizeof(r->hist_seq));
  std::memset(r->hist_qual, 0, sizeof(r->hist_qual));
  uint64_t longest = 0;
  for (uint32_t c = 0; c < C; c++) {
    const NafScan &o = outs[c].r;
    for (int k = 0; k < 257; k++) {
      r->hist_id[k] += o.hist_id[k];
      r->hist_comment[k] += o.hist_comment[k];
      r->hist_seq[k] += o.hist_seq[k];
    }
    if (o.longest_line > longest) longest = o.longest_line;
  }

  // mask RLE carry merge: walk every chunk's run groups (states alternate
  // starting unmasked), coalescing equal-state boundary runs.  Zero-length
  // groups are pure state markers and are skipped; the canonical leading-0
  // unit of a stream that starts masked re-emerges naturally when the
  // initial (unmasked, 0) carry meets a masked first run.
  uint64_t mask_n = 0;
  bool mask_tail_on = false;
  uint64_t mask_tail_run = 0;
  if (do_mask) {
    bool carry_on = ext_mask_carry && r->mask_on_in != 0;
    uint64_t carry_len = ext_mask_carry ? r->mask_run_in : 0;
    auto take = [&](bool gon, uint64_t glen) {
      if (glen == 0) return;
      if (gon == carry_on) {
        carry_len += glen;
      } else {
        emit_units(r->mask_units, mask_n, carry_len);
        carry_on = gon; carry_len = glen;
      }
    };
    for (uint32_t c = 0; c < C; c++) {
      const uint8_t *u = outs[c].mask;
      uint64_t un = outs[c].r.n_mask_units;
      uint64_t i = 0;
      bool gon = false;
      while (i < un) {
        uint64_t glen = 0;
        while (i < un && u[i] == 255) { glen += 255; i++; }
        if (i < un) { glen += u[i]; i++; }
        take(gon, glen);
        gon = !gon;
      }
      take(outs[c].r.mask_tail_on != 0, outs[c].r.mask_tail_run);
    }
    if (ext_mask_carry) {
      mask_tail_on = carry_on;
      mask_tail_run = carry_len;
    } else if (carry_len > 0) {
      emit_units(r->mask_units, mask_n, carry_len);
    }
  }

  r->seq_len = seq_off[C];
  r->packed_len = (carry_char + seq_off[C] + 1) / 2;
  r->ids_len = ids_off[C];
  r->comments_len = com_off[C];
  r->qual_len = 0;
  r->n_records = len_off[C];
  r->n_mask_units = mask_n;
  r->longest_line = longest;
  r->mask_tail_on = mask_tail_on ? 1 : 0;
  r->mask_tail_run = mask_tail_run;
  r->end_state = outs[C - 1].r.end_state;
  r->end_line_len = outs[C - 1].r.end_line_len;
  r->error = NAF_OK;
  return NAF_OK;
}

// ---------------------------------------------------------------------------
// FASTQ scanner: data points at the byte AFTER the first '@' marker.
// ---------------------------------------------------------------------------

int32_t naf_scan_fastq(const uint8_t *data, uint64_t n, int32_t seq_type,
                       int32_t strict, int32_t well_formed, int32_t do_mask,
                       int32_t do_upper, NafScan *r) {
  naf_init_tables();
  const bool *unex_seq = g_unex_by_type[seq_type];
  const uint8_t repl = seq_type <= 1 ? 'N' : (seq_type == 2 ? 'X' : '?');
  const bool nuc = seq_type <= 1;
  const bool wf = well_formed != 0;
  const int32_t fl = r->flags;
  const bool allow_partial = (fl & NAF_F_ALLOW_PARTIAL) != 0;

  bool plain_seq[256], plain_qual[256];
  for (int k = 0; k < 256; k++) {
    plain_seq[k] = wf ? (k != '\n') : (!g_is_space[k] && !unex_seq[k]);
    plain_qual[k] = wf ? (k != '\n') : (!g_is_space[k] && !g_unex_qual[k]);
  }
  SpanClass sc_seq_cls, sc_qual_cls;
  sc_seq_cls.build(plain_seq);
  sc_qual_cls.build(plain_qual);
  SpanScanner sc_seq, sc_qual;
  sc_seq.init(plain_seq, sc_seq_cls);
  sc_qual.init(plain_qual, sc_qual_cls);

  MaskState mask; mask.units = r->mask_units;
  if (fl & NAF_F_NO_MASK_FLUSH) {
    mask.on = r->mask_on_in != 0;
    mask.run = r->mask_run_in;
  }
  PackState pack; pack.out = r->packed;
  if (fl & NAF_F_PACK_CARRY) {
    pack.out[0] = (uint8_t)(r->pack_carry_in & 0x0F);
    pack.n = 1;
    pack.parity = true;
  }
  uint64_t seq_n = 0, ids_n = 0, com_n = 0, qual_n = 0;
  uint64_t n_rec = 0;
  uint64_t read_len = 0, rec_qual_len = 0, longest = 0;

  // streaming snapshot: state at the end of the last complete record, plus
  // an unexpected-char event log so histogram updates can be deferred to
  // record completion (rewinding must not double-count the rescanned tail)
  struct Snap {
    bool valid = false;
    uint64_t pos = 0, seq_n = 0, qual_n = 0, ids_n = 0, com_n = 0, n_rec = 0;
    uint64_t mask_n = 0, mask_run = 0, pack_n = 0, longest = 0;
    bool mask_on = false, pack_parity = false;
  } snap;
  std::vector<std::pair<uint8_t, uint8_t>> ue_log;  // (stream, byte)
  enum { UE_ID = 0, UE_COM = 1, UE_SEQ = 2, UE_QUAL = 3 };
  auto note_unex = [&](int which, uint8_t c) {
    if (allow_partial) { ue_log.emplace_back((uint8_t)which, c); return; }
    switch (which) {
      case UE_ID: r->hist_id[c]++; break;
      case UE_COM: r->hist_comment[c]++; break;
      case UE_SEQ: r->hist_seq[c]++; break;
      default: r->hist_qual[c]++; break;
    }
  };
  auto flush_log = [&]() {
    for (auto &e : ue_log) switch (e.first) {
      case UE_ID: r->hist_id[e.second]++; break;
      case UE_COM: r->hist_comment[e.second]++; break;
      case UE_SEQ: r->hist_seq[e.second]++; break;
      default: r->hist_qual[e.second]++; break;
    }
    ue_log.clear();
  };
  auto snap_take = [&](uint64_t pos) {
    flush_log();
    snap.valid = true; snap.pos = pos;
    snap.seq_n = seq_n; snap.qual_n = qual_n; snap.ids_n = ids_n;
    snap.com_n = com_n; snap.n_rec = n_rec;
    snap.mask_n = mask.n; snap.mask_on = mask.on; snap.mask_run = mask.run;
    snap.pack_n = pack.n; snap.pack_parity = pack.parity;
    snap.longest = longest;
  };

  enum { ID, COMMENT, SEQ, PRE_PLUS, PLUS_SKIP, PRE_QUAL, QUAL, PRE_AT } state = ID;

  auto push_seq = [&](uint8_t c, bool counted) {
    r->seq[seq_n++] = c;
    if (do_mask) mask.push(c);
    if (nuc) pack.push(g_nuc_code[c]);
    if (counted) read_len++;
  };

  auto eol = [&](uint8_t c) { return wf ? (c == '\n') : g_is_eol[c]; };

  uint64_t i = 0;
  for (; i < n; i++) {
    uint8_t c = data[i];
    switch (state) {
      case ID:
        if (wf ? (c == '\n' || c == ' ') : g_is_space[c]) {
          r->ids[ids_n++] = 0;
          if (eol(c)) { r->comments[com_n++] = 0; state = SEQ; }
          else state = COMMENT;
        } else if (!wf && g_unex_text[c]) {
          note_unex(UE_ID, c);
          if (strict) { r->error = NAF_ERR_STRICT_ID; r->error_record = n_rec + 1; r->error_char = c; goto fail; }
          push_seq('?', false);
        } else {
          r->ids[ids_n++] = c;
        }
        break;
      case COMMENT:
        if (eol(c)) { r->comments[com_n++] = 0; state = SEQ; }
        else if (!wf && g_unex_comment[c]) {
          note_unex(UE_COM, c);
          if (strict) { r->error = NAF_ERR_STRICT_COMMENT; r->error_record = n_rec + 1; r->error_char = c; goto fail; }
          r->comments[com_n++] = '?';
        } else {
          r->comments[com_n++] = c;
        }
        break;
      case SEQ:
        if (plain_seq[c]) {
          uint64_t j = sc_seq.find(data, i + 1, n);
          uint64_t len = j - i;
          std::memcpy(r->seq + seq_n, data + i, len);
          if (do_mask) mask.span(data + i, len);
          if (nuc) pack.span(data + i, len, !wf);
          seq_n += len; read_len += len;
          i = j - 1;
        } else if (eol(c)) {
          if (read_len > longest) longest = read_len;
          state = PRE_PLUS;
        } else if (g_is_space[c]) {
          // dropped (robust mode; wf treats non-LF space as plain)
        } else {
          note_unex(UE_SEQ, c);
          if (strict) { r->error = NAF_ERR_STRICT_SEQ; r->error_record = n_rec + 1; r->error_char = c; goto fail; }
          push_seq(repl, true);
        }
        break;
      case PRE_PLUS:
        if (wf) {
          if (c != '+') { r->error = NAF_ERR_FQ_NOT_WF; goto fail; }
          if (i + 1 >= n) {
            if (allow_partial) goto partial;
            r->error = NAF_ERR_FQ_NOT_WF; goto fail;
          }
          if (data[i + 1] != '\n') { r->error = NAF_ERR_FQ_NOT_WF; goto fail; }
          i++;  // consume the '\n'
          state = PRE_QUAL;
          break;
        }
        if (g_is_eol[c]) break;  // skip empty lines
        if (c != '+') { r->error = NAF_ERR_FQ_NO_PLUS; r->error_record = n_rec + 1; goto fail; }
        state = PLUS_SKIP;
        break;
      case PLUS_SKIP:
        if (g_is_eol[c]) state = PRE_QUAL;
        break;
      case PRE_QUAL:
        if (wf) {
          // well-formed: quality starts immediately (may be an empty line)
          if (c == '\n') {
            rec_qual_len = 0;
            if (rec_qual_len != read_len) { r->error = NAF_ERR_FQ_LEN; r->error_record = n_rec + 1; r->error_a = rec_qual_len; r->error_b = read_len; goto fail; }
            r->lengths[n_rec++] = read_len;
            read_len = 0;
            state = PRE_AT;
            if (allow_partial) snap_take(i + 1);
          } else {
            r->qual[qual_n++] = c;
            rec_qual_len = 1;
            state = QUAL;
          }
          break;
        }
        if (g_is_eol[c]) break;  // skip empty lines
        r->qual[qual_n++] = c;   // first char verbatim (process.c:523)
        rec_qual_len = 1;
        state = QUAL;
        break;
      case QUAL:
        if (plain_qual[c]) {
          uint64_t j = sc_qual.find(data, i + 1, n);
          uint64_t len = j - i;
          std::memcpy(r->qual + qual_n, data + i, len);
          qual_n += len; rec_qual_len += len;
          i = j - 1;
        } else if (eol(c)) {
          if (rec_qual_len != read_len) { r->error = NAF_ERR_FQ_LEN; r->error_record = n_rec + 1; r->error_a = rec_qual_len; r->error_b = read_len; goto fail; }
          r->lengths[n_rec++] = read_len;
          read_len = 0; rec_qual_len = 0;
          state = PRE_AT;
          if (allow_partial) snap_take(i + 1);
        } else if (g_is_space[c]) {
          // dropped (robust mode; wf treats non-LF space as plain)
        } else {
          note_unex(UE_QUAL, c);
          if (strict) { r->error = NAF_ERR_STRICT_QUAL; r->error_record = n_rec + 1; r->error_char = c; goto fail; }
          r->qual[qual_n++] = '!';
          rec_qual_len++;
        }
        break;
      case PRE_AT:
        if (wf) {
          if (c != '@') { r->error = NAF_ERR_FQ_NOT_WF; goto fail; }
          state = ID;
          break;
        }
        if (g_is_eol[c]) break;
        if (c != '@') { r->error = NAF_ERR_FQ_NO_AT; r->error_record = n_rec; goto fail; }
        state = ID;
        break;
    }
  }

  // EOF handling
  if (allow_partial && state != PRE_AT) goto partial;
  switch (state) {
    case ID:
      r->ids[ids_n++] = 0; r->comments[com_n++] = 0;
      r->error = NAF_ERR_FQ_NO_SEQ; r->error_record = n_rec + 1; goto fail;
    case COMMENT:
      r->comments[com_n++] = 0;
      r->error = NAF_ERR_FQ_NO_SEQ; r->error_record = n_rec + 1; goto fail;
    case SEQ:
      if (read_len > longest) longest = read_len;
      r->error = NAF_ERR_FQ_NO_QUAL; r->error_record = n_rec + 1; goto fail;
    case PRE_PLUS:
    case PLUS_SKIP:
    case PRE_QUAL:
      r->error = wf ? NAF_ERR_FQ_NO_QUAL : NAF_ERR_FQ_NO_QUAL;
      r->error_record = n_rec + 1; goto fail;
    case QUAL:
      if (rec_qual_len != read_len) { r->error = NAF_ERR_FQ_LEN; r->error_record = n_rec + 1; r->error_a = rec_qual_len; r->error_b = read_len; goto fail; }
      r->lengths[n_rec++] = read_len;
      break;
    case PRE_AT:
      break;
  }

  flush_log();
  if (do_mask) {
    if (fl & NAF_F_NO_MASK_FLUSH) {
      r->mask_tail_on = mask.on ? 1 : 0;
      r->mask_tail_run = mask.run;
    } else {
      mask.finish();
    }
  }
  if (do_upper && !nuc) {
    for (uint64_t k = 0; k < seq_n; k++) {
      uint8_t c = r->seq[k];
      if (c >= 'a' && c <= 'z') r->seq[k] = c - 32;
    }
  }

  r->consumed = n;
  r->seq_len = seq_n;
  r->packed_len = pack.n;
  r->ids_len = ids_n;
  r->comments_len = com_n;
  r->qual_len = qual_n;
  r->n_records = n_rec;
  r->n_mask_units = mask.n;
  r->longest_line = longest;
  r->error = NAF_OK;
  return NAF_OK;

partial:
  // rewind to the last complete record; the caller rescans the tail
  if (!snap.valid) {
    // no complete record in this chunk: signal "need more data"
    r->consumed = 0;
    r->seq_len = 0; r->packed_len = (fl & NAF_F_PACK_CARRY) ? 1 : 0;
    r->ids_len = 0; r->comments_len = 0; r->qual_len = 0;
    r->n_records = 0; r->n_mask_units = 0; r->longest_line = 0;
    r->mask_tail_on = (fl & NAF_F_NO_MASK_FLUSH) ? (r->mask_on_in != 0) : 0;
    r->mask_tail_run = (fl & NAF_F_NO_MASK_FLUSH) ? r->mask_run_in : 0;
    r->error = NAF_OK;
    return NAF_OK;
  }
  ue_log.clear();
  if (snap.pack_parity && snap.pack_n > 0)
    pack.out[snap.pack_n - 1] &= 0x0F;   // later pushes OR'd into this byte
  r->consumed = snap.pos;
  r->seq_len = snap.seq_n;
  r->packed_len = snap.pack_n;
  r->ids_len = snap.ids_n;
  r->comments_len = snap.com_n;
  r->qual_len = snap.qual_n;
  r->n_records = snap.n_rec;
  r->n_mask_units = snap.mask_n;
  r->longest_line = snap.longest;
  r->mask_tail_on = snap.mask_on ? 1 : 0;
  r->mask_tail_run = snap.mask_run;
  if (do_upper && !nuc) {
    for (uint64_t k = 0; k < snap.seq_n; k++) {
      uint8_t c = r->seq[k];
      if (c >= 'a' && c <= 'z') r->seq[k] = c - 32;
    }
  }
  r->error = NAF_OK;
  return NAF_OK;

fail:
  r->seq_len = seq_n; r->packed_len = pack.n; r->ids_len = ids_n;
  r->comments_len = com_n; r->qual_len = qual_n; r->n_records = n_rec;
  r->n_mask_units = mask.n; r->longest_line = longest;
  return r->error;
}

// ---------------------------------------------------------------------------
// Multithreaded FASTQ scan.
//
// FASTQ record boundaries are ambiguous from bytes alone ('@' is a valid
// quality character), so the split is SPECULATIVE with a sound sequential
// verification: candidate cuts are "EOL then '@'" positions; every chunk
// scans with ALLOW_PARTIAL, and chunk t's parse is accepted only if the
// bytes after its last complete record are all EOL — which, by induction
// from chunk 0's trusted start, proves chunk t+1's '@' is a true record
// boundary.  Any mismatch or per-chunk error falls back to the sequential
// scanner (bit-exact reference error semantics).
// ---------------------------------------------------------------------------

int32_t naf_scan_fastq_mt(const uint8_t *data, uint64_t n, int32_t seq_type,
                          int32_t strict, int32_t well_formed,
                          int32_t do_mask, int32_t do_upper,
                          int32_t n_threads, NafScan *r) {
  naf_init_tables();
  const int32_t in_flags = r->flags;
  const bool ext_mask_carry = (in_flags & NAF_F_NO_MASK_FLUSH) != 0;
  const uint64_t carry_char = (in_flags & NAF_F_PACK_CARRY) ? 1 : 0;
  uint32_t T = (uint32_t)std::max(1, n_threads);
  uint32_t hw = std::thread::hardware_concurrency();
  if (hw) T = std::min(T, hw * 2);
  if (T <= 1 || n < (1 << 21) || (in_flags & NAF_F_ALLOW_PARTIAL))
    return naf_scan_fastq(data, n, seq_type, strict, well_formed, do_mask,
                          do_upper, r);

  // candidate cuts: '@' preceded by EOL; cut index = byte AFTER the '@'
  std::vector<uint64_t> cuts{0};
  for (uint32_t t = 1; t < T; t++) {
    uint64_t target = std::max((uint64_t)t * (n / T), cuts.back());
    uint64_t cut = n;
    const uint8_t *p = data + target;
    const uint8_t *end = data + n;
    while (p < end) {
      const uint8_t *at = (const uint8_t *)memchr(p, '@', end - p);
      if (!at) break;
      uint64_t idx = (uint64_t)(at - data);
      bool prev_eol = idx > 0 &&
          (well_formed ? data[idx - 1] == '\n' : g_is_eol[data[idx - 1]]);
      if (prev_eol && idx + 1 < n) { cut = idx + 1; break; }
      p = at + 1;
    }
    if (cut > cuts.back() && cut < n) cuts.push_back(cut);
  }
  cuts.push_back(n);
  uint32_t C = (uint32_t)cuts.size() - 1;
  if (C <= 1)
    return naf_scan_fastq(data, n, seq_type, strict, well_formed, do_mask,
                          do_upper, r);

  std::vector<ChunkOut> outs(C);
  std::vector<int32_t> errs(C, 0);
  {
    std::vector<std::thread> th;
    for (uint32_t c = 0; c < C; c++) {
      th.emplace_back([&, c]() {
        uint64_t a = cuts[c], b = cuts[c + 1];
        const uint8_t *p = data + a;
        uint64_t m = b - a;
        ChunkOut &o = outs[c];
        o.seq = new uint8_t[m + 2];
        o.packed = new uint8_t[m / 2 + 2];
        o.ids = new uint8_t[m + 2];
        o.comments = new uint8_t[m + 2];
        o.mask = new uint8_t[do_mask ? m + 4 : 1];
        o.lengths = new uint64_t[m / 4 + 4];
        o.qual = new uint8_t[m + 2];
        o.r.seq = o.seq; o.r.packed = o.packed; o.r.ids = o.ids;
        o.r.comments = o.comments; o.r.mask_units = o.mask;
        o.r.lengths = o.lengths; o.r.qual = o.qual;
        // the LAST chunk must consume to true EOF (reference truncation
        // errors); earlier chunks stop at their last complete record
        o.r.flags = NAF_F_NO_MASK_FLUSH
            | (c + 1 < C ? NAF_F_ALLOW_PARTIAL : 0);
        errs[c] = naf_scan_fastq(p, m, seq_type, strict, well_formed,
                                 do_mask, do_upper, &o.r);
      });
    }
    for (auto &x : th) x.join();
  }
  bool ok = true;
  for (uint32_t c = 0; c < C && ok; c++) {
    if (errs[c] != 0) ok = false;
  }
  // verification: bytes between chunk c's consumed point and its end must
  // be EOL-only (then the next cut's '@' is a true boundary)
  for (uint32_t c = 0; c + 1 < C && ok; c++) {
    uint64_t a = cuts[c];
    uint64_t tail_from = a + outs[c].r.consumed;
    uint64_t tail_to = cuts[c + 1] - 1;    // the '@' byte sits at cuts-1
    if (outs[c].r.n_records == 0) { ok = false; break; }
    for (uint64_t k = tail_from; k < tail_to; k++)
      if (!g_is_eol[data[k]]) { ok = false; break; }
  }
  if (!ok)   // speculative split unverified: sequential rescan (exact
             // reference error semantics; r keeps its original flags)
    return naf_scan_fastq(data, n, seq_type, strict, well_formed, do_mask,
                          do_upper, r);

  // ---- merge ------------------------------------------------------------
  std::vector<uint64_t> seq_off(C + 1), ids_off(C + 1), com_off(C + 1),
      len_off(C + 1), qual_off(C + 1);
  for (uint32_t c = 0; c < C; c++) {
    seq_off[c + 1] = seq_off[c] + outs[c].r.seq_len;
    ids_off[c + 1] = ids_off[c] + outs[c].r.ids_len;
    com_off[c + 1] = com_off[c] + outs[c].r.comments_len;
    len_off[c + 1] = len_off[c] + outs[c].r.n_records;
    qual_off[c + 1] = qual_off[c] + outs[c].r.qual_len;
  }
  {
    std::vector<std::thread> th;
    for (uint32_t c = 0; c < C; c++) {
      th.emplace_back([&, c]() {
        const ChunkOut &o = outs[c];
        std::memcpy(r->seq + seq_off[c], o.seq, o.r.seq_len);
        std::memcpy(r->ids + ids_off[c], o.ids, o.r.ids_len);
        std::memcpy(r->comments + com_off[c], o.comments, o.r.comments_len);
        std::memcpy(r->qual + qual_off[c], o.qual, o.r.qual_len);
        std::memcpy(r->lengths + len_off[c], o.lengths,
                    o.r.n_records * sizeof(uint64_t));
        uint64_t off = carry_char + seq_off[c];
        uint64_t m = o.r.seq_len;
        if (m == 0) return;
        const uint8_t *src = o.packed;
        if ((off & 1) == 0) {
          std::memcpy(r->packed + off / 2, src, (m + 1) / 2);
        } else {
          uint8_t *dst = r->packed + off / 2 + 1;
          uint64_t rem = m - 1;
          uint64_t full = rem / 2;
          for (uint64_t j = 0; j < full; j++)
            dst[j] = (uint8_t)((src[j] >> 4) | ((src[j + 1] & 0x0F) << 4));
          if (rem & 1) dst[full] = (uint8_t)(src[full] >> 4);
        }
      });
    }
    for (auto &x : th) x.join();
  }
  if (carry_char)
    r->packed[0] = (uint8_t)(r->pack_carry_in & 0x0F);
  for (uint32_t c = 0; c < C; c++) {
    uint64_t off = carry_char + seq_off[c];
    if ((off & 1) == 0 || outs[c].r.seq_len == 0) continue;
    r->packed[off / 2] = (uint8_t)((r->packed[off / 2] & 0x0F) |
                                   ((outs[c].packed[0] & 0x0F) << 4));
  }

  std::memset(r->hist_id, 0, sizeof(r->hist_id));
  std::memset(r->hist_comment, 0, sizeof(r->hist_comment));
  std::memset(r->hist_seq, 0, sizeof(r->hist_seq));
  std::memset(r->hist_qual, 0, sizeof(r->hist_qual));
  uint64_t longest = 0;
  for (uint32_t c = 0; c < C; c++) {
    const NafScan &o = outs[c].r;
    for (int k = 0; k < 257; k++) {
      r->hist_id[k] += o.hist_id[k];
      r->hist_comment[k] += o.hist_comment[k];
      r->hist_seq[k] += o.hist_seq[k];
      r->hist_qual[k] += o.hist_qual[k];
    }
    if (o.longest_line > longest) longest = o.longest_line;
  }

  uint64_t mask_n = 0;
  bool mask_tail_on = false;
  uint64_t mask_tail_run = 0;
  if (do_mask) {
    bool carry_on = ext_mask_carry && r->mask_on_in != 0;
    uint64_t carry_len = ext_mask_carry ? r->mask_run_in : 0;
    auto take = [&](bool gon, uint64_t glen) {
      if (glen == 0) return;
      if (gon == carry_on) {
        carry_len += glen;
      } else {
        emit_units(r->mask_units, mask_n, carry_len);
        carry_on = gon; carry_len = glen;
      }
    };
    for (uint32_t c = 0; c < C; c++) {
      const uint8_t *u = outs[c].mask;
      uint64_t un = outs[c].r.n_mask_units;
      uint64_t i = 0;
      bool gon = false;
      while (i < un) {
        uint64_t glen = 0;
        while (i < un && u[i] == 255) { glen += 255; i++; }
        if (i < un) { glen += u[i]; i++; }
        take(gon, glen);
        gon = !gon;
      }
      take(outs[c].r.mask_tail_on != 0, outs[c].r.mask_tail_run);
    }
    if (ext_mask_carry) {
      mask_tail_on = carry_on;
      mask_tail_run = carry_len;
    } else if (carry_len > 0) {
      emit_units(r->mask_units, mask_n, carry_len);
    }
  }

  r->seq_len = seq_off[C];
  r->packed_len = (carry_char + seq_off[C] + 1) / 2;
  r->ids_len = ids_off[C];
  r->comments_len = com_off[C];
  r->qual_len = qual_off[C];
  r->n_records = len_off[C];
  r->n_mask_units = mask_n;
  r->longest_line = longest;
  r->mask_tail_on = mask_tail_on ? 1 : 0;
  r->mask_tail_run = mask_tail_run;
  r->consumed = n;
  r->error = NAF_OK;
  return NAF_OK;
}

// ---------------------------------------------------------------------------
// Decode: fused 4-bit unpack + mask + per-record line wrap + header assembly
// ---------------------------------------------------------------------------

// render modes
enum { MODE_FASTA = 0, MODE_SEQUENCES = 1, MODE_SEQ = 2, MODE_CHARCOUNT = 3,
       MODE_FASTQ = 4 };

// Materialize the full character stream: bulk nibble unpack (or raw copy +
// optional uppercase), then lowercase the masked runs span-wise.  The span
// walk reproduces MaskReader's clamp semantics exactly: a run is consecutive
// 255-units plus their terminator; the state only toggles when another unit
// follows; leftover characters keep the last run's state.
struct MaskSpans {
  std::vector<uint64_t> starts, ends;   // masked char spans, clipped
};

static void build_mask_spans(const uint8_t *units, uint64_t n_units,
                             uint64_t total, MaskSpans &ms) {
  bool on = false;
  uint64_t pos = 0, i = 0;
  while (i < n_units && pos < total) {
    uint64_t run = 0;
    while (i < n_units && units[i] == 255) { run += 255; i++; }
    if (i < n_units) { run += units[i]; i++; }
    uint64_t end = std::min(pos + run, total);
    if (on && end > pos) { ms.starts.push_back(pos); ms.ends.push_back(end); }
    pos += run;
    if (i < n_units) on = !on;
  }
  if (on && pos < total) { ms.starts.push_back(pos); ms.ends.push_back(total); }
}

static void materialize_range(uint8_t *buf, const uint8_t *seq_data,
                              uint64_t base, uint64_t a, uint64_t b,
                              bool packed, bool rna,
                              bool upper, const MaskSpans &ms) {
  // decode stream chars [a, b) (a even) into buf[a - base ...]; `base` is
  // the stream offset of buf[0], so no pointer ever leaves the allocation
  // (a full-array caller passes base = 0, the tiled caller base = t_base)
  if (packed) {
    const uint16_t *lut = rna ? g_codes_to_nucs_rna : g_codes_to_nucs_dna;
    const uint8_t *src = seq_data + (a >> 1);
    uint8_t *dst = buf + (a - base);
    uint64_t n_pairs = (b - a) / 2;
    uint64_t i = 0;
#ifdef __AVX2__
    {
      alignas(32) uint8_t c2c[16];
      for (int c = 0; c < 16; c++)
        c2c[c] = (uint8_t)(lut[c] & 0xFF);     // code -> char
      const __m256i tab = _mm256_broadcastsi128_si256(
          _mm_load_si128((const __m128i *)c2c));
      const __m256i m0f = _mm256_set1_epi8(0x0F);
      for (; i + 32 <= n_pairs; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(src + i));
        __m256i lo = _mm256_shuffle_epi8(tab, _mm256_and_si256(v, m0f));
        __m256i hi = _mm256_shuffle_epi8(
            tab, _mm256_and_si256(_mm256_srli_epi16(v, 4), m0f));
        __m256i x = _mm256_unpacklo_epi8(lo, hi);
        __m256i y = _mm256_unpackhi_epi8(lo, hi);
        _mm256_storeu_si256((__m256i *)(dst + 2 * i),
                            _mm256_permute2x128_si256(x, y, 0x20));
        _mm256_storeu_si256((__m256i *)(dst + 2 * i + 32),
                            _mm256_permute2x128_si256(x, y, 0x31));
      }
    }
#endif
    for (; i < n_pairs; i++) {
      uint16_t v = lut[src[i]];
      std::memcpy(dst + 2 * i, &v, 2);
    }
    if (a + 2 * n_pairs < b)
      buf[b - 1 - base] = (uint8_t)(lut[src[n_pairs]] & 0xFF);
  } else {
    std::memcpy(buf + (a - base), seq_data + a, b - a);
    if (upper)
      for (uint64_t k = a - base; k < b - base; k++) {
        uint8_t c = buf[k];
        if (c >= 'a' && c <= 'z') buf[k] = c - 32;
      }
  }
  // lowercase the masked spans overlapping [a, b)
  if (!ms.starts.empty()) {
    size_t lo = std::upper_bound(ms.ends.begin(), ms.ends.end(), a)
                - ms.ends.begin();
    for (size_t s = lo; s < ms.starts.size() && ms.starts[s] < b; s++) {
      uint64_t x0 = std::max(ms.starts[s], a), x1 = std::min(ms.ends[s], b);
      for (uint64_t k = x0 - base; k < x1 - base; k++) buf[k] += 32;
    }
  }
}


static void materialize_chars(uint8_t *chars, const uint8_t *seq_data,
                              uint64_t total, bool packed, bool rna,
                              bool upper, const uint8_t *mask_units,
                              uint64_t n_mask_units, int nibble_off = 0) {
  if (packed) {
    const uint16_t *lut = rna ? g_codes_to_nucs_rna : g_codes_to_nucs_dna;
    uint64_t w = 0;
    if (nibble_off && total) {
      // stream starts at the high nibble of the first byte
      chars[w++] = (uint8_t)(lut[seq_data[0]] >> 8);
      seq_data++;
    }
    uint64_t n_bytes = (total - w) / 2;
    uint64_t i = 0;
#ifdef __AVX2__
    {
      alignas(32) uint8_t c2c[16];
      for (int c = 0; c < 16; c++)
        c2c[c] = (uint8_t)(lut[c] & 0xFF);     // code -> char
      const __m256i tab = _mm256_broadcastsi128_si256(
          _mm_load_si128((const __m128i *)c2c));
      const __m256i m0f = _mm256_set1_epi8(0x0F);
      for (; i + 32 <= n_bytes; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i *)(seq_data + i));
        __m256i lo = _mm256_shuffle_epi8(tab, _mm256_and_si256(v, m0f));
        __m256i hi = _mm256_shuffle_epi8(
            tab, _mm256_and_si256(_mm256_srli_epi16(v, 4), m0f));
        // interleave lo/hi chars per 128-bit lane, then fix lane order
        __m256i a = _mm256_unpacklo_epi8(lo, hi);
        __m256i b = _mm256_unpackhi_epi8(lo, hi);
        _mm256_storeu_si256((__m256i *)(chars + w + 2 * i),
                            _mm256_permute2x128_si256(a, b, 0x20));
        _mm256_storeu_si256((__m256i *)(chars + w + 2 * i + 32),
                            _mm256_permute2x128_si256(a, b, 0x31));
      }
    }
#endif
    for (; i < n_bytes; i++) {
      uint16_t v = lut[seq_data[i]];
      std::memcpy(chars + w + 2 * i, &v, 2);
    }
    w += 2 * n_bytes;
    if (w < total)
      chars[total - 1] = (uint8_t)(lut[seq_data[n_bytes]] & 0xFF);
  } else {
    std::memcpy(chars, seq_data, total);
    if (upper)
      for (uint64_t i = 0; i < total; i++) {
        uint8_t c = chars[i];
        if (c >= 'a' && c <= 'z') chars[i] = c - 32;
      }
  }
  if (mask_units != nullptr && n_mask_units > 0) {
    bool on = false;
    uint64_t pos = 0, i = 0;
    while (i < n_mask_units && pos < total) {
      uint64_t run = 0;
      while (i < n_mask_units && mask_units[i] == 255) { run += 255; i++; }
      if (i < n_mask_units) { run += mask_units[i]; i++; }
      uint64_t end = pos + run;
      if (end > total) end = total;
      if (on)
        for (uint64_t k = pos; k < end; k++) chars[k] += 32;
      pos += run;
      if (i < n_mask_units) on = !on;
    }
    if (on && pos < total)          // stream exhausted: state extends
      for (uint64_t k = pos; k < total; k++) chars[k] += 32;
  }
}

// One item of a NUL-separated blob at `p`: its length, with `p` moved past
// its NUL (one past `end` when no NUL is left, as the reference reads).
static inline uint64_t next_item(const uint8_t *&p, const uint8_t *end) {
  uint64_t n = 0;
  if (p < end) {
    const void *z = std::memchr(p, 0, (size_t)(end - p));
    n = (uint64_t)((z ? (const uint8_t *)z : end) - p);
  }
  p += n + 1;
  return n;
}

// One record's header line into `out`: the marker, the id, the separator
// and the comment when there are ids and the comment is non-empty (the
// comment alone without ids), '\n'.  Moves id_p and co_p past the record's
// items; returns the bytes written.  Both naf_render and naf_header_lines
// lay out their headers here.
static inline uint64_t put_header(uint8_t *out, uint8_t marker,
                                  const uint8_t *&id_p, const uint8_t *id_end,
                                  const uint8_t *&co_p, const uint8_t *co_end,
                                  bool has_ids, bool has_com,
                                  const uint8_t *sep, uint64_t sep_len) {
  uint64_t w = 0;
  out[w++] = marker;
  const uint8_t *cstart = co_p;
  uint64_t clen = has_com ? next_item(co_p, co_end) : 0;
  if (has_ids) {
    const uint8_t *istart = id_p;
    uint64_t ilen = next_item(id_p, id_end);
    std::memcpy(out + w, istart, ilen); w += ilen;
    if (clen && sep_len) { std::memcpy(out + w, sep, sep_len); w += sep_len; }
  }
  if (clen) { std::memcpy(out + w, cstart, clen); w += clen; }
  out[w++] = '\n';
  return w;
}

// Renders the full output in one pass.
//   seq_data: packed nibbles (nuc) or raw chars (text/protein)
//   total_chars: the container's sequence uncompressed size
//   lengths: merged per-record lengths (u64), n_records entries
//   ids/comments: '\0'-separated blobs or NULL
//   qual: raw quality chars (FASTQ mode)
//   out: caller buffer; returns bytes written (or needed if out==NULL)
uint64_t naf_render(int32_t mode,
                    const uint8_t *seq_data, uint64_t total_chars,
                    int32_t is_packed, int32_t is_rna, int32_t do_upper,
                    int32_t nibble_off,
                    const uint8_t *mask_units, uint64_t n_mask_units,
                    const uint64_t *lengths, uint64_t n_records,
                    const uint8_t *ids, uint64_t ids_len,
                    const uint8_t *comments, uint64_t comments_len,
                    const uint8_t *qual, uint64_t qual_len,
                    uint8_t name_sep, uint64_t line_len,
                    uint8_t *out, uint64_t *charcounts) {
  naf_init_tables();

  // FASTQ output ignores the mask (unnaf.c:443 print_fastq(0)).
  const uint8_t *mu = (mode == MODE_FASTQ) ? nullptr : mask_units;
  uint64_t mu_n = (mode == MODE_FASTQ) ? 0 : n_mask_units;

  if (mode == MODE_SEQ) {
    materialize_chars(out, seq_data, total_chars, is_packed != 0,
                      is_rna != 0, do_upper != 0, mu, mu_n, nibble_off);
    return total_chars;
  }

  // The character stream is materialized in L2-resident tiles and consumed
  // immediately, so decoded bytes never round-trip through DRAM twice.
  // A nibble-offset stream (extended-format range decode) starts mid-byte,
  // which materialize_range can't address: degrade to one full-size tile.
  static const uint64_t TILE = 1 << 18;   // chars per tile (power of two)
  const bool one_tile = nibble_off != 0 || total_chars <= TILE;
  MaskSpans ms;
  if (!one_tile && mu && mu_n) build_mask_spans(mu, mu_n, total_chars, ms);
  uint8_t *tile = new uint8_t[one_tile ? total_chars + 2 : TILE];
  uint64_t t_base = 0, t_end = 0;
  if (one_tile) {
    materialize_chars(tile, seq_data, total_chars, is_packed != 0,
                      is_rna != 0, do_upper != 0, mu, mu_n, nibble_off);
    t_end = total_chars;
  }
  auto ensure_tile = [&](uint64_t p) {
    if (p >= t_base && p < t_end) return;
    t_base = p & ~(TILE - 1);
    t_end = std::min(t_base + TILE, total_chars);
    materialize_range(tile, seq_data, t_base, t_base, t_end,
                      is_packed != 0, is_rna != 0, do_upper != 0, ms);
  };

  if (mode == MODE_CHARCOUNT) {
    // 4 sub-histograms dodge store-to-load stalls on repeated chars
    uint64_t h[4][256] = {};
    uint64_t p = 0;
    while (p < total_chars) {
      ensure_tile(p);
      const uint8_t *c = tile + (p - t_base);
      uint64_t n = t_end - p, k = 0;
      for (; k + 4 <= n; k += 4) {
        h[0][c[k]]++; h[1][c[k + 1]]++; h[2][c[k + 2]]++; h[3][c[k + 3]]++;
      }
      for (; k < n; k++) h[0][c[k]]++;
      p = t_end;
    }
    for (int b = 0; b < 256; b++)
      charcounts[b] += h[0][b] + h[1][b] + h[2][b] + h[3][b];
    delete[] tile;
    return 0;
  }

  uint64_t w = 0;
  const uint8_t *id_p = ids, *id_end = ids + ids_len;
  const uint8_t *co_p = comments, *co_end = comments + comments_len;

  auto put = [&](uint8_t c) { out[w++] = c; };
  auto put_name = [&](uint8_t marker) {
    w += put_header(out + w, marker, id_p, id_end, co_p, co_end,
                    ids != nullptr, comments != nullptr, &name_sep, 1);
  };

  uint64_t pos = 0;   // chars consumed
  auto copy_chars = [&](uint64_t len) {   // sequential copy-out from `pos`
    while (len) {
      ensure_tile(pos);
      uint64_t take = std::min(len, t_end - pos);
      std::memcpy(out + w, tile + (pos - t_base), take);
      w += take; pos += take; len -= take;
    }
  };

  if (mode == MODE_FASTQ) {
    const uint8_t *q = qual;
    const uint8_t *q_end = qual + qual_len;
    for (uint64_t rec = 0; rec < n_records; rec++) {
      put_name('@');
      uint64_t len = lengths[rec];
      uint64_t sn = len;
      if (pos + sn > total_chars) sn = total_chars - pos;
      copy_chars(sn);
      put('\n'); put('+'); put('\n');
      uint64_t qn = len;
      if (q + qn > q_end) qn = (uint64_t)(q_end - q);
      std::memcpy(out + w, q, qn); w += qn; q += qn;
      put('\n');
    }
    delete[] tile;
    return w;
  }

  if (mode == MODE_SEQUENCES) {
    if (total_chars == 0) { delete[] tile; return 0; }
    for (uint64_t rec = 0; rec < n_records; rec++) {
      uint64_t len = lengths[rec];
      if (pos + len > total_chars) len = total_chars - pos;
      copy_chars(len);
      put('\n');
    }
    copy_chars(total_chars - pos);   // spill beyond sum(lengths), raw
    delete[] tile;
    return w;
  }

  // MODE_FASTA: per record, emit whole wrapped lines
  uint64_t cur_line = 0;   // bp remaining in the current output line
  bool any_data = false;
  auto emit_wrapped = [&](uint64_t len) {
    // emits `len` chars from `pos`, breaking at line_len using cur_line
    if (line_len == 0) { copy_chars(len); return; }
    while (len > 0) {
      if (cur_line == 0) { put('\n'); cur_line = line_len; }
      uint64_t take = len < cur_line ? len : cur_line;
      copy_chars(take);
      cur_line -= take; len -= take;
    }
  };
  for (uint64_t rec = 0; rec < n_records; rec++) {
    put_name('>');
    uint64_t len = lengths[rec];
    if (len == 0) continue;
    any_data = true;
    cur_line = line_len;
    if (pos + len > total_chars) len = total_chars - pos;
    emit_wrapped(len);
    put('\n');
  }
  // spill bytes beyond sum(lengths): continue last record's wrap state
  if (any_data && pos < total_chars) {
    // undo the trailing record newline state: reference appends the spill
    // continuing the wrap, after the '\n' already written
    emit_wrapped(total_chars - pos);
  }
  delete[] tile;
  return w;
}

// Exact output size of naf_render for the same inputs: a counting replay of
// the emit loops above (any change to naf_render's emission must be mirrored
// here).  O(n_records + ids_len + comments_len) — lets the caller allocate
// the final output buffer exactly once, with no truncate-copy.
uint64_t naf_render_size(int32_t mode, uint64_t total_chars,
                         const uint64_t *lengths, uint64_t n_records,
                         const uint8_t *ids, uint64_t ids_len,
                         const uint8_t *comments, uint64_t comments_len,
                         uint64_t qual_len, uint64_t line_len) {
  if (mode == MODE_SEQ) return total_chars;
  if (mode == MODE_CHARCOUNT) return 0;

  uint64_t w = 0;
  const uint8_t *id_p = ids, *id_end = ids + ids_len;
  const uint8_t *co_p = comments, *co_end = comments + comments_len;
  bool has_ids = ids != nullptr, has_com = comments != nullptr;
  auto name_size = [&]() {   // put_header's length with a 1-byte separator
    uint64_t clen = has_com ? next_item(co_p, co_end) : 0;
    uint64_t n = 2 + clen;     // marker + '\n'
    if (has_ids) n += next_item(id_p, id_end) + (clen ? 1 : 0);
    return n;
  };

  uint64_t pos = 0;
  if (mode == MODE_FASTQ) {
    uint64_t q = 0;
    for (uint64_t rec = 0; rec < n_records; rec++) {
      w += name_size();
      uint64_t len = lengths[rec];
      uint64_t sn = len;
      if (pos + sn > total_chars) sn = total_chars - pos;
      w += sn + 3; pos += sn;
      uint64_t qn = len;
      if (q + qn > qual_len) qn = qual_len - q;
      w += qn + 1; q += qn;
    }
    return w;
  }

  if (mode == MODE_SEQUENCES) {
    if (total_chars == 0) return 0;
    for (uint64_t rec = 0; rec < n_records; rec++) {
      uint64_t len = lengths[rec];
      if (pos + len > total_chars) len = total_chars - pos;
      w += len + 1; pos += len;
    }
    return w + (total_chars - pos);
  }

  // MODE_FASTA
  uint64_t cur_line = 0;
  bool any_data = false;
  auto wrapped_size = [&](uint64_t len) {
    if (line_len == 0) { pos += len; w += len; return; }
    while (len > 0) {
      if (cur_line == 0) { w++; cur_line = line_len; }
      uint64_t take = len < cur_line ? len : cur_line;
      w += take; pos += take; cur_line -= take; len -= take;
    }
  };
  for (uint64_t rec = 0; rec < n_records; rec++) {
    w += name_size();
    uint64_t len = lengths[rec];
    if (len == 0) continue;
    any_data = true;
    cur_line = line_len;
    if (pos + len > total_chars) len = total_chars - pos;
    wrapped_size(len);
    w += 1;
  }
  if (any_data && pos < total_chars) wrapped_size(total_chars - pos);
  return w;
}

// The header lines of a render plan (parallel/decode.py:build_plan): one
// put_header line a record into `out`, each line's length in `hlens`.
// `out` holds ids_len + comments_len + n_records * (2 + sep_len) bytes.
// Either blob may be NULL; NULs past the n_records-th are ignored.  Returns
// the bytes written, or -1 when a blob given is empty, not 0-terminated or
// holds fewer items than records (the caller names the fault).
int64_t naf_header_lines(const uint8_t *ids, uint64_t ids_len,
                         const uint8_t *comments, uint64_t comments_len,
                         uint64_t n_records, uint8_t marker,
                         const uint8_t *sep, uint64_t sep_len,
                         uint8_t *out, int64_t *hlens) {
  if (n_records == 0) return 0;
  if ((ids && (ids_len == 0 || ids[ids_len - 1])) ||
      (comments && (comments_len == 0 || comments[comments_len - 1])))
    return -1;
  const uint8_t *id_p = ids, *id_end = ids + ids_len;
  const uint8_t *co_p = comments, *co_end = comments + comments_len;
  uint64_t w = 0;
  for (uint64_t r = 0; r < n_records; r++) {
    if ((ids && id_p >= id_end) || (comments && co_p >= co_end)) return -1;
    uint64_t len = put_header(out + w, marker, id_p, id_end, co_p, co_end,
                              ids != nullptr, comments != nullptr, sep, sep_len);
    hlens[r] = (int64_t)len;
    w += len;
  }
  return (int64_t)w;
}

// The FASTQ grid check and block cuts of parallel/block.py:make_blocks_fastq
// in one pass over `data` (the text after the leading '@').  Returns the
// record count and writes the n_blocks + 1 cuts, each the first record start
// at or after its target (k * n) / n_blocks (n where none is left), deduped
// and padded to n as the numpy path does; or -1 where the numpy path returns
// None: empty input, no trailing LF, any byte 11, 12 or 13, a line count
// that is not a multiple of 4, an empty line, a third line not starting
// with '+', a record after the first not starting with '@'.  AVX2 finds the
// bytes in 10..13 32 at a time; the line tests run only at each LF.
int64_t naf_fastq_grid(const uint8_t *data, uint64_t n, int64_t n_blocks,
                       int64_t *cuts) {
  if (n == 0 || data[n - 1] != '\n' || n_blocks < 1) return -1;
  const uint64_t nb = (uint64_t)n_blocks;
  uint64_t ls = 0, li = 0, n_rec = 0;   // line start, line index, records
  uint64_t k = 1, t = n / nb;           // the next target and its block
  int64_t m = 1;                        // cuts written
  cuts[0] = 0;
  // the line ending at LF p: non-empty, '+' third, '@' head; a record start
  // closes every open target at or below it
  auto line = [&](uint64_t p) -> bool {
    if (p == ls) return false;
    unsigned r = (unsigned)(li & 3);
    if (r == 2 && data[ls] != '+') return false;
    if (r == 0) {
      if (li > 0 && data[ls] != '@') return false;
      n_rec++;
      for (; k < nb && t <= ls; k++, t = k * n / nb)
        if ((int64_t)ls > cuts[m - 1]) cuts[m++] = (int64_t)ls;
    }
    li++;
    ls = p + 1;
    return true;
  };
  uint64_t i = 0;
#ifdef __AVX2__
  const __m256i lf = _mm256_set1_epi8('\n');
  const __m256i three = _mm256_set1_epi8(3);
  for (; i + 32 <= n; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i *)(data + i));
    __m256i d = _mm256_sub_epi8(v, lf);                 // 10..13 -> 0..3
    uint32_t eol = (uint32_t)_mm256_movemask_epi8(
        _mm256_cmpeq_epi8(_mm256_min_epu8(d, three), d));
    if (!eol) continue;
    uint32_t lfs = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, lf));
    if (eol != lfs) return -1;                          // CR, VT or FF
    do {
      if (!line(i + (uint64_t)__builtin_ctz(lfs))) return -1;
      lfs &= lfs - 1;
    } while (lfs);
  }
#endif
  for (; i < n; i++) {
    uint8_t c = data[i];
    if (c >= 11 && c <= 13) return -1;
    if (c == '\n' && !line(i)) return -1;
  }
  if (li & 3) return -1;
  while (m < n_blocks + 1) cuts[m++] = (int64_t)n;
  cuts[n_blocks] = (int64_t)n;
  return (int64_t)n_rec;
}

// Fast standalone 4-bit unpack (decoder --seq fast path without mask)
void naf_unpack(const uint8_t *packed, uint64_t n_bytes, int32_t is_rna,
                uint8_t *out) {
  naf_init_tables();
  const uint16_t *lut = is_rna ? g_codes_to_nucs_rna : g_codes_to_nucs_dna;
  uint16_t *o16 = (uint16_t *)out;
  for (uint64_t i = 0; i < n_bytes; i++) o16[i] = lut[packed[i]];
}

}  // extern "C"
