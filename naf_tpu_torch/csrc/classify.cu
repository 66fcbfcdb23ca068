// FASTA classify launches: the per-tile parser maps that every classify
// pass starts from, and the standalone flags/value classify.
//
// Replaces naf_tpu/ops/scan_fused.py:_make_fasta_kernel (classify_fasta_fused).
// Bound: memory.  The map pass reads 1 B/B; the classify pass reads 1 B/B and
// writes 2 B/B.  Each thread loads its 128 bytes once (16-byte loads) and
// walks them in registers; the state machine costs a few integer ops a byte.
#include "classify.cuh"

namespace naf {

// Pass A: the composed parser map of each tile, maps[tile].
__global__ void __launch_bounds__(THREADS) tile_maps_kernel(const uint8_t* x, long long n,
                                                            int pe0, const uint8_t* cls,
                                                            int* maps) {
  __shared__ Tables t;
  __shared__ int buf[THREADS];
  load_tables(&t, cls, 0, 0);
  const long long start = static_cast<long long>(blockIdx.x) * TILE +
                          static_cast<long long>(threadIdx.x) * PER_THREAD;
  uint32_t w[WORDS];
  load_chunk(x, n, start, w, PAD);
  const bool pe =
      start == 0 ? pe0 != 0 : (t.cls[byte_or(x, n, start - 1, PAD)] & CLS_EOL) != 0;
  int total;
  block_exclusive_scan(chunk_map(w, pe, t), 0, buf, ComposeOp(), &total);
  if (threadIdx.x == 0) maps[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS) classify_kernel(const uint8_t* x, long long n, int pe0,
                                                           const int* st_in, const uint8_t* cls,
                                                           int repl_seq, int repl_name,
                                                           uint8_t* flags, uint8_t* sval) {
  __shared__ Tables t;
  __shared__ int buf[THREADS];
  load_tables(&t, cls, repl_seq, repl_name);
  Chunk ch;
  load_classified_chunk(ch, x, n, pe0, st_in[blockIdx.x], t, buf);
  uint32_t fw[WORDS], vw[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) fw[i] = vw[i] = 0;
  classify_chunk(ch.w, ch.pe, ch.state, t, [&](int k, uint32_t f, uint32_t v) {
    fw[k >> 2] |= f << ((k & 3) * 8);
    vw[k >> 2] |= v << ((k & 3) * 8);
  });
  store_chunk(flags, n, ch.start, fw);
  store_chunk(sval, n, ch.start, vw);
}

}  // namespace naf

extern "C" int naf_fasta_tile_maps(const uint8_t* x, long long n, int pe0, const uint8_t* cls,
                                   int* maps, int tiles, void* stream) {
  NAF_LAUNCH(naf::tile_maps_kernel, tiles, naf::THREADS, 0, stream, x, n, pe0, cls, maps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int naf_classify_fasta(const uint8_t* x, long long n, int pe0, const int* st_in,
                                  const uint8_t* cls, int repl_seq, int repl_name,
                                  uint8_t* flags, uint8_t* sval, int tiles, void* stream) {
  NAF_LAUNCH(naf::classify_kernel, tiles, naf::THREADS, 0, stream, x, n, pe0, st_in, cls,
             repl_seq, repl_name, flags, sval);
  return static_cast<int>(cudaGetLastError());
}
