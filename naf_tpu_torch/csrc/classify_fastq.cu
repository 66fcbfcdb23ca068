// FASTQ classify launches: the per-tile header maps and LF counts that every
// FASTQ pass starts from, and the standalone flags/value classify.
//
// Replaces naf_tpu/ops/scan_fused.py:_make_fastq_kernel (classify_fastq_fused).
// Bound: memory.  The map pass reads 1 B/B; the classify pass reads 1 B/B and
// writes 2 B/B.  Each thread loads its 128 bytes once (16-byte loads) and
// walks them in registers.
#include "classify_fastq.cuh"

namespace naf {

// Pass A: the composed header map and the LF count of each 32 KiB tile.
__global__ void __launch_bounds__(Q_THREADS) fastq_tile_maps_kernel(const uint8_t* x, long long n,
                                                                    const uint8_t* cls, int* maps,
                                                                    int* lfs) {
  __shared__ QTables t;
  __shared__ MapLf buf[Q_THREADS];
  load_tables(&t, cls, 0, 0);
  const long long start = static_cast<long long>(blockIdx.x) * Q_TILE +
                          static_cast<long long>(threadIdx.x) * PER_THREAD;
  uint32_t w[WORDS];
  load_chunk(x, n, start, w, PAD);
  MapLf total;
  block_exclusive_scan<Q_THREADS>(chunk_map_lf(w, t), MapLf{0, 0}, buf, MapLfOp(), &total);
  if (threadIdx.x == 0) {
    maps[blockIdx.x] = total.map;
    lfs[blockIdx.x] = total.lf;
  }
}

__global__ void __launch_bounds__(Q_THREADS) classify_fastq_kernel(
    const uint8_t* x, long long n, int pe0, const int* tile_in, const uint8_t* cls, int repl_seq,
    int repl_name, int repl_qual, uint8_t* flags, uint8_t* sval) {
  __shared__ QTables t;
  __shared__ MapLf buf[Q_THREADS];
  load_tables(&t, cls, repl_seq, repl_name, repl_qual);
  QChunk ch;
  const int* in = tile_in + 2 * static_cast<long long>(blockIdx.x);  // [lane, sub-state]
  load_fastq_chunk(ch, x, n, pe0, in[0], in[1], t, buf);
  uint32_t fw[WORDS], vw[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) fw[i] = vw[i] = 0;
  classify_fastq_chunk(ch, t, [&](int k, const QByte& r) {
    fw[k >> 2] |= r.flags() << ((k & 3) * 8);
    vw[k >> 2] |= r.sval << ((k & 3) * 8);
  });
  store_chunk(flags, n, ch.start, fw);
  store_chunk(sval, n, ch.start, vw);
}

}  // namespace naf

extern "C" int naf_fastq_tile_maps(const uint8_t* x, long long n, const uint8_t* cls, int* maps,
                                   int* lfs, int tiles, void* stream) {
  NAF_LAUNCH(naf::fastq_tile_maps_kernel, tiles, naf::Q_THREADS, 0, stream, x, n, cls, maps, lfs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int naf_classify_fastq(const uint8_t* x, long long n, int pe0, const int* tile_in,
                                  const uint8_t* cls, int repl_seq, int repl_name, int repl_qual,
                                  uint8_t* flags, uint8_t* sval, int tiles, void* stream) {
  NAF_LAUNCH(naf::classify_fastq_kernel, tiles, naf::Q_THREADS, 0, stream, x, n, pe0, tile_in,
             cls, repl_seq, repl_name, repl_qual, flags, sval);
  return static_cast<int>(cudaGetLastError());
}
