// Word assembly of the bit-packed payload (kernel K3).
//
// Replaces the Pallas TPU kernel banzai_tpu/ops/stream_pallas.py
// (pack_words_batch, body _pack_kernel).  Entry e of block b ORs its
// 32-bit contribution hi2 (from bitpack.splice_entries) into word w, where
// w is non-decreasing along the entries.  Entries with w >= nwords are
// dropped, and words at or past used[b] = ceil(total_bits / 32) stay 0.
//
// What bounds it on the card: memory traffic, two int32 reads per entry
// and one write per word, plus atomic throughput where many entries share
// a word.  The TPU kernel summed byte planes on the MXU through a
// 128-aligned sliding window because the TPU has no cheap scatter.  Here
// one thread per entry does an atomicOr into words the wrapper zeroed;
// OR is commutative, so the result does not depend on the order in which
// the atomics land.  Zero contributions (dead entries) skip the atomic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pack_words_kernel(const int* __restrict__ w,
                                  const unsigned* __restrict__ hi2,
                                  const int* __restrict__ used,
                                  unsigned* __restrict__ words, int B,
                                  int64_t E, int64_t nwords) {
  const int64_t total = (int64_t)B * E;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const unsigned h = hi2[i];
    if (h == 0u) continue;
    const int64_t b = i / E;
    const int64_t wi = w[i];
    if (wi < nwords && wi < used[b]) atomicOr(words + b * nwords + wi, h);
  }
}

}  // namespace

extern "C" int pack_words(const int* w, const unsigned* hi2, const int* used,
                          unsigned* words, int B, int64_t E, int64_t nwords,
                          void* stream) {
  const int64_t total = (int64_t)B * E;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 65535 * 16) blocks = 65535 * 16;
    pack_words_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(w, hi2, used, words, B, E,
                                                nwords);
  }
  return (int)cudaGetLastError();
}
