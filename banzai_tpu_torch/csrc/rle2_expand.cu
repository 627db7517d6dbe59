// RLE2 expansion (kernel K2).
//
// Replaces the Pallas TPU kernel banzai_tpu/ops/stream_pallas.py
// (rle2_expand_batch, body _rle2_kernel).  Entry e of block b, given by
// (off, width, zp1, val), covers output slots [off, off + width): its
// first width - 1 slots are the bits of zp1 below its leading one, least
// significant first (RUNA = 0, RUNB = 1), and its last slot is val.
// Slots at or past out_len[b] hold 258.  Dead entries have width 0.
//
// What bounds it on the card: memory traffic, one read of four int32
// entry fields and about one int32 write per output slot.  The TPU kernel
// resolved slot -> entry with an interval-mask MXU contraction and stored
// through a 128-aligned sliding window, both workarounds for a machine
// without a cheap scatter.  Here it is a direct scatter: one thread per
// entry writes its slots (offsets are disjoint, so no atomics), and the
// same thread fills slot i of the tail when i >= out_len[b].  The entry
// reads are coalesced; the writes are nearly so, since consecutive
// entries write consecutive slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rle2_expand_kernel(const int* __restrict__ off,
                                   const int* __restrict__ width,
                                   const int* __restrict__ zp1,
                                   const int* __restrict__ val,
                                   const int* __restrict__ out_len,
                                   int* __restrict__ out, int B, int64_t M) {
  const int64_t total = (int64_t)B * M;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = i / M;
    const int64_t slot = i - b * M;
    int* orow = out + b * M;
    if (slot >= out_len[b]) orow[slot] = 258;
    const int w = width[i];
    if (w > 0) {
      const int o = off[i];
      const int z = zp1[i];
      for (int d = 0; d < w - 1; ++d) orow[o + d] = (z >> d) & 1;
      orow[o + w - 1] = val[i];
    }
  }
}

}  // namespace

extern "C" int rle2_expand(const int* off, const int* width, const int* zp1,
                           const int* val, const int* out_len, int* out,
                           int B, int64_t M, void* stream) {
  const int64_t total = (int64_t)B * M;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 65535 * 16) blocks = 65535 * 16;
    rle2_expand_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(off, width, zp1, val,
                                                 out_len, out, B, M);
  }
  return (int)cudaGetLastError();
}
