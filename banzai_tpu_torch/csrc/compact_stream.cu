// Stream compaction (kernel K4): payload[mask] packed to the front.
//
// Replaces the Pallas TPU kernel banzai_tpu/ops/compact_pallas.py
// (compact_stream, body _compact_tile_kernel).  The work split is the
// JAX one: the per-tile keep counts and their exclusive prefix sum
// (base[t]) are computed outside the kernel; the kernel places the kept
// lanes of every tile at base[t] + (their rank inside the tile).
//
// What bounds it on the card: memory traffic, one int32 read of the mask
// and of the payload per lane and one int32 write per kept lane.  The TPU
// kernel ranked lanes with a [T, T] triangular compare-sum and relied on
// its sequential grid, each tile's write overwriting the garbage tail the
// tile before it left.  A GPU grid runs in no order, so here one CTA per
// tile ranks its lanes with warp ballots: a warp's count is a __popc of
// its 32-lane ballot, the per-warp offsets go through shared memory, and
// a lane's rank is its warp's offset plus the __popc of the ballot bits
// below it.  Each kept lane writes only its own slot and no lane writes
// anything else, so the wrapper's zeroed output keeps 0 past the count:
// no atomics, and the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void compact_stream_kernel(const int* __restrict__ mask,
                                      const int* __restrict__ payload,
                                      const int64_t* __restrict__ base,
                                      int* __restrict__ out, int tile) {
  __shared__ int warp_count[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * tile + threadIdx.x;
  const bool keep = mask[i] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  if (!keep) return;
  int rank = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_count[w];
  out[base[blockIdx.x] + rank] = payload[i];
}

}  // namespace

// tile: lanes per CTA, a multiple of 32 in [32, 1024] (the wrapper
// checks); N = n_tiles * tile.
extern "C" int compact_stream(const int* mask, const int* payload,
                              const int64_t* base, int* out, int64_t n_tiles,
                              int tile, void* stream) {
  if (n_tiles > 0) {
    compact_stream_kernel<<<(unsigned)n_tiles, tile, 0,
                            (cudaStream_t)stream>>>(mask, payload, base, out,
                                                    tile);
  }
  return (int)cudaGetLastError();
}
