// Stream compaction (kernel K4): payload[mask] packed to the front.
//
// Replaces the Pallas TPU kernel banzai_tpu/ops/compact_pallas.py
// (compact_stream, body _compact_tile_kernel).  The TPU kernel ranked
// lanes with a [T, T] triangular compare-sum and relied on its sequential
// grid, each tile's write overwriting the garbage tail the tile before it
// left; the per-tile counts and their prefix sum were XLA passes over an
// int32 copy of the mask.
//
// What bounds it on the card: memory traffic.  The least is one read of
// the bool mask and of the int32 payload and one int32 write per lane
// (~9 bytes a lane).  The first port spent four passes in PyTorch
// around its kernel (the mask to int32, the tile sums, their prefix sum,
// a zeroed output), ~24 bytes a lane, and lost to torch.masked_select.
// Here one call runs three kernels on the stream, and nothing else
// touches the lanes:
//
// 1. count: one warp per tile reads the tile's bool mask as 32-bit words
//    (a bool is one byte, 0 or 1, so a word's __popc counts its kept
//    lanes) and a __reduce_add_sync sums the lanes into counts[t].
// 2. scan: one CTA turns the tile counts into exclusive offsets
//    offs[t] (int64) and the total, offs[n_tiles]; each thread sums a run
//    of consecutive tiles, warp shuffles scan the 1024 run sums.
// 3. place: one CTA per tile ranks its lanes again by ballots (a warp's
//    offset through shared memory, the lane's rank the __popc of the
//    ballot bits below it) and writes each kept lane to offs[t] + rank;
//    every lane at or past the total writes 0.  Each output slot is
//    written exactly once, by one lane: no atomics, deterministic, and
//    no separate zeroing pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 1024;

constexpr int kCountWarps = 8;  // tiles per CTA of the count kernel

__global__ void __launch_bounds__(kCountWarps * 32)
    compact_count_kernel(const uint8_t* __restrict__ mask,
                         int* __restrict__ counts, int64_t n_tiles,
                         int tile) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * kCountWarps + (threadIdx.x >> 5);
  if (t >= n_tiles) return;  // whole warps exit together
  const uint32_t* words = reinterpret_cast<const uint32_t*>(mask + t * tile);
  int kept = 0;
  for (int j = lane; j < tile / 4; j += 32) kept += __popc(words[j]);
  kept = __reduce_add_sync(kFull, kept);
  if (lane == 0) counts[t] = kept;
}

__global__ void __launch_bounds__(kScanThreads)
    compact_scan_kernel(const int* __restrict__ counts,
                        int64_t* __restrict__ offs, int64_t n) {
  __shared__ int64_t warp_sum[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min(n, tid * per);
  const int64_t hi = min(n, lo + per);
  int64_t run = 0;
  for (int64_t t = lo; t < hi; ++t) run += counts[t];
  // Inclusive scan of the run sums: within warps, then across them.
  int64_t inc = run;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t v = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  int64_t before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  int64_t acc = before + inc - run;  // exclusive offset of this run
  for (int64_t t = lo; t < hi; ++t) {
    offs[t] = acc;
    acc += counts[t];
  }
  if (tid == kScanThreads - 1) offs[n] = before + inc;
}

__global__ void compact_place_kernel(const uint8_t* __restrict__ mask,
                                     const int* __restrict__ payload,
                                     const int64_t* __restrict__ offs,
                                     int* __restrict__ out, int64_t n_tiles) {
  __shared__ int warp_count[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool keep = mask[i] != 0;
  const unsigned ballot = __ballot_sync(kFull, keep);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  if (keep) {
    int rank = __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += warp_count[w];
    out[offs[blockIdx.x] + rank] = payload[i];
  }
  if (i >= offs[n_tiles]) out[i] = 0;
}

}  // namespace

// tile: lanes per CTA, a multiple of 32 in [32, 1024] (the wrapper
// checks); N = n_tiles * tile; mask: bool bytes (0 or 1), 4-byte aligned.
// counts: int32 [n_tiles] scratch; offs: int64 [n_tiles + 1],
// offs[n_tiles] receives the kept count.
extern "C" int compact_stream(const uint8_t* mask, const int* payload,
                              int* counts, int64_t* offs, int* out,
                              int64_t n_tiles, int tile, void* stream) {
  if (n_tiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t count_blocks = (n_tiles + kCountWarps - 1) / kCountWarps;
    compact_count_kernel<<<(unsigned)count_blocks, kCountWarps * 32, 0, st>>>(
        mask, counts, n_tiles, tile);
    compact_scan_kernel<<<1, kScanThreads, 0, st>>>(counts, offs, n_tiles);
    compact_place_kernel<<<(unsigned)n_tiles, tile, 0, st>>>(
        mask, payload, offs, out, n_tiles);
  }
  return (int)cudaGetLastError();
}
