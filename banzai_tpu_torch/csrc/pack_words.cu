// Payload entries to words (kernel K3), the whole function.
//
// Replaces the Pallas TPU function banzai_tpu/ops/stream_pallas.py
// pack_words_batch (body _pack_kernel, with the splice_entries pass
// before it and the used-word mask after it).  Row b holds E (value, bit
// length) entries, lengths in [0, 32]; entry e's low len bits go MSB first
// to stream bits [off_e, off_e + len), off the exclusive prefix sum of the
// lengths, and stream bit k is bit 31 - (k & 31) of word k >> 5.  total[b]
// is the row's bit count, even past nwords * 32; words at or past
// ceil(total / 32) are 0, and bits at or past word nwords are dropped.
//
// What bounds it on the card: memory traffic, one read of the int64
// values and lengths (16 bytes an entry; the kernel uses their low 32
// bits) and one write of the words.  The first port spent ~40 PyTorch
// passes over int64 rows (splice_entries, casts, a zeroed word buffer)
// before a kernel that ORed each entry into its word with global atomics,
// ~3.5 entries per word on neighbouring lanes.  The TPU summed byte planes
// on its MXU.  Here one call runs three kernels, and nothing else touches
// the entries:
//
// 1. sum: one CTA per tile of kTile entries sums the tile's lengths (int32:
//    a row of E entries holds at most 32 E bits, and the entry checks
//    that this stays below 2^31);
// 2. scan: one CTA per row turns the tile sums into each tile's first bit
//    (base) and the row's total, and zeroes every word that a tile
//    boundary splits (the word of each unaligned base, and of an unaligned
//    total): only those words can take bits from two tiles;
// 3. place: one CTA per tile gives each entry its bit offset by a block
//    sum-scan seeded by the base and ORs its at most two word fields into
//    the tile's words in shared memory (the fields are disjoint, so the
//    order of the shared atomics does not matter).  A word that lies
//    wholly inside the tile's bits is stored plainly; a split one is ORed
//    into the zeroed word with a global atomicOr.  The same CTAs write 0
//    over words [ceil(total / 32), nwords).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;               // CTA of the sum and place
constexpr int kPer = 4;                     // consecutive entries a thread
constexpr int kTile = kThreads * kPer;      // entries per tile
constexpr int kWords = kTile + 1;           // words a tile's bits can touch
constexpr int kScanThreads = 1024;

// Exclusive sum of one value per thread across the CTA (every thread
// calls it; blockDim.x a multiple of 32), and the CTA's total in *total.
// buf: 32 ints of shared memory, free again when the call returns.
__device__ int block_exclusive_sum(int v, int* buf, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  int before = 0;
  int all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) before += buf[w];
    all += buf[w];
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

// An entry's length, clamped to [0, 32] so that no input can take the
// shared word buffer out of its bounds (the lengths a caller gives are in
// that range already).
__device__ __forceinline__ int entry_len(int64_t x) {
  return x < 0 ? 0 : x > 32 ? 32 : (int)x;
}

__global__ void __launch_bounds__(kThreads)
    pack_sum_kernel(const int64_t* __restrict__ lens, int* __restrict__ sums,
                    int64_t E, int n_tiles) {
  __shared__ int buf[32];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int64_t e0 = (int64_t)t * kTile + threadIdx.x * kPer;
  const int64_t* row = lens + (int64_t)b * E;
  int s = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (e0 + j < E) s += entry_len(row[e0 + j]);
  int tile_sum;
  block_exclusive_sum(s, buf, &tile_sum);
  if (threadIdx.x == 0) sums[(int64_t)b * n_tiles + t] = tile_sum;
}

__global__ void __launch_bounds__(kScanThreads)
    pack_scan_kernel(const int* __restrict__ sums, int* __restrict__ bases,
                     int* __restrict__ total, unsigned* __restrict__ words,
                     int n_tiles, int64_t nwords) {
  __shared__ int buf[32];
  const int b = blockIdx.x;
  const int64_t row = (int64_t)b * n_tiles;
  unsigned* wrow = words + (int64_t)b * nwords;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(n_tiles, (int)threadIdx.x * per);
  const int hi = min(n_tiles, lo + per);
  int run = 0;
  for (int t = lo; t < hi; ++t) run += sums[row + t];
  int all;
  int acc = block_exclusive_sum(run, buf, &all);
  for (int t = lo; t < hi; ++t) {
    bases[row + t] = acc;
    if ((acc & 31) && (acc >> 5) < nwords) wrow[acc >> 5] = 0u;
    acc += sums[row + t];
  }
  if (threadIdx.x == 0) {
    total[b] = all;
    if ((all & 31) && (all >> 5) < nwords) wrow[all >> 5] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
    pack_place_kernel(const int64_t* __restrict__ vals,
                      const int64_t* __restrict__ lens,
                      const int* __restrict__ bases,
                      const int* __restrict__ total,
                      unsigned* __restrict__ words, int64_t E, int n_tiles,
                      int64_t nwords) {
  __shared__ int buf[32];
  __shared__ unsigned acc[kWords];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int64_t e0 = (int64_t)t * kTile + threadIdx.x * kPer;
  const int64_t* vrow = vals + (int64_t)b * E;
  const int64_t* lrow = lens + (int64_t)b * E;
  unsigned v[kPer];
  int len[kPer];
  int s = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool live = e0 + j < E;
    len[j] = live ? entry_len(lrow[e0 + j]) : 0;
    v[j] = live ? (unsigned)vrow[e0 + j] : 0u;
    s += len[j];
  }
  int tile_bits;
  int bit = block_exclusive_sum(s, buf, &tile_bits);
  const int base = bases[(int64_t)b * n_tiles + t];
  const int end = base + tile_bits;
  const int wlo = base >> 5;
  const int nloc = tile_bits > 0 ? ((end - 1) >> 5) - wlo + 1 : 0;
  for (int i = threadIdx.x; i < nloc; i += kThreads) acc[i] = 0u;
  __syncthreads();
  bit += base - (wlo << 5);  // the thread's first bit, from word wlo on
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int L = len[j];
    if (L > 0) {
      const unsigned x = L >= 32 ? v[j] : v[j] & ((1u << L) - 1u);
      const int w = bit >> 5;
      const int space = 32 - (bit & 31);
      if (L <= space) {
        atomicOr(&acc[w], x << (space - L));
      } else {
        const int spill = L - space;  // 1..31 low bits into word w + 1
        atomicOr(&acc[w], x >> spill);
        atomicOr(&acc[w + 1], x << (32 - spill));
      }
    }
    bit += L;
  }
  __syncthreads();
  unsigned* wrow = words + (int64_t)b * nwords;
  for (int i = threadIdx.x; i < nloc; i += kThreads) {
    const int64_t k = (int64_t)wlo + i;
    if (k >= nwords) break;
    const unsigned x = acc[i];
    if (32 * k >= base && 32 * k + 32 <= end) {
      wrow[k] = x;                    // no other tile has bits here
    } else if (x != 0u) {
      atomicOr(&wrow[k], x);          // a split word, zeroed by the scan
    }
  }
  const int64_t used = ((int64_t)total[b] + 31) >> 5;
  for (int64_t k = used + (int64_t)t * kThreads + threadIdx.x; k < nwords;
       k += (int64_t)n_tiles * kThreads)
    wrow[k] = 0u;
}

}  // namespace

// vals, lens: int64 [B, E] (lens in [0, 32]); words: uint32 [B, nwords];
// total: int32 [B].  scratch: int32 [2 * B * n_tiles], n_tiles =
// max(1, ceil(E / 2048)), which the caller computes and this entry
// checks; B <= 65535 and 32 E + 64 < 2^31.
extern "C" int pack_words(const int64_t* vals, const int64_t* lens,
                          unsigned* words, int* total, int* scratch, int B,
                          int64_t E, int64_t nwords, int n_tiles,
                          void* stream) {
  const int64_t want = E > 0 ? (E + kTile - 1) / kTile : 1;
  if (B > 65535 || E < 0 || nwords < 0 || 32 * E + 64 > INT32_MAX ||
      n_tiles != want)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int64_t nt = (int64_t)B * n_tiles;
    int* sums = scratch;
    int* bases = scratch + nt;
    const dim3 grid((unsigned)n_tiles, (unsigned)B);
    cudaStream_t st = (cudaStream_t)stream;
    pack_sum_kernel<<<grid, kThreads, 0, st>>>(lens, sums, E, n_tiles);
    pack_scan_kernel<<<(unsigned)B, kScanThreads, 0, st>>>(
        sums, bases, total, words, n_tiles, nwords);
    pack_place_kernel<<<grid, kThreads, 0, st>>>(vals, lens, bases, total,
                                                words, E, n_tiles, nwords);
  }
  return (int)cudaGetLastError();
}
