// RLE2 from MTF indices to symbols (kernel K2), the whole function.
//
// Replaces the Pallas TPU function banzai_tpu/ops/stream_pallas.py
// rle2_expand_batch (body _rle2_kernel, with the rle2_entries pass before
// it and the 258 tail after it).  Row b holds N MTF indices, n[b] of them
// real; lane p of the M = N + 1 lanes emits when p < n and idx[p] > 0
// (symbol idx[p] + 1), or when p == n (EOB, symbol num_names + 1).  An
// emit whose previous emit is `gap` lanes before it (gap = zero run + 1;
// the first emit's previous is lane -1) writes the bits of gap below its
// leading one, least significant first (RUNA = 0, RUNB = 1), then its
// symbol: bitlen(gap) slots.  The slots follow each other from 0; out_len
// is their count, and slots [out_len, M) hold 258.
//
// What bounds it on the card: memory traffic, one int32 read per index
// and one int32 write per slot (8 bytes a lane).  The first port ran
// rle2_entries as ~95 PyTorch passes over int64 [B, M] rows around a
// scatter kernel.  Here one call runs three kernels, and nothing else
// touches the lanes; the dependencies across the row are two scans, of
// the previous emit (a max) and of the emit widths (a sum):
//
// 1. summary: one CTA per tile of kTile lanes finds its first and last
//    emit and the width sum of its other emits (their previous emits lie
//    inside the tile, so those widths are known there);
// 2. scan: one CTA per row scans the tile summaries: each tile's carry-in
//    previous emit (the last emit of the tiles before it) gives its first
//    emit's width, and the widths give each tile's first slot (base) and
//    the row's out_len;
// 3. expand: one CTA per tile computes its emits again, with a block
//    max-scan seeded by the carry and a block sum-scan of the widths,
//    writes the tile's slots into shared memory and stores them to
//    [base, base + width sum) with consecutive threads on consecutive
//    slots; the same CTA writes 258 over its own lane range past out_len.
//    Each output slot is written exactly once: no atomics, deterministic.
//
// Digits per emit: 31 - __clz(gap), the bit length less one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;              // CTA of the summary and expand
constexpr int kLanes = 4;                  // consecutive lanes per thread
constexpr int kTile = kThreads * kLanes;   // lanes per tile
constexpr int kScanThreads = 1024;
constexpr int kTail = 258;

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Exclusive scan of one value per thread across the CTA (every thread
// calls it; blockDim.x a multiple of 32): returns the combination of the
// values of the threads before this one (identity for thread 0), and the
// combination over the whole CTA in *total.  buf: 32 ints of shared
// memory, free again when the call returns.
template <class Op>
__device__ int block_exclusive(int v, int identity, Op op, int* buf,
                               int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = op(inc, y);
  }
  int excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  int before = identity;
  int all = identity;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) before = op(before, buf[w]);
    all = op(all, buf[w]);
  }
  __syncthreads();
  *total = all;
  return op(before, excl);
}

// Slots of one emit: the digits of gap and the symbol.
__device__ __forceinline__ int emit_width(int gap) { return 32 - __clz(gap); }

// The thread's kLanes lanes from p0 on: which emit (bit j of the mask),
// their symbols, and the first and last emitting lane (-1 if none).
struct Lanes {
  unsigned mask;
  int first;
  int last;
  int val[kLanes];
};

__device__ __forceinline__ Lanes load_lanes(const int* __restrict__ idx,
                                            int64_t n, int64_t names,
                                            int N, int p0) {
  Lanes L;
  L.mask = 0u;
  L.first = -1;
  L.last = -1;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const int p = p0 + j;
    const int x = (p < N && (int64_t)p < n) ? idx[p] : 0;
    const bool eob = (int64_t)p == n;
    L.val[j] = eob ? (int)(names + 1) : x + 1;
    if (x > 0 || eob) {
      L.mask |= 1u << j;
      if (L.first < 0) L.first = p;
      L.last = p;
    }
  }
  return L;
}

// Width sum of the thread's emits, the first one's previous emit at prev.
__device__ __forceinline__ int lanes_width(const Lanes& L, int p0, int prev) {
  int w = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    if (L.mask >> j & 1u) {
      w += emit_width(p0 + j - prev);
      prev = p0 + j;
    }
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
    rle2_summary_kernel(const int* __restrict__ idx,
                        const int64_t* __restrict__ n,
                        const int64_t* __restrict__ names,
                        int* __restrict__ first, int* __restrict__ last,
                        int* __restrict__ inner, int N, int n_tiles) {
  __shared__ int buf[32];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int p0 = t * kTile + threadIdx.x * kLanes;
  const Lanes L = load_lanes(idx + (int64_t)b * N, n[b], names[b], N, p0);
  int tile_last;
  const int prev = block_exclusive(L.last, -1, MaxOp(), buf, &tile_last);
  // With no carry-in the tile's first emit counts as gap first + 1.
  int tile_w;
  block_exclusive(lanes_width(L, p0, prev), 0, SumOp(), buf, &tile_w);
  int tile_first;
  block_exclusive(L.first < 0 ? INT32_MAX : L.first, INT32_MAX, MinOp(),
                  buf, &tile_first);
  if (threadIdx.x == 0) {
    const int64_t k = (int64_t)b * n_tiles + t;
    const bool any = tile_last >= 0;
    first[k] = any ? tile_first : -1;
    last[k] = tile_last;
    inner[k] = any ? tile_w - emit_width(tile_first + 1) : 0;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    rle2_scan_kernel(const int* __restrict__ first,
                     const int* __restrict__ last,
                     const int* __restrict__ inner, int* __restrict__ carry,
                     int* __restrict__ base, int* __restrict__ out_len,
                     int n_tiles) {
  __shared__ int buf[32];
  const int64_t row = (int64_t)blockIdx.x * n_tiles;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(n_tiles, (int)threadIdx.x * per);
  const int hi = min(n_tiles, lo + per);
  int run_last = -1;
  for (int t = lo; t < hi; ++t) run_last = max(run_last, last[row + t]);
  int unused;
  int cur = block_exclusive(run_last, -1, MaxOp(), buf, &unused);
  int run_w = 0;
  for (int t = lo; t < hi; ++t) {
    carry[row + t] = cur;
    const int f = first[row + t];
    if (f >= 0) run_w += emit_width(f - cur) + inner[row + t];
    cur = max(cur, last[row + t]);
  }
  int total;
  int acc = block_exclusive(run_w, 0, SumOp(), buf, &total);
  for (int t = lo; t < hi; ++t) {
    base[row + t] = acc;
    const int f = first[row + t];
    if (f >= 0) acc += emit_width(f - carry[row + t]) + inner[row + t];
  }
  if (threadIdx.x == 0) out_len[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    rle2_expand_kernel(const int* __restrict__ idx,
                       const int64_t* __restrict__ n,
                       const int64_t* __restrict__ names,
                       const int* __restrict__ carry,
                       const int* __restrict__ base,
                       const int* __restrict__ out_len,
                       int* __restrict__ out, int N, int n_tiles) {
  __shared__ int buf[32];
  // A tile's slots: at most kTile - 1 for the emits after its first
  // (each takes at most its gap), and at most 32 for the first.
  __shared__ int slots[kTile + 32];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int M = N + 1;
  const int64_t k = (int64_t)b * n_tiles + t;
  const int p0 = t * kTile + threadIdx.x * kLanes;
  const Lanes L = load_lanes(idx + (int64_t)b * N, n[b], names[b], N, p0);
  int unused;
  int prev = block_exclusive(L.last, -1, MaxOp(), buf, &unused);
  prev = max(prev, carry[k]);
  int tile_w;
  int o = block_exclusive(lanes_width(L, p0, prev), 0, SumOp(), buf,
                          &tile_w);
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    if (L.mask >> j & 1u) {
      const int gap = p0 + j - prev;
      const int digits = 31 - __clz(gap);
      for (int d = 0; d < digits; ++d) slots[o + d] = (gap >> d) & 1;
      slots[o + digits] = L.val[j];
      o += digits + 1;
      prev = p0 + j;
    }
  }
  __syncthreads();
  int* orow = out + (int64_t)b * M;
  const int bs = base[k];
  for (int i = threadIdx.x; i < tile_w; i += kThreads) orow[bs + i] = slots[i];
  const int len = out_len[b];
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int s = t * kTile + i;
    if (s < M && s >= len) orow[s] = kTail;
  }
}

}  // namespace

// idx: int32 [B, N] MTF indices (lanes at or past n[b] are not read);
// n, names: int64 [B]; out: int32 [B, N + 1]; out_len: int32 [B].
// scratch: int32 [5 * B * n_tiles], n_tiles = ceil((N + 1) / 2048), which
// the caller computes and this entry checks; B <= 65535.
extern "C" int rle2_expand(const int* idx, const int64_t* n,
                           const int64_t* names, int* out, int* out_len,
                           int* scratch, int B, int N, int n_tiles,
                           void* stream) {
  if (B > 65535 || N < 0 || (int64_t)N + 1 + kTile > INT32_MAX ||
      n_tiles != (N + 1 + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int64_t nt = (int64_t)B * n_tiles;
    int* first = scratch;
    int* last = scratch + nt;
    int* inner = scratch + 2 * nt;
    int* carry = scratch + 3 * nt;
    int* base = scratch + 4 * nt;
    const dim3 grid((unsigned)n_tiles, (unsigned)B);
    cudaStream_t st = (cudaStream_t)stream;
    rle2_summary_kernel<<<grid, kThreads, 0, st>>>(idx, n, names, first, last,
                                                  inner, N, n_tiles);
    rle2_scan_kernel<<<(unsigned)B, kScanThreads, 0, st>>>(
        first, last, inner, carry, base, out_len, n_tiles);
    rle2_expand_kernel<<<grid, kThreads, 0, st>>>(idx, n, names, carry, base,
                                                 out_len, out, N, n_tiles);
  }
  return (int)cudaGetLastError();
}
