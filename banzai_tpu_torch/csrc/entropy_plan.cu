// The entropy plan of a batch of blocks (kernel K5), the whole function.
//
// Replaces no TPU kernel: the JAX package's plan
// (banzai_tpu/ops/huffman.py plan_entropy_device, with
// banzai_tpu/ops/banzai_plan.py banzai_split_device) is plain jnp.  Its
// PyTorch version, ops/huffman.plan_entropy_plain, stays as the plain
// version; this entry computes the same dict, bitwise, for every row of the
// batch, padded rows included.  It was added because the plain version
// runs ~1,860 library kernels a batch (17 levels of sort, cumsum and
// gathers per package-merge, in 4 refinement iterations), so the stage was
// bound by its launches on the host, not by any work on the card.
//
// What bounds it on the card: reading the RLE2 symbols, int32 [B, M], once
// per pass over them (5: the histogram and the 4 assign passes, each over
// the live lanes only); the rest is per-block work on 258-symbol rows and
// per-candidate selector rows.  In practice the assign passes are bound by
// the shared-memory pipe (table lookups, sums across lanes, atomics), and
// package-merge by its 17 dependent levels.  The [B, NSEG, 258] segment
// histogram of the plain version (148 MB at B = 8, NSEG = 18,001) is never
// built: each segment's table costs are the sums of its 50 symbols'
// lengths, taken as integers, so they are exact with no float product.
//
// One call runs 13 kernels on the caller's stream (4 and 5 four times):
//
// 1. zero: the int32 accumulators of the scratch.
// 2. hist: per (lane tile, block), the symbol counts of the live lanes
//    (lane < min(out_len, M, NSEG * 50)) by shared-memory atomics, then
//    one global atomic per nonzero count: freqs [B, 258].
// 3. init: per block, the 20 initial candidate tables (huffman.
//    initial_tables) and banzai's 3 pseudo tables (banzai_plan.
//    _initial_partition), both scans over the 258 symbols.
// 4. assign, once per refinement iteration: per (segment tile, block) CTA,
//    the current 20 tables (iteration 0: and the 3 pseudo tables) as
//    10-bit fields in shared memory; 8 lanes per 50-symbol segment (4
//    segments a warp at a time) sum each table's lengths over the
//    segment's symbols, pick each candidate's first table of least cost
//    (and banzai's, iteration 0), write the selectors and add the
//    segment's symbols to the chosen tables' counts (tf) with shared
//    atomics, one per distinct symbol of a segment (__match_any_sync),
//    then global atomics per nonzero count.
//    Integer sums give the same counts in any order.  Segments past the
//    live lanes cost nothing and select table 0, as the plain version's
//    all-zero costs do.
// 5. pm, once per iteration: one CTA per (table row, block), plus the
//    single-table row in the last iteration: package-merge, 17-bit
//    limited.  A stable rank of (weight, symbol) orders the leaves; each
//    of the 17 levels merges the sorted leaves with the sorted packages, a
//    thread per item placing it by one binary search in the other list,
//    leaves first at equal weight, which is the order of the plain
//    version's sort of (weight << 1 | tag) keys, so every level holds the
//    same sequence of weights and tags; a bitmask of each level's tags
//    gives the backward count recurrence.
// 6. mtf: per (candidate, block), the selector MTF: each thread
//    summarises a chunk of selectors as its recency list, a block scan
//    composes the summaries, and each thread walks its chunk again from
//    the list before it, for the indices and their bits.
// 7. score: per block, the delta and payload bits of each table (a warp a
//    table), the single-table candidate, the winner (first of equal
//    totals) and the outputs, int64 as the plain version returns them.
//
// Nothing is atomic in float, and every sum is an integer sum, so the
// result does not depend on the order of the atomics: deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int S = 258;           // MAX_SYMS
constexpr int T = 6;             // MAX_TABLES
constexpr int NC = 5;            // candidates of 2..6 tables
constexpr int K = 20;            // their tables, one column each
constexpr int BNT = 3;           // banzai's pseudo tables
constexpr int W = 50;            // SEGMENT_WIDTH
constexpr int L = 17;            // CODEWORD_MAX_LEN
constexpr int kInfW = 1 << 29;   // > any finite package weight
constexpr int kTagWords = (2 * S + 31) / 32;

constexpr int kThreads = 256;              // zero, hist, init, mtf, score
constexpr int kPmThreads = 2 * S + 28;     // pm: a thread per merged item
constexpr int kHistTile = kThreads * 64;   // lanes per hist CTA
constexpr int kAssignThreads = 512;
constexpr int kAssignWarps = kAssignThreads / 32;
constexpr int kGroup = 8;                    // lanes a segment in assign
constexpr int kPer = (W + kGroup - 1) / kGroup;   // its symbols a lane: 7
constexpr int kQuad = 32 / kGroup;           // segments a warp at a time
constexpr int kSegTile = kAssignWarps * 32;  // segments per assign CTA

// First column of candidate c (nt = c + 2 tables): 0, 2, 5, 9, 14, 20.
__host__ __device__ constexpr int col_lo(int c) { return c * (c + 3) / 2; }

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int64_t live_lanes(const int* out_len, int b,
                                              int M, int nseg) {
  int64_t lim = out_len[b];
  lim = lim < M ? lim : M;
  const int64_t cap = (int64_t)nseg * W;
  lim = lim < cap ? lim : cap;
  return lim > 0 ? lim : 0;
}

// -- 1. zero -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    plan_zero_kernel(int* __restrict__ p, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    p[i] = 0;
}

// -- 2. hist -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    plan_hist_kernel(const int* __restrict__ syms,
                     const int* __restrict__ out_len, int* __restrict__ freqs,
                     int M, int nseg) {
  __shared__ int h[S];
  const int b = blockIdx.y;
  const int64_t lim = live_lanes(out_len, b, M, nseg);
  const int64_t p0 = (int64_t)blockIdx.x * kHistTile;
  if (p0 >= lim) return;
  for (int s = threadIdx.x; s < S; s += kThreads) h[s] = 0;
  __syncthreads();
  const int* row = syms + (int64_t)b * M;
  for (int i = threadIdx.x; i < kHistTile; i += kThreads) {
    const int64_t p = p0 + i;
    const int s = p < lim ? row[p] : -1;
    if ((unsigned)s < (unsigned)S) atomicAdd(&h[s], 1);   // 258: past out_len
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads)
    if (h[s]) atomicAdd(&freqs[(int64_t)b * S + s], h[s]);
}

// -- 3. init -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    plan_init_kernel(const int* __restrict__ freqs,
                     const int* __restrict__ out_len,
                     const int64_t* __restrict__ num_syms,
                     uint8_t* __restrict__ lens, uint8_t* __restrict__ pseudo) {
  __shared__ int64_t cum[S];        // inclusive sums of freqs below ns
  __shared__ int64_t base_s, target_s;
  __shared__ int first_s;
  __shared__ int lo_t[BNT], hi_t[BNT];
  const int b = blockIdx.x;
  const int64_t ns = num_syms[b];
  const int* f = freqs + (int64_t)b * S;
  if (threadIdx.x < 32) {
    // Warp 0 scans the 258 counts, 9 consecutive symbols a lane.
    constexpr int kPer = (S + 31) / 32;
    const int lane = threadIdx.x;
    int64_t run = 0;
    for (int j = 0; j < kPer; ++j) {
      const int s = lane * kPer + j;
      if (s < S && s < ns) run += f[s] > 0 ? f[s] : 0;
    }
    int64_t inc = run;
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    int64_t acc = inc - run;
    for (int j = 0; j < kPer; ++j) {
      const int s = lane * kPer + j;
      if (s < S) {
        if (s < ns) acc += f[s] > 0 ? f[s] : 0;
        cum[s] = acc;
      }
    }
  }
  __syncthreads();

  // The candidates' initial tables: symbol s belongs to table
  // floor((cum(s) - 1) * nt / total); 0 there, 15 elsewhere.
  const int64_t total = cum[S - 1] > 1 ? cum[S - 1] : 1;
  uint8_t* lrow = lens + (int64_t)b * (K + 1) * S;
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const int64_t cm = cum[s] > 1 ? cum[s] - 1 : 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int nt = c + 2;
      int64_t owner = cm * nt / total;
      owner = owner < nt - 1 ? owner : nt - 1;
      for (int t = 0; t < nt; ++t)
        lrow[(int64_t)(col_lo(c) + t) * S + s] = owner == t ? 0 : 15;
    }
  }

  // Banzai's pseudo tables: contiguous ranges of about equal frequency
  // (banzai_plan._initial_partition), one table after the other.
  const int ntb = ns < 200 ? 2 : 3;
  int64_t left = 0;
  int64_t rem = out_len[b];
  for (int t = 0; t < BNT; ++t) {
    const bool empty = left >= ns;
    if (threadIdx.x == 0) {
      const int64_t den = ntb - t > 1 ? ntb - t : 1;
      target_s = floor_div(rem, den);
      const int64_t g = left - 1 > 0 ? left - 1 : 0;
      base_s = left > 0 ? cum[g < S ? g : S - 1] : 0;
      first_s = S;
    }
    __syncthreads();
    const int64_t base = base_s, target = target_s;
    for (int s = threadIdx.x; s < S; s += kThreads)
      if (s >= left && s < ns && cum[s] - base >= target)
        atomicMin(&first_s, s);
    __syncthreads();
    int64_t right = first_s < S ? (first_s < ns - 1 ? first_s : ns - 1)
                                : ns - 1;
    // Only an interior odd table shrinks by one symbol.
    if (t == 1 && ntb == 3 && right > left) right -= 1;
    const int64_t g = right < 0 ? 0 : (right < S ? right : S - 1);
    const int64_t acc = cum[g] - base;
    if (threadIdx.x == 0) {
      lo_t[t] = empty ? 1 : (int)left;   // an empty table covers nothing
      hi_t[t] = empty ? 0 : (int)right;
    }
    if (!empty) {
      left = right + 1;
      rem -= acc;
    }
    __syncthreads();
  }
  uint8_t* prow = pseudo + (int64_t)b * BNT * S;
  for (int s = threadIdx.x; s < S; s += kThreads)
    for (int t = 0; t < BNT; ++t)
      prow[t * S + s] = (s >= lo_t[t] && s <= hi_t[t]) ? 15 : 0;
}

// -- 4. assign -----------------------------------------------------------

// kBanzai (iteration 0): banzai's 3 pseudo tables ride in columns 20-22.
template <bool kBanzai>
__global__ void __launch_bounds__(kAssignThreads)
    plan_assign_kernel(const int* __restrict__ syms,
                       const int* __restrict__ out_len,
                       const int64_t* __restrict__ num_syms,
                       const uint8_t* __restrict__ lens,
                       const uint8_t* __restrict__ pseudo,
                       uint8_t* __restrict__ sel, int* __restrict__ tf,
                       int* __restrict__ split, int M, int nseg, int nsp) {
  constexpr int NCOL = kBanzai ? K + BNT : K;
  // A symbol's lengths in all tables: three 10-bit fields a word, 8 words
  // (two 16-byte loads) a symbol.
  __shared__ uint4 tab[S][2];
  __shared__ int cnt[NCOL * S];
  const int b = blockIdx.y;
  const int seg_lo = blockIdx.x * kSegTile;
  const int seg_hi = min(nseg, seg_lo + kSegTile);
  const int64_t lim = live_lanes(out_len, b, M, nseg);
  const int64_t live_segs = (lim + W - 1) / W;
  const int live_hi = live_segs < seg_hi ? (int)live_segs : seg_hi;

  // Segments with no live lane: every cost is 0, so table 0 everywhere.
  {
    const int n0 = live_hi > seg_lo ? live_hi : seg_lo;
    const int span = seg_hi - n0;
    for (int i = threadIdx.x; i < NC * span; i += kAssignThreads) {
      const int c = i / span;
      sel[((int64_t)b * NC + c) * nsp + n0 + i % span] = 0;
    }
  }
  if (live_hi <= seg_lo) return;

  const uint8_t* lrow = lens + (int64_t)b * (K + 1) * S;
  const uint8_t* prow = pseudo + (int64_t)b * BNT * S;
  for (int s = threadIdx.x; s < S; s += kAssignThreads) {
    uint32_t v[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      v[w] = 0;
#pragma unroll
      for (int h = 0; h < 3; ++h) {
        const int k = 3 * w + h;
        uint32_t x = 0;
        if (k < K)
          x = lrow[(int64_t)k * S + s];
        else if (k < NCOL)
          x = prow[(k - K) * S + s];
        v[w] |= x << (10 * h);
      }
    }
    tab[s][0] = make_uint4(v[0], v[1], v[2], v[3]);
    tab[s][1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
  for (int i = threadIdx.x; i < NCOL * S; i += kAssignThreads) cnt[i] = 0;
  __syncthreads();

  // A warp takes kQuad consecutive segments at a time, kGroup lanes each:
  // lane j of a group holds the segment's symbols kPer * j .. + kPer - 1.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroup;
  const int j = lane % kGroup;
  const int ntb = num_syms[b] < 200 ? 2 : 3;
  const int* row = syms + (int64_t)b * M;
  auto load = [&](int q, int (&v)[kPer]) {
    const int seg = seg_lo + kQuad * q + g;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t p = (int64_t)seg * W + kPer * j + i;
      int x = (seg < live_hi && kPer * j + i < W && p < lim) ? row[p] : -1;
      v[i] = (unsigned)x < (unsigned)S ? x : -1;
    }
  };
  int next[kPer];
  load(warp, next);
  for (int q = warp; seg_lo + kQuad * q < live_hi; q += kAssignWarps) {
    int v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = next[i];
    load(q + kAssignWarps, next);
    const int seg = seg_lo + kQuad * q + g;
    uint32_t a[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (v[i] < 0) continue;
      const uint4 lo = tab[v[i]][0], hi = tab[v[i]][1];
      a[0] += lo.x, a[1] += lo.y, a[2] += lo.z, a[3] += lo.w;
      a[4] += hi.x, a[5] += hi.y, a[6] += hi.z, a[7] += hi.w;
    }
#pragma unroll
    for (int w = 0; w < (NCOL + 2) / 3; ++w)
#pragma unroll
      for (int d = kGroup / 2; d > 0; d >>= 1)
        a[w] += __shfl_xor_sync(kFull, a[w], d);
    // Each candidate's first table of least cost (costs <= 50 * 17 <
    // 2^10, so no field carries into the next).
    auto cost = [&](int k) { return (a[k / 3] >> (10 * (k % 3))) & 1023u; };
    int col[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int best = col_lo(c);
      uint32_t bc = cost(best);
#pragma unroll
      for (int k = col_lo(c) + 1; k < col_lo(c + 1); ++k) {
        const uint32_t ck = cost(k);
        if (ck < bc) {
          bc = ck;
          best = k;
        }
      }
      col[c] = best;
    }
    int bz = 0;
    if constexpr (kBanzai) {
      uint32_t bc = cost(K);
#pragma unroll
      for (int t = 1; t < BNT; ++t) {
        const uint32_t ck = cost(K + t);
        if (t < ntb && ck < bc) {
          bc = ck;
          bz = t;
        }
      }
    }
    int mine = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (j == c) mine = col[c] - col_lo(c);
    if (j < NC && seg < live_hi)
      sel[((int64_t)b * NC + j) * nsp + seg] = (uint8_t)mine;
    // One atomic per distinct symbol of a segment: the key holds the group.
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = v[i];
      const unsigned peers = __match_any_sync(kFull, s < 0 ? -1 : g << 9 | s);
      if (s >= 0 && lane == __ffs(peers) - 1) {
        const int n = __popc(peers);
#pragma unroll
        for (int c = 0; c < NC; ++c) atomicAdd(&cnt[col[c] * S + s], n);
        if constexpr (kBanzai) atomicAdd(&cnt[(K + bz) * S + s], n);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NCOL * S; i += kAssignThreads) {
    const int v = cnt[i];
    if (!v) continue;
    if (i < K * S)
      atomicAdd(&tf[(int64_t)b * K * S + i], v);
    else
      atomicAdd(&split[(int64_t)b * BNT * S + i - K * S], v);
  }
}

// -- 5. pm ---------------------------------------------------------------

// Entries of a[0, n) (sorted) below x, or at most x.
__device__ __forceinline__ int count_below(const int* a, int n, int x,
                                           bool inclusive) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x || (inclusive && a[mid] == x))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Row r < K of block b: table r's counts tf[b][r]; row K: freqs[b], the
// single-table candidate.  Writes the lengths to lens[b][r].
__global__ void __launch_bounds__(kPmThreads)
    plan_pm_kernel(const int* __restrict__ tf, const int* __restrict__ freqs,
                   const int64_t* __restrict__ num_syms,
                   uint8_t* __restrict__ lens) {
  __shared__ int w[S], leaf[S], order[S], pkg[S], merged[2 * S];
  __shared__ unsigned tags[L][kTagWords];
  __shared__ int x[L];
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t ns = num_syms[b];
  const int* src =
      r < K ? tf + ((int64_t)b * K + r) * S : freqs + (int64_t)b * S;
  for (int s = threadIdx.x; s < S; s += kPmThreads)
    w[s] = s < ns ? (src[s] > 1 ? src[s] : 1) : kInfW;
  for (int i = threadIdx.x; i < L * kTagWords; i += kPmThreads)
    (&tags[0][0])[i] = 0u;
  for (int j = threadIdx.x; j < S; j += kPmThreads) pkg[j] = kInfW;
  __syncthreads();
  // Stable ascending order of the leaves: ties keep symbol order.  The
  // symbols at or past ns weigh kInfW, more than any other, so they keep
  // their places.
  const int live = ns < S ? (ns > 0 ? (int)ns : 0) : S;
  for (int i = threadIdx.x; i < S; i += kPmThreads) {
    const int wi = w[i];
    int rank = i;
    if (i < live) {
      rank = 0;
      for (int j = 0; j < live; ++j) {
        const int wj = w[j];
        rank += (wj < wi) | ((wj == wi) & (j < i));
      }
    }
    leaf[rank] = wi;
    order[rank] = i;
  }
  __syncthreads();
  // A level: thread t < S places leaf t, thread S + j package j.  The
  // first `live` leaves and `fin` packages are finite (a package of two
  // finite items weighs less than the total count, < kInfW), and each list
  // is sorted, so an item of weight kInfW has its place without a search.
  const int t = threadIdx.x;
  int fin = 0;
  for (int l = 0; l < L; ++l) {
    if (t < S) {
      const int pos =
          t < live ? t + count_below(pkg, fin, leaf[t], false) : t + fin;
      merged[pos] = leaf[t];
    } else if (t < 2 * S) {
      const int j = t - S;
      const int pos =
          j < fin ? j + count_below(leaf, live, pkg[j], true) : j + S;
      merged[pos] = pkg[j];
      atomicOr(&tags[l][pos >> 5], 1u << (pos & 31));
    }
    __syncthreads();
    if (t < S) {
      const int sum = merged[2 * t] + merged[2 * t + 1];
      pkg[t] = sum < kInfW ? sum : kInfW;
    }
    fin = (live + fin) / 2;
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    // c_{l-1} = 2 * (packages among the first c_l items of level l); lane
    // q counts the tags of word q below c_l.
    const int lane = threadIdx.x;
    int64_t c = 2 * ns - 2;
    for (int l = L - 1; l >= 0; --l) {
      const int n = c <= 0 ? 0 : (c < 2 * S ? (int)c : 2 * S);
      const int below = n - 32 * lane;
      int p = 0;
      if (lane < kTagWords && below > 0)
        p = __popc(below >= 32 ? tags[l][lane]
                               : tags[l][lane] & ((1u << below) - 1u));
      for (int d = 16; d > 0; d >>= 1) p += __shfl_xor_sync(kFull, p, d);
      if (lane == 0) x[l] = (int)(c - p);
      c = 2 * (int64_t)p;
    }
  }
  __syncthreads();
  uint8_t* out = lens + ((int64_t)b * (K + 1) + r) * S;
  for (int i = threadIdx.x; i < S; i += kPmThreads) {
    int len = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) len += i < x[l];
    const int s = order[i];
    out[s] = s < ns ? (uint8_t)len : 0;
  }
}

// -- 6. mtf and 7. score --------------------------------------------------

// A move-to-front list of the 6 tables: entry i (0 = front) in bits
// [4i, 4i + 4).  A run of selectors is summarised by its distinct tables,
// latest use first, in the same form: the list after the run is the
// summary followed by the rest of the list before it.
constexpr uint32_t kIdentity = 0x543210u;

__device__ __forceinline__ int mtf_find(uint32_t list, int v) {
  int i = 0;
#pragma unroll
  for (int j = 0; j < T; ++j)
    if (((list >> (4 * j)) & 15u) == (uint32_t)v) i = j;
  return i;
}

__device__ __forceinline__ uint32_t mtf_front(uint32_t list, int i, int v) {
  const uint32_t below = list & ((1u << (4 * i)) - 1u);
  const uint32_t above = list & ~((1u << (4 * i + 4)) - 1u);
  return above | (below << 4) | (uint32_t)v;
}

// The summary of a run summarised by (ra, na) followed by one summarised
// by (rb, nb); its count goes to *n.  With na = 6 it is the MTF list
// after the second run from the list ra.
__device__ __forceinline__ uint32_t rec_then(uint32_t ra, int na, uint32_t rb,
                                             int nb, int* n) {
  uint32_t out = rb & ((1u << (4 * nb)) - 1u);
  int k = nb;
  for (int j = 0; j < na; ++j) {
    const uint32_t v = (ra >> (4 * j)) & 15u;
    bool seen = false;
    for (int i = 0; i < nb; ++i) seen |= ((rb >> (4 * i)) & 15u) == v;
    if (!seen) {
      out |= v << (4 * k);
      ++k;
    }
  }
  *n = k;
  return out;
}

// Selector j of a 16-byte word (j < 16).
__device__ __forceinline__ int sel_byte(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 255u;
}

// Per (candidate, block): the selector MTF indices (bytes, into idx) and
// their bits over the live selectors (into bits[b][c]).  Thread t walks
// chunk t of whole 16-byte words; a block scan of the chunks' summaries
// gives each its list before it.
__global__ void __launch_bounds__(kThreads)
    plan_mtf_kernel(const uint8_t* __restrict__ sel,
                    const int* __restrict__ out_len, uint8_t* __restrict__ idx,
                    int* __restrict__ bits, int nseg, int nsp) {
  __shared__ uint32_t wr[kThreads / 32];
  __shared__ int wn[kThreads / 32], wbits[kThreads / 32];
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row_off = ((int64_t)b * NC + c) * nsp;
  const uint8_t* row = sel + row_off;
  const int64_t used = floor_div((int64_t)out_len[b] + W - 1, W);
  const int64_t live = used < nseg ? used : nseg;   // selectors that count
  const int chunk = ((nseg + kThreads - 1) / kThreads + 15) / 16 * 16;
  const int lo = min(nseg, (int)threadIdx.x * chunk);
  const int hi = min(nseg, lo + chunk);

  uint32_t r = 0;   // this chunk's summary
  int n = 0;
  for (int p0 = lo + (hi - lo - 1) / 16 * 16; hi > lo && p0 >= lo && n < T;
       p0 -= 16) {
    const uint4 v4 = *reinterpret_cast<const uint4*>(row + p0);
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      const uint32_t v = sel_byte(v4, j);
      if (p0 + j >= hi || n == T) continue;
      bool seen = false;
      for (int i = 0; i < n; ++i) seen |= ((r >> (4 * i)) & 15u) == v;
      if (!seen) {
        r |= v << (4 * n);
        ++n;
      }
    }
  }
  // Inclusive scan over the warp, then over the warps before this one.
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t ro = __shfl_up_sync(kFull, r, d);
    const int no = __shfl_up_sync(kFull, n, d);
    if (lane >= d) r = rec_then(ro, no, r, n, &n);
  }
  uint32_t er = __shfl_up_sync(kFull, r, 1);   // exclusive, in the warp
  int en = __shfl_up_sync(kFull, n, 1);
  if (lane == 0) er = 0, en = 0;
  if (lane == 31) wr[warp] = r, wn[warp] = n;
  __syncthreads();
  uint32_t pr = 0;
  int pn = 0;
  for (int w = 0; w < warp; ++w) pr = rec_then(pr, pn, wr[w], wn[w], &pn);
  pr = rec_then(pr, pn, er, en, &pn);
  uint32_t list = rec_then(kIdentity, T, pr, pn, &pn);

  int sum = 0;
  uint8_t* out = idx + row_off;
  for (int p0 = lo; p0 < hi; p0 += 16) {
    const uint4 v4 = *reinterpret_cast<const uint4*>(row + p0);
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int v = sel_byte(v4, j);
      const int i = mtf_find(list, v);
      list = mtf_front(list, i, v);
      o[j >> 2] |= (uint32_t)i << (8 * (j & 3));
      if (p0 + j < live) sum += i + 1;
    }
    // Bytes past nseg (the row's padding) are never read back.
    *reinterpret_cast<uint4*>(out + p0) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
  if (lane == 0) wbits[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += wbits[w];
    bits[b * NC + c] = total;
  }
}

__global__ void __launch_bounds__(kThreads)
    plan_score_kernel(const uint8_t* __restrict__ sel,
                      const uint8_t* __restrict__ idx,
                      const int* __restrict__ mtf_bits,
                      const int* __restrict__ tf, const int* __restrict__ freqs,
                      const uint8_t* __restrict__ lens,
                      const int* __restrict__ split,
                      const int* __restrict__ out_len,
                      const int64_t* __restrict__ num_syms,
                      int64_t* __restrict__ num_tables,
                      int64_t* __restrict__ tables,
                      int64_t* __restrict__ selectors,
                      int64_t* __restrict__ sel_mtf_idx,
                      int64_t* __restrict__ total_bits,
                      int64_t* __restrict__ nseg_used,
                      int64_t* __restrict__ banzai_split, int nseg, int nsp) {
  __shared__ int64_t delta[K + 1], pay[K + 1];
  __shared__ int win_s;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t ns = num_syms[b];
  const int64_t used = floor_div((int64_t)out_len[b] + W - 1, W);
  // Column k < K: table k with its counts; k == K: the single table; one
  // warp a column.
  for (int k = warp; k <= K; k += kThreads / 32) {
    const uint8_t* l = lens + ((int64_t)b * (K + 1) + k) * S;
    const int* cnt =
        k < K ? tf + ((int64_t)b * K + k) * S : freqs + (int64_t)b * S;
    int64_t d = 0, q = 0;
    for (int s = lane; s < S; s += 32) {
      if (s >= 1 && s < ns) d += abs((int)l[s] - (int)l[s - 1]);
      q += (int64_t)cnt[s] * l[s];
    }
    for (int o = 16; o > 0; o >>= 1) {
      d += __shfl_xor_sync(kFull, d, o);
      q += __shfl_xor_sync(kFull, q, o);
    }
    if (lane == 0) {
      delta[k] = 5 + ns + 2 * d;
      pay[k] = q;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // Single table: selectors all 0 (1 bit each), an all-15s second table.
    const int64_t live = used < nseg ? used : nseg;
    int64_t best = live + delta[K] + (5 + ns) + pay[K];
    int win = 0;
    for (int c = 0; c < NC; ++c) {
      int64_t bits = mtf_bits[b * NC + c];
      for (int k = col_lo(c); k < col_lo(c + 1); ++k) bits += delta[k] + pay[k];
      if (bits < best) {
        best = bits;
        win = c + 1;
      }
    }
    win_s = win;
    num_tables[b] = win == 0 ? 2 : win + 1;
    total_bits[b] = best;
    nseg_used[b] = used;
  }
  __syncthreads();
  const int win = win_s;
  const int c = win - 1;
  const uint8_t* lrow = lens + (int64_t)b * (K + 1) * S;
  for (int i = threadIdx.x; i < T * S; i += kThreads) {
    const int t = i / S, s = i % S;
    int64_t v;
    if (win == 0)
      v = t == 0 ? lrow[(int64_t)K * S + s] : (s < ns ? 15 : 0);
    else
      v = t < c + 2 ? lrow[(int64_t)(col_lo(c) + t) * S + s] : 0;
    tables[(int64_t)b * T * S + i] = v;
  }
  for (int i = threadIdx.x; i < BNT * S; i += kThreads)
    banzai_split[(int64_t)b * BNT * S + i] = split[(int64_t)b * BNT * S + i];
  int64_t* srow = selectors + (int64_t)b * nseg;
  int64_t* irow = sel_mtf_idx + (int64_t)b * nseg;
  const int64_t off = ((int64_t)b * NC + (win == 0 ? 0 : c)) * nsp;
  for (int p = threadIdx.x; p < nseg; p += kThreads) {
    srow[p] = win == 0 ? 0 : sel[off + p];
    irow[p] = win == 0 ? 0 : idx[off + p];
  }
}

template <class Kern, class... Args>
int launch(Kern kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
           Args... args) {
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch bytes of one call; ops/plan_kernel.plan_scratch_bytes computes
// the same.  Layout: int32 freqs [B, S], tf [4, B, K, S] (one per
// iteration), split [B, BNT, S] (zeroed by the call); then bytes: lens
// [B, K + 1, S], pseudo [B, BNT, S], the candidates' selectors and their
// MTF indices [B, NC, nsp] each, nsp = nseg rounded up to 16 (every row
// starts 16-byte aligned); then int32 MTF bits [B, NC].
static int64_t scratch_bytes_for(int64_t B, int64_t nsp) {
  return 4 * B * S * (1 + 4 * K + BNT) + B * S * (K + 1 + BNT) +
         2 * B * NC * nsp + 4 * B * NC;
}

// syms: int32 [B, M] RLE2 symbols (258 past out_len); out_len: int32 [B];
// num_syms: int64 [B].  Outputs, int64: num_tables [B], tables [B, 6, S],
// selectors and sel_mtf_idx [B, nseg], total_bits and nseg_used [B],
// banzai_split [B, 3, S].  1 <= B <= 65535, 1 <= nseg, nseg * 50 < 2^29
// (so every count, and every package weight, stays below kInfW).
extern "C" int entropy_plan(const int* syms, const int* out_len,
                            const int64_t* num_syms, int64_t* num_tables,
                            int64_t* tables, int64_t* selectors,
                            int64_t* sel_mtf_idx, int64_t* total_bits,
                            int64_t* nseg_used, int64_t* banzai_split,
                            void* scratch, int64_t scratch_bytes, int B, int M,
                            int nseg, void* stream) {
  const int64_t nsp = ((int64_t)nseg + 15) / 16 * 16;
  if (B < 1 || B > 65535 || M < 0 || nseg < 1 ||
      (int64_t)nseg * W >= kInfW ||
      scratch_bytes != scratch_bytes_for(B, nsp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* freqs = (int*)scratch;
  int* tf = freqs + (int64_t)B * S;
  int* split = tf + 4 * (int64_t)B * K * S;
  uint8_t* lens = (uint8_t*)(split + (int64_t)B * BNT * S);
  uint8_t* pseudo = lens + (int64_t)B * (K + 1) * S;
  uint8_t* sel = pseudo + (int64_t)B * BNT * S;
  uint8_t* idx = sel + (int64_t)B * NC * nsp;
  int* mtf_bits = (int*)(idx + (int64_t)B * NC * nsp);
  const int64_t zero_words = (int64_t)B * S * (1 + 4 * K + BNT);
  const int64_t cap = (int64_t)nseg * W;
  const int64_t lanes = M < cap ? M : cap;
  const int64_t zero_ctas = (zero_words + kThreads - 1) / kThreads;
  const int64_t hist_tiles =
      lanes > 0 ? (lanes + kHistTile - 1) / kHistTile : 1;
  const dim3 hist_grid((unsigned)hist_tiles, (unsigned)B);
  const dim3 seg_grid((unsigned)((nseg + kSegTile - 1) / kSegTile),
                      (unsigned)B);
  int err = launch(plan_zero_kernel,
                   dim3((unsigned)(zero_ctas < 2048 ? zero_ctas : 2048)),
                   kThreads, 0, st, freqs, zero_words);
  if (!err)
    err = launch(plan_hist_kernel, hist_grid, kThreads, 0, st, syms, out_len,
                 freqs, M, nseg);
  if (!err)
    err = launch(plan_init_kernel, dim3((unsigned)B), kThreads, 0, st,
                 (const int*)freqs, out_len, num_syms, lens, pseudo);
  for (int it = 0; it < 4 && !err; ++it) {
    int* tf_it = tf + it * (int64_t)B * K * S;
    if (it == 0)
      err = launch(plan_assign_kernel<true>, seg_grid, kAssignThreads, 0, st,
                   syms, out_len, num_syms, (const uint8_t*)lens,
                   (const uint8_t*)pseudo, sel, tf_it, split, M, nseg,
                   (int)nsp);
    else
      err = launch(plan_assign_kernel<false>, seg_grid, kAssignThreads, 0, st,
                   syms, out_len, num_syms, (const uint8_t*)lens,
                   (const uint8_t*)pseudo, sel, tf_it, split, M, nseg,
                   (int)nsp);
    if (!err)
      err = launch(plan_pm_kernel, dim3(it == 3 ? K + 1 : K, (unsigned)B),
                   kPmThreads, 0, st, (const int*)tf_it, (const int*)freqs,
                   num_syms, lens);
  }
  if (!err)
    err = launch(plan_mtf_kernel, dim3(NC, (unsigned)B), kThreads, 0, st,
                 (const uint8_t*)sel, out_len, idx, mtf_bits, nseg, (int)nsp);
  if (!err)
    err = launch(plan_score_kernel, dim3((unsigned)B), kThreads, 0, st,
                 (const uint8_t*)sel, (const uint8_t*)idx,
                 (const int*)mtf_bits,
                 (const int*)(tf + 3 * (int64_t)B * K * S),
                 (const int*)freqs, (const uint8_t*)lens, (const int*)split,
                 out_len, num_syms, num_tables, tables, selectors, sel_mtf_idx,
                 total_bits, nseg_used, banzai_split, nseg, (int)nsp);
  return err;
}
