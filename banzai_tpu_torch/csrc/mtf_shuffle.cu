// Within-chunk move-to-front shuffle (kernel K1).
//
// Replaces the Pallas TPU kernel banzai_tpu/ops/mtf_pallas.py
// (mtf_shuffle_pallas, body _make_kernel).  For every chunk c and step t,
// out[c, t] is the position of syms[c, t] in the chunk's 256-entry recency
// state, and that symbol then moves to the front.  A pad symbol (-1)
// leaves the state alone and yields -1.
//
// What bounds it on the card: the shuffle is a dependent chain of K steps
// per chunk, so it is bound by the latency of each step, not by memory
// (each chunk reads 256 + K ints and writes K).  The TPU kernel kept the
// state resident in VMEM and ran chunks as lanes over a sequential grid;
// here chunks are independent, so each warp owns one chunk and keeps the
// 256 state entries in registers, 8 per lane (lane l holds slots
// 8l..8l+7).  One step is 8 compares, a __ballot_sync to find the slot,
// one __shfl_up_sync to carry each lane's last entry into the next lane,
// and 8 selects for the shift.  Symbols and indices move through the warp
// 32 at a time with coalesced loads and stores.
//
// With debug != 0 the kernel also writes err[c]: bit 0 = a valid symbol
// matched no slot, bit 1 = a valid symbol matched more than one slot
// (the state is not a permutation of byte values).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void mtf_shuffle_kernel(const int* __restrict__ syms,
                                   const int* __restrict__ state0,
                                   int* __restrict__ out,
                                   int* __restrict__ err,
                                   int64_t C, int K, int debug) {
  const int lane = threadIdx.x & 31;
  const int64_t c =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= C) return;  // whole warps exit together

  int st[8];
  const int4* s4 = reinterpret_cast<const int4*>(state0 + c * 256 + lane * 8);
  const int4 a = s4[0];
  const int4 b = s4[1];
  st[0] = a.x; st[1] = a.y; st[2] = a.z; st[3] = a.w;
  st[4] = b.x; st[5] = b.y; st[6] = b.z; st[7] = b.w;

  const int* row = syms + c * K;
  int* orow = out + c * K;
  int my_sym = -1;
  int my_out = -1;
  int errbits = 0;
  for (int t = 0; t < K; ++t) {
    const int j = t & 31;
    if (j == 0) my_sym = (t + lane < K) ? row[t + lane] : -1;
    const int s = __shfl_sync(kFull, my_sym, j);

    int local = -1;  // first matching slot of this lane
    int nlocal = 0;
#pragma unroll
    for (int q = 7; q >= 0; --q) {
      if (st[q] == s) { local = q; ++nlocal; }
    }
    const unsigned hits = __ballot_sync(kFull, local >= 0);
    int idx = -1;
    if (s >= 0 && hits) {
      const int src = __ffs(hits) - 1;
      idx = src * 8 + __shfl_sync(kFull, local, src);
    }
    if (debug && s >= 0) {
      const int total = __reduce_add_sync(kFull, nlocal);
      if (total == 0) errbits |= 1;
      if (total > 1) errbits |= 2;
    }

    // Shift slots [0, idx) up by one and put s at slot 0.
    const int carry = __shfl_up_sync(kFull, st[7], 1);
    if (idx >= 0) {
#pragma unroll
      for (int q = 7; q >= 1; --q) {
        if (lane * 8 + q <= idx) st[q] = st[q - 1];
      }
      if (lane * 8 <= idx) st[0] = (lane == 0) ? s : carry;
    }

    if (lane == j) my_out = idx;
    if (j == 31 || t == K - 1) {
      if (lane <= j) orow[t - j + lane] = my_out;
    }
  }
  if (debug && lane == 0) err[c] = errbits;
}

}  // namespace

extern "C" int mtf_shuffle(const int* syms, const int* state0, int* out,
                           int* err, int64_t C, int K, int debug,
                           void* stream) {
  if (C > 0) {
    const int64_t blocks = (C + kWarpsPerBlock - 1) / kWarpsPerBlock;
    mtf_shuffle_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(syms, state0, out, err, C,
                                                 K, debug);
  }
  return (int)cudaGetLastError();
}
