// Within-chunk move-to-front shuffle (kernel K1).
//
// Replaces the Pallas TPU kernel banzai_tpu/ops/mtf_pallas.py
// (mtf_shuffle_pallas, body _make_kernel).  For every chunk c and step t,
// out[c, t] is the position of syms[c, t] in the chunk's 256-entry recency
// state, and that symbol then moves to the front.  A pad symbol (-1), or a
// symbol that no slot holds, leaves the state alone and yields -1.
//
// What bounds it on the card.  The shuffle is a chain of K dependent steps
// per chunk; each chunk reads 4K + 1024 bytes and writes 4K.  At the main
// path's chunk (ops/mtf.CHUNK = 2048) the bytes take ~0.02 ms for a
// level-9 batch of 8 blocks, while one warp-step per symbol is 7.2 M
// warp-steps of ~33 instructions on 3,520 warps, ~27 per SM: the latency
// of the step chain (~12 dependent instructions and a vote) with too few
// warps to hide it, and the instruction issue, set the pace, far above the
// bytes.  The chunk is long because the chunk states around the kernel
// (ops/mtf.chunk_states) shrink with it.  The design cuts instructions
// and registers per step and keeps every memory access off the chain:
//
// * One warp per chunk; the state lives in registers, byte-packed: lane l
//   holds slots 8l..8l+7 in two 32-bit words (lo = slots 8l..8l+3, byte b
//   of lo = slot 8l+b; hi = slots 8l+4..8l+7).
// * Match: the per-byte equality of __vcmpeq4, written as the exact
//   zero-byte test on (word ^ s * 0x01010101), which leaves bit 7 of each
//   matching byte set (four integer ops a word; vset4 is emulated on
//   sm_90).  A __ballot_sync finds the first lane with a match, src.
// * Shift: each lane shifts its 8 bytes up by one with two funnel shifts,
//   the byte carried in from the lane below by one __shfl_up_sync of its
//   hi word (lane 0 takes s).  Lanes below src keep the shifted bytes,
//   lane src keeps them for bytes 0..first match (the mask z ^ (z - 1) of
//   its 64-bit match word z), lanes above src keep their old bytes.  The
//   index is the count of moved bytes less one (a __reduce_add_sync of
//   the masks' popcounts), stored by lane 0: no divergent branch.
// * Memory: the warp stages its chunk's symbols into shared memory with
//   cp.async in tiles of kTile, the next tile in flight while the current
//   one runs (double buffer); the indices go to a shared tile and are
//   written back from there, coalesced, once per tile.  A step reads its
//   symbol from shared memory four at a time (one 16-byte broadcast load).
//
// The kernel is templated on kDebug: the debug build also writes err[c]:
// bit 0 = a valid symbol matched no slot, bit 1 = a valid symbol matched
// more than one slot (the state is not a permutation of byte values),
// bit 2 = state0 holds a value outside 0..255.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 256;  // symbols per staged tile
constexpr unsigned kFull = 0xffffffffu;

struct WarpTiles {
  int in[2][kTile];  // double-buffered symbols
  int out[kTile];    // indices of the tile being run
};

// Bit 7 of each byte of w that equals the byte broadcast in sb.
__device__ __forceinline__ uint32_t byte_eq(uint32_t w, uint32_t sb) {
  const uint32_t x = w ^ sb;
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

__device__ __forceinline__ uint32_t pack4(int4 v) {
  return (uint32_t)(v.x & 0xff) | ((uint32_t)(v.y & 0xff) << 8) |
         ((uint32_t)(v.z & 0xff) << 16) | ((uint32_t)(v.w & 0xff) << 24);
}

// Stage len symbols from global src into shared dst (one commit group).
__device__ __forceinline__ void stage(int* dst, const int* src, int len,
                                      int vec, int lane) {
  if (vec) {
    for (int j = lane * 4; j < len; j += 128)
      __pipeline_memcpy_async(dst + j, src + j, 16);
  } else {
    for (int j = lane; j < len; j += 32)
      __pipeline_memcpy_async(dst + j, src + j, 4);
  }
  __pipeline_commit();
}

template <bool kDebug>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    mtf_shuffle_kernel(const int* __restrict__ syms,
                       const int* __restrict__ state0, int* __restrict__ out,
                       int* __restrict__ err, int64_t C, int K, int vec) {
  __shared__ __align__(16) WarpTiles tiles[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int warp = threadIdx.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (c >= C) return;  // whole warps exit together
  WarpTiles& tw = tiles[warp];
  const int* row = syms + c * K;
  int* orow = out + c * K;

  const int ntiles = (K + kTile - 1) / kTile;
  stage(tw.in[0], row, min(K, kTile), vec, lane);

  const int4* s4 = reinterpret_cast<const int4*>(state0 + c * 256 + lane * 8);
  const int4 a = s4[0];
  const int4 b = s4[1];
  uint32_t lo = pack4(a);
  uint32_t hi = pack4(b);
  int errbits = 0;
  if (kDebug) {
    const int any = a.x | a.y | a.z | a.w | b.x | b.y | b.z | b.w;
    if (__any_sync(kFull, any & ~0xff)) errbits |= 4;
  }

  for (int i = 0; i < ntiles; ++i) {
    const int base = i * kTile;
    const int len = min(kTile, K - base);
    if (i + 1 < ntiles) {
      stage(tw.in[(i + 1) & 1], row + base + kTile,
            min(kTile, K - base - kTile), vec, lane);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    int* in = tw.in[i & 1];
    const int len4 = (len + 3) & ~3;
    if (lane < len4 - len) in[len + lane] = -1;  // pad to whole int4s
    __syncwarp();

    const int4* in4 = reinterpret_cast<const int4*>(in);
    for (int t = 0; t < len4; t += 4) {
      const int4 q = in4[t >> 2];
      const int sq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = sq[u];
        const uint32_t sb = (uint32_t)s * 0x01010101u;
        const uint32_t z0 = byte_eq(lo, sb);
        const uint32_t z1 = byte_eq(hi, sb);
        const unsigned hits = __ballot_sync(kFull, s >= 0 && (z0 | z1));
        // lane <= src, the first lane with a match (none: no slot holds s)
        const bool upto_src = hits != 0 && (hits & lanes_below) == 0;
        const uint64_t z = ((uint64_t)z1 << 32) | z0;
        const uint64_t m = upto_src ? (z ^ (z - 1)) : 0;
        const uint32_t m0 = (uint32_t)m;
        const uint32_t m1 = (uint32_t)(m >> 32);
        uint32_t carry = __shfl_up_sync(kFull, hi, 1);
        if (lane == 0) carry = (uint32_t)s << 24;
        const uint32_t nlo = __funnelshift_l(carry, lo, 8);
        const uint32_t nhi = __funnelshift_l(lo, hi, 8);
        lo = (nlo & m0) | (lo & ~m0);
        hi = (nhi & m1) | (hi & ~m1);
        // The warp moved idx + 1 bytes (8 in each lane below src, first
        // match + 1 in lane src) and none when no slot holds s: one
        // reduction gives the index without a branch.
        const int moved = __reduce_add_sync(kFull, __popc(m0) + __popc(m1));
        if (lane == 0) tw.out[t + u] = (moved >> 3) - 1;
        if (kDebug && s >= 0) {
          const int total = __reduce_add_sync(kFull, __popc(z0) + __popc(z1));
          if (total == 0) errbits |= 1;
          if (total > 1) errbits |= 2;
        }
      }
    }
    __syncwarp();
    if (vec) {
      for (int j = lane * 4; j < len; j += 128)
        *reinterpret_cast<int4*>(orow + base + j) =
            *reinterpret_cast<const int4*>(tw.out + j);
    } else {
      for (int j = lane; j < len; j += 32) orow[base + j] = tw.out[j];
    }
    __syncwarp();  // out and in[i & 1] are free for the next tiles
  }
  if (kDebug && lane == 0) err[c] = errbits;
}

}  // namespace

// vec != 0: K % 4 == 0 and syms, out 16-byte aligned (16-byte copies).
extern "C" int mtf_shuffle(const int* syms, const int* state0, int* out,
                           int* err, int64_t C, int K, int vec, int debug,
                           void* stream) {
  if (C > 0 && K > 0) {
    const int64_t blocks = (C + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cudaStream_t st = (cudaStream_t)stream;
    if (debug) {
      mtf_shuffle_kernel<true><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                 st>>>(syms, state0, out, err, C, K, vec);
    } else {
      mtf_shuffle_kernel<false><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                  st>>>(syms, state0, out, err, C, K, vec);
    }
  }
  return (int)cudaGetLastError();
}
