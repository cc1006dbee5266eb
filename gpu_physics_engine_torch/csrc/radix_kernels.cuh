// Hand kernels of the array pipelines' radix sort for Hopper (sm_90a): a
// "onesweep" stable LSD sort of u32 keys with one int32 payload (Merrill &
// Garland 2016, decoupled look-back; Adinets & Merrill 2022, Onesweep).
//
// radix_digit_hist_kernel, once a sort: the 256-bin histogram of each of
//     the four 8-bit digits, hist[pass][digit], from one read of the
//     caller's int64 keys.  A digit histogram does not depend on key
//     order, so this one read serves all four passes; the exclusive scan
//     of a pass's row is that pass's digit bases (where the digit's keys
//     start in the pass's output).  It replaces the digit-major half of
//     the XLA scan of gpu_physics_engine_tpu/ops/radix_sort.py:111-113.
// radix_onesweep_kernel, once a pass: replaces K12, _rank_hist
//     (gpu_physics_engine_tpu/ops/radix_sort.py:80, pallas_call :84,
//     kernel _rank_hist_kernel :51: the stable digit ranks of a key block
//     and its histogram), the block-minor half of that scan, and the XLA
//     scatter and gathers of :114-127.  Each CTA takes a tile of kSweepTile
//     keys, ranks them stably by the digit (key >> shift) & 255, finds
//     where the tile's run of each digit starts by a decoupled look-back
//     over the earlier tiles' counts, and stores key and payload there.
//
// Bound: device memory.  About 80 bytes a key for a whole sort: the
// histogram reads 8 (int64 keys); pass 0 reads the int64 key and the
// payload and writes the u32 key and the payload (20); passes 1 and 2 move
// 16 each; the last pass reads 8 and writes the int64 key and the payload
// (20).  At the 1M scene's 4,403,200 pair keys that is 352 MB, 0.105 ms at
// 3.35 TB/s.  The arithmetic is a few integer operations a key.
//
// Histogram design: a grid of up to one 1024-thread CTA per SM; each warp
// takes segments of 256 keys in turn (lane l reads keys l, l + 32, ...,
// coalesced, 8 in flight).  Each lane keeps, for each of the four digits,
// the digit it last saw and how many times in a row, and adds a run to
// the CTA's shared [4][256] table only when the digit changes: keys that
// share their high bytes (nearby cell ids) cost one shared atomic a run,
// not one a key, and random bytes spread their atomics over the bins.
// (Grouping a warp's lanes with __match_any_sync instead was several
// times slower on random keys: that instruction is slow when a warp
// holds many distinct values.)  The CTA then
// adds its nonzero bins into the global table.  Integer adds: the order
// of a sum of counts does not matter, so the result is exact and
// deterministic.
//
// Onesweep design: 256 threads, 16 keys a thread, at most 64 registers (4
// CTAs an SM).  A CTA takes its tile id from an atomic counter, in launch
// order, so every earlier tile belongs to a CTA that is already running:
// the look-back below can wait for it without any assumption about
// co-residency.  Lane l of warp w holds keys w * 512 + k * 32 + l
// (k = 0..15), loaded with coalesced loads.  In order:
//   1. The tile's count of each digit, with shared atomics, published at
//      once into the look-back array look[tile][digit]: a 64-bit word with
//      the count in the low half and a flag in the high half (pass * 4 + 1:
//      the tile's own count; pass * 4 + 2: the inclusive prefix over tiles
//      0..tile; anything smaller: not yet written in this pass, so one
//      array zeroed once a sort serves all passes).  Publishing before the
//      rank lets the later tiles look back past this one meanwhile, and
//      halves the walks' length.
//   2. The rank, K12's warp multisplit with 16 keys a thread: for k in
//      order, eight ballots give each lane its peers (the lanes with its
//      digit); the lowest peer advances the warp's running count of the
//      digit in shared memory and hands the old count to its peers, so a
//      key's rank in its warp is that count plus its lower peers.  One
//      thread a digit then scans the 8 warps' counts (warp order = key
//      order): the tile-local ranks.
//   3. The staging: keys, then the payloads (loaded only now, all at
//      once, so that they take no registers during the rank), into shared
//      memory in digit order.
//   4. The look-back, one thread a digit: it walks back over the earlier
//      tiles, adding their counts, until it meets an inclusive prefix
//      (acquire loads, release stores at device scope, __nanosleep
//      backoff), then publishes its own inclusive prefix.  It comes after
//      the staging so that the earlier tiles have had that long to publish
//      theirs.
//   5. The store: a key's destination is its digit's base + the tile's
//      exclusive prefix of the digit + its tile-local rank; thread j
//      stores the j-th staged key and payload, so that a warp stores runs
//      of one digit to consecutive addresses.
// A ragged last tile is masked; the first pass reads int64 keys and the
// last writes int64 keys, so the caller's tensor needs no conversion or
// padding.  Every destination follows from the ranks: the only atomics
// whose order varies are the tile counter (which CTA does a tile, not
// what it writes) and integer adds of counts, so the output is
// deterministic and equals the plain version's.  Counts stay below
// n < 2^31: int32.
#pragma once

#include <stdint.h>

namespace gpe {

constexpr int kRadixBins = 256;
constexpr int kRadixPasses = 4;
constexpr int kHistThreads = 1024;
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kSweepPer = 16;  // keys a thread
constexpr int kSweepTile = kSweepThreads * kSweepPer;  // 4,096 keys
constexpr int kWarpKeys = 32 * kSweepPer;  // a warp's 512 consecutive keys
constexpr int kSweepBlocksPerSM = 4;  // 64 registers a thread
constexpr int kHistPer = 8;  // keys a lane of the histogram reads a segment
constexpr int kHistSegment = 32 * kHistPer;

// The sort's scratch, one buffer zeroed once a sort: hist i32[4][256],
// one tile counter a pass i32[kScratchCounters], then the look-back array
// u64[ntiles][256] (8-byte aligned).
constexpr int kScratchCounters = 8;
constexpr long long kLookOffset =
    (kRadixPasses * kRadixBins + kScratchCounters) * 4;  // bytes

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long look_word(unsigned flag,
                                                        int count) {
  return ((unsigned long long)flag << 32) | (unsigned)count;
}

__global__ void __launch_bounds__(kHistThreads)
    radix_digit_hist_kernel(const long long* __restrict__ keys,
                            int* __restrict__ hist, int n) {
  __shared__ int counts[kRadixPasses][kRadixBins];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < kRadixPasses * kRadixBins; i += kHistThreads)
    (&counts[0][0])[i] = 0;
  __syncthreads();
  // each lane counts its own runs of equal digits and adds a run to the
  // shared table when it ends
  uint32_t cur[kRadixPasses];
  int run[kRadixPasses];
#pragma unroll
  for (int p = 0; p < kRadixPasses; ++p) {
    cur[p] = 0u;
    run[p] = 0;
  }
  const long long nwarps = (long long)gridDim.x * (kHistThreads / 32);
  for (long long seg = (long long)blockIdx.x * (kHistThreads / 32) +
                       (tid >> 5);
       seg * kHistSegment < n; seg += nwarps) {
    const long long i0 = seg * kHistSegment + lane;
    uint32_t key[kHistPer];
#pragma unroll
    for (int k = 0; k < kHistPer; ++k)
      key[k] = i0 + k * 32 < n ? (uint32_t)keys[i0 + k * 32] : 0u;
#pragma unroll
    for (int k = 0; k < kHistPer; ++k) {
      if (i0 + k * 32 >= n) break;
#pragma unroll
      for (int p = 0; p < kRadixPasses; ++p) {
        const uint32_t d = (key[k] >> (8 * p)) & (kRadixBins - 1);
        if (d != cur[p]) {
          if (run[p]) atomicAdd(&counts[p][cur[p]], run[p]);
          cur[p] = d;
          run[p] = 0;
        }
        ++run[p];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kRadixPasses; ++p)
    if (run[p]) atomicAdd(&counts[p][cur[p]], run[p]);
  __syncthreads();
  for (int i = tid; i < kRadixPasses * kRadixBins; i += kHistThreads) {
    const int c = (&counts[0][0])[i];
    if (c) atomicAdd(hist + i, c);
  }
}

// The lanes of the warp whose 8-bit digit `d` equals this lane's, from
// eight ballots, one a bit (CUB's MatchAny): __match_any_sync is slow
// when the warp holds many distinct values.
__device__ __forceinline__ uint32_t match_digit(uint32_t d) {
  uint32_t peers = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool one = (d >> b) & 1u;
    const uint32_t set = __ballot_sync(0xFFFFFFFFu, one);
    peers &= one ? set : ~set;
  }
  return peers;
}

// Exclusive scan of one int a thread over the kSweepThreads threads of a
// CTA (thread order); `wsum` is kSweepWarps ints of shared scratch.
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += u;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kSweepWarps; ++w)
    if (w < warp) before += wsum[w];
  __syncthreads();  // wsum may be reused by the caller's next scan
  return before + inc - v;
}

// One stable pass on the digit at `shift` (pass = shift / 8).  KIn and
// KOut are uint32_t (the key bits) or long long (the caller's u32 values
// in int64).  `hist` is the pass's row of the digit histogram, `counter`
// its tile counter, `look` the look-back array u64[ntiles][256].
template <typename KIn, typename KOut>
__global__ void __launch_bounds__(kSweepThreads, kSweepBlocksPerSM)
    radix_onesweep_kernel(const KIn* __restrict__ keys,
                          const int* __restrict__ vals,
                          KOut* __restrict__ okeys, int* __restrict__ ovals,
                          const int* __restrict__ hist, int* counter,
                          unsigned long long* look, int n, int shift) {
  __shared__ int wcount[kSweepWarps][kRadixBins];
  __shared__ uint32_t skeys[kSweepTile];
  __shared__ int svals[kSweepTile];
  __shared__ int tcount[kRadixBins];  // the tile's count of the digit
  __shared__ int lstart[kRadixBins];  // the digit's first staged slot
  __shared__ int gdelta[kRadixBins];  // output index - staged slot
  __shared__ int wsum[kSweepWarps];
  __shared__ int tile_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = tid;  // the digit this thread scans and looks back for
  const unsigned flag0 = (unsigned)(shift / 8) * 4u;  // + 1 count, + 2 incl.

  if (tid == 0) tile_s = atomicAdd(counter, 1);
  for (int i = tid; i < kSweepWarps * kRadixBins; i += kSweepThreads)
    (&wcount[0][0])[i] = 0;
  tcount[d] = 0;
  __syncthreads();
  const int tile = tile_s;
  const long long t0 = (long long)tile * kSweepTile;
  const int tn = (int)min((long long)kSweepTile, n - t0);
  const int w0 = warp * kWarpKeys + lane;  // this lane's first tile slot

  uint32_t key[kSweepPer];
#pragma unroll
  for (int k = 0; k < kSweepPer; ++k)
    key[k] = w0 + k * 32 < tn ? (uint32_t)keys[t0 + w0 + k * 32] : 0u;
  // the tile's digit counts first, with shared atomics (a sum has no
  // order), so that the later tiles can look back past this one while it
  // ranks
#pragma unroll
  for (int k = 0; k < kSweepPer; ++k)
    if (w0 + k * 32 < tn)
      atomicAdd(&tcount[(key[k] >> shift) & (kRadixBins - 1)], 1);
  // the pass's digit bases: the exclusive scan of its histogram row (its
  // barrier also completes the counts)
  const int dbase = block_exclusive_scan(hist[d], wsum);
  const int count = tcount[d];
  unsigned long long* mine = look + (long long)tile * kRadixBins + d;
  st_release(mine, look_word(flag0 + (tile == 0 ? 2u : 1u), count));

  // rank: for k in key order, each key's count of earlier keys of its
  // warp with the same digit.  The lowest peer advances the digit's count
  // with an atomic (it alone touches that count in this step, and it
  // consumes the result before the shuffle that the next step's lanes
  // wait on, so the steps stay in order without a __syncwarp).
  const uint32_t lower = (1u << lane) - 1u;
  int rnk[kSweepPer];
#pragma unroll
  for (int k = 0; k < kSweepPer; ++k) {
    const bool ok = w0 + k * 32 < tn;
    const uint32_t dk = (key[k] >> shift) & (kRadixBins - 1);
    const uint32_t peers = match_digit(dk) & __ballot_sync(0xFFFFFFFFu, ok);
    const int leader = ok ? __ffs(peers) - 1 : lane;
    int pre = 0;
    if (ok && lane == leader)
      pre = atomicAdd(&wcount[warp][dk], __popc(peers));
    pre = __shfl_sync(0xFFFFFFFFu, pre, leader);
    rnk[k] = pre + __popc(peers & lower);
  }
  __syncthreads();
  // one thread a digit: the warps' counts become their starts within the
  // digit's run of the tile (warp order is key order)
  for (int w = 0, run = 0; w < kSweepWarps; ++w) {
    const int c = wcount[w][d];
    wcount[w][d] = run;
    run += c;
  }
  const int start = block_exclusive_scan(count, wsum);
  lstart[d] = start;
  __syncthreads();

  // stage in digit order, key order within a digit (rnk becomes the
  // staged slot).  The payload is loaded only now, all of it at once,
  // which keeps the rank within 64 registers a thread (four CTAs an SM).
#pragma unroll
  for (int k = 0; k < kSweepPer; ++k) {
    if (w0 + k * 32 < tn) {
      const int dk = (key[k] >> shift) & (kRadixBins - 1);
      rnk[k] += lstart[dk] + wcount[warp][dk];
      skeys[rnk[k]] = key[k];
    }
  }
  int val[kSweepPer];
#pragma unroll
  for (int k = 0; k < kSweepPer; ++k)
    val[k] = w0 + k * 32 < tn ? vals[t0 + w0 + k * 32] : 0;
#pragma unroll
  for (int k = 0; k < kSweepPer; ++k)
    if (w0 + k * 32 < tn) svals[rnk[k]] = val[k];

  // look back only now, after the staging, so that the earlier tiles
  // have had that much longer to publish their inclusive prefixes
  int excl = 0;
  if (tile > 0) {
    const unsigned long long* prev = mine - kRadixBins;
    unsigned ns = 32;
    while (true) {
      const unsigned long long w = ld_acquire(prev);
      const unsigned flag = (unsigned)(w >> 32);
      if (flag <= flag0) {  // not yet written in this pass
        __nanosleep(ns);
        ns = min(ns * 2u, 1024u);
        continue;
      }
      excl += (int)(unsigned)w;
      if (flag == flag0 + 2u) break;
      prev -= kRadixBins;
    }
    st_release(mine, look_word(flag0 + 2u, excl + count));
  }
  gdelta[d] = dbase + excl - start;
  __syncthreads();
  for (int s = tid; s < tn; s += kSweepThreads) {
    const uint32_t k = skeys[s];
    const long long dest = gdelta[(k >> shift) & (kRadixBins - 1)] + s;
    okeys[dest] = (KOut)k;
    ovals[dest] = svals[s];
  }
}

}  // namespace gpe
