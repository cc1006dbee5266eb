// Hand kernels of the array pipelines' radix sort for Hopper (sm_90a): the
// three steps of one stable LSD pass.
//
// K12 radix_rank_hist_kernel replaces gpu_physics_engine_tpu/ops/
//     radix_sort.py::_rank_hist (:80, pallas_call :84; kernel
//     _rank_hist_kernel :51): for every 1024-key block, each key's 8-bit
//     digit (key >> shift) & 255, its stable rank inside the block (the
//     count of earlier keys of the block with the same digit) and the
//     block's 256-bin histogram, hist[block][digit].
// radix_offsets (three small kernels) replaces the XLA scan of the JAX
//     radix_sort.py:111-113: offset[block][digit] = the exclusive scan of
//     the histograms in (digit, block) order, digits major and blocks
//     minor, so that equal digits keep block order.
// radix_scatter_kernel replaces the XLA scatter and gathers of
//     radix_sort.py:114-127: key and payload go straight to
//     offset[block][digit] + rank.
//
// Bound: device memory.  Per key K12 reads 4 bytes and writes a 4-byte
// rank; the scatter reads key, rank and payload and writes key and payload
// (20 bytes); the offsets read the 1 KiB histogram row of every block and
// write one offset row.  At the 1M scene's 4,403,200 pairs that is about
// 0.13 GB a pass, 0.04 ms at 3.35 TB/s.  The arithmetic is a few integer
// operations per key.
//
// K12 design: one CUDA block of 1024 threads per key block, one key per
// thread.  The TPU kernel builds a [1024, 256] one-hot and scans it along
// the block axis with ten shifted adds; here a warp finds the lanes that
// share its digit with __match_any_sync, a lane's rank in its warp is the
// popcount of the lower lanes of that set, and the first lane of each set
// writes the set's size into a [32 warps][256 digits] table in shared
// memory (32 KB; every other entry stays 0).  256 threads then turn each
// digit's column into an exclusive scan over the warps, in warp order,
// and the column total is the block's histogram entry.  A key's rank is
// its warp's offset for its digit plus its rank in the warp: ascending
// index order among equal digits, decided without atomics, so the result
// is deterministic and equals the plain version's.
//
// Offsets design: the histogram is [nblocks][256], so a thread that owns
// one digit reads one column and 256 threads read whole 1 KiB rows.  The
// (digit, block) scan is a per-digit scan down the blocks plus the digit's
// base, the sum of all smaller digits' totals.  Reduce then scan in three
// launches: (1) per chunk of kOffsetRows blocks, each digit's partial sum;
// (2) one block scans the partials down the chunks per digit, then the
// digit totals across the 256 digits, and turns every partial into the
// chunk's starting offset; (3) per chunk, each digit walks its rows and
// writes the running offset.  All three are latency-bound, not bound by
// their few megabytes (PERF.md).  Counts stay below n < 2^31: int32.
//
// Scatter design: one block of 1024 threads per kScatterBlocks key blocks.
// It scans their histogram rows into local digit starts, places each key
// and payload in shared memory at its digit's start + its block's share +
// rank (digit order, stable), then thread j stores the j-th staged key at
// offset[b0][digit] + (j - the digit's start): the threads of a warp store
// consecutive keys of one digit run to consecutive addresses instead of 32
// scattered words, and four blocks together make the runs four times
// longer.  No atomics; every destination is decided by the ranks, so the
// result is deterministic.
#pragma once

#include <stdint.h>

namespace gpe {

constexpr int kRadixBlock = 1024;  // keys per block = threads per block
constexpr int kRadixBins = 256;
constexpr int kRadixWarps = kRadixBlock / 32;
constexpr int kOffsetRows = 32;  // histogram rows (key blocks) per chunk

__global__ void __launch_bounds__(kRadixBlock)
    radix_rank_hist_kernel(const uint32_t* __restrict__ keys,
                           int* __restrict__ rank, int* __restrict__ hist,
                           int shift) {
  __shared__ int counts[kRadixWarps][kRadixBins];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kRadixWarps * kRadixBins; i += kRadixBlock)
    (&counts[0][0])[i] = 0;
  __syncthreads();

  const long long base = (long long)blockIdx.x * kRadixBlock;
  const uint32_t digit = (keys[base + tid] >> shift) & (kRadixBins - 1);
  const uint32_t peers = __match_any_sync(0xFFFFFFFFu, digit);
  const uint32_t lower = peers & ((1u << lane) - 1u);
  if (lower == 0u) counts[warp][digit] = __popc(peers);
  __syncthreads();

  if (tid < kRadixBins) {
    int run = 0;
    for (int w = 0; w < kRadixWarps; ++w) {
      const int c = counts[w][tid];
      counts[w][tid] = run;
      run += c;
    }
    hist[(long long)blockIdx.x * kRadixBins + tid] = run;
  }
  __syncthreads();
  rank[base + tid] = counts[warp][digit] + __popc(lower);
}

// In-place exclusive scan of the kRadixBins ints of shared array `a`, run
// by the 32 lanes of one warp (8 consecutive entries a lane).
__device__ __forceinline__ void warp_exclusive_scan_bins(int* a) {
  constexpr int kPer = kRadixBins / 32;
  const int lane = threadIdx.x & 31;
  int v[kPer], s = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = a[lane * kPer + i];
    s += v[i];
  }
  int inc = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += u;
  }
  int run = inc - s;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    a[lane * kPer + i] = run;
    run += v[i];
  }
}

// Offsets (1): part[chunk][d] = sum of hist[b][d] over the chunk's blocks.
__global__ void __launch_bounds__(kRadixBins)
    radix_chunk_sums_kernel(const int* __restrict__ hist,
                            int* __restrict__ part, int nblocks) {
  const int d = threadIdx.x;
  const int b0 = blockIdx.x * kOffsetRows;
  const int b1 = min(b0 + kOffsetRows, nblocks);
  int s = 0;
#pragma unroll 8
  for (int b = b0; b < b1; ++b) s += hist[(long long)b * kRadixBins + d];
  part[(long long)blockIdx.x * kRadixBins + d] = s;
}

// Offsets (2), one block: part[c][d] becomes the offset of chunk c's first
// block for digit d: the digit's base (the totals of all smaller digits)
// plus digit d's partials of the earlier chunks.  kBaseSplit threads share
// each digit's column, each a quarter of the chunks, and read it in
// batches of kBatch independent loads, so that their latencies overlap.
constexpr int kBaseSplit = 4;

__global__ void __launch_bounds__(kRadixBins * kBaseSplit)
    radix_chunk_base_kernel(int* __restrict__ part, int nchunks) {
  constexpr int kBatch = 8;
  __shared__ int qsum[kBaseSplit][kRadixBins];
  __shared__ int base[kRadixBins];
  const int d = threadIdx.x % kRadixBins;
  const int q = threadIdx.x / kRadixBins;
  const int per = (nchunks + kBaseSplit - 1) / kBaseSplit;
  const int c0 = min(q * per, nchunks), c1 = min(c0 + per, nchunks);
  int s = 0;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) s += part[c * kRadixBins + d];
  qsum[q][d] = s;
  __syncthreads();
  if (q == 0) {
    int total = 0;
    for (int i = 0; i < kBaseSplit; ++i) total += qsum[i][d];
    base[d] = total;  // the digit's total
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_exclusive_scan_bins(base);
  __syncthreads();
  int run = base[d];
  for (int i = 0; i < q; ++i) run += qsum[i][d];
  for (int b0 = c0; b0 < c1; b0 += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      v[i] = b0 + i < c1 ? part[(b0 + i) * kRadixBins + d] : 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (b0 + i < c1) part[(b0 + i) * kRadixBins + d] = run;
      run += v[i];
    }
  }
}

// Offsets (3): offset[b][d] for every block b of the chunk.
__global__ void __launch_bounds__(kRadixBins)
    radix_offsets_kernel(const int* __restrict__ hist,
                         const int* __restrict__ part,
                         int* __restrict__ offset, int nblocks) {
  const int d = threadIdx.x;
  const int b0 = blockIdx.x * kOffsetRows;
  const int b1 = min(b0 + kOffsetRows, nblocks);
  int run = part[(long long)blockIdx.x * kRadixBins + d];
#pragma unroll 8
  for (int b = b0; b < b1; ++b) {
    const long long i = (long long)b * kRadixBins + d;
    offset[i] = run;
    run += hist[i];
  }
}

// The scatter: keys/payload of block b to offset[b][digit] + rank, for the
// kScatterBlocks key blocks b0 .. b0 + nsub - 1 of one CUDA block.  They
// are staged together in digit order, blocks minor within a digit: since
// offset[b + 1][d] = offset[b][d] + hist[b][d], each digit's staged run is
// one contiguous run of the output, starting at offset[b0][d], and runs
// are kScatterBlocks times longer than one block's.
constexpr int kScatterBlocks = 4;  // key blocks per CUDA block

__global__ void __launch_bounds__(kRadixBlock)
    radix_scatter_kernel(const uint32_t* __restrict__ keys,
                         const int* __restrict__ vals,
                         const int* __restrict__ rank,
                         const int* __restrict__ hist,
                         const int* __restrict__ offset,
                         uint32_t* __restrict__ okeys,
                         int* __restrict__ ovals, int shift, int nblocks) {
  __shared__ uint32_t skeys[kScatterBlocks * kRadixBlock];
  __shared__ int svals[kScatterBlocks * kRadixBlock];
  __shared__ int lstart[kScatterBlocks][kRadixBins];
  __shared__ int dstart[kRadixBins];
  __shared__ int goff[kRadixBins];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kScatterBlocks;
  const int nsub = min(kScatterBlocks, nblocks - b0);
  uint32_t key[kScatterBlocks];
  int val[kScatterBlocks], r[kScatterBlocks];
#pragma unroll
  for (int j = 0; j < kScatterBlocks; ++j) {
    if (j >= nsub) break;
    const long long i = (long long)(b0 + j) * kRadixBlock + tid;
    key[j] = keys[i];
    val[j] = vals[i];
    r[j] = rank[i];
  }
  if (tid < kRadixBins) {
    int run = 0;
    for (int j = 0; j < nsub; ++j) {
      lstart[j][tid] = run;
      run += hist[(long long)(b0 + j) * kRadixBins + tid];
    }
    dstart[tid] = run;  // the digit's count here; scanned below
    goff[tid] = offset[(long long)b0 * kRadixBins + tid];
  }
  __syncthreads();
  if (tid < 32) warp_exclusive_scan_bins(dstart);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScatterBlocks; ++j) {
    if (j >= nsub) break;
    const int d = (key[j] >> shift) & (kRadixBins - 1);
    const int slot = dstart[d] + lstart[j][d] + r[j];
    skeys[slot] = key[j];
    svals[slot] = val[j];
  }
  __syncthreads();
  for (int s = tid; s < nsub * kRadixBlock; s += kRadixBlock) {
    const uint32_t k = skeys[s];
    const int d = (k >> shift) & (kRadixBins - 1);
    const long long dest = (long long)goff[d] + (s - dstart[d]);
    okeys[dest] = k;
    ovals[dest] = svals[s];
  }
}

}  // namespace gpe
