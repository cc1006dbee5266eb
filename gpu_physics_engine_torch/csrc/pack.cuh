// The occupant counting and block scan that the packed kernels share: K1
// past cap 64 (collide_integrate_pack_kernel, csrc/tiled_kernels.cuh) and
// the GS rank past the window (gs_rank_pack_kernel, csrc/gs_simple.cuh).
// Each packs a window's occupants per tile in shared memory: a thread per
// window tile counts its tile's occupants from the pid plane a word of 32
// slots at a time (neighbouring threads on neighbouring tiles: coalesced),
// a block scan of the counts gives each tile its first packed index, and
// the same thread reads its words again to write its occupants there.
#pragma once

#include <cuda_runtime.h>

namespace gpe {

// Exclusive prefix of v over the block's threads; *total gets the sum.  ws:
// blockDim.x / 32 ints of shared memory.  Every thread of the block calls
// it (it holds two barriers).
__device__ __forceinline__ int block_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (lane >= d) inc += u;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int t = ws[w];
    if (w < warp) before += t;
    all += t;
  }
  __syncthreads();  // ws may be written again
  *total = all;
  return before + inc - v;
}

// Bit b of the word: slot k0 + b of the tile whose slot 0 lies at g0 is
// occupied (slot k at g0 + k * plane).
__device__ __forceinline__ unsigned pack_word(const int* __restrict__ pid,
                                              int cap, int plane, int g0,
                                              int k0) {
  unsigned bits = 0;
#pragma unroll 8
  for (int b = 0; b < 32; ++b) {
    const int k = k0 + b;
    if (k < cap && pid[k * plane + g0] >= 0) bits |= 1u << b;
  }
  return bits;
}

}  // namespace gpe
