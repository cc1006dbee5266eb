// Plain C entry points for the radix-sort kernels (radix_kernels.cuh),
// loaded from Python with ctypes (gpu_physics_engine_torch/ops/_cuda.py).
//
// Every pointer is a device pointer; the launch goes on the caller's
// stream and nothing here synchronises or allocates.  The function
// returns cudaGetLastError() so that a refused launch is reported at the
// call.
#include <cuda_runtime.h>

#include "radix_kernels.cuh"

extern "C" {

// K12: keys u32[nblocks * 1024] -> rank i32[nblocks * 1024] and hist
// i32[nblocks, 256] of the digit (key >> shift) & 255.
int gpe_radix_rank_hist(const void* keys, void* rank, void* hist, int nblocks,
                        int shift, void* stream) {
  gpe::radix_rank_hist_kernel<<<nblocks, gpe::kRadixBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int*>(rank),
      static_cast<int*>(hist), shift);
  return (int)cudaGetLastError();
}

// radix_offsets: hist i32[nblocks, 256] -> offset i32[nblocks, 256], the
// exclusive scan in (digit, block) order; part is scratch i32[nchunks,
// 256], nchunks = ceil(nblocks / kOffsetRows).  Three launches.
int gpe_radix_offsets(const void* hist, void* part, void* offset, int nblocks,
                      void* stream) {
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int nchunks = (nblocks + gpe::kOffsetRows - 1) / gpe::kOffsetRows;
  const auto* h = static_cast<const int*>(hist);
  auto* p = static_cast<int*>(part);
  gpe::radix_chunk_sums_kernel<<<nchunks, gpe::kRadixBins, 0, s>>>(h, p,
                                                                   nblocks);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  gpe::radix_chunk_base_kernel<<<1, gpe::kRadixBins * gpe::kBaseSplit, 0,
                                 s>>>(p, nchunks);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  gpe::radix_offsets_kernel<<<nchunks, gpe::kRadixBins, 0, s>>>(
      h, p, static_cast<int*>(offset), nblocks);
  return (int)cudaGetLastError();
}

// radix_scatter: keys u32 and vals i32 [nblocks * 1024] with their ranks,
// histograms and offsets -> okeys, ovals at offset[block][digit] + rank.
int gpe_radix_scatter(const void* keys, const void* vals, const void* rank,
                      const void* hist, const void* offset, void* okeys,
                      void* ovals, int nblocks, int shift, void* stream) {
  if (nblocks < 1) return (int)cudaErrorInvalidValue;
  const int grid = (nblocks + gpe::kScatterBlocks - 1) / gpe::kScatterBlocks;
  gpe::radix_scatter_kernel<<<grid, gpe::kRadixBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(vals),
      static_cast<const int*>(rank), static_cast<const int*>(hist),
      static_cast<const int*>(offset), static_cast<uint32_t*>(okeys),
      static_cast<int*>(ovals), shift, nblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
