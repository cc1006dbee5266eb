// Plain C entry point for the radix-sort kernel (radix_kernels.cuh),
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

}  // extern "C"
