// Plain C entry points for the radix-sort kernels (radix_kernels.cuh),
// loaded from Python with ctypes (gpu_physics_engine_torch/ops/_cuda.py).
//
// Every pointer is a device pointer; the launch goes on the caller's
// stream and nothing here synchronises or allocates.  The function
// returns the first CUDA error of its calls (cudaGetLastError() after the
// launch), so that a refused launch is reported at the call.
#include <cuda_runtime.h>

#include "radix_kernels.cuh"

extern "C" {

// Bytes of the sort's scratch for `ntiles` tiles of kSweepTile keys: the
// digit histogram, the tile counters and the look-back array (below 2^31
// for any n < 2^31; ops/radix_sort.scratch_words mirrors it).
int gpe_radix_scratch_bytes(int ntiles) {
  return (int)(gpe::kLookOffset + (long long)ntiles * gpe::kRadixBins *
                                      sizeof(unsigned long long));
}

// Zero the scratch for `ntiles` tiles (ntiles 0: the histogram and the
// counters only), then radix_digit_hist: keys i64[n] (u32 values) ->
// scratch's hist i32[4][256].
int gpe_radix_digit_hist(const void* keys, void* scratch, int n, int ntiles,
                         void* stream) {
  if (n < 1 || ntiles < 0) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(scratch, 0,
                                   gpe_radix_scratch_bytes(ntiles), s);
  if (rc != cudaSuccess) return (int)rc;
  int dev = 0, sms = 0;
  rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  // one segment of kHistSegment keys a warp and round
  const long long per =
      (long long)gpe::kHistThreads / 32 * gpe::kHistSegment;
  const long long want = (n + per - 1) / per;
  const int grid = (int)(want < sms ? want : sms);
  gpe::radix_digit_hist_kernel<<<grid, gpe::kHistThreads, 0, s>>>(
      static_cast<const long long*>(keys), static_cast<int*>(scratch), n);
  return (int)cudaGetLastError();
}

// radix_onesweep, the pass on the digit at `shift`: keys (u32 bits, or
// i64 u32 values when in64) and vals i32 [n] -> okeys (u32 bits, or i64
// when out64) and ovals [n], stably sorted by the digit.  Reads the pass's
// histogram row and advances its tile counter and the look-back array in
// `scratch` (zeroed by gpe_radix_digit_hist for these n).
int gpe_radix_onesweep(const void* keys, const void* vals, void* okeys,
                       void* ovals, void* scratch, int n, int shift, int in64,
                       int out64, void* stream) {
  if (n < 1 || shift < 0 || shift > 24 || shift % 8)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + gpe::kSweepTile - 1) / gpe::kSweepTile;
  const int pass = shift / 8;
  int* hist = static_cast<int*>(scratch) + pass * gpe::kRadixBins;
  int* counter = static_cast<int*>(scratch) +
                 gpe::kRadixPasses * gpe::kRadixBins + pass;
  auto* look = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + gpe::kLookOffset);
  const auto* v = static_cast<const int*>(vals);
  auto* ov = static_cast<int*>(ovals);
  if (in64 && out64)
    gpe::radix_onesweep_kernel<long long, long long>
        <<<ntiles, gpe::kSweepThreads, 0, s>>>(
            static_cast<const long long*>(keys), v,
            static_cast<long long*>(okeys), ov, hist, counter, look, n,
            shift);
  else if (in64)
    gpe::radix_onesweep_kernel<long long, uint32_t>
        <<<ntiles, gpe::kSweepThreads, 0, s>>>(
            static_cast<const long long*>(keys), v,
            static_cast<uint32_t*>(okeys), ov, hist, counter, look, n,
            shift);
  else if (out64)
    gpe::radix_onesweep_kernel<uint32_t, long long>
        <<<ntiles, gpe::kSweepThreads, 0, s>>>(
            static_cast<const uint32_t*>(keys), v,
            static_cast<long long*>(okeys), ov, hist, counter, look, n,
            shift);
  else
    gpe::radix_onesweep_kernel<uint32_t, uint32_t>
        <<<ntiles, gpe::kSweepThreads, 0, s>>>(
            static_cast<const uint32_t*>(keys), v,
            static_cast<uint32_t*>(okeys), ov, hist, counter, look, n,
            shift);
  return (int)cudaGetLastError();
}

}  // extern "C"
