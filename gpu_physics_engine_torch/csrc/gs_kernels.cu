// Plain C entry points for the Gauss-Seidel kernels (gs_kernels.cuh),
// loaded from Python with ctypes (gpu_physics_engine_torch/ops/_cuda.py).
//
// Every pointer is a device pointer; every launch goes on the caller's
// stream and nothing here synchronises or allocates.  Each function returns
// cudaGetLastError() so that a refused launch is reported at the call.
#include <cuda_runtime.h>

#include "gs_kernels.cuh"

namespace {

constexpr int kThreads = 256;

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// K5: src/rpid int32 [K, TY, TX], rrad float [K, TY, TX], count int32
// [TY, TX].  1 <= K <= 16.
int gpe_gs_rank(const void* x, const void* y, const void* rad,
                const void* pid, void* src, void* rpid, void* rrad,
                void* count, int cap, int TY, int TX, int K, float t,
                void* stream) {
  if (K < 1 || K > gpe::kGsMaxK) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int n = TY * TX;
  const auto* fx = static_cast<const float*>(x);
  const auto* fy = static_cast<const float*>(y);
  const auto* fr = static_cast<const float*>(rad);
  const auto* ip = static_cast<const int*>(pid);
  auto* isrc = static_cast<int*>(src);
  auto* ipid = static_cast<int*>(rpid);
  auto* frad = static_cast<float*>(rrad);
  auto* icnt = static_cast<int*>(count);
  if (K <= 8)
    gpe::gs_rank_kernel<8><<<blocks_for(n), kThreads, 0, s>>>(
        fx, fy, fr, ip, isrc, ipid, frad, icnt, cap, TY, TX, K, t);
  else
    gpe::gs_rank_kernel<16><<<blocks_for(n), kThreads, 0, s>>>(
        fx, fy, fr, ip, isrc, ipid, frad, icnt, cap, TY, TX, K, t);
  return (int)cudaGetLastError();
}

// K6: one color pass (1..4), in place on x, y float [cap, TY, TX].
int gpe_gs_color(void* x, void* y, const void* src, const void* rrad,
                 int cap, int TY, int TX, int K, int color, float stiffness,
                 void* stream) {
  if (K < 1 || K > gpe::kGsMaxK || color < 1 || color > 4)
    return (int)cudaErrorInvalidValue;
  // color = 1 + ((tx-1)&1) + 2*((ty-1)&1): first row/column of the color
  const int ty0 = 1 - ((color - 1) >> 1);
  const int tx0 = 1 - ((color - 1) & 1);
  const int HY = (TY - ty0 + 1) / 2;
  const int HX = (TX - tx0 + 1) / 2;
  const int n = HY * HX;
  if (n <= 0) return (int)cudaGetLastError();
  const auto s = static_cast<cudaStream_t>(stream);
  auto* fx = static_cast<float*>(x);
  auto* fy = static_cast<float*>(y);
  const auto* isrc = static_cast<const int*>(src);
  const auto* frad = static_cast<const float*>(rrad);
  if (K <= 8)
    gpe::gs_color_kernel<8><<<blocks_for(n), kThreads, 0, s>>>(
        fx, fy, isrc, frad, cap, TY, TX, K, ty0, tx0, HY, HX, stiffness);
  else
    gpe::gs_color_kernel<16><<<blocks_for(n), kThreads, 0, s>>>(
        fx, fy, isrc, frad, cap, TY, TX, K, ty0, tx0, HY, HX, stiffness);
  return (int)cudaGetLastError();
}

}  // extern "C"
