// Plain C entry points for the Gauss-Seidel kernels (gs_kernels.cuh),
// loaded from Python with ctypes (gpu_physics_engine_torch/ops/_cuda.py).
//
// Every pointer is a device pointer except `consts` (host); every launch
// goes on the caller's stream and nothing here synchronises or allocates.
// Each function returns cudaGetLastError() so that a refused launch is
// reported at the call.
#include <cuda_runtime.h>

#include "gs_kernels.cuh"

namespace {

constexpr int kThreads = 256;

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <class L, bool MASK>
void launch_rank(const float* x, const float* y, const float* rad,
                 const int* pid, int* src, int* rpid, float* rrad, int* count,
                 int cap, const L& lay, int n, int K, float t, float r0,
                 cudaStream_t s) {
  if (K <= 8)
    gpe::gs_rank_kernel<8, L, MASK><<<blocks_for(n), kThreads, 0, s>>>(
        x, y, rad, pid, src, rpid, rrad, count, cap, lay, n, K, t, r0);
  else
    gpe::gs_rank_kernel<16, L, MASK><<<blocks_for(n), kThreads, 0, s>>>(
        x, y, rad, pid, src, rpid, rrad, count, cap, lay, n, K, t, r0);
}

template <class L>
void launch_color(float* x, float* y, const int* src, const float* rrad,
                  int cap, const L& lay, int n, int K, float stiffness,
                  cudaStream_t s) {
  if (K <= 8)
    gpe::gs_color_kernel<8, L><<<blocks_for(n), kThreads, 0, s>>>(
        x, y, src, rrad, cap, lay, n, K, stiffness);
  else
    gpe::gs_color_kernel<16, L><<<blocks_for(n), kThreads, 0, s>>>(
        x, y, src, rrad, cap, lay, n, K, stiffness);
}

// The first full row (column) of color 1..4 is ty0 = 1 - ((color-1) >> 1)
// (tx0 = 1 - ((color-1) & 1)): color = 1 + ((tx-1)&1) + 2*((ty-1)&1).
int color_ty0(int color) { return 1 - ((color - 1) >> 1); }
int color_tx0(int color) { return 1 - ((color - 1) & 1); }

}  // namespace

extern "C" {

// K5: src/rpid int32 [K, TY, TX], rrad float [K, TY, TX], count int32
// [TY, TX].  1 <= K <= 16.
int gpe_gs_rank(const void* x, const void* y, const void* rad,
                const void* pid, void* src, void* rpid, void* rrad,
                void* count, int cap, int TY, int TX, int K, float t,
                void* stream) {
  if (K < 1 || K > gpe::kGsMaxK) return (int)cudaErrorInvalidValue;
  const gpe::FlatLayout lay{TY, TX, 0, 0, 1, TX};
  launch_rank<gpe::FlatLayout, false>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(rad), static_cast<const int*>(pid),
      static_cast<int*>(src), static_cast<int*>(rpid),
      static_cast<float*>(rrad), static_cast<int*>(count), cap, lay,
      TY * TX, K, t, 0.0f, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K5-par: fields [4, cap, DY, DX] (rad may be null: uniform radius r0),
// src/rpid/rrad [4, K, DY, DX], count [4, DY, DX].  One launch covers
// parities p0 .. p0 + np - 1 (np = 4: all of them).
int gpe_gs_rank_par(const void* x, const void* y, const void* rad,
                    const void* pid, void* src, void* rpid, void* rrad,
                    void* count, int cap, int TY, int TX, int DY, int DX,
                    int origin, int p0, int np, int K, float t, float r0,
                    void* stream) {
  if (K < 1 || K > gpe::kGsMaxK || p0 < 0 || np < 1 || p0 + np > 4)
    return (int)cudaErrorInvalidValue;
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, p0};
  launch_rank<gpe::ParLayout, true>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(rad), static_cast<const int*>(pid),
      static_cast<int*>(src), static_cast<int*>(rpid),
      static_cast<float*>(rrad), static_cast<int*>(count), cap, lay,
      np * DY * DX, K, t, r0, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K6: one color pass (1..4), in place on x, y float [cap, TY, TX].
int gpe_gs_color(void* x, void* y, const void* src, const void* rrad,
                 int cap, int TY, int TX, int K, int color, float stiffness,
                 void* stream) {
  if (K < 1 || K > gpe::kGsMaxK || color < 1 || color > 4)
    return (int)cudaErrorInvalidValue;
  const int ty0 = color_ty0(color);
  const int tx0 = color_tx0(color);
  const int HY = (TY - ty0 + 1) / 2;
  const int HX = (TX - tx0 + 1) / 2;
  const int n = HY * HX;
  if (n <= 0) return (int)cudaGetLastError();
  const gpe::FlatLayout lay{TY, TX, ty0, tx0, 2, HX};
  launch_color(static_cast<float*>(x), static_cast<float*>(y),
               static_cast<const int*>(src), static_cast<const float*>(rrad),
               cap, lay, n, K, stiffness, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K6-par (and K6-mx, K6-dec): one color pass on the parity layout, in
// place on x, y [4, cap, DY, DX], tables src/rrad [4, K, DY, DX].  The
// color's cells are the whole sub-grid of one parity.
int gpe_gs_color_par(void* x, void* y, const void* src, const void* rrad,
                     int cap, int TY, int TX, int DY, int DX, int origin,
                     int K, int color, float stiffness, void* stream) {
  if (K < 1 || K > gpe::kGsMaxK || color < 1 || color > 4)
    return (int)cudaErrorInvalidValue;
  // parity (ty - origin) & 1 of the color's first row and column
  const int pa = (color_ty0(color) - origin) & 1;
  const int pb = (color_tx0(color) - origin) & 1;
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, 2 * pa + pb};
  launch_color(static_cast<float*>(x), static_cast<float*>(y),
               static_cast<const int*>(src), static_cast<const float*>(rrad),
               cap, lay, DY * DX, K, stiffness,
               static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K6-par's Verlet tail: in place on x, y, px, py float [n] (any layout);
// consts = host float[kVerletNumConsts] in VerletConsts order.
int gpe_gs_verlet(void* x, void* y, void* px, void* py, const void* pid,
                  const void* prm, int n, const void* consts, void* stream) {
  const float* f = static_cast<const float*>(consts);
  const gpe::VerletConsts c{f[0], f[1], f[2], f[3], f[4], f[5]};
  if (n <= 0) return (int)cudaGetLastError();
  gpe::gs_verlet_kernel<<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(y),
      static_cast<float*>(px), static_cast<float*>(py),
      static_cast<const int*>(pid), static_cast<const float*>(prm), n, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
