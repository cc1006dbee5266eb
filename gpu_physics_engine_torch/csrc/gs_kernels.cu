// Plain C entry points for the Gauss-Seidel kernels (gs_kernels.cuh),
// loaded from Python with ctypes (gpu_physics_engine_torch/ops/_cuda.py).
//
// Every pointer is a device pointer except `consts` (host); every launch
// goes on the caller's stream and nothing here synchronises or allocates.
// Each function returns cudaGetLastError() so that a refused launch is
// reported at the call.
#include <cuda_runtime.h>

#include <algorithm>

#include "gs_kernels.cuh"

namespace {

constexpr int kThreads = 256;

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// K5's grid: one block per region of kRankRows x kRankCols full-space
// tiles (on ParLayout half as many cells of each sub-grid per axis).
dim3 rank_grid(const gpe::FlatLayout& l) {
  constexpr int RY = gpe::kRankRows, RX = gpe::kRankCols;
  return dim3((l.TX + RX - 1) / RX, (l.TY + RY - 1) / RY);
}
dim3 rank_grid(const gpe::ParLayout& l) {
  constexpr int SY = gpe::kRankRows / 2, SX = gpe::kRankCols / 2;
  return dim3((l.DX + SX - 1) / SX, (l.DY + SY - 1) / SY);
}

template <int KMAX, class L, bool MASK>
int launch_rank_k(const float* x, const float* y, const float* rad,
                  const int* pid, int* src, int* rpid, float* rrad,
                  int* count, int cap, const L& lay, int np, int K, float t,
                  float r0, cudaStream_t s) {
  const int smem = gpe::rank_window_bytes(cap, rad == nullptr);
  // past the default 48 KB from cap 8 to 12, by layout and radius
  const cudaError_t rc =
      gpe::allow_smem(gpe::gs_rank_kernel<KMAX, L, MASK>, smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::gs_rank_kernel<KMAX, L, MASK>
      <<<rank_grid(lay), gpe::kRankThreads, smem, s>>>(
          x, y, rad, pid, src, rpid, rrad, count, cap, lay, np, K, t, r0);
  return (int)cudaGetLastError();
}

template <class L, bool MASK>
int launch_rank(const void* x, const void* y, const void* rad,
                const void* pid, void* src, void* rpid, void* rrad,
                void* count, int cap, const L& lay, int np, int K, float t,
                float r0, void* stream) {
  if (K < 1 || K > gpe::kGsMaxK || cap < 1 || cap > gpe::kMaxCap ||
      lay.TY < 1 || lay.TX < 1)
    return (int)cudaErrorInvalidValue;
  auto* launch = K <= 8 ? &launch_rank_k<8, L, MASK>
                        : &launch_rank_k<16, L, MASK>;
  return launch(static_cast<const float*>(x), static_cast<const float*>(y),
                static_cast<const float*>(rad), static_cast<const int*>(pid),
                static_cast<int*>(src), static_cast<int*>(rpid),
                static_cast<float*>(rrad), static_cast<int*>(count), cap,
                lay, np, K, t, r0, static_cast<cudaStream_t>(stream));
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

// Blocks of colors_mega's cooperative grid on device dev: as many as fit
// on the card at once (resident blocks per SM x SMs).  Queried on the
// first launch on each device and kept: the occupancy query costs host
// time, and the step is short enough for the host to set its pace.
template <int KMAX>
cudaError_t mega_grid(int dev, int* blocks) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t rc =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gpe::gs_colors_mega_kernel<KMAX>, kThreads, 0);
    if (rc != cudaSuccess) return rc;
    if (!coop) return cudaErrorNotSupported;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached[dev] = per_sm * sms;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

// The first full row (column) of color 1..4 is ty0 = 1 - ((color-1) >> 1)
// (tx0 = 1 - ((color-1) & 1)): color = 1 + ((tx-1)&1) + 2*((ty-1)&1).
int color_ty0(int color) { return 1 - ((color - 1) >> 1); }
int color_tx0(int color) { return 1 - ((color - 1) & 1); }

}  // namespace

extern "C" {

// K5: src/rpid int32 [K, TY, TX], rrad float [K, TY, TX], count int32
// [TY, TX].  1 <= K <= 16, 1 <= cap <= 32.
int gpe_gs_rank(const void* x, const void* y, const void* rad,
                const void* pid, void* src, void* rpid, void* rrad,
                void* count, int cap, int TY, int TX, int K, float t,
                void* stream) {
  if (rad == nullptr) return (int)cudaErrorInvalidValue;
  const gpe::FlatLayout lay{TY, TX, 0, 0, 1, TX};
  return launch_rank<gpe::FlatLayout, false>(x, y, rad, pid, src, rpid, rrad,
                                             count, cap, lay, 1, K, t, 0.0f,
                                             stream);
}

// K5-par: fields [4, cap, DY, DX] (rad may be null: uniform radius r0),
// src/rpid/rrad [4, K, DY, DX], count [4, DY, DX].  One launch covers
// parities p0 .. p0 + np - 1 (np = 4: all of them).
int gpe_gs_rank_par(const void* x, const void* y, const void* rad,
                    const void* pid, void* src, void* rpid, void* rrad,
                    void* count, int cap, int TY, int TX, int DY, int DX,
                    int origin, int p0, int np, int K, float t, float r0,
                    void* stream) {
  if (p0 < 0 || np < 1 || p0 + np > 4 || DY < 1 || DX < 1)
    return (int)cudaErrorInvalidValue;
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, p0};
  return launch_rank<gpe::ParLayout, true>(x, y, rad, pid, src, rpid, rrad,
                                           count, cap, lay, np, K, t, r0,
                                           stream);
}

// K5's shared-memory bytes at cap, with or without a radius plane, as the
// launches above take them (either layout).
int gpe_gs_rank_window_bytes(int cap, int uniform) {
  return gpe::rank_window_bytes(cap, uniform != 0);
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

// colors_mega: the four K6-par colors on the parity layout, then (integ
// != 0) the Verlet tail, in one cooperative launch: in place on x, y (and
// px, py) [4, cap, DY, DX], tables src/rrad [4, K, DY, DX]; consts = host
// float[kVerletNumConsts].  The grid is as many blocks as fit on the card
// at once (mega_grid), at most what the work needs.  A card without
// cooperative launch gives cudaErrorNotSupported; a refused launch returns
// its error.
int gpe_gs_colors_mega(void* x, void* y, void* px, void* py, const void* pid,
                       const void* src, const void* rrad, const void* prm,
                       int cap, int TY, int TX, int DY, int DX, int origin,
                       int K, float stiffness, int integ, const void* consts,
                       void* stream) {
  if (K < 1 || K > gpe::kGsMaxK || DY < 1 || DX < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, resident = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = K <= 8 ? mega_grid<8>(dev, &resident)
                : mega_grid<16>(dev, &resident);
  if (rc != cudaSuccess) return (int)rc;
  auto* fn = K <= 8 ? &gpe::gs_colors_mega_kernel<8>
                    : &gpe::gs_colors_mega_kernel<16>;
  const long long work = integ ? 4LL * cap * DY * DX : (long long)DY * DX;
  const int blocks = (int)std::min<long long>(resident, blocks_for(work));
  int pars = 0;
  for (int color = 1; color <= 4; ++color) {
    const int pa = (color_ty0(color) - origin) & 1;
    const int pb = (color_tx0(color) - origin) & 1;
    pars |= (2 * pa + pb) << (2 * (color - 1));
  }
  const float* f = static_cast<const float*>(consts);
  gpe::VerletConsts c{f[0], f[1], f[2], f[3], f[4], f[5]};
  gpe::ParLayout lay{TY, TX, DY, DX, origin, 0};
  float* ax = static_cast<float*>(x);
  float* ay = static_cast<float*>(y);
  float* apx = static_cast<float*>(px);
  float* apy = static_cast<float*>(py);
  const int* apid = static_cast<const int*>(pid);
  const int* asrc = static_cast<const int*>(src);
  const float* arrad = static_cast<const float*>(rrad);
  const float* aprm = static_cast<const float*>(prm);
  void* args[] = {&ax,  &ay,  &apx,  &apy, &apid,      &asrc,  &arrad, &aprm,
                  &cap, &lay, &pars, &K,   &stiffness, &integ, &c};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn),
                                   dim3(blocks), dim3(kThreads), args, 0,
                                   static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(rc != cudaSuccess ? rc : last);
}

}  // extern "C"
