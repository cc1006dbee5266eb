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

// K5's grid: one block per region of kRankRows x rank_cols full-space
// tiles of the cap's class (on ParLayout half as many cells of each
// sub-grid per axis).
dim3 rank_grid(const gpe::FlatLayout& l, bool wide) {
  const int RY = gpe::kRankRows, RX = gpe::rank_cols(wide);
  return dim3((l.TX + RX - 1) / RX, (l.TY + RY - 1) / RY);
}
dim3 rank_grid(const gpe::ParLayout& l, bool wide) {
  const int SY = gpe::kRankRows / 2, SX = gpe::rank_cols(wide) / 2;
  return dim3((l.DX + SX - 1) / SX, (l.DY + SY - 1) / SY);
}

template <int KMAX, class M, class L, bool MASK>
int launch_rank_k(const float* x, const float* y, const float* rad,
                  const int* pid, int* src, int* rpid, float* rrad,
                  int* count, int cap, const L& lay, int np, int K, float t,
                  float r0, cudaStream_t s) {
  constexpr bool wide = sizeof(M) == 8;
  const int smem = gpe::rank_window_bytes(cap, rad == nullptr);
  // past the default 48 KB from cap 8 to 12, by layout and radius
  const cudaError_t rc =
      gpe::allow_smem(gpe::gs_rank_kernel<KMAX, M, L, MASK>, smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::gs_rank_kernel<KMAX, M, L, MASK>
      <<<rank_grid(lay, wide), gpe::rank_threads(wide), smem, s>>>(
          x, y, rad, pid, src, rpid, rrad, count, cap, lay, np, K, t, r0);
  return (int)cudaGetLastError();
}

template <class L, bool MASK>
int launch_rank(const void* x, const void* y, const void* rad,
                const void* pid, void* src, void* rpid, void* rrad,
                void* count, int cap, const L& lay, int np, int K, float t,
                float r0, void* stream) {
  if (K < 1 || cap < 1 || lay.TY < 1 || lay.TX < 1)
    return (int)cudaErrorInvalidValue;
  if (!gpe::gs_windowed(cap, K))
    return gpe::launch_rank_pack(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(rad), static_cast<const int*>(pid),
        static_cast<int*>(src), static_cast<int*>(rpid),
        static_cast<float*>(rrad), static_cast<int*>(count), cap, lay, np, K,
        t, r0, 0, static_cast<cudaStream_t>(stream));
  // the K-deep list's registers by K, the mask word by cap
  using Fn = int (*)(const float*, const float*, const float*, const int*,
                     int*, int*, float*, int*, int, const L&, int, int, float,
                     float, cudaStream_t);
  static constexpr Fn table[2][2] = {
      {&launch_rank_k<8, unsigned, L, MASK>,
       &launch_rank_k<8, gpe::Mask64, L, MASK>},
      {&launch_rank_k<16, unsigned, L, MASK>,
       &launch_rank_k<16, gpe::Mask64, L, MASK>}};
  const Fn launch = table[K <= 8 ? 0 : 1][cap > gpe::kNarrowCap ? 1 : 0];
  return launch(static_cast<const float*>(x), static_cast<const float*>(y),
                static_cast<const float*>(rad), static_cast<const int*>(pid),
                static_cast<int*>(src), static_cast<int*>(rpid),
                static_cast<float*>(rrad), static_cast<int*>(count), cap,
                lay, np, K, t, r0, static_cast<cudaStream_t>(stream));
}

// The window's grid: one block per region of the cap's class (on
// ParLayout half as many cells of each sub-grid per axis).
dim3 window_grid(const gpe::FlatLayout& l, int RY, int RX) {
  return dim3((l.TX + RX - 1) / RX, (l.TY + RY - 1) / RY);
}
dim3 window_grid(const gpe::ParLayout& l, int RY, int RX) {
  const int SY = RY / 2, SX = RX / 2;
  return dim3((l.DX + SX - 1) / SX, (l.DY + SY - 1) / SY);
}

template <int KMAX, int CLS, class L>
int launch_window_k(const gpe::GsWindowArgs& a, const L& lay,
                    cudaStream_t s) {
  const int smem = gpe::gs_window_bytes(a.cap, a.c1);
  // past the default 48 KB from cap 3 of the smallest class, by class
  const cudaError_t rc =
      gpe::allow_smem(gpe::gs_colors_window_kernel<KMAX, CLS, L>, smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::gs_colors_window_kernel<KMAX, CLS, L>
      <<<window_grid(lay, gpe::gs_window_ry(CLS), gpe::gs_window_rx(CLS)),
         gpe::kGsWinThreads, smem, s>>>(a, lay);
  return (int)cudaGetLastError();
}

template <class L>
int launch_window(const gpe::GsWindowArgs& a, const int* count, const L& lay,
                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (!gpe::gs_windowed(a.cap, a.K))
    return gpe::launch_colors_ranked(a, count, lay, st);
  using Fn = int (*)(const gpe::GsWindowArgs&, const L&, cudaStream_t);
  static constexpr Fn table[2][gpe::kGsWinClasses] = {
      {&launch_window_k<8, 0, L>, &launch_window_k<8, 1, L>,
       &launch_window_k<8, 2, L>, &launch_window_k<8, 3, L>,
       &launch_window_k<8, 4, L>},
      {&launch_window_k<16, 0, L>, &launch_window_k<16, 1, L>,
       &launch_window_k<16, 2, L>, &launch_window_k<16, 3, L>,
       &launch_window_k<16, 4, L>}};
  return table[a.K <= 8 ? 0 : 1][gpe::gs_window_class(a.cap)](a, lay, st);
}

}  // namespace

extern "C" {

// K5: src/rpid int32 [K, TY, TX], rrad float [K, TY, TX], count int32
// [TY, TX].  Any K >= 1 and cap >= 1 (past cap 64 or K 16 the packed
// kernel).
int gpe_gs_rank(const void* x, const void* y, const void* rad,
                const void* pid, void* src, void* rpid, void* rrad,
                void* count, int cap, int TY, int TX, int K, float t,
                void* stream) {
  if (rad == nullptr) return (int)cudaErrorInvalidValue;
  const gpe::FlatLayout lay{TY, TX};
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

// K5's window bytes at (cap, K), with or without a radius plane, as the
// launches above take them (either layout); 0 past the window
// (gpe_gs_route): the packed kernel's plan is gpe_gs_rank_pack_bytes.
int gpe_gs_rank_window_bytes(int cap, int uniform, int K) {
  return gpe::gs_windowed(cap, K) ? gpe::rank_window_bytes(cap, uniform != 0)
                                  : 0;
}

// K6, K6-par (K6-mx, K6-dec) and colors_mega: colors 1..c1 (0 <= c1 <=
// 4; c1 = 4: a whole solve) in one launch of the window kernel,
// then (integ != 0) the substep's Verlet step.  Reads x, y and writes
// every slot to ox, oy (new planes, never x or y); with integ, px, py in
// place.  par == 0: fields [cap, TY, TX], tables src/rrad [K, TY, TX];
// par != 0: fields [4, cap, DY, DX], tables [4, K, DY, DX] with the given
// origin.  rrad may be null: every valid rank has radius r0.  With integ,
// pid, prm (device float[4]) and consts (host float[kVerletNumConsts] in
// VerletConsts order) are read.  Any K >= 1 and cap >= 1.  Past cap 64 or
// K 16 the ranked-slot solve: the copy, the colors on the ranked slots,
// each cell's rank count read from `count` (K5's count table, shaped as
// the tables without K; required there), and the tail; the window kernel
// ignores `count`.
int gpe_gs_colors_window(const void* x, const void* y, void* px, void* py,
                         const void* pid, const void* src, const void* rrad,
                         const void* count, const void* prm, void* ox,
                         void* oy, int cap, int TY, int TX, int DY, int DX,
                         int origin, int par, int K, int c1, float r0,
                         float stiffness, int integ, const void* consts,
                         void* stream) {
  if (K < 1 || cap < 1 || c1 < 0 || c1 > gpe::kGsWinMaxColors || TY < 1 ||
      TX < 1 || (par && (DY < 1 || DX < 1)) ||
      (integ && (!px || !py || !pid || !prm || !consts)))
    return (int)cudaErrorInvalidValue;
  gpe::GsWindowArgs a{};
  a.x = static_cast<const float*>(x);
  a.y = static_cast<const float*>(y);
  a.px = static_cast<float*>(px);
  a.py = static_cast<float*>(py);
  a.pid = static_cast<const int*>(pid);
  a.prm = static_cast<const float*>(prm);
  a.src = static_cast<const int*>(src);
  a.rrad = static_cast<const float*>(rrad);
  a.ox = static_cast<float*>(ox);
  a.oy = static_cast<float*>(oy);
  a.cap = cap;
  a.K = K;
  a.c1 = c1;
  a.integ = integ != 0;
  a.r0 = r0;
  a.stiffness = stiffness;
  if (integ) {
    const float* f = static_cast<const float*>(consts);
    a.vc = gpe::VerletConsts{f[0], f[1], f[2], f[3], f[4], f[5]};
  }
  const auto* n = static_cast<const int*>(count);
  if (par)
    return launch_window(a, n, gpe::ParLayout{TY, TX, DY, DX, origin, 0},
                         stream);
  return launch_window(a, n, gpe::FlatLayout{TY, TX}, stream);
}

// The window's shared-memory bytes at cap for a launch of `colors` colors,
// as the launches above take them (either layout); 0 past cap 64 (the
// ranked-slot solve stages nothing; past K 16 too).
int gpe_gs_colors_window_bytes(int cap, int colors) {
  return cap > gpe::kWideCap ? 0 : gpe::gs_window_bytes(cap, colors);
}

}  // extern "C"
