// Plain C entry points for the tiled-pipeline kernels (tiled_kernels.cuh),
// loaded from Python with ctypes (gpu_physics_engine_torch/ops/_cuda.py).
//
// Every pointer is a device pointer except `consts` (host); every launch
// goes on the caller's stream and nothing here synchronises or allocates.
// Each function returns cudaGetLastError() so that a refused launch is
// reported at the call, not at some later synchronisation.
#include <cuda_runtime.h>

#include "tiled_kernels.cuh"

namespace {

constexpr int kThreads = 256;

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <bool UNIFORM, bool CIRCLE, bool INTEGRATE = true>
void launch_k1(const float* x, const float* y, const float* px,
               const float* py, const float* rad, const int* pid,
               const float* prm, float* ox, float* oy, float* opx,
               float* opy, int cap, int TY, int TX, const gpe::K1Consts& c,
               cudaStream_t s) {
  const long long n = (long long)cap * TY * TX;
  gpe::collide_integrate_kernel<UNIFORM, CIRCLE, INTEGRATE>
      <<<blocks_for(n), kThreads, 0, s>>>(x, y, px, py, rad, pid, prm, ox,
                                          oy, opx, opy, cap, TY, TX, c);
}

gpe::K1Consts k1_consts(const void* consts) {
  const float* f = static_cast<const float*>(consts);
  return gpe::K1Consts{f[0], f[1], f[2],  f[3],  f[4],  f[5],  f[6],
                       f[7], f[8], f[9], f[10], f[11], f[12], f[13]};
}

}  // namespace

extern "C" {

// K3: the K1 sweep without the Verlet step; writes ox, oy only.
int gpe_collide(const void* x, const void* y, const void* rad,
                const void* pid, void* ox, void* oy, int cap, int TY, int TX,
                int uniform, const void* consts, void* stream) {
  const gpe::K1Consts c = k1_consts(consts);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fx = static_cast<const float*>(x);
  const auto* fy = static_cast<const float*>(y);
  const auto* fr = static_cast<const float*>(rad);
  const auto* ip = static_cast<const int*>(pid);
  auto* gx = static_cast<float*>(ox);
  auto* gy = static_cast<float*>(oy);
  if (uniform)
    launch_k1<true, false, false>(fx, fy, nullptr, nullptr, fr, ip, nullptr,
                                  gx, gy, nullptr, nullptr, cap, TY, TX, c,
                                  s);
  else
    launch_k1<false, false, false>(fx, fy, nullptr, nullptr, fr, ip,
                                   nullptr, gx, gy, nullptr, nullptr, cap, TY,
                                   TX, c, s);
  return (int)cudaGetLastError();
}

// K1.  consts = host float[kK1NumConsts] in K1Consts order.
int gpe_collide_integrate(const void* x, const void* y, const void* px,
                          const void* py, const void* rad, const void* pid,
                          const void* prm, void* ox, void* oy, void* opx,
                          void* opy, int cap, int TY, int TX, int uniform,
                          int circle, const void* consts, void* stream) {
  const gpe::K1Consts c = k1_consts(consts);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fx = static_cast<const float*>(x);
  const auto* fy = static_cast<const float*>(y);
  const auto* fpx = static_cast<const float*>(px);
  const auto* fpy = static_cast<const float*>(py);
  const auto* fr = static_cast<const float*>(rad);
  const auto* ip = static_cast<const int*>(pid);
  const auto* fp = static_cast<const float*>(prm);
  auto* gx = static_cast<float*>(ox);
  auto* gy = static_cast<float*>(oy);
  auto* gpx = static_cast<float*>(opx);
  auto* gpy = static_cast<float*>(opy);
  if (uniform && circle)
    launch_k1<true, true>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx, gpy,
                          cap, TY, TX, c, s);
  else if (uniform)
    launch_k1<true, false>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx, gpy,
                           cap, TY, TX, c, s);
  else if (circle)
    launch_k1<false, true>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx, gpy,
                           cap, TY, TX, c, s);
  else
    launch_k1<false, false>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx, gpy,
                            cap, TY, TX, c, s);
  return (int)cudaGetLastError();
}

// K2 plan: plan = int32 [cap, TY, TX].
int gpe_relocate_plan(const void* x, const void* y, const void* pid,
                      void* plan, int cap, int TY, int TX, int row0, int gTY,
                      int gTX, int match, float t, float delta,
                      void* stream) {
  const gpe::FlatLayout lay{TY, TX, 0, 0, 1, TX};
  const int n = TY * TX;
  gpe::relocate_plan_kernel<gpe::FlatLayout><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int*>(pid), static_cast<int*>(plan), cap, lay, n,
      row0, gTY, gTX, match, t, delta);
  return (int)cudaGetLastError();
}

// K2 apply: six fresh output planes + defer int32 [TY, TX].
int gpe_relocate_apply(const void* x, const void* y, const void* px,
                       const void* py, const void* rad, const void* pid,
                       const void* plan, void* ox, void* oy, void* opx,
                       void* opy, void* orad, void* opid, void* defer,
                       int cap, int TY, int TX, int row0, int gTY, int gTX,
                       int match, float t, float delta, void* stream) {
  const gpe::FlatLayout lay{TY, TX, 0, 0, 1, TX};
  const int n = TY * TX;
  gpe::relocate_apply_kernel<gpe::FlatLayout><<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(rad), static_cast<const int*>(pid),
      static_cast<const int*>(plan), static_cast<float*>(ox),
      static_cast<float*>(oy), static_cast<float*>(opx),
      static_cast<float*>(opy), static_cast<float*>(orad),
      static_cast<int*>(opid), static_cast<int*>(defer), cap, lay, n, row0,
      gTY, gTX, match, t, delta);
  return (int)cudaGetLastError();
}

// K2-par plan on the parity layout: fields and plan [4, cap, DY, DX], one
// launch over parities p0 .. p0 + np - 1.  One device: row0 0, the grid's
// own TY x TX as the global grid.
int gpe_relocate_plan_par(const void* x, const void* y, const void* pid,
                          void* plan, int cap, int TY, int TX, int DY,
                          int DX, int origin, int p0, int np, int match,
                          float t, float delta, void* stream) {
  if (p0 < 0 || np < 1 || p0 + np > 4) return (int)cudaErrorInvalidValue;
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, p0};
  const int n = np * DY * DX;
  gpe::relocate_plan_kernel<gpe::ParLayout><<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int*>(pid), static_cast<int*>(plan), cap, lay, n, 0,
      TY, TX, match, t, delta);
  return (int)cudaGetLastError();
}

// K2-par apply: fresh output planes [4, cap, DY, DX] (rad and orad null
// under uniform radius) + defer int32 [4, DY, DX].
int gpe_relocate_apply_par(const void* x, const void* y, const void* px,
                           const void* py, const void* rad, const void* pid,
                           const void* plan, void* ox, void* oy, void* opx,
                           void* opy, void* orad, void* opid, void* defer,
                           int cap, int TY, int TX, int DY, int DX,
                           int origin, int p0, int np, int match, float t,
                           float delta, void* stream) {
  if (p0 < 0 || np < 1 || p0 + np > 4 ||
      (rad == nullptr) != (orad == nullptr))
    return (int)cudaErrorInvalidValue;
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, p0};
  const int n = np * DY * DX;
  gpe::relocate_apply_kernel<gpe::ParLayout><<<blocks_for(n), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(rad), static_cast<const int*>(pid),
      static_cast<const int*>(plan), static_cast<float*>(ox),
      static_cast<float*>(oy), static_cast<float*>(opx),
      static_cast<float*>(opy), static_cast<float*>(orad),
      static_cast<int*>(opid), static_cast<int*>(defer), cap, lay, n, 0, TY,
      TX, match, t, delta);
  return (int)cudaGetLastError();
}

}  // extern "C"
