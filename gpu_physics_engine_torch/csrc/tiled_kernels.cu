// Plain C entry points for the tiled-pipeline kernels (tiled_kernels.cuh),
// loaded from Python with ctypes (gpu_physics_engine_torch/ops/_cuda.py).
//
// Every pointer is a device pointer except `consts` (host); every launch
// goes on the caller's stream and nothing here synchronises or allocates.
// Each function returns cudaGetLastError() so that a refused launch is
// reported at the call, not at some later synchronisation.
#include <cuda_runtime.h>

#include <algorithm>

#include "tiled_kernels.cuh"

namespace {

// Raise a kernel's limit of dynamic shared memory where a launch needs
// more than the default 48 KB.  The call is made on every such launch: K2
// at every cap, K1 past cap 9 uniform or cap 7 general, the fused relocate
// past cap 20.  A size the card cannot give is refused here, and the error
// returns to the caller.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// K1 / K3: one block of kK1Tiles threads per kK1RegionY x kK1RegionX tiles,
// with the window's shared memory sized from cap (past 48 KB from cap 10
// uniform, cap 8 general).
template <bool UNIFORM, bool CIRCLE, bool INTEGRATE = true>
int launch_k1(const float* x, const float* y, const float* px,
              const float* py, const float* rad, const int* pid,
              const float* prm, float* ox, float* oy, float* opx, float* opy,
              int cap, int TY, int TX, const gpe::K1Consts& c,
              cudaStream_t s) {
  if (cap < 1 || cap > gpe::kMaxCap || TY < 1 || TX < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((TX + gpe::kK1RegionX - 1) / gpe::kK1RegionX,
                  (TY + gpe::kK1RegionY - 1) / gpe::kK1RegionY);
  const int smem = gpe::k1_smem_bytes(cap, UNIFORM);
  const cudaError_t rc = allow_smem(
      gpe::collide_integrate_kernel<UNIFORM, CIRCLE, INTEGRATE>, smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::collide_integrate_kernel<UNIFORM, CIRCLE, INTEGRATE>
      <<<grid, gpe::kK1Tiles, smem, s>>>(x, y, px, py, rad, pid, prm, ox, oy,
                                         opx, opy, cap, TY, TX, c);
  return (int)cudaGetLastError();
}

// One launch of the fused relocate over the storage extent [ylo, ylo + NY)
// x [xlo, xlo + NX): one block per kRegionY x kRegionX tiles, with a
// thread for every plan of the region and its ring (612 tiles at 16 x 32:
// 640 threads), so the plan phase is one pass of the block; 512 of them
// then apply (past 48 KB of shared memory from cap 21).
constexpr int kFusedThreads =
    std::min(1024, (gpe::kRingTiles + 31) / 32 * 32);

template <class L, class H>
int launch_fused(const void* x, const void* y, const void* px,
                 const void* py, const void* rad, const void* pid, void* ox,
                 void* oy, void* opx, void* opy, void* orad, void* opid,
                 void* defer, int cap, const L& lay, int ylo, int xlo, int NY,
                 int NX, int row0, int gTY, int gTX, int match, const H& home,
                 void* stream) {
  if (cap < 1 || cap > gpe::kMaxCap || NY < 1 || NX < 1 ||
      (rad == nullptr) != (orad == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((NX + gpe::kRegionX - 1) / gpe::kRegionX,
                  (NY + gpe::kRegionY - 1) / gpe::kRegionY);
  const int smem = gpe::fused_smem_bytes(cap);
  const cudaError_t rc = allow_smem(gpe::relocate_fused_kernel<L, H>, smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::relocate_fused_kernel<L, H>
      <<<grid, kFusedThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(y),
          static_cast<const float*>(px), static_cast<const float*>(py),
          static_cast<const float*>(rad), static_cast<const int*>(pid),
          static_cast<float*>(ox), static_cast<float*>(oy),
          static_cast<float*>(opx), static_cast<float*>(opy),
          static_cast<float*>(orad), static_cast<int*>(opid),
          static_cast<int*>(defer), cap, lay, ylo, xlo, NY, NX, row0, gTY,
          gTX, match, home);
  return (int)cudaGetLastError();
}

// One launch of K2's window kernel: one block of k2_threads per region,
// shared memory sized from cap (past 48 KB at every cap: 53,568 bytes at
// cap 1, 85,312 at cap 32, on either layout).
template <class L>
int launch_window(const void* x, const void* y, const void* px,
                  const void* py, const void* rad, const void* pid, void* ox,
                  void* oy, void* opx, void* opy, void* orad, void* opid,
                  void* defer, int cap, const L& lay, dim3 grid, int p0,
                  int np, int row0, int gTY, int gTX, int match, float t,
                  float delta, void* stream) {
  if (cap < 1 || cap > gpe::kMaxCap || match < gpe::kFlip ||
      match > gpe::kGreedy || (rad == nullptr) != (orad == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = gpe::k2_window_bytes(cap, gpe::k2_par<L>());
  const cudaError_t rc = allow_smem(gpe::relocate_window_kernel<L>, smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::relocate_window_kernel<L>
      <<<grid, gpe::k2_threads<L>(), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(y),
          static_cast<const float*>(px), static_cast<const float*>(py),
          static_cast<const float*>(rad), static_cast<const int*>(pid),
          static_cast<float*>(ox), static_cast<float*>(oy),
          static_cast<float*>(opx), static_cast<float*>(opy),
          static_cast<float*>(orad), static_cast<int*>(opid),
          static_cast<int*>(defer), cap, lay, p0, np, row0, gTY, gTX, match,
          gpe::StepHome{t, delta, gTY, gTX});
  return (int)cudaGetLastError();
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
    return launch_k1<true, false, false>(fx, fy, nullptr, nullptr, fr, ip,
                                         nullptr, gx, gy, nullptr, nullptr,
                                         cap, TY, TX, c, s);
  return launch_k1<false, false, false>(fx, fy, nullptr, nullptr, fr, ip,
                                        nullptr, gx, gy, nullptr, nullptr,
                                        cap, TY, TX, c, s);
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
    return launch_k1<true, true>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx,
                                 gpy, cap, TY, TX, c, s);
  if (uniform)
    return launch_k1<true, false>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx,
                                  gpy, cap, TY, TX, c, s);
  if (circle)
    return launch_k1<false, true>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx,
                                  gpy, cap, TY, TX, c, s);
  return launch_k1<false, false>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx,
                                 gpy, cap, TY, TX, c, s);
}

// K2: six fresh output planes + defer int32 [TY, TX].
int gpe_relocate_pull(const void* x, const void* y, const void* px,
                      const void* py, const void* rad, const void* pid,
                      void* ox, void* oy, void* opx, void* opy, void* orad,
                      void* opid, void* defer, int cap, int TY, int TX,
                      int row0, int gTY, int gTX, int match, float t,
                      float delta, void* stream) {
  if (TY < 1 || TX < 1) return (int)cudaErrorInvalidValue;
  const gpe::FlatLayout lay{TY, TX, 0, 0, 1, TX};
  const dim3 grid((TX + gpe::kK2WidthFlat - 1) / gpe::kK2WidthFlat,
                  (TY + gpe::kK2RowsFlat - 1) / gpe::kK2RowsFlat);
  return launch_window(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                       defer, cap, lay, grid, 0, 1, row0, gTY, gTX, match, t,
                       delta, stream);
}

// K2-par on the parity layout: fields [4, cap, DY, DX], fresh output
// planes (rad and orad null under uniform radius) + defer int32 [4, DY,
// DX] for parities p0 .. p0 + np - 1.  One device: row0 0, the grid's own
// TY x TX as the global grid.
int gpe_relocate_par(const void* x, const void* y, const void* px,
                     const void* py, const void* rad, const void* pid,
                     void* ox, void* oy, void* opx, void* opy, void* orad,
                     void* opid, void* defer, int cap, int TY, int TX,
                     int DY, int DX, int origin, int p0, int np, int match,
                     float t, float delta, void* stream) {
  if (p0 < 0 || np < 1 || p0 + np > 4 || DY < 1 || DX < 1)
    return (int)cudaErrorInvalidValue;
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, 0};
  const dim3 grid((DX + gpe::kK2WidthPar - 1) / gpe::kK2WidthPar,
                  (DY + gpe::kK2RowsPar - 1) / gpe::kK2RowsPar);
  return launch_window(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                       defer, cap, lay, grid, p0, np, 0, TY, TX, match, t,
                       delta, stream);
}

// K2's shared-memory bytes at cap on either layout, as the launches above
// take them.
int gpe_relocate_window_bytes(int cap, int par) {
  return gpe::k2_window_bytes(cap, par != 0);
}

// K4: plan + apply in one launch on [cap, TY, TX]: flip matching, no
// hysteresis, the home tile by division.  Six fresh output planes + defer
// int32 [TY, TX].
int gpe_relocate_one(const void* x, const void* y, const void* px,
                     const void* py, const void* rad, const void* pid,
                     void* ox, void* oy, void* opx, void* opy, void* orad,
                     void* opid, void* defer, int cap, int TY, int TX,
                     int row0, int gTY, int gTX, float t, void* stream) {
  const gpe::FlatLayout lay{TY, TX, 0, 0, 1, TX};
  return launch_fused(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                      defer, cap, lay, 0, 0, TY, TX, row0, gTY, gTX,
                      gpe::kFlip, gpe::DivHome{t, gTY, gTX}, stream);
}

// relocate_mega: K2-par's plan + apply in one launch on the parity layout
// [4, cap, DY, DX] (rad and orad null under uniform radius); defer int32
// [4, DY, DX].  One device: row0 0, the grid's own TY x TX.
int gpe_relocate_mega(const void* x, const void* y, const void* px,
                      const void* py, const void* rad, const void* pid,
                      void* ox, void* oy, void* opx, void* opy, void* orad,
                      void* opid, void* defer, int cap, int TY, int TX,
                      int DY, int DX, int origin, int match, float t,
                      float delta, void* stream) {
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, 0};
  return launch_fused(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                      defer, cap, lay, origin, origin, 2 * DY, 2 * DX, 0, TY,
                      TX, match, gpe::StepHome{t, delta, TY, TX}, stream);
}

}  // extern "C"
