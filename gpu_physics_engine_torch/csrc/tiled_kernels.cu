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

// K1 / K3: one block of kK1Threads threads per k1_rows x k1_cols tiles of
// the mask word M's class, with the window's shared memory sized from cap
// (past 48 KB from cap 10 uniform, cap 8 general, and at every cap past
// 32).
template <class M, bool UNIFORM, bool CIRCLE, bool INTEGRATE>
int launch_k1_m(const float* x, const float* y, const float* px,
                const float* py, const float* rad, const int* pid,
                const float* prm, float* ox, float* oy, float* opx,
                float* opy, int cap, int TY, int TX, const gpe::K1Consts& c,
                cudaStream_t s) {
  constexpr int cls = gpe::mask_class<M>();
  const dim3 grid((TX + gpe::k1_cols(cls) - 1) / gpe::k1_cols(cls),
                  (TY + gpe::k1_rows(cls) - 1) / gpe::k1_rows(cls));
  const int smem = gpe::k1_mask_bytes(cap, UNIFORM);
  const cudaError_t rc = gpe::allow_smem(
      gpe::collide_integrate_kernel<M, UNIFORM, CIRCLE, INTEGRATE>, smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::collide_integrate_kernel<M, UNIFORM, CIRCLE, INTEGRATE>
      <<<grid, gpe::kK1Threads, smem, s>>>(x, y, px, py, rad, pid, prm, ox,
                                           oy, opx, opy, cap, TY, TX, c);
  return (int)cudaGetLastError();
}

// K1 / K3 past cap 64: one block of kK1PackThreads per plan.RY x plan.RX
// tiles, plan.smem bytes of shared memory whatever the cap.
template <bool UNIFORM, bool CIRCLE, bool INTEGRATE>
int launch_k1_pack(const float* x, const float* y, const float* px,
                   const float* py, const float* rad, const int* pid,
                   const float* prm, float* ox, float* oy, float* opx,
                   float* opy, int cap, int TY, int TX,
                   const gpe::K1Consts& c, const gpe::K1PackPlan& plan,
                   cudaStream_t s) {
  if (!gpe::k1_pack_ok(plan)) return (int)cudaErrorInvalidValue;
  const dim3 grid((TX + plan.RX - 1) / plan.RX, (TY + plan.RY - 1) / plan.RY);
  const cudaError_t rc = gpe::allow_smem(
      gpe::collide_integrate_pack_kernel<UNIFORM, CIRCLE, INTEGRATE>,
      plan.smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::collide_integrate_pack_kernel<UNIFORM, CIRCLE, INTEGRATE>
      <<<grid, gpe::kK1PackThreads, plan.smem, s>>>(
          x, y, px, py, rad, pid, prm, ox, oy, opx, opy, cap, TY, TX, c,
          plan);
  return (int)cudaGetLastError();
}

// The cap's kernel: the mask word of 32 bits up to cap 32, 64 bits for
// caps 33-64; past 64 the packed kernel under `plan` (the default plan
// unless a study passes another).
template <bool UNIFORM, bool CIRCLE, bool INTEGRATE = true>
int launch_k1(const float* x, const float* y, const float* px,
              const float* py, const float* rad, const int* pid,
              const float* prm, float* ox, float* oy, float* opx, float* opy,
              int cap, int TY, int TX, const gpe::K1Consts& c,
              cudaStream_t s,
              const gpe::K1PackPlan& plan = gpe::k1_pack_plan(),
              bool pack = false) {
  if (cap < 1 || TY < 1 || TX < 1) return (int)cudaErrorInvalidValue;
  if (pack || cap > gpe::kWideCap)
    return launch_k1_pack<UNIFORM, CIRCLE, INTEGRATE>(
        x, y, px, py, rad, pid, prm, ox, oy, opx, opy, cap, TY, TX, c, plan,
        s);
  auto* launch =
      cap > gpe::kNarrowCap
          ? &launch_k1_m<gpe::Mask64, UNIFORM, CIRCLE, INTEGRATE>
          : &launch_k1_m<unsigned, UNIFORM, CIRCLE, INTEGRATE>;
  return launch(x, y, px, py, rad, pid, prm, ox, oy, opx, opy, cap, TY, TX,
                c, s);
}

// The relocate window's grid: one block per region of class C, 8 x 64
// tiles on FlatLayout, 4 x 32 cells of each sub-grid on ParLayout.
template <int C>
dim3 window_grid(const gpe::FlatLayout& l) {
  constexpr int R = gpe::k2_rows(false, C), W = gpe::k2_width(false, C);
  return dim3((l.TX + W - 1) / W, (l.TY + R - 1) / R);
}
template <int C>
dim3 window_grid(const gpe::ParLayout& l) {
  constexpr int R = gpe::k2_rows(true, C), W = gpe::k2_width(true, C);
  return dim3((l.DX + W - 1) / W, (l.DY + R - 1) / R);
}

// One launch of the relocate window (K2, K2-par, K4, relocate_mega), with
// the step rule H and the mask word M: one block of k2_threads per region,
// shared memory sized from cap (past 48 KB at every cap: 53,568 bytes at
// cap 1, 85,312 at cap 32, 168,576 at cap 64, on either layout).
template <class M, class L, class H>
int launch_window_m(const void* x, const void* y, const void* px,
                    const void* py, const void* rad, const void* pid,
                    void* ox, void* oy, void* opx, void* opy, void* orad,
                    void* opid, void* defer, int cap, const L& lay, int p0,
                    int np, int row0, int gTY, int gTX, int match,
                    const H& home, void* stream) {
  const int smem = gpe::k2_mask_bytes(cap, gpe::k2_par<L>());
  const cudaError_t rc =
      gpe::allow_smem(gpe::relocate_window_kernel<M, L, H>, smem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid = window_grid<gpe::mask_class<M>()>(lay);
  gpe::relocate_window_kernel<M, L, H>
      <<<grid, gpe::k2_threads<M, L>(), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(y),
          static_cast<const float*>(px), static_cast<const float*>(py),
          static_cast<const float*>(rad), static_cast<const int*>(pid),
          static_cast<float*>(ox), static_cast<float*>(oy),
          static_cast<float*>(opx), static_cast<float*>(opy),
          static_cast<float*>(orad), static_cast<int*>(opid),
          static_cast<int*>(defer), cap, lay, p0, np, row0, gTY, gTX, match,
          home);
  return (int)cudaGetLastError();
}

// The warp kernel's grid on rows x cols storage cells: one block per RY x
// RX full-space tiles (on the parity layout RY/2 x RX/2 cells of each
// sub-grid of rows x cols).
dim3 warp_grid(int rows, int cols, bool par, int RY, int RX) {
  const int ry = par ? RY / 2 : RY, rx = par ? RX / 2 : RX;
  return dim3((cols + rx - 1) / rx, (rows + ry - 1) / ry);
}
dim3 warp_grid(const gpe::FlatLayout& l, int RY, int RX) {
  return warp_grid(l.TY, l.TX, false, RY, RX);
}
dim3 warp_grid(const gpe::ParLayout& l, int RY, int RX) {
  return warp_grid(l.DY, l.DX, true, RY, RX);
}

// The relocate past cap 64: relocate_warp_kernel on its region
// (k2_warp_region), its arrays in shared memory or, where no region fits a
// block, in `scratch` (k2_warp_bytes a block, the grid's blocks in order).
template <class L, class H, bool SMEM>
int launch_warp_s(const void* x, const void* y, const void* px,
                  const void* py, const void* rad, const void* pid, void* ox,
                  void* oy, void* opx, void* opy, void* orad, void* opid,
                  void* defer, int cap, const L& lay, int p0, int np,
                  int row0, int gTY, int gTX, int match, const H& home,
                  int RY, int RX, void* scratch, void* stream) {
  const int smem = SMEM ? (int)gpe::k2_warp_bytes(cap, RY, RX) : 0;
  const cudaError_t rc =
      gpe::allow_smem(gpe::relocate_warp_kernel<L, H, SMEM>, smem);
  if (rc != cudaSuccess) return (int)rc;
  gpe::relocate_warp_kernel<L, H, SMEM>
      <<<warp_grid(lay, RY, RX), gpe::kK2WarpThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(y),
          static_cast<const float*>(px), static_cast<const float*>(py),
          static_cast<const float*>(rad), static_cast<const int*>(pid),
          static_cast<float*>(ox), static_cast<float*>(oy),
          static_cast<float*>(opx), static_cast<float*>(opy),
          static_cast<float*>(orad), static_cast<int*>(opid),
          static_cast<int*>(defer), cap, lay, p0, np, row0, gTY, gTX, match,
          home, RY, RX, static_cast<unsigned char*>(scratch));
  return (int)cudaGetLastError();
}

template <class L, class H>
int launch_window(const void* x, const void* y, const void* px,
                  const void* py, const void* rad, const void* pid, void* ox,
                  void* oy, void* opx, void* opy, void* orad, void* opid,
                  void* defer, int cap, const L& lay, int p0, int np,
                  int row0, int gTY, int gTX, int match, const H& home,
                  void* scratch, void* stream, bool warp = false) {
  if (cap < 1 || match < gpe::kFlip || match > gpe::kGreedy ||
      (rad == nullptr) != (orad == nullptr))
    return (int)cudaErrorInvalidValue;
  if (warp || cap > gpe::kWideCap) {
    int RY, RX;
    if (gpe::k2_warp_region(cap, &RY, &RX))
      return launch_warp_s<L, H, true>(
          x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid, defer, cap,
          lay, p0, np, row0, gTY, gTX, match, home, RY, RX, nullptr, stream);
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return launch_warp_s<L, H, false>(
        x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid, defer, cap, lay,
        p0, np, row0, gTY, gTX, match, home, RY, RX, scratch, stream);
  }
  auto* launch = cap > gpe::kNarrowCap ? &launch_window_m<gpe::Mask64, L, H>
                                       : &launch_window_m<unsigned, L, H>;
  return launch(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid, defer,
                cap, lay, p0, np, row0, gTY, gTX, match, home, stream);
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
                      float delta, void* stream, void* scratch) {
  if (TY < 1 || TX < 1) return (int)cudaErrorInvalidValue;
  const gpe::FlatLayout lay{TY, TX};
  return launch_window(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                       defer, cap, lay, 0, 1, row0, gTY, gTX, match,
                       gpe::StepHome{t, delta, gTY, gTX}, scratch, stream);
}

// K2 through the warp kernel at any cap (the studies' comparison at caps
// up to 64, utils/kernel_study.py).  As gpe_relocate_pull otherwise.
int gpe_relocate_pull_warp(const void* x, const void* y, const void* px,
                           const void* py, const void* rad, const void* pid,
                           void* ox, void* oy, void* opx, void* opy,
                           void* orad, void* opid, void* defer, int cap,
                           int TY, int TX, int row0, int gTY, int gTX,
                           int match, float t, float delta, void* stream,
                           void* scratch) {
  if (TY < 1 || TX < 1) return (int)cudaErrorInvalidValue;
  const gpe::FlatLayout lay{TY, TX};
  return launch_window(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                       defer, cap, lay, 0, 1, row0, gTY, gTX, match,
                       gpe::StepHome{t, delta, gTY, gTX}, scratch, stream,
                       true);
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
                     float t, float delta, void* stream, void* scratch) {
  if (p0 < 0 || np < 1 || p0 + np > 4 || DY < 1 || DX < 1)
    return (int)cudaErrorInvalidValue;
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, 0};
  return launch_window(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                       defer, cap, lay, p0, np, 0, TY, TX, match,
                       gpe::StepHome{t, delta, TY, TX}, scratch, stream);
}

// K2's shared-memory bytes at cap on either layout, as the launches above
// take them (past cap 64 the warp kernel's; 0 where its arrays go to
// device scratch).
int gpe_relocate_window_bytes(int cap, int par) {
  if (cap <= gpe::kWideCap) return gpe::k2_mask_bytes(cap, par != 0);
  int RY, RX;
  return gpe::k2_warp_region(cap, &RY, &RX)
             ? (int)gpe::k2_warp_bytes(cap, RY, RX)
             : 0;
}

// The device scratch a relocate launch at cap needs on rows x cols storage
// cells (on the parity layout, DY x DX of each sub-grid): a block's arrays
// for every block of the warp kernel's grid where no region fits a block,
// else 0.  The callers allocate the scratch they pass from this.
long long gpe_relocate_scratch_bytes(int cap, int rows, int cols, int par) {
  int RY, RX;
  if (cap <= gpe::kWideCap || gpe::k2_warp_region(cap, &RY, &RX)) return 0;
  const dim3 g = warp_grid(rows, cols, par != 0, RY, RX);
  return (long long)g.x * g.y * gpe::k2_warp_bytes(cap, RY, RX);
}

// K1's (and K3's) shared-memory bytes at cap, with or without the radius
// plane, as the launches above take them.
int gpe_collide_window_bytes(int cap, int uniform) {
  return cap <= gpe::kWideCap ? gpe::k1_mask_bytes(cap, uniform != 0)
                              : gpe::k1_pack_plan().smem;
}

// K1 through the packed kernel at any cap under another plan (region
// ry x rx, shared bytes): the studies' variants and the streamed window's
// checks (utils/kernel_study.py, chip_smoke.py).  As gpe_collide_integrate
// otherwise.
int gpe_collide_integrate_pack(const void* x, const void* y, const void* px,
                               const void* py, const void* rad,
                               const void* pid, const void* prm, void* ox,
                               void* oy, void* opx, void* opy, int cap,
                               int TY, int TX, int uniform, int circle,
                               const void* consts, void* stream, int ry,
                               int rx, int smem) {
  const gpe::K1Consts c = k1_consts(consts);
  const gpe::K1PackPlan plan{ry, rx, smem};
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
                                 gpy, cap, TY, TX, c, s, plan, true);
  if (uniform)
    return launch_k1<true, false>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx,
                                  gpy, cap, TY, TX, c, s, plan, true);
  if (circle)
    return launch_k1<false, true>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx,
                                  gpy, cap, TY, TX, c, s, plan, true);
  return launch_k1<false, false>(fx, fy, fpx, fpy, fr, ip, fp, gx, gy, gpx,
                                 gpy, cap, TY, TX, c, s, plan, true);
}

// K4: the relocate window on [cap, TY, TX] with flip matching, no
// hysteresis and the home tile by division.  Six fresh output planes +
// defer int32 [TY, TX].
int gpe_relocate_one(const void* x, const void* y, const void* px,
                     const void* py, const void* rad, const void* pid,
                     void* ox, void* oy, void* opx, void* opy, void* orad,
                     void* opid, void* defer, int cap, int TY, int TX,
                     int row0, int gTY, int gTX, float t, void* stream,
                     void* scratch) {
  if (TY < 1 || TX < 1) return (int)cudaErrorInvalidValue;
  const gpe::FlatLayout lay{TY, TX};
  return launch_window(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                       defer, cap, lay, 0, 1, row0, gTY, gTX, gpe::kFlip,
                       gpe::DivHome{t, gTY, gTX}, scratch, stream);
}

// relocate_mega: K2-par over all four parities in one launch on the
// parity layout [4, cap, DY, DX] (rad and orad null under uniform radius);
// defer int32 [4, DY, DX].  One device: row0 0, the grid's own TY x TX.
int gpe_relocate_mega(const void* x, const void* y, const void* px,
                      const void* py, const void* rad, const void* pid,
                      void* ox, void* oy, void* opx, void* opy, void* orad,
                      void* opid, void* defer, int cap, int TY, int TX,
                      int DY, int DX, int origin, int match, float t,
                      float delta, void* stream, void* scratch) {
  if (DY < 1 || DX < 1) return (int)cudaErrorInvalidValue;
  const gpe::ParLayout lay{TY, TX, DY, DX, origin, 0};
  return launch_window(x, y, px, py, rad, pid, ox, oy, opx, opy, orad, opid,
                       defer, cap, lay, 0, 4, 0, TY, TX, match,
                       gpe::StepHome{t, delta, TY, TX}, scratch, stream);
}

}  // extern "C"
