// Launchers of the Gauss-Seidel kernels past cap 256 or K 64
// (gs_simple.cuh), called by gs_kernels.cu's entry points.  Every launch
// goes on the caller's stream; nothing here synchronises or allocates.
#include <cuda_runtime.h>

#include "gs_simple.cuh"

namespace {

// The cells of a rank launch: every cell (FlatLayout), or those of its np
// parities from lay.p0.
int list_cells(const gpe::FlatLayout& l, int) { return l.TY * l.TX; }
int list_cells(const gpe::ParLayout& l, int np) { return np * l.DY * l.DX; }

// Blocks for n items of `threads` threads each (grid-stride loops past
// the cap).
int grid_of(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return (int)(b < 1 ? 1 : b > 65535LL * 16 ? 65535LL * 16 : b);
}

// K5 on the list kernel: a warp per cell (MASK on the parity layout).
template <class L, bool MASK>
int launch_list(const float* x, const float* y, const float* rad,
                const int* pid, int* src, int* rpid, float* rrad, int* count,
                int cap, const L& lay, int np, int K, float t, float r0,
                cudaStream_t s) {
  const int smem = gpe::gs_list_bytes();
  const cudaError_t rc =
      gpe::allow_smem(gpe::gs_rank_list_kernel<L, MASK>, smem);
  if (rc != cudaSuccess) return (int)rc;
  const int cells = list_cells(lay, np);
  gpe::gs_rank_list_kernel<L, MASK>
      <<<grid_of(cells, gpe::kGsListThreads / 32), gpe::kGsListThreads, smem,
         s>>>(x, y, rad, pid, src, rpid, rrad, count, cap, lay, cells, K, t,
              r0);
  return (int)cudaGetLastError();
}

// Slots of the storage (all parities on ParLayout).
int storage_slots(const gpe::FlatLayout& l, int cap) {
  return cap * l.TY * l.TX;
}
int storage_slots(const gpe::ParLayout& l, int cap) {
  return 4 * cap * l.DY * l.DX;
}

// x, y copied to the outputs, a launch a color on them in place, then the
// tail over every slot.
template <class L>
int launch_cells(const gpe::GsWindowArgs& a, const L& lay, cudaStream_t s) {
  const int slots = storage_slots(lay, a.cap);
  cudaError_t rc = cudaMemcpyAsync(a.ox, a.x, sizeof(float) * (size_t)slots,
                                   cudaMemcpyDeviceToDevice, s);
  if (rc == cudaSuccess)
    rc = cudaMemcpyAsync(a.oy, a.y, sizeof(float) * (size_t)slots,
                         cudaMemcpyDeviceToDevice, s);
  if (rc != cudaSuccess) return (int)rc;
  const long long cells = ((long long)lay.TY + 1) / 2 * ((lay.TX + 1) / 2);
  for (int c = 1; c <= a.c1; ++c) {
    gpe::gs_color_cells_kernel<L>
        <<<grid_of(cells, gpe::kGsCellThreads), gpe::kGsCellThreads, 0, s>>>(
            a, lay, c);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  if (a.integ) {
    gpe::gs_verlet_tail_kernel<<<grid_of(slots, 256), 256, 0, s>>>(a, slots);
    rc = cudaGetLastError();
  }
  return (int)rc;
}

}  // namespace

namespace gpe {

int launch_rank_list(const float* x, const float* y, const float* rad,
                     const int* pid, int* src, int* rpid, float* rrad,
                     int* count, int cap, const FlatLayout& lay, int np,
                     int K, float t, float r0, cudaStream_t s) {
  return launch_list<FlatLayout, false>(x, y, rad, pid, src, rpid, rrad,
                                        count, cap, lay, np, K, t, r0, s);
}
int launch_rank_list(const float* x, const float* y, const float* rad,
                     const int* pid, int* src, int* rpid, float* rrad,
                     int* count, int cap, const ParLayout& lay, int np,
                     int K, float t, float r0, cudaStream_t s) {
  return launch_list<ParLayout, true>(x, y, rad, pid, src, rpid, rrad, count,
                                      cap, lay, np, K, t, r0, s);
}
int launch_color_cells(const GsWindowArgs& a, const FlatLayout& lay,
                       cudaStream_t s) {
  return launch_cells(a, lay, s);
}
int launch_color_cells(const GsWindowArgs& a, const ParLayout& lay,
                       cudaStream_t s) {
  return launch_cells(a, lay, s);
}

}  // namespace gpe
