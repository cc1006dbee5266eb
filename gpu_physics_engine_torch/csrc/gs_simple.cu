// Launchers of the Gauss-Seidel kernels past cap 64 or K 16
// (gs_simple.cuh), called by gs_kernels.cu's entry points, and the plain C
// entry points that report their routes and plans.  Every launch goes on
// the caller's stream; nothing here synchronises or allocates.
#include <cuda_runtime.h>

#include "gs_simple.cuh"

namespace {

// Blocks for n items of `threads` threads each (grid-stride loops past
// the cap).
int grid_of(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return (int)(b < 1 ? 1 : b > 65535LL * 16 ? 65535LL * 16 : b);
}

// K5's grid: a block per region of kGsPackRY x kGsPackRX full-space tiles
// (on ParLayout half as many cells of each sub-grid per axis).
dim3 pack_grid(const gpe::FlatLayout& l) {
  return dim3((l.TX + gpe::kGsPackRX - 1) / gpe::kGsPackRX,
              (l.TY + gpe::kGsPackRY - 1) / gpe::kGsPackRY);
}
dim3 pack_grid(const gpe::ParLayout& l) {
  constexpr int SY = gpe::kGsPackRY / 2, SX = gpe::kGsPackRX / 2;
  return dim3((l.DX + SX - 1) / SX, (l.DY + SY - 1) / SY);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The table entries of a launch over np parities from p0 (FlatLayout: all
// of them, from 0): tables are parity-major, each parity's K planes
// contiguous.
long long table_first(const gpe::FlatLayout&, int, int) { return 0; }
long long table_first(const gpe::ParLayout& l, int K, int) {
  return (long long)l.p0 * K * l.DY * l.DX;
}
long long table_words(const gpe::FlatLayout& l, int K, int) {
  return (long long)K * l.TY * l.TX;
}
long long table_words(const gpe::ParLayout& l, int K, int np) {
  return (long long)np * K * l.DY * l.DX;
}

// The fill of the launch's table entries, then the packed kernel.
template <class L, bool MASK>
int launch_pack(const float* x, const float* y, const float* rad,
                const int* pid, int* src, int* rpid, float* rrad, int* count,
                int cap, const L& lay, int np, int K, float t, float r0,
                int entries, cudaStream_t s) {
  if (entries == 0) entries = gpe::kGsPackEntries;
  if (entries < 1 || entries > gpe::kGsPackEntries)
    return (int)cudaErrorInvalidValue;
  const long long first = table_first(lay, K, np);
  const int n = (int)table_words(lay, K, np);
  int* fs = src + first;
  int* fp = rpid + first;
  float* fr = rrad + first;
  const int vec = aligned16(fs) && aligned16(fp) && aligned16(fr);
  gpe::gs_rank_fill_kernel<<<grid_of(vec ? n / 4 : n, 256), 256, 0, s>>>(
      fs, fp, fr, n, vec);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const int smem = gpe::gs_pack_bytes(rad == nullptr, entries);
  gpe::gs_rank_pack_kernel<L, MASK>
      <<<pack_grid(lay), gpe::kGsPackThreads, smem, s>>>(
          x, y, rad, pid, src, rpid, rrad, count, cap, lay, np, K, t, r0,
          entries);
  return (int)cudaGetLastError();
}

// Slots of the storage (all parities on ParLayout).
int storage_slots(const gpe::FlatLayout& l, int cap) {
  return cap * l.TY * l.TX;
}
int storage_slots(const gpe::ParLayout& l, int cap) {
  return 4 * cap * l.DY * l.DX;
}

// The copy, colors 1 .. c1 and with integ the tail, each a launch in
// stream order.
template <class L>
int launch_ranked(const gpe::GsWindowArgs& a, const int* count, const L& lay,
                  cudaStream_t s) {
  constexpr int T = gpe::kGsRankedThreads;
  if (count == nullptr) return (int)cudaErrorInvalidValue;
  const int slots = storage_slots(lay, a.cap);
  const int vec = (aligned16(a.x) && aligned16(a.y) && aligned16(a.ox) &&
                   aligned16(a.oy)) |
                  (aligned16(a.pid) << 1);
  gpe::gs_colors_ranked_kernel<L, gpe::kGsRankedCopy>
      <<<grid_of(vec & 1 ? slots / 4 : slots, T), T, 0, s>>>(
          a, count, lay, gpe::kGsPhaseCopy, slots, vec);
  cudaError_t rc = cudaGetLastError();
  const long long cells = ((long long)lay.TY + 1) / 2 * ((lay.TX + 1) / 2);
  for (int c = 1; c <= a.c1 && rc == cudaSuccess; ++c) {
    gpe::gs_colors_ranked_kernel<L, gpe::kGsRankedColor>
        <<<grid_of(cells, T), T, 0, s>>>(a, count, lay, c, slots, vec);
    rc = cudaGetLastError();
  }
  if (a.integ && rc == cudaSuccess) {
    gpe::gs_colors_ranked_kernel<L, gpe::kGsRankedTail>
        <<<grid_of(vec & 2 ? slots / 4 : slots, T), T, 0, s>>>(
            a, count, lay, gpe::kGsPhaseTail, slots, vec);
    rc = cudaGetLastError();
  }
  return (int)rc;
}

}  // namespace

namespace gpe {

int launch_rank_pack(const float* x, const float* y, const float* rad,
                     const int* pid, int* src, int* rpid, float* rrad,
                     int* count, int cap, const FlatLayout& lay, int np,
                     int K, float t, float r0, int entries, cudaStream_t s) {
  return launch_pack<FlatLayout, false>(x, y, rad, pid, src, rpid, rrad,
                                        count, cap, lay, np, K, t, r0,
                                        entries, s);
}
int launch_rank_pack(const float* x, const float* y, const float* rad,
                     const int* pid, int* src, int* rpid, float* rrad,
                     int* count, int cap, const ParLayout& lay, int np,
                     int K, float t, float r0, int entries, cudaStream_t s) {
  return launch_pack<ParLayout, true>(x, y, rad, pid, src, rpid, rrad, count,
                                      cap, lay, np, K, t, r0, entries, s);
}
int launch_colors_ranked(const GsWindowArgs& a, const int* count,
                         const FlatLayout& lay, cudaStream_t s) {
  return launch_ranked(a, count, lay, s);
}
int launch_colors_ranked(const GsWindowArgs& a, const int* count,
                         const ParLayout& lay, cudaStream_t s) {
  return launch_ranked(a, count, lay, s);
}

}  // namespace gpe

extern "C" {

// The kernels a launch at (cap, K) takes: bit 0 set where the rank is
// gs_rank_pack_kernel (else gs_rank_kernel), bit 1 where the solve is
// gs_colors_ranked_kernel (else gs_colors_window_kernel).
int gpe_gs_route(int cap, int K) {
  return gpe::gs_windowed(cap, K) ? 0 : 3;
}

// The packed rank's shared bytes a block with a buffer of `entries`
// occupants (0: the default plan's, kGsPackEntries), with or without a
// radius plane.
int gpe_gs_rank_pack_bytes(int uniform, int entries) {
  return gpe::gs_pack_bytes(uniform != 0,
                            entries ? entries : gpe::kGsPackEntries);
}

// K5 and K5-par on the packed kernel at any cap and K, with a buffer of
// `entries` occupants (1 .. kGsPackEntries; 0: the default plan's): a
// window with more streams.
// Arguments as gpe_gs_rank (par == 0) and gpe_gs_rank_par (par != 0; rad
// may be null there).  For the studies and the checks that make windows
// stream; the engine's launches take gpe_gs_rank / gpe_gs_rank_par.
int gpe_gs_rank_pack(const void* x, const void* y, const void* rad,
                     const void* pid, void* src, void* rpid, void* rrad,
                     void* count, int cap, int TY, int TX, int DY, int DX,
                     int origin, int par, int p0, int np, int K, float t,
                     float r0, int entries, void* stream) {
  if (K < 1 || cap < 1 || TY < 1 || TX < 1 ||
      (par && (p0 < 0 || np < 1 || p0 + np > 4 || DY < 1 || DX < 1)) ||
      (!par && rad == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* fx = static_cast<const float*>(x);
  const auto* fy = static_cast<const float*>(y);
  const auto* fr = static_cast<const float*>(rad);
  const auto* ip = static_cast<const int*>(pid);
  auto* is = static_cast<int*>(src);
  auto* iq = static_cast<int*>(rpid);
  auto* fq = static_cast<float*>(rrad);
  auto* ic = static_cast<int*>(count);
  const auto st = static_cast<cudaStream_t>(stream);
  if (par)
    return gpe::launch_rank_pack(fx, fy, fr, ip, is, iq, fq, ic, cap,
                                 gpe::ParLayout{TY, TX, DY, DX, origin, p0},
                                 np, K, t, r0, entries, st);
  return gpe::launch_rank_pack(fx, fy, fr, ip, is, iq, fq, ic, cap,
                               gpe::FlatLayout{TY, TX}, 1, K, t, 0.0f,
                               entries, st);
}

}  // extern "C"
