// Hand kernels of the reference-exact Gauss-Seidel path for Hopper (sm_90a).
//
// K5  gs_rank_kernel   replaces gpu_physics_engine_tpu/ops/gs_pallas.py::
//     _rank_full (:467; kernels _rank_kernel :219, _rank_kernel_net :362);
//     on ParLayout it also replaces ops/gs_parity.py::rank_parity (:275;
//     _rank_kernel_par :160, _rank_kernel_par_all :206), "K5-par".
// K6  gs_color_kernel  replaces gpu_physics_engine_tpu/ops/gs_pallas.py::
//     gs_solve_pallas_flat (:543; _solve_kernel :390 with _sweep :77, and
//     _apply_kernel :431); on ParLayout it replaces the color passes of
//     gs_solve_pallas_dec (:783), gs_solve_pallas_mx (:1045) and
//     ops/gs_parity.py::solve_parity (:433; _solve_dec_kernel,
//     _apply_dec_kernel), "K6-dec", "K6-mx", "K6-par".
// gs_verlet_kernel     is K6-par's Verlet tail: the Verlet step that
//     ops/gs_parity.py::_apply_integrate_dec_kernel (:353) fuses into the
//     color-4 apply, launched right after the color-4 pass.
// gs_colors_mega_kernel replaces ops/gs_mega.py::colors_mega (:503, kernel
//     _mega_kernel :136): the four K6-par colors and the Verlet tail in
//     one cooperative launch.
//
// Storage is a layout of csrc/layout.cuh: slot-major [CAP, TY, TX] (flat)
// or parity-major [4, CAP, DY, DX]; the rank tables are the same layout
// with K planes, the count with one.  Tile (ty, tx) is reference cell
// (ty-1, tx-1).  Source code j*cap + s names slot s of the tile at full
// offset (j/3 - 1, j%3 - 1) from the cell.
//
// Exactness is the contract: the results must equal the scalar model's
// bit for bit.  Every product, sum, quotient and square root goes through
// the __f*_rn intrinsics, which are never contracted into an FMA and are
// IEEE-rounded whatever the build flags (which also say -fmad=false and
// never --use_fast_math).
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "layout.cuh"

namespace gpe {

constexpr int kGsMaxK = 16;
constexpr int kBigPid = 0x7FFFFFFF;
constexpr float kGsMinDist = 1e-4f;  // f32 rounding of MIN_DISTANCE

// ---------------------------------------------------------------------------
// K5: per cell, the K smallest member pids in ascending order.
// ---------------------------------------------------------------------------

// Candidate (j, s) of cell (ty, tx) is slot s of the tile at full offset
// (j/3 - 1, j%3 - 1); it is a member when its circle strictly overlaps the
// cell's box [lo, lo + t) per axis (the full 2D clip: under pull-relocate
// hysteresis a member may be stored one tile off its home, so no
// per-offset shortcut is valid).  Out-of-grid neighbours are empty; the
// border ring is empty too, so this equals the TPU kernel's wrap-around
// views.  Members are inserted into a KMAX-deep ascending register list;
// pids are unique, so its first K entries are exactly the TPU's min-pid
// selection, whatever order the candidates are visited in.
//
// Bound: device memory.  The function reads the pid plane and the
// occupants' x, y (and radius) and writes the K-deep tables and the count:
// 0.096 ms at the 1M-GS shape [4, 960, 2773] with K = 8 on an H100 at
// 3.35 TB/s, three quarters of it the table writes.
//
// One block owns a region of kRankRows x kRankCols full-space tiles (on
// ParLayout 2 x 32 sub-grid cells of each parity, indexed in full space as
// K2's window is) and works in two phases with one barrier:
//
//  1. stage: the threads take the tiles of the window (the region and a
//     one-tile ring, the only halo the rank reads), neighbouring threads
//     on neighbouring storage words (on ParLayout a warp walks one parity
//     class of the window).  A thread loads the pid of every slot of its
//     tiles, then x, y (and radius unless rad == nullptr) of the occupied
//     ones, each as one batch of loads; each plane is read once.  Shared
//     memory keeps the occupants' pid, x, y (radius) and a CAP-bit mask of
//     the occupied slots per tile; out-of-grid tiles keep an empty mask.
//  2. rank and write: a thread per region cell of the launch's parities
//     (p0 .. p0 + np - 1; FlatLayout: every cell) walks its 9 window tiles
//     in the order j, and in each only the occupied slots (the mask's bits),
//     with the same IEEE-rounded clip-and-distance test and insertion as a
//     thread reading its candidates from device memory would run, then
//     writes its K table entries and count, coalesced along tx (a warp
//     holds 32 cells of one row: two warps a region row on FlatLayout).
//
// A thread per cell reading its 9 x cap candidates from device memory
// fetched every slot's pid, x, y and radius for 9 cells, mostly empty ones
// (about 10% of the 1M-GS slots are occupied), and on ParLayout a warp's
// +-1 neighbours lie in the other sub-grids.  The window reads the pid
// plane and the occupants once, and the rank reads only shared memory.
// What bounds it now is the table writes' pace (PERF.md).  The region
// (4 x 64: 8 x 32 took 15% longer on FlatLayout, 26% on ParLayout), the
// register list without radii and the launch bounds (five blocks an SM
// for K <= 8, 48 registers; six, at 40, took 2-3% longer) were chosen by
// timing in the 1M-GS step, as were a thread per cell writing its own
// tables (a thread per table entry from shared memory took 15-26% longer)
// and 256-thread blocks (128 gained 2% flat, lost 4% on ParLayout).
// MASK (the parity layouts, as _rank_kernel_par): border and pad cells
// keep the fill tables and count 0.  rad == nullptr: every occupant has
// the uniform radius r0 (the parity state drops the radius planes).
constexpr int kRankRows = 4;   // full-space tile rows of a region
constexpr int kRankCols = 64;  // full-space tile columns of a region
constexpr int kRankThreads = kRankRows * kRankCols;  // a thread per cell
constexpr int kRankWinX = kRankCols + 2;
constexpr int kRankWinTiles = (kRankRows + 2) * kRankWinX;

// Dynamic shared memory of one block: per window tile and slot pid and
// x, y (float2) (and radius unless uniform), and a mask per window tile.
__host__ __device__ constexpr int rank_window_bytes(int cap, bool uniform) {
  return kRankWinTiles * (cap * (uniform ? 12 : 16) + 4);
}
// Every cap fits a block (204,336 bytes at cap 32 with a radius plane).
static_assert(rank_window_bytes(kMaxCap, false) <= kSmemLimit, "K5 window");

// The region's first full tile (ty0, tx0): (ty0 - o, tx0 - o) is even on
// ParLayout, so region row ry holds parity row (ry & 1).
__device__ __forceinline__ void rank_origin(const FlatLayout&, int* ty0,
                                            int* tx0) {
  *ty0 = kRankRows * (int)blockIdx.y;
  *tx0 = kRankCols * (int)blockIdx.x;
}
__device__ __forceinline__ void rank_origin(const ParLayout& l, int* ty0,
                                            int* tx0) {
  *ty0 = kRankRows * (int)blockIdx.y + l.o;
  *tx0 = kRankCols * (int)blockIdx.x + l.o;
}

// Window tile i of the stage: row-major on FlatLayout; on ParLayout by
// parity class of (wy, wx), each class row-major, so that neighbouring
// threads read neighbouring words of one sub-grid.
__device__ __forceinline__ void rank_window_tile(const FlatLayout&, int i,
                                                 int* wy, int* wx) {
  *wy = i / kRankWinX;
  *wx = i - *wy * kRankWinX;
}
__device__ __forceinline__ void rank_window_tile(const ParLayout&, int i,
                                                 int* wy, int* wx) {
  constexpr int SX = kRankWinX / 2;
  constexpr int A = (kRankRows + 2) / 2 * SX;
  const int q = i / A, r = i - q * A;
  const int cy = r / SX;
  *wy = 2 * cy + (q >> 1);
  *wx = 2 * (r - cy * SX) + (q & 1);
}

// Region cell r of the launch's parities, in region coordinates.
__device__ __forceinline__ void rank_region_tile(const FlatLayout&, int r,
                                                 int* ry, int* rx) {
  *ry = r / kRankCols;
  *rx = r - *ry * kRankCols;
}
__device__ __forceinline__ void rank_region_tile(const ParLayout& l, int r,
                                                 int* ry, int* rx) {
  constexpr int SX = kRankCols / 2;
  constexpr int A = kRankRows / 2 * SX;
  const int pl = r / A, q = r - pl * A, p = l.p0 + pl;
  const int cy = q / SX;
  *ry = 2 * cy + (p >> 1);
  *rx = 2 * (q - cy * SX) + (p & 1);
}

// Region cells ranked by a launch over np parities (FlatLayout: all).
__device__ __forceinline__ int rank_cells(const FlatLayout&, int) {
  return kRankThreads;
}
__device__ __forceinline__ int rank_cells(const ParLayout&, int np) {
  return np * (kRankThreads / 4);
}

// Whether full tile (ty, tx) of a region has a storage cell (ParLayout:
// pad cells too).
__device__ __forceinline__ bool rank_stored(const FlatLayout& l, int ty,
                                            int tx) {
  return ty < l.TY && tx < l.TX;
}
__device__ __forceinline__ bool rank_stored(const ParLayout& l, int ty,
                                            int tx) {
  return ((ty - l.o) >> 1) < l.DY && ((tx - l.o) >> 1) < l.DX;
}

template <int KMAX, class L, bool MASK>
__global__ void __launch_bounds__(kRankThreads, KMAX <= 8 ? 5 : 1) gs_rank_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ rad, const int* __restrict__ pid,
    int* __restrict__ src, int* __restrict__ rpid, float* __restrict__ rrad,
    int* __restrict__ count, int cap, L lay, int np, int K, float t,
    float r0) {
  constexpr int WX = kRankWinX, Wn = kRankWinTiles;
  extern __shared__ __align__(16) unsigned char rank_smem[];
  float2* wxy = reinterpret_cast<float2*>(rank_smem);  // [cap][window]
  int* wpid = reinterpret_cast<int*>(wxy + cap * Wn);  // [cap][window]
  float* wr = reinterpret_cast<float*>(wpid + cap * Wn);
  uint32_t* wmask = reinterpret_cast<uint32_t*>(
      wr + (rad ? cap * Wn : 0));                       // [window]
  const int TY = lay.TY, TX = lay.TX;
  int ty0, tx0;
  rank_origin(lay, &ty0, &tx0);

  // 1. stage the window: a thread takes window tiles tid, tid + T, ...;
  // every pid of its tiles is loaded before any is used, then the
  // occupants' x, y (radius), so a block waits for two loads, not 2 x kPer
  constexpr int kPer = (Wn + kRankThreads - 1) / kRankThreads;
  int sty[kPer], stx[kPer], sw[kPer];  // sw: window index, -1 past it
  bool in[kPer];                       // the tile lies in the grid
  uint32_t occ[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kRankThreads;
    int wy = 0, wx = 0;
    if (i < Wn) rank_window_tile(lay, i, &wy, &wx);
    sty[u] = ty0 - 1 + wy;
    stx[u] = tx0 - 1 + wx;
    sw[u] = i < Wn ? wy * WX + wx : -1;
    in[u] = i < Wn && sty[u] >= 0 && sty[u] < TY && stx[u] >= 0 &&
            stx[u] < TX;
    occ[u] = 0;
  }
  for (int k0 = 0; k0 < cap; k0 += 4) {
    int p[kPer][4];
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        p[u][kk] = in[u] && k0 + kk < cap
                       ? pid[lay.at(k0 + kk, cap, sty[u], stx[u])]
                       : -1;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (in[u] && k0 + kk < cap) {
          wpid[(k0 + kk) * Wn + sw[u]] = p[u][kk];
          occ[u] |= (uint32_t)(p[u][kk] >= 0) << (k0 + kk);
        }
  }
  for (int k0 = 0; k0 < cap; k0 += 4) {
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = k0 + kk;
        if (k < cap && ((occ[u] >> k) & 1u)) {
          const int g = lay.at(k, cap, sty[u], stx[u]);
          wxy[k * Wn + sw[u]] = make_float2(x[g], y[g]);
          if (rad) wr[k * Wn + sw[u]] = rad[g];
        }
      }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (sw[u] >= 0) wmask[sw[u]] = occ[u];  // out of grid: empty
  __syncthreads();

  // 2. rank and write a region cell of the launch's parities per thread
  if ((int)threadIdx.x >= rank_cells(lay, np)) return;
  int ry, rx;
  rank_region_tile(lay, threadIdx.x, &ry, &rx);
  const int ty = ty0 + ry, tx = tx0 + rx;
  if (!rank_stored(lay, ty, tx)) return;
  const bool live = !MASK || (ty >= 1 && ty <= TY - 2 && tx >= 1 &&
                              tx <= TX - 2);
  const float lox = __fmul_rn((float)(tx - 1), t);
  const float loy = __fmul_rn((float)(ty - 1), t);
  const float hix = __fadd_rn(lox, t);
  const float hiy = __fadd_rn(loy, t);

  // the list holds pid and (j << 5 | s); a member's radius is read back
  // from the window when the tables are written (fewer live registers)
  int kp[KMAX], kc[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    kp[q] = kBigPid;
    kc[q] = -1;
  }
  int members = 0;
  const int wc = (ry + 1) * WX + rx + 1;
  for (int j = 0; j < (live ? 9 : 0); ++j) {
    const int w = wc + (j / 3 - 1) * WX + (j % 3 - 1);
    for (uint32_t m = wmask[w]; m; m &= m - 1u) {
      const int s = __ffs((int)m) - 1;
      const int i = s * Wn + w;
      const float2 c = wxy[i];
      const float r = rad ? wr[i] : r0;
      const float px = fminf(fmaxf(c.x, lox), hix);
      const float py = fminf(fmaxf(c.y, loy), hiy);
      const float ddx = __fsub_rn(c.x, px);
      const float ddy = __fsub_rn(c.y, py);
      const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
      if (!(d2 < __fmul_rn(r, r))) continue;
      ++members;
      int cp = wpid[i], cc = (j << 5) | s;
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        if (cp < kp[q]) {
          const int tp = kp[q];
          const int tc = kc[q];
          kp[q] = cp;
          kc[q] = cc;
          cp = tp;
          cc = tc;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    if (q < K) {
      const int o = lay.at(q, K, ty, tx);
      const int c = kc[q], j = c >> 5, s = c & 31;
      src[o] = c >= 0 ? j * cap + s : -1;
      rpid[o] = kp[q];
      rrad[o] = c < 0 ? 0.0f
                      : (rad ? wr[s * Wn + wc + (j / 3 - 1) * WX +
                                  (j % 3 - 1)]
                             : r0);
    }
  }
  count[lay.at(0, 1, ty, tx)] = members;
}

// ---------------------------------------------------------------------------
// K6: one color pass, written back through the source codes.
// ---------------------------------------------------------------------------

// One thread per cell of this color: flat, cells (ty0 + 2*cy, tx0 + 2*cx);
// parity, every cell of the color's sub-grid, which is contiguous, so the
// table and slot accesses of neighbouring threads coalesce.  Valid ranks
// are a prefix (the rank fills them in ascending pid order), so the thread
// loads ranks 0..nv-1 at their current positions, runs the ordered a < b
// sweep on registers, and stores them back to their slots.  Cells of one
// color are particle-disjoint, so no slot is written twice or read by
// another cell of the launch.  The pair math follows _sweep's f32 order:
//   dist = sqrt(dx*dx + dy*dy), hit = rsum^2 > dist^2 && dist > 1e-4,
//   c = ((d / max(dist, 1e-4)) * pen) * stiffness,
//   w_a = r_b / max(rsum, 1e-4), x_a += c*w_a, x_b -= c*w_b.
// gs_color_cell is the per-cell body; gs_color_kernel runs it once per
// thread, gs_colors_mega_kernel for all four colors in one launch.
template <int KMAX, class L>
__device__ __forceinline__ void gs_color_cell(float* __restrict__ x,
                                              float* __restrict__ y,
                                              const int* __restrict__ src,
                                              const float* __restrict__ rrad,
                                              int cap, const L& lay, int i,
                                              int K, float stiffness) {
  int ty, tx;
  lay.cell(i, &ty, &tx);
  if (ty < 0 || ty >= lay.TY || tx < 0 || tx >= lay.TX) return;  // pad

  int slot[KMAX];
  float lx[KMAX], ly[KMAX], lr[KMAX];
  int nv = 0;
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    slot[q] = 0;
    lx[q] = 0.0f;
    ly[q] = 0.0f;
    lr[q] = 0.0f;
    if (q < K && q == nv) {
      const int tq = lay.at(q, K, ty, tx);
      const int code = src[tq];
      if (code >= 0) {
        const int j = code / cap;
        const int s = code - j * cap;
        const int at = lay.at(s, cap, ty + j / 3 - 1, tx + j % 3 - 1);
        slot[q] = at;
        lx[q] = x[at];
        ly[q] = y[at];
        lr[q] = rrad[tq];
        nv = q + 1;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < KMAX - 1; ++a) {
#pragma unroll
    for (int b = a + 1; b < KMAX; ++b) {
      if (b < nv) {
        const float dx = __fsub_rn(lx[a], lx[b]);
        const float dy = __fsub_rn(ly[a], ly[b]);
        const float dist =
            __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        const float rsum = __fadd_rn(lr[a], lr[b]);
        if (__fmul_rn(rsum, rsum) > __fmul_rn(dist, dist) &&
            dist > kGsMinDist) {
          const float safe = fmaxf(dist, kGsMinDist);
          const float pen = __fsub_rn(rsum, dist);
          const float cxp =
              __fmul_rn(__fmul_rn(__fdiv_rn(dx, safe), pen), stiffness);
          const float cyp =
              __fmul_rn(__fmul_rn(__fdiv_rn(dy, safe), pen), stiffness);
          const float rs = fmaxf(rsum, kGsMinDist);
          const float wa = __fdiv_rn(lr[b], rs);
          const float wb = __fdiv_rn(lr[a], rs);
          lx[a] = __fadd_rn(lx[a], __fmul_rn(cxp, wa));
          ly[a] = __fadd_rn(ly[a], __fmul_rn(cyp, wa));
          lx[b] = __fsub_rn(lx[b], __fmul_rn(cxp, wb));
          ly[b] = __fsub_rn(ly[b], __fmul_rn(cyp, wb));
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    if (q < nv) {
      x[slot[q]] = lx[q];
      y[slot[q]] = ly[q];
    }
  }
}

template <int KMAX, class L>
__global__ void gs_color_kernel(float* __restrict__ x, float* __restrict__ y,
                                const int* __restrict__ src,
                                const float* __restrict__ rrad, int cap,
                                L lay, int n, int K, float stiffness) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  gs_color_cell<KMAX>(x, y, src, rrad, cap, lay, i, K, stiffness);
}

// ---------------------------------------------------------------------------
// K6-par's Verlet tail: one substep's Verlet step, in place, after color 4.
// ---------------------------------------------------------------------------

struct VerletConsts {
  float r0;              // uniform radius: the box clamp's lower bound
  float xmax, ymax;      // world_width - r0, world_height - r0 (f32)
  float gx, gy;
  float mouse_strength;
};
constexpr int kVerletNumConsts = 6;

// One thread per slot, any layout (the step is elementwise): occupied
// slots take the step, empty ones keep their values.  The TPU fuses this
// into the color-4 pull-apply, which holds every particle's final
// position; K6 writes in place and a color-4 cell does not own every
// slot, so the step runs as its own launch right after the color-4 pass.
// Op order of ops/tiled.py::integrate (box world, uniform radius), every
// operation IEEE-rounded and uncontracted:
//   v = x - px, d = (mx, my) - x, dist = sqrt(d.d),
//   inv = dist > 1e-6 ? 1 / max(dist, 1e-6) : 0,
//   a = g + (d * inv) * (strength * pressed),
//   x' = clamp((x + v) + a * dt^2, r0, world - r0), px' = x.
// prm = [dt * dt_scale, mouse_x, mouse_y, pressed] in device memory.
__device__ __forceinline__ void gs_verlet_slot(float* __restrict__ x,
                                               float* __restrict__ y,
                                               float* __restrict__ px,
                                               float* __restrict__ py,
                                               const int* __restrict__ pid,
                                               const float* __restrict__ prm,
                                               int i, const VerletConsts& c) {
  if (pid[i] < 0) return;
  const float xi = x[i];
  const float yi = y[i];
  const float vel_x = __fsub_rn(xi, px[i]);
  const float vel_y = __fsub_rn(yi, py[i]);
  const float dt = prm[0], mx = prm[1], my = prm[2], pressed = prm[3];
  const float dxm = __fsub_rn(mx, xi);
  const float dym = __fsub_rn(my, yi);
  const float dist =
      __fsqrt_rn(__fadd_rn(__fmul_rn(dxm, dxm), __fmul_rn(dym, dym)));
  const float inv = dist > 1e-6f ? __fdiv_rn(1.0f, fmaxf(dist, 1e-6f)) : 0.0f;
  const float strength = __fmul_rn(c.mouse_strength, pressed);
  const float ax = __fadd_rn(c.gx, __fmul_rn(__fmul_rn(dxm, inv), strength));
  const float ay = __fadd_rn(c.gy, __fmul_rn(__fmul_rn(dym, inv), strength));
  const float dt2 = __fmul_rn(dt, dt);
  const float nx = __fadd_rn(__fadd_rn(xi, vel_x), __fmul_rn(ax, dt2));
  const float ny = __fadd_rn(__fadd_rn(yi, vel_y), __fmul_rn(ay, dt2));
  x[i] = fminf(fmaxf(nx, c.r0), c.xmax);
  y[i] = fminf(fmaxf(ny, c.r0), c.ymax);
  px[i] = xi;
  py[i] = yi;
}


__global__ void gs_verlet_kernel(float* __restrict__ x, float* __restrict__ y,
                                 float* __restrict__ px,
                                 float* __restrict__ py,
                                 const int* __restrict__ pid,
                                 const float* __restrict__ prm, int n,
                                 VerletConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  gs_verlet_slot(x, y, px, py, pid, prm, i, c);
}

// ---------------------------------------------------------------------------
// colors_mega: the four colors (and the Verlet tail) in one launch.
// ---------------------------------------------------------------------------

// A persistent cooperative kernel on the parity layout: every thread runs
// a grid-stride loop over the color's sub-grid (the cells of one color are
// particle-disjoint, so a phase is race-free, as one K6-par launch is),
// and the grid synchronises between colors and before the tail, which
// runs the same grid-stride loop over every slot.  Each phase runs the
// bodies of K6-par and the Verlet tail on the same cells in the same
// order, so the result equals four K6-par launches plus the tail bit for
// bit.  pars holds the parity of color c in bits 2(c-1), 2(c-1)+1.  Launch
// only with cudaLaunchCooperativeKernel, with no more blocks than can be
// resident at once.
template <int KMAX>
__global__ void gs_colors_mega_kernel(float* __restrict__ x,
                                      float* __restrict__ y,
                                      float* __restrict__ px,
                                      float* __restrict__ py,
                                      const int* __restrict__ pid,
                                      const int* __restrict__ src,
                                      const float* __restrict__ rrad,
                                      const float* __restrict__ prm, int cap,
                                      ParLayout lay, int pars, int K,
                                      float stiffness, int integ,
                                      VerletConsts c) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int cells = lay.DY * lay.DX;
  for (int color = 0; color < 4; ++color) {
    ParLayout cl = lay;
    cl.p0 = (pars >> (2 * color)) & 3;
    for (int i = i0; i < cells; i += stride)
      gs_color_cell<KMAX>(x, y, src, rrad, cap, cl, i, K, stiffness);
    if (color < 3 || integ) grid.sync();
  }
  if (!integ) return;
  const int slots = 4 * cap * cells;
  for (int i = i0; i < slots; i += stride)
    gs_verlet_slot(x, y, px, py, pid, prm, i, c);
}

}  // namespace gpe
