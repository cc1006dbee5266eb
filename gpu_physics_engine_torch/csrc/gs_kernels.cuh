// Hand kernels of the reference-exact Gauss-Seidel path for Hopper (sm_90a).
//
// K5  gs_rank_kernel   replaces gpu_physics_engine_tpu/ops/gs_pallas.py::
//     _rank_full (:467; kernels _rank_kernel :219, _rank_kernel_net :362);
//     on ParLayout it also replaces ops/gs_parity.py::rank_parity (:275;
//     _rank_kernel_par :160, _rank_kernel_par_all :206), "K5-par".
// K6  gs_colors_window_kernel replaces gpu_physics_engine_tpu/ops/
//     gs_pallas.py::gs_solve_pallas_flat (:543; _solve_kernel :390 with
//     _sweep :77, and _apply_kernel :431), one launch a solve; on ParLayout
//     it replaces the color passes of gs_solve_pallas_dec (:783),
//     gs_solve_pallas_mx (:1045) and ops/gs_parity.py::solve_parity (:433;
//     _solve_dec_kernel, _apply_dec_kernel), "K6-dec", "K6-mx", "K6-par",
//     with the Verlet half of _apply_integrate_dec_kernel (:353) fused as
//     K6-par's tail, and ops/gs_mega.py::colors_mega (:503, kernel
//     _mega_kernel :136): the four colors and the tail in one launch.
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

#include <stdint.h>

#include "layout.cuh"

namespace gpe {

constexpr int kGsRegK = 16;  // K up to this: the K ranks in registers
// Up to cap 64 and K 16 the rank and the solve take the window kernels
// below; past either, the packed rank and the ranked-slot solve
// (csrc/gs_simple.cuh).
__host__ __device__ constexpr bool gs_windowed(int cap, int K) {
  return cap <= kWideCap && K <= kGsRegK;
}
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
// One block owns a region of kRankRows x rank_cols full-space tiles (on
// ParLayout 2 x rank_cols/2 sub-grid cells of each parity, indexed in
// full space as K2's window is) and works in two phases with one barrier:
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
//
// The mask word M is unsigned for caps up to 32, with a region of 4 x 64
// tiles, and Mask64 for caps 33-64, with a region of 4 x 32 (the 4 x 64
// window would need 408,672 bytes at cap 64 with a radius plane; 4 x 32
// needs 210,528).  A thread per region cell in either class.
constexpr int kRankRows = 4;  // full-space tile rows of a region
__host__ __device__ constexpr int rank_cols(bool wide) {  // full-space cols
  return wide ? 32 : 64;
}
__host__ __device__ constexpr int rank_threads(bool wide) {
  return kRankRows * rank_cols(wide);  // a thread per cell
}
__host__ __device__ constexpr int rank_win_x(bool wide) {
  return rank_cols(wide) + 2;
}
__host__ __device__ constexpr int rank_win_tiles(bool wide) {
  return (kRankRows + 2) * rank_win_x(wide);
}

// Dynamic shared memory of one block: per window tile and slot pid and
// x, y (float2) (and radius unless uniform), and a mask per window tile.
__host__ __device__ constexpr int rank_window_bytes(int cap, bool uniform) {
  return rank_win_tiles(cap > kNarrowCap) *
         (cap * (uniform ? 12 : 16) + mask_bytes(cap));
}
// Every cap fits a block (204,336 bytes at cap 32 and 210,528 at cap 64,
// with a radius plane).
static_assert(rank_window_bytes(kNarrowCap, false) <= kSmemLimit, "K5");
static_assert(rank_window_bytes(kWideCap, false) <= kSmemLimit, "K5 wide");
static_assert(rank_win_tiles(true) % 2 == 0, "the 64-bit masks' alignment");

// The region's first full tile (ty0, tx0): (ty0 - o, tx0 - o) is even on
// ParLayout, so region row ry holds parity row (ry & 1).
template <bool W>
__device__ __forceinline__ void rank_origin(const FlatLayout&, int* ty0,
                                            int* tx0) {
  *ty0 = kRankRows * (int)blockIdx.y;
  *tx0 = rank_cols(W) * (int)blockIdx.x;
}
template <bool W>
__device__ __forceinline__ void rank_origin(const ParLayout& l, int* ty0,
                                            int* tx0) {
  *ty0 = kRankRows * (int)blockIdx.y + l.o;
  *tx0 = rank_cols(W) * (int)blockIdx.x + l.o;
}

// Window tile i of the stage: row-major on FlatLayout; on ParLayout by
// parity class of (wy, wx), each class row-major, so that neighbouring
// threads read neighbouring words of one sub-grid.
template <bool W>
__device__ __forceinline__ void rank_window_tile(const FlatLayout&, int i,
                                                 int* wy, int* wx) {
  *wy = i / rank_win_x(W);
  *wx = i - *wy * rank_win_x(W);
}
template <bool W>
__device__ __forceinline__ void rank_window_tile(const ParLayout&, int i,
                                                 int* wy, int* wx) {
  constexpr int SX = rank_win_x(W) / 2;
  constexpr int A = (kRankRows + 2) / 2 * SX;
  const int q = i / A, r = i - q * A;
  const int cy = r / SX;
  *wy = 2 * cy + (q >> 1);
  *wx = 2 * (r - cy * SX) + (q & 1);
}

// Region cell r of the launch's parities, in region coordinates.
template <bool W>
__device__ __forceinline__ void rank_region_tile(const FlatLayout&, int r,
                                                 int* ry, int* rx) {
  *ry = r / rank_cols(W);
  *rx = r - *ry * rank_cols(W);
}
template <bool W>
__device__ __forceinline__ void rank_region_tile(const ParLayout& l, int r,
                                                 int* ry, int* rx) {
  constexpr int SX = rank_cols(W) / 2;
  constexpr int A = kRankRows / 2 * SX;
  const int pl = r / A, q = r - pl * A, p = l.p0 + pl;
  const int cy = q / SX;
  *ry = 2 * cy + (p >> 1);
  *rx = 2 * (q - cy * SX) + (p & 1);
}

// Region cells ranked by a launch over np parities (FlatLayout: all).
template <bool W>
__device__ __forceinline__ int rank_cells(const FlatLayout&, int) {
  return rank_threads(W);
}
template <bool W>
__device__ __forceinline__ int rank_cells(const ParLayout&, int np) {
  return np * (rank_threads(W) / 4);
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

template <int KMAX, class M, class L, bool MASK>
__global__ void __launch_bounds__(rank_threads(sizeof(M) == 8),
                                  sizeof(M) == 8 ? 1 : (KMAX <= 8 ? 5 : 1))
    gs_rank_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ rad, const int* __restrict__ pid,
    int* __restrict__ src, int* __restrict__ rpid, float* __restrict__ rrad,
    int* __restrict__ count, int cap, L lay, int np, int K, float t,
    float r0) {
  constexpr bool kWide = sizeof(M) == 8;
  constexpr int WX = rank_win_x(kWide), Wn = rank_win_tiles(kWide);
  constexpr int kT = rank_threads(kWide), kSB = slot_bits<M>();
  extern __shared__ __align__(16) unsigned char rank_smem[];
  float2* wxy = reinterpret_cast<float2*>(rank_smem);  // [cap][window]
  int* wpid = reinterpret_cast<int*>(wxy + cap * Wn);  // [cap][window]
  float* wr = reinterpret_cast<float*>(wpid + cap * Wn);
  M* wmask = reinterpret_cast<M*>(wr + (rad ? cap * Wn : 0));  // [window]
  const int TY = lay.TY, TX = lay.TX;
  int ty0, tx0;
  rank_origin<kWide>(lay, &ty0, &tx0);

  // 1. stage the window: a thread takes window tiles tid, tid + T, ...;
  // every pid of its tiles is loaded before any is used, then the
  // occupants' x, y (radius), so a block waits for two loads, not 2 x kPer
  constexpr int kPer = (Wn + kT - 1) / kT;
  int sty[kPer], stx[kPer], sw[kPer];  // sw: window index, -1 past it
  bool in[kPer];                       // the tile lies in the grid
  M occ[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kT;
    int wy = 0, wx = 0;
    if (i < Wn) rank_window_tile<kWide>(lay, i, &wy, &wx);
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
          occ[u] |= (M)(p[u][kk] >= 0) << (k0 + kk);
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
  if ((int)threadIdx.x >= rank_cells<kWide>(lay, np)) return;
  int ry, rx;
  rank_region_tile<kWide>(lay, threadIdx.x, &ry, &rx);
  const int ty = ty0 + ry, tx = tx0 + rx;
  if (!rank_stored(lay, ty, tx)) return;
  const bool live = !MASK || (ty >= 1 && ty <= TY - 2 && tx >= 1 &&
                              tx <= TX - 2);
  const float lox = __fmul_rn((float)(tx - 1), t);
  const float loy = __fmul_rn((float)(ty - 1), t);
  const float hix = __fadd_rn(lox, t);
  const float hiy = __fadd_rn(loy, t);

  // the list holds pid and (j << kSB | s); a member's radius is read back
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
    for (M m = wmask[w]; m; m &= m - 1u) {
      const int s = mask_low(m);
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
      int cp = wpid[i], cc = (j << kSB) | s;
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
      const int c = kc[q], j = c >> kSB, s = c & ((1 << kSB) - 1);
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
// K6 (flat, mx, dec, par) and colors_mega: the color solve on a window.
// ---------------------------------------------------------------------------

// The per-color pair math follows _sweep's f32 order:
//   dist = sqrt(dx*dx + dy*dy), hit = rsum^2 > dist^2 && dist > 1e-4,
//   c = ((d / max(dist, 1e-4)) * pen) * stiffness,
//   w_a = r_b / max(rsum, 1e-4), x_a += c*w_a, x_b -= c*w_b.
// Valid ranks are a prefix (the rank fills them in ascending pid order).
//
// gs_colors_window_kernel computes colors 1..c1 (a whole solve: 1..4) of
// one frame, then, with integ, the substep's Verlet step, and writes x and
// y to new planes.  A block owns a region of RY x RX full-space tiles (on
// ParLayout RY/2 x RX/2 cells of each sub-grid, indexed in full space as
// K5's window is) and works on a window of the region and a halo of H
// tiles on every side, in three phases:
//
//  1. stage: x and y of every slot of every stored window tile, coalesced
//     along tx (on ParLayout a warp walks one parity class), into shared
//     memory.  Tiles outside the grid (ParLayout: pad cells stay stored)
//     are skipped; no cell reaches them.
//  2. colors: for c = 1..c1 a thread per cell of color c runs one cell:
//     it loads the cell's K source codes from device memory as one batch
//     (no chain through "rank q-1 was valid"); a cell with fewer than two
//     valid ranks is done.  Otherwise it loads the valid ranks' radii (or
//     takes r0 when rrad == nullptr: the uniform-radius tables hold r0 for
//     every valid rank), decodes each code to a (window tile, slot),
//     sweeps in registers with the __f*_rn intrinsics (the warp leaves the
//     unrolled pair loop past its largest member count) and writes back to
//     shared memory.  A barrier separates the colors.  Cells of one color
//     are particle-disjoint (cell edge >= 2 r_max, and the frozen tables
//     name each slot from at most one cell of a color), so no shared slot
//     has two writers within a color.
//  3. write: a thread per (slot, region tile) writes every slot of the
//     region's stored tiles to ox, oy, coalesced; empty slots (and pad
//     cells) keep their input values.  With integ, an occupied slot
//     (pid >= 0) first takes the Verlet step (gs_verlet_slot), reading and
//     writing px, py in place: only the region's owner touches them.
//
// The halo.  A color-c cell reads and writes only slots stored within one
// tile of it (the source codes name the 3 x 3 tiles around the cell), so
// after color c a slot's value depends on cells within one tile of its
// tile, and those on slots within one tile of them: the correct part of
// the window shrinks by 2 tiles on every side that faces unstaged tiles,
// per color.  Inductively, if every tile at least 2k tiles inside the
// window's inner edges is correct before the k-th color (k = 0 .. n-1 for
// n = c1 colors; true at k = 0), the block sweeps the cells at
// least 2k + 1 inside: their 3 x 3 lies in the correct part (and in the
// window), and every cell within one tile of a tile 2k + 2 inside is among
// them, so tiles 2(k + 1) inside are correct after it.  After n colors the
// region is correct when H = 2n: 8 tiles for a solve.  At the grid's edges
// the window is clipped (tiles outside [0, TY) x [0, TX) do not exist), so
// nothing shrinks there.  The halo's cells are computed again by every
// block that stages them: the cost of needing no grid synchronisation.
// x and y are written out of place because a neighbour's halo reads the
// region's input values: in place, a block could read a neighbour's final
// values.  Regions are disjoint: no slot is written twice, no atomics.
//
// Bound: device memory.  The function reads each valid rank's code (and
// radius), the occupied slots' x, y (and px, py, the pid plane with the
// tail) and writes them.  What sets the kernel's time is elsewhere
// (PERF.md, utils/kernel_study.py --k6): the sweeps, which the halo's
// cells make 1.5-1.6x as many as the grid's at the 1M-GS and 4M-GS caps,
// and the out-of-place copy of every empty slot.  The regions by cap class
// (GPE_GSW_RY<c>, GPE_GSW_RX<c>: near-square, the most tiles that leave
// two blocks an SM), the block size (kGsWinThreads) and the launch bounds
// (GPE_GSW_MINB) were chosen by timing in the 1M-GS and 4M-GS steps; a
// study build may override them.
#ifndef GPE_GSW_THREADS
#define GPE_GSW_THREADS 512
#endif
#ifndef GPE_GSW_MINB  // resident blocks an SM the launch bounds ask, K <= 8
#define GPE_GSW_MINB 2
#endif
// RY, RX of the regions of the classes cap <= 4, 8, 16, 32 (caps 33-64:
// 4 x 6, fixed in gs_window_side)
#ifndef GPE_GSW_RY0
#define GPE_GSW_RY0 32
#endif
#ifndef GPE_GSW_RX0
#define GPE_GSW_RX0 48
#endif
#ifndef GPE_GSW_RY1
#define GPE_GSW_RY1 32
#endif
#ifndef GPE_GSW_RX1
#define GPE_GSW_RX1 32
#endif
#ifndef GPE_GSW_RY2
#define GPE_GSW_RY2 8
#endif
#ifndef GPE_GSW_RX2
#define GPE_GSW_RX2 32
#endif
#ifndef GPE_GSW_RY3
#define GPE_GSW_RY3 8
#endif
#ifndef GPE_GSW_RX3
#define GPE_GSW_RX3 16
#endif
constexpr int kGsWinThreads = GPE_GSW_THREADS;
constexpr int kGsWinMaxColors = 4;
constexpr int kGsWinMaxHalo = 2 * kGsWinMaxColors;
// Region class of a cap, and its region's sides (device code calls them
// with a constant class only): classes 0-4, caps up to 64, each a whole
// solve a launch.
constexpr int kGsWinClasses = 5;
constexpr int gs_window_class(int cap) {
  return cap <= 4 ? 0 : cap <= 8 ? 1 : cap <= 16 ? 2 : cap <= 32 ? 3 : 4;
}
__host__ __device__ constexpr int gs_window_side(int cls, int axis) {
  constexpr int sides[kGsWinClasses][2] = {{GPE_GSW_RY0, GPE_GSW_RX0},
                                           {GPE_GSW_RY1, GPE_GSW_RX1},
                                           {GPE_GSW_RY2, GPE_GSW_RX2},
                                           {GPE_GSW_RY3, GPE_GSW_RX3},
                                           {4, 6}};  // one block an SM
  return sides[cls][axis];
}
__host__ __device__ constexpr int gs_window_ry(int cls) {
  return gs_window_side(cls, 0);
}
__host__ __device__ constexpr int gs_window_rx(int cls) {
  return gs_window_side(cls, 1);
}

// Dynamic shared memory of one block: x, y (float2) of every slot of the
// window, the region and a halo of 2 tiles per color of the launch.
constexpr int gs_window_bytes(int cap, int colors) {
  return (gs_window_ry(gs_window_class(cap)) + 4 * colors) *
         (gs_window_rx(gs_window_class(cap)) + 4 * colors) * cap * 8;
}
// Every class fits a block at its largest cap and a whole solve; regions
// have even sides, so a ParLayout window keeps each sub-grid's parity.
static_assert(gs_window_bytes(4, kGsWinMaxColors) <= kSmemLimit, "cap 4");
static_assert(gs_window_bytes(8, kGsWinMaxColors) <= kSmemLimit, "cap 8");
static_assert(gs_window_bytes(16, kGsWinMaxColors) <= kSmemLimit, "cap 16");
static_assert(gs_window_bytes(32, kGsWinMaxColors) <= kSmemLimit, "cap 32");
static_assert(gs_window_bytes(64, kGsWinMaxColors) <= kSmemLimit, "cap 64");
constexpr bool gs_window_even(int cls) {
  return cls >= kGsWinClasses ||
         (gs_window_ry(cls) % 2 == 0 && gs_window_rx(cls) % 2 == 0 &&
          gs_window_even(cls + 1));
}
static_assert(gs_window_even(0), "regions need even sides");

struct VerletConsts {
  float r0;              // uniform radius: the box clamp's lower bound
  float xmax, ymax;      // world_width - r0, world_height - r0 (f32)
  float gx, gy;
  float mouse_strength;
};
constexpr int kVerletNumConsts = 6;

struct GsWindowArgs {
  const float* x;  // inputs: read only
  const float* y;
  float* px;  // the tail's, in place (integ only)
  float* py;
  const int* pid;    // integ only
  const float* prm;  // integ only: [dt, mouse_x, mouse_y, pressed]
  const int* src;
  const float* rrad;  // nullptr: every valid rank has radius r0
  float* ox;          // outputs: every stored slot
  float* oy;
  int cap, K, c1, integ;
  float r0, stiffness;
  VerletConsts vc;
};

// Whether full tile (ty, tx) has a storage cell (ParLayout: pad cells too).
__device__ __forceinline__ bool gs_stored(const FlatLayout& l, int ty,
                                          int tx) {
  return ty >= 0 && ty < l.TY && tx >= 0 && tx < l.TX;
}
__device__ __forceinline__ bool gs_stored(const ParLayout& l, int ty,
                                          int tx) {
  const int q = ty - l.o, r = tx - l.o;
  return q >= 0 && r >= 0 && (q >> 1) < l.DY && (r >> 1) < l.DX;
}

// Tile i of a WY x WX block of full-space tiles whose corner has even
// (ty - o, tx - o): row-major on FlatLayout; on ParLayout by parity class,
// each class row-major, so that neighbouring threads touch neighbouring
// words of one sub-grid.
__device__ __forceinline__ void gs_block_tile(const FlatLayout&, int i,
                                              int WY, int WX, int* wy,
                                              int* wx) {
  (void)WY;
  *wy = i / WX;
  *wx = i - *wy * WX;
}
__device__ __forceinline__ void gs_block_tile(const ParLayout&, int i,
                                              int WY, int WX, int* wy,
                                              int* wx) {
  const int SX = WX >> 1, A = (WY >> 1) * SX;
  const int q = i / A, r = i - q * A;
  const int cy = r / SX;
  *wy = 2 * cy + (q >> 1);
  *wx = 2 * (r - cy * SX) + (q & 1);
}

// The region's first full tile: (ty0 - o, tx0 - o) is even on ParLayout.
template <int RY, int RX>
__device__ __forceinline__ void gs_region_origin(const FlatLayout&, int* ty0,
                                                 int* tx0) {
  *ty0 = RY * (int)blockIdx.y;
  *tx0 = RX * (int)blockIdx.x;
}
template <int RY, int RX>
__device__ __forceinline__ void gs_region_origin(const ParLayout& l, int* ty0,
                                                 int* tx0) {
  *ty0 = RY * (int)blockIdx.y + l.o;
  *tx0 = RX * (int)blockIdx.x + l.o;
}

// One cell (ty, tx) of a color on the window: w holds x, y of slot s of
// window tile t at w[s * WN + t], window tile (0, 0) being full tile
// (wy0, wx0).
// The cells of color c = k + 1 that the window sweeps: those at least
// 2k + 1 tiles inside its inner edges, from (fy, fx), ny x nx.
struct GsColorCells {
  int fy, fx, ny, nx;
};
__device__ __forceinline__ GsColorCells gs_color_cells(int k, int wy0,
                                                       int wx0, int WY,
                                                       int WX, int TY,
                                                       int TX) {
  const int c = k + 1, m = 2 * k + 1;
  // color c = 1 + ((tx-1)&1) + 2*((ty-1)&1): its rows' (columns') parity
  // in full space
  const int pa = ((c - 1) >> 1) ^ 1, pb = ((c - 1) & 1) ^ 1;
  const int ylo = wy0 > 0 ? wy0 + m : 0;
  const int yhi = wy0 + WY < TY ? wy0 + WY - m : TY;
  const int xlo = wx0 > 0 ? wx0 + m : 0;
  const int xhi = wx0 + WX < TX ? wx0 + WX - m : TX;
  GsColorCells g;
  g.fy = ylo + ((pa - ylo) & 1);
  g.fx = xlo + ((pb - xlo) & 1);
  g.ny = yhi > g.fy ? (yhi - g.fy + 1) >> 1 : 0;
  g.nx = xhi > g.fx ? (xhi - g.fx + 1) >> 1 : 0;
  return g;
}

template <int KMAX, class L>
__device__ __forceinline__ void gs_color_cell(float2* __restrict__ w, int WN,
                                              int WX, int wy0, int wx0,
                                              const GsWindowArgs& a,
                                              const L& lay, int ty,
                                              int tx) {
  const int K = a.K, cap = a.cap;
  int code[KMAX];  // one batch of loads, not a chain through rank q - 1
#pragma unroll
  for (int q = 0; q < KMAX; ++q)
    code[q] = q < K ? __ldg(a.src + lay.at(q, K, ty, tx)) : -1;
  int nv = 0;
#pragma unroll
  for (int q = 0; q < KMAX; ++q)
    if (q == nv && code[q] >= 0) nv = q + 1;
  if (nv < 2) return;  // no pair: the members stay where they are

  int wi[KMAX];
  float lx[KMAX], ly[KMAX], lr[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    wi[q] = 0;
    lx[q] = 0.0f;
    ly[q] = 0.0f;
    lr[q] = 0.0f;
    if (q < nv) {
      lr[q] = a.rrad ? __ldg(a.rrad + lay.at(q, K, ty, tx)) : a.r0;
      const int j = code[q] / cap;
      const int s = code[q] - j * cap;
      wi[q] = s * WN + (ty + j / 3 - 1 - wy0) * WX + (tx + j % 3 - 1 - wx0);
      const float2 v = w[wi[q]];
      lx[q] = v.x;
      ly[q] = v.y;
    }
  }

  // the warp's largest nv: the pairs past it are skipped by a branch the
  // whole warp takes (a lane still sweeps only its own b < nv)
  const int nvw = __reduce_max_sync(__activemask(), nv);
#pragma unroll
  for (int p = 0; p < KMAX - 1; ++p) {
    if (p + 1 >= nvw) break;
#pragma unroll
    for (int b = p + 1; b < KMAX; ++b) {
      if (b >= nvw) break;
      if (b < nv) {
        const float dx = __fsub_rn(lx[p], lx[b]);
        const float dy = __fsub_rn(ly[p], ly[b]);
        const float dist =
            __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        const float rsum = __fadd_rn(lr[p], lr[b]);
        if (__fmul_rn(rsum, rsum) > __fmul_rn(dist, dist) &&
            dist > kGsMinDist) {
          const float safe = fmaxf(dist, kGsMinDist);
          const float pen = __fsub_rn(rsum, dist);
          const float cxp =
              __fmul_rn(__fmul_rn(__fdiv_rn(dx, safe), pen), a.stiffness);
          const float cyp =
              __fmul_rn(__fmul_rn(__fdiv_rn(dy, safe), pen), a.stiffness);
          const float rs = fmaxf(rsum, kGsMinDist);
          const float wa = __fdiv_rn(lr[b], rs);
          const float wb = __fdiv_rn(lr[p], rs);
          lx[p] = __fadd_rn(lx[p], __fmul_rn(cxp, wa));
          ly[p] = __fadd_rn(ly[p], __fmul_rn(cyp, wa));
          lx[b] = __fsub_rn(lx[b], __fmul_rn(cxp, wb));
          ly[b] = __fsub_rn(ly[b], __fmul_rn(cyp, wb));
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < KMAX; ++q)
    if (q < nv) w[wi[q]] = make_float2(lx[q], ly[q]);
}

// One substep's Verlet step of an occupied slot at (x, y) with previous
// position (px, py); returns the new position.  Op order of
// ops/tiled.py::integrate (box world, uniform radius), every operation
// IEEE-rounded and uncontracted:
//   v = x - px, d = (mx, my) - x, dist = sqrt(d.d),
//   inv = dist > 1e-6 ? 1 / max(dist, 1e-6) : 0,
//   a = g + (d * inv) * (strength * pressed),
//   x' = clamp((x + v) + a * dt^2, r0, world - r0), px' = x.
// prm = [dt * dt_scale, mouse_x, mouse_y, pressed] in device memory.  The
// TPU fuses this into the color-4 pull-apply (ops/gs_parity.py::
// _apply_integrate_dec_kernel :353); here it runs on the region's slots
// after the last color.
__device__ __forceinline__ float2 gs_verlet_slot(float xi, float yi,
                                                 float pxi, float pyi,
                                                 const float* __restrict__ prm,
                                                 const VerletConsts& c) {
  const float vel_x = __fsub_rn(xi, pxi);
  const float vel_y = __fsub_rn(yi, pyi);
  const float dt = __ldg(prm), mx = __ldg(prm + 1), my = __ldg(prm + 2);
  const float pressed = __ldg(prm + 3);
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
  return make_float2(fminf(fmaxf(nx, c.r0), c.xmax),
                     fminf(fmaxf(ny, c.r0), c.ymax));
}

template <int KMAX, int CLS, class L>
__global__ void __launch_bounds__(kGsWinThreads, KMAX <= 8 ? GPE_GSW_MINB : 1)
    gs_colors_window_kernel(GsWindowArgs a, L lay) {
  constexpr int RY = gs_window_ry(CLS), RX = gs_window_rx(CLS);
  constexpr int T = kGsWinThreads;
  constexpr int kPer = ((RY + 2 * kGsWinMaxHalo) * (RX + 2 * kGsWinMaxHalo) +
                        T - 1) / T;  // window tiles a thread stages, at most
  extern __shared__ __align__(16) unsigned char gs_window_smem[];
  float2* w = reinterpret_cast<float2*>(gs_window_smem);  // [cap][window]
  const int cap = a.cap;
  const int nc = a.c1;  // colors of this launch, 0 .. 4
  const int H = 2 * nc;
  const int WY = RY + 2 * H, WX = RX + 2 * H, WN = WY * WX;
  int ty0, tx0;
  gs_region_origin<RY, RX>(lay, &ty0, &tx0);
  const int wy0 = ty0 - H, wx0 = tx0 - H;  // the window's full tile (0, 0)

  // 1. stage: a thread takes window tiles tid, tid + T, ...; the loads of
  // four slots of all its tiles are issued before any is stored
  int sat[kPer], sw[kPer];  // slot 0's storage offset (-1: none), window
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * T;
    sat[u] = -1;
    sw[u] = 0;
    if (i < WN) {
      int wy, wx;
      gs_block_tile(lay, i, WY, WX, &wy, &wx);
      if (gs_stored(lay, wy0 + wy, wx0 + wx)) {
        sat[u] = lay.at(0, cap, wy0 + wy, wx0 + wx);
        sw[u] = wy * WX + wx;
      }
    }
  }
  const int plane = lay.plane();  // storage offset from slot s to s + 1
  for (int k0 = 0; k0 < cap; k0 += 4) {
    float2 v[kPer][4];
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (sat[u] >= 0 && k0 + kk < cap) {
          const int g = sat[u] + (k0 + kk) * plane;
          v[u][kk] = make_float2(__ldg(a.x + g), __ldg(a.y + g));
        }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (sat[u] >= 0 && k0 + kk < cap) w[(k0 + kk) * WN + sw[u]] = v[u][kk];
  }
  __syncthreads();

  // 2. colors 1 .. c1: the k-th sweeps the cells of its color at least
  // 2k + 1 tiles inside the window's inner edges
  const int TY = lay.TY, TX = lay.TX;
  for (int k = 0; k < nc; ++k) {
    const GsColorCells g =
        gs_color_cells(k, wy0, wx0, WY, WX, TY, TX);
    for (int i = threadIdx.x; i < g.ny * g.nx; i += T) {
      const int cy = i / g.nx;
      gs_color_cell<KMAX>(w, WN, WX, wy0, wx0, a, lay, g.fy + 2 * cy,
                          g.fx + 2 * (i - cy * g.nx));
    }
    __syncthreads();
  }

  // 3. write the region's stored tiles (the tail first where asked): a
  // thread per (slot, region tile), four a round; pid, px and py of all
  // four are loaded as one batch, px and py whatever pid says (a thread
  // per tile walking its slots, px and py after pid, took several times
  // as long: PERF.md)
  constexpr int RN = RY * RX, U = 4;
  for (int e0 = threadIdx.x; e0 < cap * RN; e0 += T * U) {
    int g[U], t[U], p[U];
    float2 q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * T;
      g[u] = -1;
      t[u] = 0;
      if (e < cap * RN) {
        const int s = e / RN, i = e - s * RN;
        int ry, rx;
        gs_block_tile(lay, i, RY, RX, &ry, &rx);
        if (gs_stored(lay, ty0 + ry, tx0 + rx)) {
          g[u] = lay.at(s, cap, ty0 + ry, tx0 + rx);
          t[u] = s * WN + (ry + H) * WX + rx + H;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[u] = -1;
      if (a.integ && g[u] >= 0) {
        p[u] = __ldg(a.pid + g[u]);
        q[u] = make_float2(a.px[g[u]], a.py[g[u]]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g[u] < 0) continue;
      float2 v = w[t[u]];
      if (p[u] >= 0) {
        a.px[g[u]] = v.x;
        a.py[g[u]] = v.y;
        v = gs_verlet_slot(v.x, v.y, q[u].x, q[u].y, a.prm, a.vc);
      }
      a.ox[g[u]] = v.x;
      a.oy[g[u]] = v.y;
    }
  }
}

// ---------------------------------------------------------------------------
// Past cap 64 or K 16: the launchers of csrc/gs_simple.cuh's kernels
// (gs_simple.cu), called by gs_kernels.cu's entry points.  Each returns
// cudaGetLastError() or the first error.
// ---------------------------------------------------------------------------
// K5 on the packed kernel over the launch's cells, with a buffer of
// `entries` occupants (0: the default plan's, or fewer: a study's plan).
int launch_rank_pack(const float* x, const float* y, const float* rad,
                     const int* pid, int* src, int* rpid, float* rrad,
                     int* count, int cap, const FlatLayout& lay, int np,
                     int K, float t, float r0, int entries, cudaStream_t s);
int launch_rank_pack(const float* x, const float* y, const float* rad,
                     const int* pid, int* src, int* rpid, float* rrad,
                     int* count, int cap, const ParLayout& lay, int np,
                     int K, float t, float r0, int entries, cudaStream_t s);
// K6: the copy, colors 1..a.c1 and with a.integ the tail; count may be
// null.
int launch_colors_ranked(const GsWindowArgs& a, const int* count,
                         const FlatLayout& lay, cudaStream_t s);
int launch_colors_ranked(const GsWindowArgs& a, const int* count,
                         const ParLayout& lay, cudaStream_t s);

}  // namespace gpe
