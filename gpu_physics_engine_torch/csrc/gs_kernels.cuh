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

constexpr int kGsMaxK = 16;
constexpr int kBigPid = 0x7FFFFFFF;
constexpr float kGsMinDist = 1e-4f;  // f32 rounding of MIN_DISTANCE

// ---------------------------------------------------------------------------
// K5: per cell, the K smallest member pids in ascending order.
// ---------------------------------------------------------------------------

// One thread per cell.  Candidate (j, s) is a member when its circle
// strictly overlaps the cell's box [lo, lo + t) per axis (the full 2D clip:
// under pull-relocate hysteresis a member may be stored one tile off its
// home, so no per-offset shortcut is valid).  Out-of-grid neighbours are
// empty; the border ring is empty too, so this equals the TPU kernel's
// wrap-around views.  Members are inserted into a KMAX-deep ascending
// register list; pids are unique, so its first K entries are exactly the
// TPU's min-pid selection.
//
// MASK (the parity layouts, as _rank_kernel_par): border and pad cells keep
// the fill tables and count 0.  rad == nullptr: every occupant has the
// uniform radius r0 (the parity state drops the radius planes).
template <int KMAX, class L, bool MASK>
__global__ void gs_rank_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               const float* __restrict__ rad,
                               const int* __restrict__ pid,
                               int* __restrict__ src, int* __restrict__ rpid,
                               float* __restrict__ rrad,
                               int* __restrict__ count, int cap, L lay,
                               int n, int K, float t, float r0) {
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 >= n) return;
  const int TY = lay.TY, TX = lay.TX;
  int ty, tx;
  lay.cell(i0, &ty, &tx);
  const bool live = !MASK || (ty >= 1 && ty <= TY - 2 && tx >= 1 &&
                              tx <= TX - 2);
  const float lox = __fmul_rn((float)(tx - 1), t);
  const float loy = __fmul_rn((float)(ty - 1), t);
  const float hix = __fadd_rn(lox, t);
  const float hiy = __fadd_rn(loy, t);

  int kp[KMAX], kc[KMAX];
  float kr[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    kp[q] = kBigPid;
    kc[q] = -1;
    kr[q] = 0.0f;
  }
  int members = 0;
  for (int j = 0; j < (live ? 9 : 0); ++j) {
    const int nty = ty + j / 3 - 1;
    const int ntx = tx + j % 3 - 1;
    if (nty < 0 || nty >= TY || ntx < 0 || ntx >= TX) continue;
    for (int s = 0; s < cap; ++s) {
      const int i = lay.at(s, cap, nty, ntx);
      const int p = pid[i];
      if (p < 0) continue;
      const float cx = x[i];
      const float cy = y[i];
      const float r = rad ? rad[i] : r0;
      const float px = fminf(fmaxf(cx, lox), hix);
      const float py = fminf(fmaxf(cy, loy), hiy);
      const float ddx = __fsub_rn(cx, px);
      const float ddy = __fsub_rn(cy, py);
      const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
      if (!(d2 < __fmul_rn(r, r))) continue;
      ++members;
      int cp = p, cc = j * cap + s;
      float cr = r;
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        if (cp < kp[q]) {
          const int tp = kp[q];
          const int tc = kc[q];
          const float tr = kr[q];
          kp[q] = cp;
          kc[q] = cc;
          kr[q] = cr;
          cp = tp;
          cc = tc;
          cr = tr;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    if (q < K) {
      const int o = lay.at(q, K, ty, tx);
      src[o] = kc[q];
      rpid[o] = kp[q];
      rrad[o] = kr[q];
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
template <int KMAX, class L>
__global__ void gs_color_kernel(float* __restrict__ x, float* __restrict__ y,
                                const int* __restrict__ src,
                                const float* __restrict__ rrad, int cap,
                                L lay, int n, int K, float stiffness) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
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
__global__ void gs_verlet_kernel(float* __restrict__ x, float* __restrict__ y,
                                 float* __restrict__ px,
                                 float* __restrict__ py,
                                 const int* __restrict__ pid,
                                 const float* __restrict__ prm, int n,
                                 VerletConsts c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || pid[i] < 0) return;
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

}  // namespace gpe
