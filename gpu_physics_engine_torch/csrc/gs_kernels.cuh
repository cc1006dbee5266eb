// Hand kernels of the reference-exact Gauss-Seidel path for Hopper (sm_90a).
//
// K5  gs_rank_kernel   replaces gpu_physics_engine_tpu/ops/gs_pallas.py::
//     _rank_full (:467; kernels _rank_kernel :219, _rank_kernel_net :362).
// K6  gs_color_kernel  replaces gpu_physics_engine_tpu/ops/gs_pallas.py::
//     gs_solve_pallas_flat (:543; _solve_kernel :390 with _sweep :77, and
//     _apply_kernel :431).
//
// Storage is slot-major [CAP, TY, TX] (csrc/tiled_kernels.cuh); the rank
// tables are rank-major [K, TY, TX].  Tile (ty, tx) is reference cell
// (ty-1, tx-1).  Source code j*cap + s names slot s of the tile at offset
// (j/3 - 1, j%3 - 1) from the cell.
//
// Exactness is the contract: the results must equal the scalar model's
// bit for bit.  Every product, sum, quotient and square root goes through
// the __f*_rn intrinsics, which are never contracted into an FMA and are
// IEEE-rounded whatever the build flags (which also say -fmad=false and
// never --use_fast_math).
#pragma once

#include <stdint.h>

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
template <int KMAX>
__global__ void gs_rank_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               const float* __restrict__ rad,
                               const int* __restrict__ pid,
                               int* __restrict__ src, int* __restrict__ rpid,
                               float* __restrict__ rrad,
                               int* __restrict__ count, int cap, int TY,
                               int TX, int K, float t) {
  const int ntiles = TY * TX;
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= ntiles) return;
  const int ty = tile / TX;
  const int tx = tile - ty * TX;
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
  for (int j = 0; j < 9; ++j) {
    const int nty = ty + j / 3 - 1;
    const int ntx = tx + j % 3 - 1;
    if (nty < 0 || nty >= TY || ntx < 0 || ntx >= TX) continue;
    const int ntile = nty * TX + ntx;
    for (int s = 0; s < cap; ++s) {
      const int i = s * ntiles + ntile;
      const int p = pid[i];
      if (p < 0) continue;
      const float cx = x[i];
      const float cy = y[i];
      const float r = rad[i];
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
      src[q * ntiles + tile] = kc[q];
      rpid[q * ntiles + tile] = kp[q];
      rrad[q * ntiles + tile] = kr[q];
    }
  }
  count[tile] = members;
}

// ---------------------------------------------------------------------------
// K6: one color pass, written back through the source codes.
// ---------------------------------------------------------------------------

// One thread per cell of this color: cells (ty0 + 2*cy, tx0 + 2*cx).  Valid
// ranks are a prefix (the rank fills them in ascending pid order), so the
// thread loads ranks 0..nv-1 at their current positions, runs the ordered
// a < b sweep on registers, and stores them back to their slots.  Cells of
// one color are particle-disjoint, so no slot is written twice or read by
// another cell of the launch.  The pair math follows _sweep's f32 order:
//   dist = sqrt(dx*dx + dy*dy), hit = rsum^2 > dist^2 && dist > 1e-4,
//   c = ((d / max(dist, 1e-4)) * pen) * stiffness,
//   w_a = r_b / max(rsum, 1e-4), x_a += c*w_a, x_b -= c*w_b.
template <int KMAX>
__global__ void gs_color_kernel(float* __restrict__ x, float* __restrict__ y,
                                const int* __restrict__ src,
                                const float* __restrict__ rrad, int cap,
                                int TY, int TX, int K, int ty0, int tx0,
                                int HY, int HX, float stiffness) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HY * HX) return;
  const int cy = i / HX;
  const int cx = i - cy * HX;
  const int ty = ty0 + 2 * cy;
  const int tx = tx0 + 2 * cx;
  const int ntiles = TY * TX;
  const int tile = ty * TX + tx;

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
      const int code = src[q * ntiles + tile];
      if (code >= 0) {
        const int j = code / cap;
        const int s = code - j * cap;
        const int at = s * ntiles + (ty + j / 3 - 1) * TX + (tx + j % 3 - 1);
        slot[q] = at;
        lx[q] = x[at];
        ly[q] = y[at];
        lr[q] = rrad[q * ntiles + tile];
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

}  // namespace gpe
