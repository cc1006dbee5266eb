// Hand kernels of the persistent tiled pipeline for Hopper (sm_90a).
//
// K1  collide_integrate_kernel  replaces gpu_physics_engine_tpu/ops/
//     tiled_pallas.py::collide_integrate_pallas (:524, kernel
//     _collide_integrate_band_kernel :388).
// K3  collide_integrate_kernel<..., INTEGRATE = false>  replaces
//     tiled_pallas.py::collide_pallas (:455, kernel _collide_band_kernel
//     :355): the same sweep without the Verlet step.
// K2  relocate_plan_kernel + relocate_apply_kernel  replace
//     gpu_physics_engine_tpu/ops/tiled_pallas.py::relocate_pallas (:945,
//     kernels _relocate_plan_kernel :647 / _plan_choose :713 and
//     _relocate_apply_kernel :780 / _apply_merge :841); on ParLayout they
//     replace ops/gs_parity.py::relocate_parity (:689; _plan_kernel_par
//     :539, _apply_kernel_par :573 and their _all variants :617, :651),
//     "K2-par".
//
// Storage is slot-major [CAP, TY, TX]: slot k of tile (ty, tx) sits at
// k*TY*TX + ty*TX + tx, so neighbouring threads (neighbouring tiles of one
// slot) read neighbouring addresses.  K2 also runs on the parity layout
// [4, CAP, DY, DX] of csrc/layout.cuh; the matching exists once.
//
// Build with -fmad=false: the integer decisions of K2 (which tile a
// position falls in) must equal the plain PyTorch version's bit for bit,
// and PyTorch rounds every product and sum separately.  No fast math:
// the Verlet step divides by max(dist, 1e-6) and needs IEEE '/' and sqrt.
#pragma once

#include <stdint.h>

#include "layout.cuh"

namespace gpe {

constexpr int kMaxCap = 32;  // K2's per-tile claim bitsets are 32 bits

// Fixed claim priority of the eight neighbours (tiled_pallas._NEIGHBORS):
// (-1,-1) (-1,0) (-1,1) (0,-1) (0,1) (1,-1) (1,0) (1,1)
__device__ __forceinline__ int nbr_dy(int e) {
  return e < 3 ? -1 : (e < 5 ? 0 : 1);
}
__device__ __forceinline__ int nbr_dx(int e) {
  return e < 3 ? e - 1 : (e == 3 ? -1 : (e == 4 ? 1 : e - 6));
}
__device__ __forceinline__ int nbr_index(int dy, int dx) {
  return dy < 0 ? dx + 1 : (dy == 0 ? (dx < 0 ? 3 : 4) : dx + 6);
}

// ---------------------------------------------------------------------------
// K1: one fused substep -- 3x3 x CAP Jacobi pair sweep, then Verlet.
// ---------------------------------------------------------------------------

struct K1Consts {
  float r0;          // uniform radius (UNIFORM only)
  float rsum_c;      // 2*r0
  float rsum2_c;     // (2*r0)^2
  float half_stiff;  // 0.5*stiffness (the uniform inverse-mass split)
  float stiffness;
  float min2;        // MIN_DISTANCE^2
  float mouse_strength;
  float gx, gy;
  float world_w, world_h;
  float cx, cy, world_r;  // circle world
};
constexpr int kK1NumConsts = 14;

// One thread per (slot, tile).  The thread gathers its own half of every
// pair correction from all 9 neighbour tiles x CAP slots, in the order
// (dy, dx, k) of the plain version, so it owns its output: no atomics, no
// carry between blocks, deterministic.  (The TPU kernel's Newton form
// evaluates each cross-tile pair once and carries band-seam reactions
// between sequential grid steps; CUDA blocks run in no order, so this
// gather form computes the same pair set and per-pair math with another
// order of the f32 sums.)  Out-of-grid neighbours are skipped; empty slots
// and non-pairs add exactly zero in the plain version, so skipping them
// changes no bit.
//
// K3 (collide_pallas, tiled_pallas.py:455, kernel _collide_band_kernel
// :355) is this kernel with INTEGRATE = false: it writes x + acc_x, y +
// acc_y for every slot and stops; px, py, prm, opx and opy are unused.
template <bool UNIFORM, bool CIRCLE, bool INTEGRATE = true>
__global__ void collide_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ rad, const int* __restrict__ pid,
    const float* __restrict__ prm, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ opx,
    float* __restrict__ opy, int cap, int TY, int TX, K1Consts c) {
  const int ntiles = TY * TX;
  const long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= (long long)cap * ntiles) return;
  const int i = (int)gi;
  const int k = i / ntiles;
  const int tile = i - k * ntiles;
  const int ty = tile / TX;
  const int tx = tile - ty * TX;

  const float xm = x[i];
  const float ym = y[i];
  const bool occ = pid[i] >= 0;
  const float rm = UNIFORM ? c.r0 : rad[i];

  float ax = 0.0f, ay = 0.0f;
  if (occ) {
    for (int dy = -1; dy <= 1; ++dy) {
      const int nty = ty + dy;
      if (nty < 0 || nty >= TY) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int ntx = tx + dx;
        if (ntx < 0 || ntx >= TX) continue;
        const int ntile = nty * TX + ntx;
        const bool self_tile = (dy == 0 && dx == 0);
        for (int kk = 0; kk < cap; ++kk) {
          const int j = kk * ntiles + ntile;
          if (pid[j] < 0 || (self_tile && kk == k)) continue;
          const float ddx = xm - x[j];
          const float ddy = ym - y[j];
          const float d2 = ddx * ddx + ddy * ddy;
          float rk = 0.0f, rsum, rsum2;
          if (UNIFORM) {
            rsum = c.rsum_c;
            rsum2 = c.rsum2_c;
          } else {
            rk = rad[j];
            rsum = rm + rk;
            rsum2 = rsum * rsum;
          }
          if (!(rsum2 > d2 && d2 > c.min2)) continue;
          const float inv = rsqrtf(fmaxf(d2, c.min2));
          const float dist = d2 * inv;
          float coef;
          if (UNIFORM) {
            coef = inv * ((c.rsum_c - dist) * c.half_stiff);
          } else {
            const float pen = (rsum - dist) * c.stiffness;
            const float wi = rk * rsqrtf(fmaxf(rsum2, c.min2));
            coef = inv * pen * wi;
          }
          ax = ax + ddx * coef;
          ay = ay + ddy * coef;
        }
      }
    }
  }
  const float cx = xm + ax;
  const float cy = ym + ay;
  if (!INTEGRATE || !occ) {
    ox[i] = cx;
    oy[i] = cy;
    if (INTEGRATE) {
      opx[i] = px[i];
      opy[i] = py[i];
    }
    return;
  }

  // position Verlet: gravity, mouse attractor, world constraint
  const float vel_x = cx - px[i];
  const float vel_y = cy - py[i];
  const float dt = prm[0], mx = prm[1], my = prm[2], pressed = prm[3];
  const float dxm = mx - cx;
  const float dym = my - cy;
  const float dist = sqrtf(dxm * dxm + dym * dym);
  const float inv = dist > 1e-6f ? 1.0f / fmaxf(dist, 1e-6f) : 0.0f;
  const float strength = c.mouse_strength * pressed;
  const float axm = c.gx + dxm * inv * strength;
  const float aym = c.gy + dym * inv * strength;
  const float dt2 = dt * dt;
  float nx = cx + vel_x + axm * dt2;
  float ny = cy + vel_y + aym * dt2;
  if (CIRCLE) {
    const float dxc = nx - c.cx;
    const float dyc = ny - c.cy;
    const float d2c = dxc * dxc + dyc * dyc;
    const float max_r = c.world_r - rm;
    if (d2c > max_r * max_r) {
      const float invc = 1.0f / sqrtf(fmaxf(d2c, 1e-12f));
      nx = c.cx + max_r * dxc * invc;
      ny = c.cy + max_r * dyc * invc;
    }
  } else {
    nx = fminf(fmaxf(nx, rm), c.world_w - rm);
    ny = fminf(fmaxf(ny, rm), c.world_h - rm);
  }
  ox[i] = nx;
  oy[i] = ny;
  opx[i] = cx;
  opy[i] = cy;
}

// ---------------------------------------------------------------------------
// K2: pull relocation.  Plan, then apply; one thread per tile in each.
// ---------------------------------------------------------------------------

enum Match { kFlip = 0, kFlip2 = 1, kGreedy = 2 };

// One-hop step toward home with hysteresis (tiled_pallas._step_offsets):
// a particle stored in global tile (sty, stx), spanning [(s-1)*t, s*t) per
// axis, moves once it is at least delta past the boundary; targets never
// step onto the border ring.  Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn are never contracted into an FMA).
__device__ __forceinline__ void step_offsets(float x, float y, int sty,
                                             int stx, float t, float delta,
                                             int gTY, int gTX, int* dty,
                                             int* dtx) {
  const float sy = (float)sty, sx = (float)stx;
  const float sy1 = (float)(sty - 1), sx1 = (float)(stx - 1);
  int a = (int)(y >= __fadd_rn(__fmul_rn(sy, t), delta)) -
          (int)(y < __fsub_rn(__fmul_rn(sy1, t), delta));
  int b = (int)(x >= __fadd_rn(__fmul_rn(sx, t), delta)) -
          (int)(x < __fsub_rn(__fmul_rn(sx1, t), delta));
  if (sty + a < 1 || sty + a > gTY - 2) a = 0;
  if (stx + b < 1 || stx + b > gTX - 2) b = 0;
  *dty = a;
  *dtx = b;
}

// plan[k] = code of the in-mover accepted for my free slot k, or -1:
//   flip:   code = e (source slot cap-1-k)
//   flip2:  code = e + 8*rule (source slot cap-1-k for rule 0, k for 1)
//   greedy: code = e*cap + s
// Each neighbour's claims on this tile are a CAP-bit mask, so the
// sequential matching of _plan_choose runs on registers.  One thread per
// cell of the launch (parity pad cells are not interior: plan -1).
template <class L>
__global__ void relocate_plan_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const int* __restrict__ pid, int* __restrict__ plan, int cap, L lay,
    int n, int row0, int gTY, int gTX, int match, float t, float delta) {
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 >= n) return;
  const int TY = lay.TY;
  int ty, tx;
  lay.cell(i0, &ty, &tx);
  const int my_ty = ty + row0;
  const bool interior = my_ty >= 1 && my_ty <= gTY - 2 && tx >= 1 &&
                        tx <= gTX - 2 && ty <= TY - 1;
  if (!interior) {
    for (int k = 0; k < cap; ++k) plan[lay.at(k, cap, ty, tx)] = -1;
    return;
  }

  uint32_t claims[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ey = nbr_dy(e), ex = nbr_dx(e);
    const int nty = ty + ey, ntx = tx + ex;
    uint32_t m = 0;
    if (nty >= 0 && nty <= TY - 1 && ntx >= 0 && ntx <= gTX - 1) {
      for (int s = 0; s < cap; ++s) {
        const int j = lay.at(s, cap, nty, ntx);
        if (pid[j] < 0) continue;
        int dty, dtx;
        step_offsets(x[j], y[j], my_ty + ey, tx + ex, t, delta, gTY, gTX,
                     &dty, &dtx);
        if (dty == -ey && dtx == -ex) m |= 1u << s;
      }
    }
    claims[e] = m;
  }

  uint32_t claimed[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) claimed[e] = 0;
  for (int k = 0; k < cap; ++k) {
    int code = -1;
    const int mine = lay.at(k, cap, ty, tx);
    if (pid[mine] < 0) {
      if (match == kFlip) {
        const int s = cap - 1 - k;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (code < 0 && ((claims[e] >> s) & 1u)) code = e;
        }
      } else if (match == kFlip2) {
        for (int rule = 0; rule < 2 && code < 0; ++rule) {
          const int s = rule == 0 ? cap - 1 - k : k;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (code < 0 && (((claims[e] & ~claimed[e]) >> s) & 1u)) {
              code = e + 8 * rule;
              claimed[e] |= 1u << s;
            }
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t avail = claims[e] & ~claimed[e];
          if (code < 0 && avail) {
            const int s = __ffs((int)avail) - 1;  // lowest free source slot
            code = e * cap + s;
            claimed[e] |= 1u << s;
          }
        }
      }
    }
    plan[mine] = code;
  }
}

// Apply: pull the planned in-movers, vacate my occupants whose target's
// plan names them, count the movers that found no slot, and write the
// survivors compacted to the low slots (zero-filled above).  Writes go to
// fresh output planes: neighbouring tiles read the inputs concurrently.
// rad and orad may both be null (the parity state under uniform radius
// carries no radius planes).
template <class L>
__global__ void relocate_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ rad, const int* __restrict__ pid,
    const int* __restrict__ plan, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ opx,
    float* __restrict__ opy, float* __restrict__ orad,
    int* __restrict__ opid, int* __restrict__ defer, int cap, L lay, int n,
    int row0, int gTY, int gTX, int match, float t, float delta) {
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 >= n) return;
  const int TY = lay.TY;
  int ty, tx;
  lay.cell(i0, &ty, &tx);
  const int my_ty = ty + row0;

  int nout = 0, ndefer = 0;
  for (int k = 0; k < cap; ++k) {
    const int i = lay.at(k, cap, ty, tx);
    const int code = plan[i];
    int src = -1;  // slot whose particle lands in my output
    if (code >= 0) {
      // pull: plans exist only for start-empty slots of interior tiles,
      // so the source neighbour is always inside the grid
      int e, s;
      if (match == kFlip) {
        e = code;
        s = cap - 1 - k;
      } else if (match == kFlip2) {
        e = code & 7;
        s = code >= 8 ? k : cap - 1 - k;
      } else {
        e = code / cap;
        s = code - e * cap;
      }
      src = lay.at(s, cap, ty + nbr_dy(e), tx + nbr_dx(e));
    } else if (pid[i] >= 0) {
      src = i;
      int dty, dtx;
      step_offsets(x[i], y[i], my_ty, tx, t, delta, gTY, gTX, &dty, &dtx);
      const bool in_slab = ty + dty >= 0 && ty + dty <= TY - 1;
      if (in_slab && (dty != 0 || dtx != 0)) {
        // leave check: the target names me (offset -dty,-dtx from it)
        const int me = nbr_index(-dty, -dtx);
        const int gy = ty + dty, gx = tx + dtx;
        bool accepted;
        if (match == kFlip) {
          accepted = plan[lay.at(cap - 1 - k, cap, gy, gx)] == me;
        } else if (match == kFlip2) {
          accepted = plan[lay.at(cap - 1 - k, cap, gy, gx)] == me ||
                     plan[lay.at(k, cap, gy, gx)] == me + 8;
        } else {
          accepted = false;
          for (int kd = 0; kd < cap; ++kd) {
            accepted |= plan[lay.at(kd, cap, gy, gx)] == me * cap + k;
          }
        }
        if (accepted) {
          src = -1;
        } else {
          ++ndefer;
        }
      }
    }
    if (src >= 0) {
      const int o = lay.at(nout, cap, ty, tx);
      ox[o] = x[src];
      oy[o] = y[src];
      opx[o] = px[src];
      opy[o] = py[src];
      if (rad) orad[o] = rad[src];
      opid[o] = pid[src];
      ++nout;
    }
  }
  for (int k = nout; k < cap; ++k) {
    const int o = lay.at(k, cap, ty, tx);
    ox[o] = 0.0f;
    oy[o] = 0.0f;
    opx[o] = 0.0f;
    opy[o] = 0.0f;
    if (orad) orad[o] = 0.0f;
    opid[o] = -1;
  }
  defer[lay.at(0, 1, ty, tx)] = ndefer;
}

}  // namespace gpe
