// Hand kernels of the persistent tiled pipeline for Hopper (sm_90a).
//
// K1  collide_integrate_kernel  replaces gpu_physics_engine_tpu/ops/
//     tiled_pallas.py::collide_integrate_pallas (:524, kernel
//     _collide_integrate_band_kernel :388).
// K3  collide_integrate_kernel<..., INTEGRATE = false>  replaces
//     tiled_pallas.py::collide_pallas (:455, kernel _collide_band_kernel
//     :355): the same sweep without the Verlet step.
// K2  relocate_window_kernel<FlatLayout>  replaces
//     gpu_physics_engine_tpu/ops/tiled_pallas.py::relocate_pallas (:945,
//     kernels _relocate_plan_kernel :647 / _plan_choose :713 and
//     _relocate_apply_kernel :780 / _apply_merge :841); on ParLayout it
//     replaces ops/gs_parity.py::relocate_parity (:689; _plan_kernel_par
//     :539, _apply_kernel_par :573 and their _all variants :617, :651),
//     "K2-par".  Bound: device memory: the pid plane read, and x, y, px,
//     py, radius of the occupied slots only; six planes and the defer plane
//     written (0.106 ms at the 4M shape with 4,194,304 particles on an H100
//     at 3.35 TB/s).  Plan and apply in one launch on a shared-memory window
//     (below).
// K4  relocate_window_kernel<FlatLayout, DivHome>  replaces
//     tiled_pallas.py::relocate_pallas_one (:1187, kernel
//     _relocate_one_kernel :1068): K2 with flip matching, no hysteresis,
//     the home tile by a correctly rounded division.
// relocate_mega  relocate_window_kernel<ParLayout, StepHome>  replaces
//     ops/gs_mega.py::relocate_mega (:443, kernel _reloc_mega_kernel :311):
//     K2-par over all four parities, the config's matching and hysteresis.
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

#include <type_traits>

#include "layout.cuh"

namespace gpe {

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

// One block owns a region of k1_rows x k1_cols tiles (below) and works in
// three phases, with a barrier between them:
//
//  1. stage: the region and a one-tile ring (the window) go to shared
//     memory, every slot of x, y (and radius unless UNIFORM), each plane
//     read once, coalesced along tx; per window tile a CAP-bit mask of
//     its occupied slots (pid >= 0).  Tiles outside the grid keep an
//     empty mask.
//  2. sweep: the region's occupied (tile, slot) pairs, listed in tile-major
//     order, are dealt to the threads, so no thread walks an empty slot and
//     a warp works on neighbouring tiles (its shared-memory reads land on
//     neighbouring words).  Each particle gathers its own half of every
//     pair correction from the 9 window tiles, visiting the occupied
//     candidates of each in ascending slot order: the order (dy, dx, k) of
//     the plain version, so it owns its sums and they equal the plain
//     version's bit for bit (no atomics, no carry between blocks).  Empty
//     slots and out-of-grid tiles add exactly zero in the plain version,
//     so skipping them changes no bit.  The sums go to shared memory.
//  3. write: one thread per (slot, tile) of the region, coalesced along tx:
//     x + sum, y + sum (x, y from the window), then (INTEGRATE) the Verlet
//     step.
//
// A thread per (slot, tile) reading its 9 x CAP candidates from device
// memory would fetch every slot's (x, y, pid) for 72 threads at cap 8 and
// run whole warps for one occupied lane; the window reads each once and
// deals out occupied particles only.  The region's shape and the dealing
// were chosen by timing the alternatives (PERF.md).  (The TPU kernel's
// Newton form evaluates each cross-tile pair once and carries band-seam
// reactions between sequential grid steps; CUDA blocks run in no order,
// so this gather form computes the same pair set and per-pair math with
// another order of the f32 sums.)
//
// K3 (collide_pallas, tiled_pallas.py:455, kernel _collide_band_kernel
// :355) is this kernel with INTEGRATE = false: it writes x + acc_x, y +
// acc_y for every slot and stops; px, py, prm, opx and opy are unused.
//
// The mask word M is unsigned for caps up to 32, with a region of 8 x 32
// tiles and a thread per tile; Mask64 for caps 33-64, with a region of
// 4 x 16 tiles and four threads a tile (the 8 x 32 window would need
// 427 KB at cap 64, 4 x 32 still 240 KB; 4 x 16 needs 124,768 bytes with a
// radius plane); Mask256 for caps 65-256, with a region of 2 x 8 tiles
// (165,120 bytes at cap 256 with a radius plane; 4 x 8 would need
// 268,800), whose 16 tiles list their occupants and whose 256 threads
// share the sweep.  The particle list packs (region tile, slot) into u16:
// (255 << 5 | 31), (63 << 6 | 63) and (15 << 8 | 255) all fit.
constexpr int kK1Threads = 256;  // a block's threads, every class
__host__ __device__ constexpr int k1_rows(int cls) {  // region tile rows
  return cls == 0 ? 8 : cls == 1 ? 4 : 2;
}
__host__ __device__ constexpr int k1_cols(int cls) {  // region columns:
  return cls == 0 ? 32 : cls == 1 ? 16 : 8;  // a warp writes one row of
}                                           // the narrow region
__host__ __device__ constexpr int k1_win_tiles(int cls) {
  return (k1_rows(cls) + 2) * (k1_cols(cls) + 2);
}

// Dynamic shared memory of one block: window x/y (float2) [cap][window],
// the sums (float2) [cap][region], window radius [cap][window] (general
// radius only), occupancy masks [window], the particle list (u16)
// [cap * region].  213,840 bytes at cap 32, general radius; 124,768 at
// cap 64; 165,120 at cap 256 (kMaxCap).
__host__ __device__ constexpr int k1_smem_bytes(int cap, bool uniform) {
  return k1_win_tiles(cap_class(cap)) * (cap * (uniform ? 8 : 12) +
                                         mask_bytes(cap)) +
         k1_rows(cap_class(cap)) * k1_cols(cap_class(cap)) * cap * 10;
}
static_assert(k1_smem_bytes(kNarrowCap, false) <= kSmemLimit, "K1 window");
static_assert(k1_smem_bytes(kWideCap, false) <= kSmemLimit, "K1 wide window");
static_assert(k1_smem_bytes(kMaxCap, false) <= kSmemLimit, "K1 256 window");
static_assert(k1_win_tiles(1) % 2 == 0 && k1_win_tiles(2) % 2 == 0,
              "the 64-bit mask words' alignment");

template <class M, bool UNIFORM, bool CIRCLE, bool INTEGRATE = true>
__global__ void __launch_bounds__(kK1Threads) collide_integrate_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ rad, const int* __restrict__ pid,
    const float* __restrict__ prm, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ opx,
    float* __restrict__ opy, int cap, int TY, int TX, K1Consts c) {
  constexpr int kCls = mask_class<M>();
  constexpr int kRY = k1_rows(kCls), kRX = k1_cols(kCls);
  constexpr int kTiles = kRY * kRX, kWinX = kRX + 2;
  constexpr int kWinTiles = k1_win_tiles(kCls);
  constexpr int kT = kK1Threads, kSB = slot_bits<M>();
  extern __shared__ __align__(16) unsigned char k1_smem[];
  float2* wxy = reinterpret_cast<float2*>(k1_smem);  // [cap][window]
  float2* acc = wxy + cap * kWinTiles;                // [cap][region]
  float* wr = reinterpret_cast<float*>(acc + cap * kTiles);
  M* wmask = reinterpret_cast<M*>(wr + (UNIFORM ? 0 : cap * kWinTiles));
  unsigned short* plist =
      reinterpret_cast<unsigned short*>(wmask + kWinTiles);
  __shared__ int warp_total[kT / 32];

  const int ntiles = TY * TX;
  const int by = kRY * (int)blockIdx.y;
  const int bx = kRX * (int)blockIdx.x;
  const int tid = threadIdx.x;

  // 1. stage the window
  for (int w = tid; w < kWinTiles; w += kT) wmask[w] = 0u;
  __syncthreads();
  // x, y (and radius) are read whatever the pid: with a few occupied
  // slots in every 32-byte sector the empty ones cost no extra sector, and
  // all loads of an iteration then go out together
#pragma unroll 4
  for (int i = tid; i < cap * kWinTiles; i += kT) {
    const int k = i / kWinTiles;
    const int w = i - k * kWinTiles;
    const int wy = w / kWinX;
    const int ty = by - 1 + wy;
    const int tx = bx - 1 + (w - wy * kWinX);
    if (ty < 0 || ty >= TY || tx < 0 || tx >= TX) continue;
    const int g = k * ntiles + ty * TX + tx;
    const int p = pid[g];
    wxy[i] = make_float2(x[g], y[g]);
    if (!UNIFORM) wr[i] = rad[g];
    if (p >= 0) atomicOr(&wmask[w], M(1) << k);  // an OR: any order
  }
  __syncthreads();

  // 2a. list the region's occupied slots: thread tid owns region tile tid
  // (a thread past the region's tiles owns none)
  {
    const int ly = tid / kRX;
    const int lx = tid - ly * kRX;
    const M own = (kT == kTiles || tid < kTiles)
                      ? wmask[(ly + 1) * kWinX + lx + 1]
                      : M(0);
    const int cnt = mask_count(own);
    const int lane = tid & 31, warp = tid >> 5;
    int inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += u;
    }
    if (lane == 31) warp_total[warp] = inc;
    __syncthreads();
    int pos = inc - cnt;
    for (int w = 0; w < warp; ++w) pos += warp_total[w];
    for (M m = own; m; m &= m - 1u)
      plist[pos++] = (unsigned short)((tid << kSB) | mask_low(m));
  }
  int total = 0;
#pragma unroll
  for (int w = 0; w < kT / 32; ++w) total += warp_total[w];
  __syncthreads();

  // 2b. the sweep, one listed particle per thread at a time
  for (int e = tid; e < total; e += kT) {
    const int code = plist[e];
    const int lt = code >> kSB, k = code & ((1 << kSB) - 1);
    const int ly = lt / kRX;
    const int wc = (ly + 1) * kWinX + (lt - ly * kRX) + 1;
    const float2 pm = wxy[k * kWinTiles + wc];
    const float xm = pm.x, ym = pm.y;
    const float rm = UNIFORM ? c.r0 : wr[k * kWinTiles + wc];
    float ax = 0.0f, ay = 0.0f;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int w = wc + dy * kWinX + dx;
        M m = wmask[w];
        if (dy == 0 && dx == 0) m &= ~(M(1) << k);
        for (; m; m &= m - 1u) {
          const int j = mask_low(m) * kWinTiles + w;
          const float2 q = wxy[j];
          const float ddx = xm - q.x;
          const float ddy = ym - q.y;
          const float d2 = ddx * ddx + ddy * ddy;
          float rk = 0.0f, rsum, rsum2;
          if (UNIFORM) {
            rsum = c.rsum_c;
            rsum2 = c.rsum2_c;
          } else {
            rk = wr[j];
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
    acc[k * kTiles + lt] = make_float2(ax, ay);
  }
  __syncthreads();

  // 3. write every slot of the region
#pragma unroll 4
  for (int i = tid; i < cap * kTiles; i += kT) {
    const int k = i / kTiles;
    const int lt = i - k * kTiles;
    const int ly = lt / kRX;
    const int lx = lt - ly * kRX;
    const int ty = by + ly, tx = bx + lx;
    if (ty >= TY || tx >= TX) continue;
    const int g = k * ntiles + ty * TX + tx;
    const int wi = k * kWinTiles + (ly + 1) * kWinX + lx + 1;
    const bool occ = (wmask[(ly + 1) * kWinX + lx + 1] >> k) & 1u;
    const float2 a = occ ? acc[i] : make_float2(0.0f, 0.0f);
    const float2 p = wxy[wi];  // the slot's x, y, staged in phase 1
    const float cx = p.x + a.x;
    const float cy = p.y + a.y;
    if (!INTEGRATE || !occ) {
      ox[g] = cx;
      oy[g] = cy;
      if (INTEGRATE) {
        opx[g] = px[g];
        opy[g] = py[g];
      }
      continue;
    }
    const float rm = UNIFORM ? c.r0 : wr[wi];

    // position Verlet: gravity, mouse attractor, world constraint
    const float vel_x = cx - px[g];
    const float vel_y = cy - py[g];
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
    ox[g] = nx;
    oy[g] = ny;
    opx[g] = cx;
    opy[g] = cy;
  }
}

// ---------------------------------------------------------------------------
// The pull relocation: the step rules, the matching and the window kernel
// of K2, K2-par, K4 and relocate_mega.
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

// K4's one-hop offsets (tiled_pallas._home_tile): the home tile
// floor(pos / t) + 1 by a correctly rounded division, clipped to the
// interior, and the clipped step toward it.  No hysteresis.
__device__ __forceinline__ void home_offsets(float x, float y, int sty,
                                             int stx, float t, int gTY,
                                             int gTX, int* dty, int* dtx) {
  const int wy = min(max((int)floorf(__fdiv_rn(y, t)) + 1, 1), gTY - 2);
  const int wx = min(max((int)floorf(__fdiv_rn(x, t)) + 1, 1), gTX - 2);
  *dty = min(max(wy - sty, -1), 1);
  *dtx = min(max(wx - stx, -1), 1);
}

// Where a particle stored in global tile (sty, stx) steps: K2, K2-par and
// relocate_mega take step_offsets with the config's hysteresis, K4 the home
// division.
struct StepHome {
  float t, delta;
  int gTY, gTX;
  __device__ __forceinline__ void operator()(float x, float y, int sty,
                                             int stx, int* dty,
                                             int* dtx) const {
    step_offsets(x, y, sty, stx, t, delta, gTY, gTX, dty, dtx);
  }
};
struct DivHome {
  float t;
  int gTY, gTX;
  __device__ __forceinline__ void operator()(float x, float y, int sty,
                                             int stx, int* dty,
                                             int* dtx) const {
    home_offsets(x, y, sty, stx, t, gTY, gTX, dty, dtx);
  }
};

// The sequential matching of _plan_choose on register masks: claims[e] =
// the slots of neighbour e whose occupant hops to this tile.  For every
// slot k in ascending order, write(k, code, e, s) with the in-mover
// accepted for a free slot k (neighbour e, its slot s), code -1 if none:
//   flip:   code = e (s = cap-1-k)
//   flip2:  code = e + 8*rule (s = cap-1-k for rule 0, k for 1)
//   greedy: code = e*cap + s
// claimed[e] ends as the slots of neighbour e that this tile took.
template <class M, class F, class W>
__device__ __forceinline__ void match_claims(const M (&claims)[8],
                                             int cap, int match, F is_free,
                                             W write, M (&claimed)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) claimed[e] = 0;
  for (int k = 0; k < cap; ++k) {
    int code = -1, ce = 0, cs = 0;
    if (is_free(k)) {
      if (match == kFlip) {
        const int s = cap - 1 - k;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (code < 0 && ((claims[e] >> s) & 1u)) {
            code = e;
            ce = e;
            cs = s;
            claimed[e] |= M(1) << s;
          }
        }
      } else if (match == kFlip2) {
        for (int rule = 0; rule < 2 && code < 0; ++rule) {
          const int s = rule == 0 ? cap - 1 - k : k;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (code < 0 && (((claims[e] & ~claimed[e]) >> s) & 1u)) {
              code = e + 8 * rule;
              ce = e;
              cs = s;
              claimed[e] |= M(1) << s;
            }
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const M avail = claims[e] & ~claimed[e];
          if (code < 0 && avail) {
            const int s = mask_low(avail);  // lowest free source slot
            code = e * cap + s;
            ce = e;
            cs = s;
            claimed[e] |= M(1) << s;
          }
        }
      }
    }
    write(k, code, ce, cs);
  }
}

// K2 / K2-par / K4 / relocate_mega: the pull relocate on a shared-memory
// tile window, one launch.
//
// One block owns a region of storage cells: 8 x 64 tiles on FlatLayout; on
// ParLayout 4 x 32 sub-grid cells of each of the four parities, which is
// the full-space 8 x 64 region.  Its window is the region and a two-tile
// full-space halo (on ParLayout one sub-grid cell of each parity), indexed
// in full space.  It works in four phases, with a barrier between them:
//
//  1. stage: a thread per window tile reads the pid of its slots, then
//     x, y of the occupied ones, each plane once, neighbouring threads on
//     neighbouring storage words (on ParLayout a warp walks one parity's
//     sub-window), and computes every occupant's one-hop step once (H:
//     StepHome, the products of step_offsets, or K4's DivHome).  It keeps
//     a CAP-bit mask of the occupied slots and one of the slots hopping in
//     each of the eight directions.
//  2. plan: a thread per tile of the region and its one-tile ring: the
//     claims on the tile are eight masks of its neighbours' directions, and
//     match_claims runs on them.  A region tile keeps the source
//     (neighbour, slot) of each free slot it fills; every planned tile
//     keeps the masks of its neighbours' slots it took.
//     The ring's plans are computed again by the neighbouring block.
//  3. apply: a thread per region tile.  Its occupants taken by a neighbour
//     leave; its movers not taken are deferred; the other occupants and the
//     pulled sources, in slot order, are its outputs, ranked in place.
//  4. write: a thread per (output slot, region tile), coalesced along tx:
//     x, y, px, py, radius and pid of the source (read from device memory,
//     mostly the same word it writes), or the zero fill.
//
// The plan never leaves shared memory, and no particle's step is computed
// twice by one block (the TPU kernel recomputed every neighbour's plan).
// Each output slot is written by one thread from the inputs, so the kernel
// is deterministic without atomics and equals the plain version bit for
// bit.  On ParLayout a launch applies parities p0 .. p0+np-1 of its region
// (gs_par_fused=False launches one parity at a time) and plans all four.
// Two launches (the plan through device memory, the apply staging the
// region again) took 43-53% longer in the step state, and the region
// shapes and block sizes were chosen by timing (PERF.md).
// A region is 64 tiles wide on FlatLayout (two warps write a row: 12-13%
// faster than 32 wide in the step state, whose write phase stored at about
// half the card's rate) and 32 sub-grid cells wide on ParLayout (wider took
// 15% longer there).  Threads: one per region tile on FlatLayout (512),
// half that on ParLayout (256; 512 took 6% longer at 1M-GS par).
//
// The mask word M sets the class: 32 and 64 bits (caps up to 64) take the
// regions above; Mask256 (caps 65-256) a region of 4 x 16 tiles (on
// ParLayout 2 x 8 cells of each sub-grid: the full-space 4 x 16), 106,752
// bytes at cap 256 on either layout (8 x 64 would need 404 KB, 4 x 32
// 201 KB), and 128 threads a block, so that its per-thread masks (a
// planned tile's eight claims and eight taken masks of four words each)
// have 255 registers to live in.  A source code (e << 8) | slot stays
// below kNoSource.
constexpr int kK2WidthFlat = 64;
constexpr int kK2WidthPar = 32;
constexpr int kK2RowsFlat = 8;  // region rows, flat
constexpr int kK2RowsPar = 4;   // region rows of each parity, parity
__host__ __device__ constexpr int k2_width(bool par, int cls) {
  return cls == 2 ? (par ? 8 : 16) : (par ? kK2WidthPar : kK2WidthFlat);
}
__host__ __device__ constexpr int k2_rows(bool par, int cls) {
  return cls == 2 ? (par ? 2 : 4) : (par ? kK2RowsPar : kK2RowsFlat);
}
template <class L>
__host__ __device__ constexpr bool k2_par() {
  return std::is_same<L, ParLayout>::value;
}
template <class M, class L>
__host__ __device__ constexpr int k2_threads() {
  return mask_class<M>() == 2 ? 128 : k2_par<L>() ? 256 : 512;
}
constexpr unsigned short kNoSource = 0xFFFF;
constexpr int kOwnTile = 8;  // source code e for the tile itself

// Dynamic shared memory of one block: occupancy and eight direction masks
// per window tile, eight taken masks per planned tile (each mask a 32-bit
// word up to cap 32, 64-bit to cap 64, four 64-bit words past it), the
// output count and the source codes (u16) [cap] per region tile.
__host__ __device__ constexpr int k2_window_bytes(int cap, bool par) {
  const int cls = cap_class(cap);
  const int ry = (par ? 2 : 1) * k2_rows(par, cls);
  const int rx = (par ? 2 : 1) * k2_width(par, cls);
  return mask_bytes(cap) *
             (9 * (ry + 4) * (rx + 4) + 8 * (ry + 2) * (rx + 2)) +
         (4 + 2 * cap) * ry * rx;
}
// Every cap fits a block (85,312 bytes at cap 32, 168,576 at cap 64,
// 106,752 at cap 256, on either layout).
static_assert(k2_window_bytes(kWideCap, false) <= kSmemLimit, "K2 window");
static_assert(k2_window_bytes(kWideCap, true) <= kSmemLimit, "K2-par window");
static_assert(k2_window_bytes(kMaxCap, false) <= kSmemLimit, "K2 256");
static_assert(k2_window_bytes(kMaxCap, true) <= kSmemLimit, "K2-par 256");
static_assert((kOwnTile << slot_bits<Mask256>()) + kMaxCap - 1 < kNoSource,
              "a source code stays below kNoSource");

// Full-space geometry of a block of class C: region RY x RX from full tile
// (ty0, tx0), window (RY + 4) x (RX + 4) from (ty0 - 2, tx0 - 2).
struct K2Box {
  int RY, RX, WY, WX, ty0, tx0;
};
template <int C>
__device__ __forceinline__ K2Box k2_box(const FlatLayout&) {
  constexpr int R = k2_rows(false, C), W = k2_width(false, C);
  return K2Box{R, W, R + 4, W + 4, R * (int)blockIdx.y, W * (int)blockIdx.x};
}
template <int C>
__device__ __forceinline__ K2Box k2_box(const ParLayout& l) {
  constexpr int R = 2 * k2_rows(true, C), W = 2 * k2_width(true, C);
  return K2Box{R, W, R + 4, W + 4, R * (int)blockIdx.y + l.o,
               W * (int)blockIdx.x + l.o};
}

// Window tile i of the stage, in window coordinates: row-major on
// FlatLayout; on ParLayout parity-major, each parity's sub-window row-major,
// so that neighbouring threads read neighbouring words of one sub-grid.
__device__ __forceinline__ void k2_window_tile(const FlatLayout&,
                                               const K2Box& b, int i,
                                               int* wy, int* wx) {
  *wy = i / b.WX;
  *wx = i - *wy * b.WX;
}
__device__ __forceinline__ void k2_window_tile(const ParLayout&,
                                               const K2Box& b, int i,
                                               int* wy, int* wx) {
  const int SX = b.WX / 2, A = (b.WY / 2) * SX;
  const int p = i / A, r = i - p * A;
  const int cy = r / SX;
  *wy = 2 * cy + (p >> 1);
  *wx = 2 * (r - cy * SX) + (p & 1);
}

// Region cell r of the applied parities (p0 .. p0 + np - 1), in region
// coordinates, and back (-1 for a tile of a parity not applied).
template <int C>
__device__ __forceinline__ void k2_region_tile(const FlatLayout&,
                                               const K2Box&, int, int r,
                                               int* ry, int* rx) {
  constexpr int W = k2_width(false, C);
  *ry = r / W;
  *rx = r - *ry * W;
}
template <int C>
__device__ __forceinline__ void k2_region_tile(const ParLayout&,
                                               const K2Box& b, int p0, int r,
                                               int* ry, int* rx) {
  constexpr int W = k2_width(true, C);
  const int A = (b.RY / 2) * W;
  const int pl = r / A, q = r - pl * A, p = p0 + pl;
  const int cy = q / W;
  *ry = 2 * cy + (p >> 1);
  *rx = 2 * (q - cy * W) + (p & 1);
}
template <int C>
__device__ __forceinline__ int k2_region_index(const FlatLayout&,
                                               const K2Box&, int, int,
                                               int ry, int rx) {
  return ry * k2_width(false, C) + rx;
}
template <int C>
__device__ __forceinline__ int k2_region_index(const ParLayout&,
                                               const K2Box& b, int p0, int np,
                                               int ry, int rx) {
  const int pl = (((ry & 1) << 1) | (rx & 1)) - p0;
  if (pl < 0 || pl >= np) return -1;
  return (pl * (b.RY / 2) + (ry >> 1)) * k2_width(true, C) + (rx >> 1);
}

// Whether full tile (ty, tx) has a storage cell (ParLayout: pad cells too).
__device__ __forceinline__ bool k2_stored(const FlatLayout& l, int ty,
                                          int tx) {
  return ty >= 0 && ty < l.TY && tx >= 0 && tx < l.TX;
}
__device__ __forceinline__ bool k2_stored(const ParLayout& l, int ty,
                                          int tx) {
  const int q = ty - l.o, r = tx - l.o;
  return q >= 0 && r >= 0 && (q >> 1) < l.DY && (r >> 1) < l.DX;
}

template <class M, class L, class H>
__global__ void __launch_bounds__(k2_threads<M, L>()) relocate_window_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ rad, const int* __restrict__ pid,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ opx,
    float* __restrict__ opy, float* __restrict__ orad,
    int* __restrict__ opid, int* __restrict__ defer, int cap, L lay, int p0,
    int np, int row0, int gTY, int gTX, int match, H home) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  constexpr int kCls = mask_class<M>();
  const K2Box b = k2_box<kCls>(lay);
  const int Wn = b.WY * b.WX, PX = b.WX - 2, Pn = (b.WY - 2) * PX;
  const int Rn = b.RY * b.RX;            // region cells, all parities
  constexpr bool par = k2_par<L>();
  const int Ra = np * k2_rows(par, kCls) * k2_width(par, kCls);  // applied
  constexpr int kSB = slot_bits<M>();  // a source code: (e << kSB) | slot
  M* occm = reinterpret_cast<M*>(k2_smem);  // [window]
  M* dirm = occm + Wn;                      // [8][window]
  M* taken = dirm + 8 * Wn;                 // [8][planned]
  int* nout = reinterpret_cast<int*>(taken + 8 * Pn);     // [region]
  unsigned short* src =
      reinterpret_cast<unsigned short*>(nout + Rn);       // [cap][region]
  const int TY = lay.TY, TX = lay.TX;
  const int wy0 = b.ty0 - 2, wx0 = b.tx0 - 2;  // full tile of window (0, 0)

  // 1. stage: occupancy and direction masks of every window tile
  for (int i = threadIdx.x; i < Wn; i += blockDim.x) {
    int wy, wx;
    k2_window_tile(lay, b, i, &wy, &wx);
    const int ty = wy0 + wy, tx = wx0 + wx;
    M occ = 0, d[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = 0;
    if (ty >= 0 && ty < TY && tx >= 0 && tx < TX) {
      // every pid first, then x, y of the occupied slots only: the upper
      // slot planes are mostly empty, and their sectors are never fetched
#pragma unroll 8
      for (int k = 0; k < cap; ++k)
        occ |= (M)(pid[lay.at(k, cap, ty, tx)] >= 0) << k;
#pragma unroll 4
      for (M m = occ; m; m &= m - 1u) {
        const int k = mask_low(m);
        const int g = lay.at(k, cap, ty, tx);
        int dty, dtx;
        home(x[g], y[g], ty + row0, tx, &dty, &dtx);
        const int c = (dty | dtx) ? nbr_index(dty, dtx) : -1;
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] |= (M)(c == e) << k;
      }
    }
    const int w = wy * b.WX + wx;
    occm[w] = occ;
#pragma unroll
    for (int e = 0; e < 8; ++e) dirm[e * Wn + w] = d[e];
  }
  __syncthreads();

  // 2. plan the region and its ring
  const M all = cap == 8 * (int)sizeof(M) ? ~M(0) : (M(1) << cap) - 1u;
  for (int i = threadIdx.x; i < Pn; i += blockDim.x) {
    const int wy = i / PX + 1, wx = i - (wy - 1) * PX + 1;
    const int ty = wy0 + wy, tx = wx0 + wx;
    const int w = wy * b.WX + wx;
    const int ry = wy - 2, rx = wx - 2;
    const int r = ry >= 0 && ry < b.RY && rx >= 0 && rx < b.RX
                      ? k2_region_index<kCls>(lay, b, p0, np, ry, rx)
                      : -1;
    const int my_ty = ty + row0;
    const bool interior = ty >= 0 && ty <= TY - 1 && my_ty >= 1 &&
                          my_ty <= gTY - 2 && tx >= 1 && tx <= gTX - 2;
    // neighbour e's slots hopping to me: its direction 7 - e
    M claims[8], any = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      claims[e] = interior
                      ? dirm[(7 - e) * Wn + w + nbr_dy(e) * b.WX + nbr_dx(e)]
                      : 0u;
      any |= claims[e];
    }
    M took[8];
    if (any) {
      const M freem = ~occm[w] & all;
      match_claims(
          claims, cap, match, [&](int k) { return (freem >> k) & 1u; },
          [&](int k, int code, int e, int s) {
            if (r >= 0)
              src[k * Ra + r] =
                  code >= 0 ? (unsigned short)((e << kSB) | s) : kNoSource;
          },
          took);
    } else {  // no claims (most tiles): no matching
#pragma unroll
      for (int e = 0; e < 8; ++e) took[e] = 0;
      if (r >= 0)
        for (int k = 0; k < cap; ++k) src[k * Ra + r] = kNoSource;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) taken[e * Pn + i] = took[e];
  }
  __syncthreads();

  // 3. apply: who leaves, who is deferred, the outputs in slot order
  for (int r = threadIdx.x; r < Ra; r += blockDim.x) {
    int ry, rx;
    k2_region_tile<kCls>(lay, b, p0, r, &ry, &rx);
    const int wy = ry + 2, wx = rx + 2, ty = b.ty0 + ry, tx = b.tx0 + rx;
    const int w = wy * b.WX + wx;
    const M occ = occm[w];
    M gone = 0, movers = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // the neighbour at -offset(e) took my slots through its mask e
      gone |= taken[e * Pn + (wy - 1 - nbr_dy(e)) * PX + (wx - 1 - nbr_dx(e))];
      // movers whose target lies in the slab (the others stay, undeferred)
      const int tr = ty + nbr_dy(e);
      if (tr >= 0 && tr <= TY - 1) movers |= dirm[e * Wn + w];
    }
    const M keep = occ & ~gone;
    int j = 0;
    for (int k = 0; k < cap; ++k) {  // in place: j <= k
      unsigned short c = kNoSource;
      if ((keep >> k) & 1u) {
        c = (unsigned short)((kOwnTile << kSB) | k);
      } else if (!((occ >> k) & 1u)) {
        c = src[k * Ra + r];
      }
      if (c != kNoSource) src[j++ * Ra + r] = c;
    }
    nout[r] = j;
    if (k2_stored(lay, ty, tx))
      defer[lay.at(0, 1, ty, tx)] = mask_count(movers & ~gone);
  }
  __syncthreads();

  // 4. write every slot of the applied region: thread i takes output slot
  // j = i / Ra of region cell r = i % Ra (stepped without a division)
  int j = threadIdx.x / Ra, r = threadIdx.x - j * Ra;
#pragma unroll 2
  for (int i = threadIdx.x; i < cap * Ra; i += blockDim.x) {
    int ry, rx;
    k2_region_tile<kCls>(lay, b, p0, r, &ry, &rx);
    const int ty = b.ty0 + ry, tx = b.tx0 + rx;
    if (k2_stored(lay, ty, tx)) {
      const int o = lay.at(j, cap, ty, tx);
      if (j < nout[r]) {
        const int c = src[j * Ra + r];
        const int e = c >> kSB, s = c & ((1 << kSB) - 1);
        const int g = e == kOwnTile
                          ? lay.at(s, cap, ty, tx)
                          : lay.at(s, cap, ty + nbr_dy(e), tx + nbr_dx(e));
        ox[o] = x[g];
        oy[o] = y[g];
        opx[o] = px[g];
        opy[o] = py[g];
        if (rad) orad[o] = rad[g];
        opid[o] = pid[g];
      } else {
        ox[o] = 0.0f;
        oy[o] = 0.0f;
        opx[o] = 0.0f;
        opy[o] = 0.0f;
        if (orad) orad[o] = 0.0f;
        opid[o] = -1;
      }
    }
    for (r += blockDim.x; r >= Ra; r -= Ra) ++j;
  }
}

}  // namespace gpe
