// Hand kernels of the Gauss-Seidel path past cap 256 or K 64 for Hopper
// (sm_90a): the rank and the color solve without a window.  They replace
// the same TPU kernels as gs_kernels.cuh's (K5, K5-par; K6, K6-par,
// K6-mx/dec, colors_mega) where those kernels' windows and register lists
// end.  A translation unit of their own (gs_simple.cu), so that the window
// kernels' machine code is the one it was before these existed.
#pragma once

#include "gs_kernels.cuh"

namespace gpe {

// ---------------------------------------------------------------------------
// Past cap 256 or K 64: the rank and the color solve without a window.
// ---------------------------------------------------------------------------
//
// The window kernels above stage a region's slots (and, in the rank's
// selection kernel, four-word member masks) in shared memory, which past
// cap 256 no region fits, and keep a cell's ranks in registers or a local
// array of kGsMaxK.  These kernels are the simplest that take any cap and K
// (their times: PERF.md); the launchers pick them past either limit
// (gs_simple).  The same tables, cells, pairs and f32 operations in the
// same order.

// K5 past cap 256 or K 64: gs_rank_list_kernel, a warp per cell.  The warp
// walks the cell's 9 tiles in the order j, each tile's slots in chunks of
// 32 lanes, tests every occupant as gs_rank_kernel does and compacts the
// members (pid, source code, radius) into its list in shared memory by
// ballot prefix counts.  A member's rank is the count of listed members
// with a smaller pid (pids are unique: the ranks are the ascending-pid
// order); a rank below K writes its table entry, lanes past the member
// count write the fill, and the count is the members'.  A cell with more
// members than the list holds ranks each member by counting over the
// cell's candidates again (the same test), a chunk of 32 at a time.
// kGsListThreads, kGsListCap and gs_list_bytes: csrc/gs_kernels.cuh.

// Cell i of a launch over the parities from l.p0 (FlatLayout: every
// cell), in full coordinates.
__device__ __forceinline__ void gs_list_cell(const FlatLayout& l, int i,
                                             int* ty, int* tx) {
  *ty = i / l.TX;
  *tx = i - *ty * l.TX;
}
__device__ __forceinline__ void gs_list_cell(const ParLayout& l, int i,
                                             int* ty, int* tx) {
  const int A = l.DY * l.DX, p = l.p0 + i / A, q = i - (i / A) * A;
  const int si = q / l.DX;
  *ty = 2 * si + (p >> 1) + l.o;
  *tx = 2 * (q - si * l.DX) + (p & 1) + l.o;
}

// Whether candidate (j, s) of cell (ty, tx) is a member (gs_rank_kernel's
// clip-and-distance test); its pid, source code and radius.
template <class L>
__device__ __forceinline__ bool gs_list_member(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ rad, const int* __restrict__ pid, int cap,
    const L& lay, int ty, int tx, int j, int s, float lox, float loy,
    float hix, float hiy, float r0, int* p, int* code, float* rr) {
  const int nty = ty + j / 3 - 1, ntx = tx + j % 3 - 1;
  if (s >= cap || nty < 0 || nty >= lay.TY || ntx < 0 || ntx >= lay.TX)
    return false;
  const int g = lay.at(s, cap, nty, ntx);
  *p = pid[g];
  if (*p < 0) return false;
  const float cx = x[g], cy = y[g];
  *rr = rad ? rad[g] : r0;
  *code = j * cap + s;
  const float px = fminf(fmaxf(cx, lox), hix);
  const float py = fminf(fmaxf(cy, loy), hiy);
  const float ddx = __fsub_rn(cx, px);
  const float ddy = __fsub_rn(cy, py);
  const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
  return d2 < __fmul_rn(*rr, *rr);
}

template <class L, bool MASK>
__global__ void __launch_bounds__(kGsListThreads) gs_rank_list_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ rad, const int* __restrict__ pid,
    int* __restrict__ src, int* __restrict__ rpid, float* __restrict__ rrad,
    int* __restrict__ count, int cap, L lay, int ncells, int K, float t,
    float r0) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  constexpr int NW = kGsListThreads / 32;
  extern __shared__ __align__(16) unsigned char list_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* lpid = reinterpret_cast<int*>(list_smem) + warp * kGsListCap;
  int* lcode = reinterpret_cast<int*>(list_smem) + (NW + warp) * kGsListCap;
  float* lrad = reinterpret_cast<float*>(list_smem) +
                (2 * NW + warp) * kGsListCap;
  const int TY = lay.TY, TX = lay.TX;
  for (int cell = blockIdx.x * NW + warp; cell < ncells;
       cell += gridDim.x * NW) {
    int ty, tx;
    gs_list_cell(lay, cell, &ty, &tx);
    const bool live =
        MASK ? (ty >= 1 && ty <= TY - 2 && tx >= 1 && tx <= TX - 2)
             : (ty >= 0 && ty < TY && tx >= 0 && tx < TX);
    const float lox = __fmul_rn((float)(tx - 1), t);
    const float loy = __fmul_rn((float)(ty - 1), t);
    const float hix = __fadd_rn(lox, t);
    const float hiy = __fadd_rn(loy, t);
    auto write = [&](int q, int code, int p, float rr) {
      const int o = lay.at(q, K, ty, tx);
      src[o] = code;
      rpid[o] = p;
      rrad[o] = rr;
    };
    int n = 0;  // the cell's members
    for (int j = 0; j < (live ? 9 : 0); ++j)
      for (int s0 = 0; s0 < cap; s0 += 32) {
        int p = 0, code = 0;
        float rr = 0.0f;
        const bool mem = gs_list_member(x, y, rad, pid, cap, lay, ty, tx, j,
                                        s0 + lane, lox, loy, hix, hiy, r0,
                                        &p, &code, &rr);
        const unsigned m = __ballot_sync(kAll, mem);
        const int pos = n + __popc(m & ((1u << lane) - 1u));
        if (mem && pos < kGsListCap) {
          lpid[pos] = p;
          lcode[pos] = code;
          lrad[pos] = rr;
        }
        n += __popc(m);
      }
    __syncwarp();
    if (n <= kGsListCap) {
      for (int i = lane; i < n; i += 32) {
        const int p = lpid[i];
        int q = 0;
        for (int u = 0; u < n; ++u) q += lpid[u] < p;
        if (q < K) write(q, lcode[i], p, lrad[i]);
      }
    } else {  // past the list: count over the candidates again
      for (int j = 0; j < 9; ++j)
        for (int s0 = 0; s0 < cap; s0 += 32) {
          int p = 0, code = 0;
          float rr = 0.0f;
          const bool mem = gs_list_member(x, y, rad, pid, cap, lay, ty, tx,
                                          j, s0 + lane, lox, loy, hix, hiy,
                                          r0, &p, &code, &rr);
          if (!__any_sync(kAll, mem)) continue;
          int q = 0;
          for (int j2 = 0; j2 < 9; ++j2)
            for (int u0 = 0; u0 < cap; u0 += 32) {
              int p2 = 0, c2 = 0;
              float r2 = 0.0f;
              const bool m2 = gs_list_member(x, y, rad, pid, cap, lay, ty, tx,
                                             j2, u0 + lane, lox, loy, hix,
                                             hiy, r0, &p2, &c2, &r2);
              const unsigned mm = __ballot_sync(kAll, m2);
              for (int b = 0; b < 32; ++b) {
                const int pb = __shfl_sync(kAll, p2, b);
                q += ((mm >> b) & 1u) && pb < p;
              }
            }
          if (mem && q < K) write(q, code, p, rr);
        }
    }
    for (int q = n + lane; q < K; q += 32) write(q, -1, kBigPid, 0.0f);
    if (lane == 0) count[lay.at(0, 1, ty, tx)] = n;
    __syncwarp();  // the list is written again by the next cell
  }
}

// K6 (every route) past cap 256 or K 64: the launcher copies x, y to the
// outputs, then runs one launch of gs_color_cells_kernel per color on them
// in place (cells of one color are particle-disjoint, so no slot has two
// writers in a launch, and a color reads the last one's results in stream
// order), then with integ gs_verlet_tail_kernel over every slot.  A thread
// per cell of the color runs gs_color_cell_deep's sweep on device memory:
// each rank's slot and radius read from the tables when it is used.
// Rank q of cell (ty, tx): its slot's storage offset and its radius.
template <class L>
__device__ __forceinline__ void gs_rank_slot(const GsWindowArgs& a,
                                             const L& lay, int ty, int tx,
                                             int q, int* g, float* r) {
  const int code = a.src[lay.at(q, a.K, ty, tx)];
  const int j = code / a.cap, s = code - j * a.cap;
  *g = lay.at(s, a.cap, ty + j / 3 - 1, tx + j % 3 - 1);
  *r = a.rrad ? a.rrad[lay.at(q, a.K, ty, tx)] : a.r0;
}

constexpr int kGsCellThreads = 128;

template <class L>
__global__ void __launch_bounds__(kGsCellThreads)
    gs_color_cells_kernel(GsWindowArgs a, L lay, int color) {
  const int TY = lay.TY, TX = lay.TX, K = a.K;
  const int pa = ((color - 1) >> 1) ^ 1, pb = ((color - 1) & 1) ^ 1;
  const int ny = TY > pa ? (TY - pa + 1) >> 1 : 0;
  const int nx = TX > pb ? (TX - pb + 1) >> 1 : 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ny * nx;
       i += gridDim.x * blockDim.x) {
    const int cy = i / nx;
    const int ty = pa + 2 * cy, tx = pb + 2 * (i - cy * nx);
    int nv = 0;  // the valid ranks are a prefix
    while (nv < K && a.src[lay.at(nv, K, ty, tx)] >= 0) ++nv;
    for (int p = 0; p < nv - 1; ++p) {
      int gp, gb;
      float rp, rb;
      gs_rank_slot(a, lay, ty, tx, p, &gp, &rp);
      float2 vp = make_float2(a.ox[gp], a.oy[gp]);
      for (int b = p + 1; b < nv; ++b) {
        gs_rank_slot(a, lay, ty, tx, b, &gb, &rb);
        float2 vb = make_float2(a.ox[gb], a.oy[gb]);
        const float dx = __fsub_rn(vp.x, vb.x);
        const float dy = __fsub_rn(vp.y, vb.y);
        const float dist =
            __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
        const float rsum = __fadd_rn(rp, rb);
        if (__fmul_rn(rsum, rsum) > __fmul_rn(dist, dist) &&
            dist > kGsMinDist) {
          const float safe = fmaxf(dist, kGsMinDist);
          const float pen = __fsub_rn(rsum, dist);
          const float cxp =
              __fmul_rn(__fmul_rn(__fdiv_rn(dx, safe), pen), a.stiffness);
          const float cyp =
              __fmul_rn(__fmul_rn(__fdiv_rn(dy, safe), pen), a.stiffness);
          const float rs = fmaxf(rsum, kGsMinDist);
          const float wa = __fdiv_rn(rb, rs);
          const float wb = __fdiv_rn(rp, rs);
          vp.x = __fadd_rn(vp.x, __fmul_rn(cxp, wa));
          vp.y = __fadd_rn(vp.y, __fmul_rn(cyp, wa));
          vb.x = __fsub_rn(vb.x, __fmul_rn(cxp, wb));
          vb.y = __fsub_rn(vb.y, __fmul_rn(cyp, wb));
          a.ox[gb] = vb.x;
          a.oy[gb] = vb.y;
        }
      }
      a.ox[gp] = vp.x;
      a.oy[gp] = vp.y;
    }
  }
}

// The Verlet tail of the window kernels' write phase, over every slot of
// the storage (any layout): an occupied slot's px, py take its position,
// which takes the step.
__global__ void __launch_bounds__(256)
    gs_verlet_tail_kernel(GsWindowArgs a, int slots) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < slots;
       i += gridDim.x * blockDim.x) {
    if (a.pid[i] < 0) continue;
    const float qx = a.px[i], qy = a.py[i];
    const float vx = a.ox[i], vy = a.oy[i];
    a.px[i] = vx;
    a.py[i] = vy;
    const float2 v = gs_verlet_slot(vx, vy, qx, qy, a.prm, a.vc);
    a.ox[i] = v.x;
    a.oy[i] = v.y;
  }
}

}  // namespace gpe
