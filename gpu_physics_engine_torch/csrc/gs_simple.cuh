// Hand kernels of the Gauss-Seidel path past the window kernels' classes
// (cap past 64 or K past 16) for Hopper (sm_90a): an occupant-packed rank
// and a solve on the ranked slots alone.  They replace the same TPU
// kernels as gs_kernels.cuh's, where those kernels' windows and register
// lists end:
//
// K5  gs_rank_pack_kernel replaces gpu_physics_engine_tpu/ops/gs_pallas.py
//     ::_rank_full (:467) and, on ParLayout, ops/gs_parity.py::rank_parity
//     (:275), "K5-par".
// K6  gs_colors_ranked_kernel replaces gs_pallas.py::gs_solve_pallas_flat
//     (:543) and, on ParLayout, the color passes of gs_solve_pallas_dec
//     (:783), gs_solve_pallas_mx (:1045), ops/gs_parity.py::solve_parity
//     (:433, with the Verlet half of _apply_integrate_dec_kernel :353) and
//     ops/gs_mega.py::colors_mega (:503).
//
// A translation unit of their own (gs_simple.cu), so that the window
// kernels' machine code is the one it was before these existed.  The
// same tables, cells, pairs and f32 operations in the same order as the
// window kernels and the plain versions: bit for bit.
#pragma once

#include "gs_kernels.cuh"
#include "pack.cuh"

namespace gpe {

// ---------------------------------------------------------------------------
// K5 past cap 64 or K 16: gs_rank_pack_kernel
// ---------------------------------------------------------------------------
//
// Bound: device memory.  The function reads the pid plane and the
// occupants' x, y (and radius), and writes the K-deep tables and the
// count: at GS-cap312 ([312, 480, 1388], K 8, 262,144 particles) the
// 831 MB pid plane is nearly all of it, 0.27 ms at 3.35 TB/s.  The
// window kernel's slot-per-thread staging does not scale past cap 64: its
// shared memory grows with the cap, and at the GS densities (0.4
// occupants a tile) nearly every staged slot is empty.
//
// One block of kGsPackThreads owns a region of kGsPackRY x kGsPackRX
// full-space tiles (on ParLayout 3 x 15 sub-grid cells of each parity,
// indexed in full space as gs_rank_kernel's) and its one-tile ring, the
// window, a thread a window tile:
//
//  1. count: each thread reads its tile's pid plane a word of 32 slots at
//     a time (pack_word: neighbouring threads on neighbouring tiles, on
//     ParLayout a warp in one parity class, so the reads coalesce) and
//     counts the occupants; a block scan (block_scan) gives each tile its
//     first packed index.  Both are K1's packed kernel's (csrc/pack.cuh).
//  2. pack: the same thread reads its words again and writes each
//     occupant's pid, slot, x, y (radius) to its tile's packed indices:
//     shared memory holds the window's occupants, not its slots.
//  3. rank the region cells of the launch's parities, each candidate (the
//     9 tiles' packed occupants in the order j) tested with
//     gs_rank_kernel's clip-and-distance test, one round per rank q <
//     min(members, K) taking the smallest member pid not yet taken (pids
//     are unique: the ranks are the ascending-pid order, as the plain
//     version's stable sort gives them), which writes rank q's entry (src
//     = j * cap + s, rpid, rrad).  In a window of at most kGsPackThreadMax
//     occupants (the GS densities: 0.4 a tile) a thread ranks a cell,
//     testing its few candidates again each round.  In a denser one a warp
//     ranks a cell: its lanes take the candidates, each lane's members a
//     bit in a 64-bit word (a buffer of kGsPackEntries = 64 x 32 occupants
//     at most), the member count the warp's sum, and a round the warp's
//     minimum of the lanes' smallest members, its lane writing the entry:
//     members x K / 32 pid reads a cell, not members^2.  Streaming such
//     windows instead took 17-61x as long (1.5-6 occupants a tile at cap
//     128: utils/kernel_study.py --k5 --gs-dense on an H100).
//  4. the count: the cell's thread (or its warp's lane 0) writes it.
//
// Before it, gs_rank_fill_kernel writes the fill entry (src -1, rpid
// kBigPid, rrad 0) over the whole of the three tables in 16-byte words,
// and the ranks are then written over it: at K 32 the tables are most of
// the bytes, and a fill written per region (rows of 30 cells, 15 on
// ParLayout) took the packed kernel past the sel kernel it replaced.
//
// A window whose occupants do not fit the buffer (a pile of full tiles at
// a wide cap) streams: each warp ranks its cells from device memory, the
// 9 x cap candidates of a cell counted once and then, per round, each
// lane's smallest untaken member pid (a pid at or below the last round's,
// or at or above the lane's best so far, skips the distance test).  No
// atomics, no carry between blocks; every table entry has one writer.
// MASK (the parity layouts): border and pad cells keep the fill tables
// and count 0.  rad == nullptr: every occupant has the uniform radius r0.
//
// The pid plane is read twice (count, then pack; the second read mostly
// from L2 at the GS caps) and once more for each block's ring: 1.42x
// at this region.  The region (a window of 8 x 32 tiles, one per thread)
// keeps the ring's overlap low and the rows' reads 128 bytes wide.
constexpr int kGsPackThreads = 256;
constexpr int kGsPackRY = 6;   // full-space tile rows of a region
constexpr int kGsPackRX = 30;  // full-space tile columns of a region
constexpr int kGsPackWY = kGsPackRY + 2, kGsPackWX = kGsPackRX + 2;
constexpr int kGsPackWT = kGsPackWY * kGsPackWX;  // window tiles
static_assert(kGsPackWT == kGsPackThreads, "a thread per window tile");
static_assert(kGsPackRY % 2 == 0 && kGsPackRX % 2 == 0,
              "regions need even sides");
// The buffer's occupants, at most: a lane's candidates of one cell fit its
// 64-bit member word.
constexpr int kGsPackEntries = 64 * 32;
// Up to this many occupants in a window a thread ranks a cell; past it a
// warp does.
constexpr int kGsPackThreadMax = 256;
// Header of the block's shared memory: per window tile its first packed
// index and count, and the scan's warp sums; 16-byte aligned.
__host__ __device__ constexpr int gs_pack_header() {
  return ((2 * kGsPackWT + kGsPackThreads / 32) * 4 + 15) / 16 * 16;
}
// A block's shared bytes with a buffer of `entries` occupants (pid, slot,
// x, y and, unless uniform, the radius).
__host__ __device__ constexpr int gs_pack_bytes(bool uniform, int entries) {
  return gs_pack_header() + entries * (uniform ? 16 : 20);
}
static_assert(gs_pack_bytes(false, kGsPackEntries) <= 48 * 1024,
              "the default plan needs no opt-in to shared memory");

// Region cell r of the launch's parities from l.p0 (FlatLayout: every
// cell), in region coordinates, and the number of them.
__device__ __forceinline__ void gs_pack_cell(const FlatLayout&, int r,
                                             int* ry, int* rx) {
  *ry = r / kGsPackRX;
  *rx = r - *ry * kGsPackRX;
}
__device__ __forceinline__ void gs_pack_cell(const ParLayout& l, int r,
                                             int* ry, int* rx) {
  constexpr int SX = kGsPackRX / 2, A = kGsPackRY / 2 * SX;
  const int pl = r / A, q = r - pl * A, p = l.p0 + pl;
  const int cy = q / SX;
  *ry = 2 * cy + (p >> 1);
  *rx = 2 * (q - cy * SX) + (p & 1);
}
__device__ __forceinline__ int gs_pack_cells(const FlatLayout&, int) {
  return kGsPackRY * kGsPackRX;
}
__device__ __forceinline__ int gs_pack_cells(const ParLayout&, int np) {
  return np * (kGsPackRY * kGsPackRX / 4);
}

// A candidate at (cx, cy) with radius rr is a member of the cell whose box
// is [lox, hix] x [loy, hiy]: gs_rank_kernel's test, operation for
// operation.
__device__ __forceinline__ bool gs_box_member(float cx, float cy, float rr,
                                              float lox, float loy,
                                              float hix, float hiy) {
  const float px = fminf(fmaxf(cx, lox), hix);
  const float py = fminf(fmaxf(cy, loy), hiy);
  const float ddx = __fsub_rn(cx, px);
  const float ddy = __fsub_rn(cy, py);
  const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
  return d2 < __fmul_rn(rr, rr);
}

// The cell's box: [lo, lo + t] per axis, tile (ty, tx) being reference
// cell (ty - 1, tx - 1).
struct GsBox {
  float lox, loy, hix, hiy;
};
__device__ __forceinline__ GsBox gs_cell_box(int ty, int tx, float t) {
  GsBox b;
  b.lox = __fmul_rn((float)(tx - 1), t);
  b.loy = __fmul_rn((float)(ty - 1), t);
  b.hix = __fadd_rn(b.lox, t);
  b.hiy = __fadd_rn(b.loy, t);
  return b;
}

// The window's packed occupants.
struct GsPacked {
  const int* off;     // [window tile] first packed index
  const int* cnt;     // [window tile] occupants
  const float2* xy;   // [entry]
  const int* pid;     // [entry]
  const int* slot;    // [entry]
  const float* rad;   // [entry]; nullptr: every occupant has radius r0
};

// Cell (ty, tx) at window tile wc from the packed occupants: its member
// count; writes its ranks q < min(members, K).  Every lane of the warp
// calls it.
template <class L>
__device__ __forceinline__ int gs_rank_cell_packed(
    const GsPacked& w, int wc, int cap, int K, const L& lay, int ty, int tx,
    const GsBox& box, float r0, int* __restrict__ src,
    int* __restrict__ rpid, float* __restrict__ rrad) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  // candidate e of tile j is entry base[j] + e - pre[j]
  int pre[9], base[9], E = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int t = wc + (j / 3 - 1) * kGsPackWX + (j % 3 - 1);
    pre[j] = E;
    base[j] = w.off[t];
    E += w.cnt[t];
  }
  auto locate = [&](int e, int* j) {
    int idx = base[0] + e, jj = 0;
#pragma unroll
    for (int u = 1; u < 9; ++u)
      if (e >= pre[u]) {  // the last tile whose first candidate is <= e
        jj = u;
        idx = base[u] + e - pre[u];
      }
    *j = jj;
    return idx;
  };
  unsigned long long mine = 0;  // bit i: candidate lane + 32 i is a member
  for (int i = 0, e = lane; e < E; ++i, e += 32) {
    int j;
    const int idx = locate(e, &j);
    const float2 c = w.xy[idx];
    if (gs_box_member(c.x, c.y, w.rad ? w.rad[idx] : r0, box.lox, box.loy,
                      box.hix, box.hiy))
      mine |= 1ull << i;
  }
  const int n = __reduce_add_sync(kAll, __popcll(mine));
  const int nq = min(n, K);
  for (int q = 0; q < nq; ++q) {
    int best = kBigPid, bi = 0;
    for (unsigned long long m = mine; m; m &= m - 1u) {
      const int i = __ffsll((long long)m) - 1;
      int j;
      const int p = w.pid[locate(lane + 32 * i, &j)];
      if (p < best) {
        best = p;
        bi = i;
      }
    }
    if (best == __reduce_min_sync(kAll, best)) {  // the one lane holding it
      int j;
      const int idx = locate(lane + 32 * bi, &j);
      const int o = lay.at(q, K, ty, tx);
      src[o] = j * cap + w.slot[idx];
      rpid[o] = best;
      rrad[o] = w.rad ? w.rad[idx] : r0;
      mine &= ~(1ull << bi);
    }
  }
  return n;
}

// Cell (ty, tx) from device memory (a window that overflows the buffer):
// its member count; writes its ranks q < min(members, K).  Every lane of
// the warp calls it.
template <class L>
__device__ __forceinline__ int gs_rank_cell_stream(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ rad, const int* __restrict__ pid, int cap,
    int K, const L& lay, int ty, int tx, const GsBox& box, float r0,
    int* __restrict__ src, int* __restrict__ rpid,
    float* __restrict__ rrad) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  // candidate e = j * cap + s: its storage offset, or -1 out of the grid
  auto at = [&](int e) {
    const int j = e / cap, s = e - j * cap;
    const int nty = ty + j / 3 - 1, ntx = tx + j % 3 - 1;
    return nty < 0 || nty >= lay.TY || ntx < 0 || ntx >= lay.TX
               ? -1
               : lay.at(s, cap, nty, ntx);
  };
  auto member = [&](int g) {
    return gs_box_member(x[g], y[g], rad ? rad[g] : r0, box.lox, box.loy,
                         box.hix, box.hiy);
  };
  int mine = 0;
  for (int e = lane; e < 9 * cap; e += 32) {
    const int g = at(e);
    mine += g >= 0 && pid[g] >= 0 && member(g);
  }
  const int n = __reduce_add_sync(kAll, mine);
  const int nq = min(n, K);
  int last = -1;  // the last round's pid: the ranks ascend
  for (int q = 0; q < nq; ++q) {
    int best = kBigPid, be = 0;
    for (int e = lane; e < 9 * cap; e += 32) {
      const int g = at(e);
      if (g < 0) continue;
      const int p = pid[g];
      if (p <= last || p >= best || !member(g)) continue;
      best = p;
      be = e;
    }
    last = __reduce_min_sync(kAll, best);
    if (best == last) {
      const int g = at(be);
      const int o = lay.at(q, K, ty, tx);
      src[o] = be;  // j * cap + s
      rpid[o] = best;
      rrad[o] = rad ? rad[g] : r0;
    }
  }
  return n;
}

// Cell (ty, tx) by one thread from the packed occupants: its member count;
// writes its ranks q < min(members, K), each the smallest member pid past
// the last (E x (min(members, K) + 1) tests for E candidates).
template <class L>
__device__ __forceinline__ int gs_rank_cell_thread(
    const GsPacked& w, int wc, int cap, int K, const L& lay, int ty, int tx,
    const GsBox& box, float r0, int* __restrict__ src,
    int* __restrict__ rpid, float* __restrict__ rrad) {
  auto member = [&](int idx) {
    const float2 c = w.xy[idx];
    return gs_box_member(c.x, c.y, w.rad ? w.rad[idx] : r0, box.lox,
                         box.loy, box.hix, box.hiy);
  };
  int n = 0;
  for (int j = 0; j < 9; ++j) {
    const int t = wc + (j / 3 - 1) * kGsPackWX + (j % 3 - 1);
    for (int idx = w.off[t]; idx < w.off[t] + w.cnt[t]; ++idx)
      n += member(idx);
  }
  int last = -1;
  for (int q = 0; q < min(n, K); ++q) {
    int best = kBigPid, bidx = 0, bj = 0;
    for (int j = 0; j < 9; ++j) {
      const int t = wc + (j / 3 - 1) * kGsPackWX + (j % 3 - 1);
      for (int idx = w.off[t]; idx < w.off[t] + w.cnt[t]; ++idx) {
        const int p = w.pid[idx];
        if (p > last && p < best && member(idx)) {
          best = p;
          bidx = idx;
          bj = j;
        }
      }
    }
    const int o = lay.at(q, K, ty, tx);
    src[o] = bj * cap + w.slot[bidx];
    rpid[o] = best;
    rrad[o] = w.rad ? w.rad[bidx] : r0;
    last = best;
  }
  return n;
}

template <class L, bool MASK>
__global__ void __launch_bounds__(kGsPackThreads) gs_rank_pack_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ rad, const int* __restrict__ pid,
    int* __restrict__ src, int* __restrict__ rpid, float* __restrict__ rrad,
    int* __restrict__ count, int cap, L lay, int np, int K, float t,
    float r0, int entries) {
  constexpr int T = kGsPackThreads, RY = kGsPackRY, RX = kGsPackRX;
  constexpr int WY = kGsPackWY, WX = kGsPackWX;
  extern __shared__ __align__(16) unsigned char gs_pack_smem[];
  int* off_w = reinterpret_cast<int*>(gs_pack_smem);  // [window]
  int* cnt_w = off_w + kGsPackWT;                     // [window]
  int* ws = cnt_w + kGsPackWT;  // [T / 32] the scan's warp sums
  float2* bxy = reinterpret_cast<float2*>(gs_pack_smem + gs_pack_header());
  int* bpid = reinterpret_cast<int*>(bxy + entries);
  int* bslot = bpid + entries;
  float* br = reinterpret_cast<float*>(bslot + entries);
  const int TY = lay.TY, TX = lay.TX, tid = threadIdx.x;
  int ty0, tx0;
  gs_region_origin<RY, RX>(lay, &ty0, &tx0);

  // 1. count: thread tid owns window tile (wy, wx)
  int wy, wx;
  gs_block_tile(lay, tid, WY, WX, &wy, &wx);
  const int oty = ty0 - 1 + wy, otx = tx0 - 1 + wx;
  const bool in = oty >= 0 && oty < TY && otx >= 0 && otx < TX;
  const int g0 = in ? lay.at(0, cap, oty, otx) : 0;
  const int plane = lay.plane();
  int n_own = 0;
  if (in)
    for (int k0 = 0; k0 < cap; k0 += 32)
      n_own += __popc(pack_word(pid, cap, plane, g0, k0));
  int total;
  const int first = block_scan(n_own, ws, &total);
  off_w[wy * WX + wx] = first;
  cnt_w[wy * WX + wx] = n_own;
  const bool packed = total <= entries;

  // 2. pack, ascending by slot
  if (packed)
    for (int k0 = 0, pos = first; pos < first + n_own; k0 += 32)
      for (unsigned m = pack_word(pid, cap, plane, g0, k0); m; m &= m - 1u) {
        const int k = k0 + __ffs((int)m) - 1;
        const int g = g0 + k * plane;
        bpid[pos] = pid[g];
        bslot[pos] = k;
        bxy[pos] = make_float2(x[g], y[g]);
        if (rad) br[pos] = rad[g];
        ++pos;
      }
  __syncthreads();

  // 3. rank the region cells of the launch's parities: a thread a cell in
  // a sparse window, else a warp a cell
  const GsPacked w{off_w, cnt_w, bxy, bpid, bslot, rad ? br : nullptr};
  const int lane = tid & 31, cells = gs_pack_cells(lay, np);
  if (packed && total <= kGsPackThreadMax) {
    for (int r = tid; r < cells; r += T) {
      int ry, rx;
      gs_pack_cell(lay, r, &ry, &rx);
      const int ty = ty0 + ry, tx = tx0 + rx;
      if (!rank_stored(lay, ty, tx)) continue;
      int n = 0;
      if (!MASK || (ty >= 1 && ty <= TY - 2 && tx >= 1 && tx <= TX - 2))
        n = gs_rank_cell_thread(w, (ry + 1) * WX + rx + 1, cap, K, lay, ty,
                                tx, gs_cell_box(ty, tx, t), r0, src, rpid,
                                rrad);
      count[lay.at(0, 1, ty, tx)] = n;
    }
  } else {
    for (int r = tid >> 5; r < cells; r += T / 32) {
      int ry, rx;
      gs_pack_cell(lay, r, &ry, &rx);
      const int ty = ty0 + ry, tx = tx0 + rx;
      if (!rank_stored(lay, ty, tx)) continue;
      int n = 0;
      if (!MASK || (ty >= 1 && ty <= TY - 2 && tx >= 1 && tx <= TX - 2)) {
        const GsBox box = gs_cell_box(ty, tx, t);
        n = packed ? gs_rank_cell_packed(w, (ry + 1) * WX + rx + 1, cap, K,
                                         lay, ty, tx, box, r0, src, rpid,
                                         rrad)
                   : gs_rank_cell_stream(x, y, rad, pid, cap, K, lay, ty,
                                         tx, box, r0, src, rpid, rrad);
      }
      if (lane == 0) count[lay.at(0, 1, ty, tx)] = n;
    }
  }
}

// The fill of every entry of the three tables (src -1, rpid kBigPid, rrad
// 0), `n` words a table, in 16-byte words where `vec` says the tables are
// aligned: the packed kernel then writes only the ranks over it.
__global__ void __launch_bounds__(256) gs_rank_fill_kernel(
    int* __restrict__ src, int* __restrict__ rpid, float* __restrict__ rrad,
    int n, int vec) {
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  int done = 0;
  if (vec) {
    const int n4 = n >> 2;
    for (int i = i0; i < n4; i += stride) {
      reinterpret_cast<int4*>(src)[i] = make_int4(-1, -1, -1, -1);
      reinterpret_cast<int4*>(rpid)[i] =
          make_int4(kBigPid, kBigPid, kBigPid, kBigPid);
      reinterpret_cast<float4*>(rrad)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    done = n4 << 2;
  }
  for (int i = done + i0; i < n; i += stride) {
    src[i] = -1;
    rpid[i] = kBigPid;
    rrad[i] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// K6 past cap 64 or K 16: gs_colors_ranked_kernel
// ---------------------------------------------------------------------------
//
// Bound: device memory.  The colors read each valid rank's code (and
// radius) and its occupant's x, y, and write the occupants' x, y: at
// GS-cap128 (262,144 particles) 0.003 ms at 3.35 TB/s.  The out-of-place
// contract (x and y are not written: the solve returns new planes) adds
// the copy of every slot, x and y read and ox, oy written, 16 bytes a
// slot: 0.41 ms at GS-cap128 [128, 480, 1388], 0.99 ms at cap 312.  The
// Verlet tail reads the pid plane and rewrites the occupied slots.
//
// The solve runs in phases: the copy, colors 1 .. c1, and with integ the
// tail.
//
//  * copy: x, y to ox, oy in a grid-stride pass of 16-byte loads and
//    stores (4-byte ones where a plane is not 16-byte aligned).
//  * color c: a thread per cell of the color; it takes n = min(count, K)
//    from K5's count table (the valid ranks are its first n) and is done
//    at n < 2.  Up to kGsRankedRegK ranks it loads the ranks'
//    codes and radii and their slots' x, y as one batch into registers,
//    sweeps there (gs_color_cell's unrolled pairs, the warp leaving at its
//    largest n) and writes the slots back; past that it reads each rank's
//    slot and radius from the tables as the sweep uses them and its
//    position from ox, oy (gs_rank_slot), the plain version's read and
//    write order.  Cells of one color are particle-disjoint, so no slot
//    has two writers in a color; a color reads the last one's writes.
//  * tail: a thread per slot; an occupied slot's px, py take its position,
//    which takes the step (gs_verlet_slot).
//
// The window kernels stage every slot of a region and a halo in shared
// memory; past cap 64 that is a few tiles of mostly empty slots a block,
// and only a color's cells in it have work.  Here the colors touch only
// the ranked slots, and the copy runs at the copy's own rate.  Each phase
// is a launch of its own instantiation in stream order: one cooperative
// launch with grid barriers between the phases took up to 46% longer (its
// grid held to the colors' occupancy, 106 registers; as long at K 32,
// cap 16, flat), and 16 ranks in registers 1-11% longer than 8
// (utils/kernel_study.py --gs-wide on an H100; PERF.md).
constexpr int kGsRankedThreads = 256;
constexpr int kGsRankedRegK = 8;  // ranks a cell keeps in registers
constexpr int kGsPhaseCopy = 0;   // phases: 0 the copy, 1-4 the colors,
constexpr int kGsPhaseTail = 5;   // 5 the tail
// What an instantiation runs: the copy, a color or the tail, a launch
// each, each with its own registers.
enum GsRankedMode { kGsRankedCopy, kGsRankedColor, kGsRankedTail };

// Rank q of cell (ty, tx): its slot's storage offset and its radius.
template <class L>
__device__ __forceinline__ void gs_rank_slot(const GsWindowArgs& a,
                                             const L& lay, int ty, int tx,
                                             int q, int* g, float* r) {
  const int code = __ldg(a.src + lay.at(q, a.K, ty, tx));
  const int j = code / a.cap, s = code - j * a.cap;
  *g = lay.at(s, a.cap, ty + j / 3 - 1, tx + j % 3 - 1);
  *r = a.rrad ? __ldg(a.rrad + lay.at(q, a.K, ty, tx)) : a.r0;
}

// The pair (p, b) at (xp, yp), (xb, yb) with radii rp, rb: _sweep's f32
// operations in its order; moves both where they overlap.
__device__ __forceinline__ void gs_pair(float& xp, float& yp, float& xb,
                                        float& yb, float rp, float rb,
                                        float stiffness) {
  const float dx = __fsub_rn(xp, xb);
  const float dy = __fsub_rn(yp, yb);
  const float dist =
      __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float rsum = __fadd_rn(rp, rb);
  if (__fmul_rn(rsum, rsum) > __fmul_rn(dist, dist) && dist > kGsMinDist) {
    const float safe = fmaxf(dist, kGsMinDist);
    const float pen = __fsub_rn(rsum, dist);
    const float cxp = __fmul_rn(__fmul_rn(__fdiv_rn(dx, safe), pen),
                                stiffness);
    const float cyp = __fmul_rn(__fmul_rn(__fdiv_rn(dy, safe), pen),
                                stiffness);
    const float rs = fmaxf(rsum, kGsMinDist);
    const float wa = __fdiv_rn(rb, rs);
    const float wb = __fdiv_rn(rp, rs);
    xp = __fadd_rn(xp, __fmul_rn(cxp, wa));
    yp = __fadd_rn(yp, __fmul_rn(cyp, wa));
    xb = __fsub_rn(xb, __fmul_rn(cxp, wb));
    yb = __fsub_rn(yb, __fmul_rn(cyp, wb));
  }
}

// Cell (ty, tx) of a color with n (2 .. kGsRankedRegK) valid ranks, in
// registers.
template <class L>
__device__ __forceinline__ void gs_ranked_cell_regs(const GsWindowArgs& a,
                                                    const L& lay, int ty,
                                                    int tx, int n) {
  constexpr int KMAX = kGsRankedRegK;
  int g[KMAX];
  float lx[KMAX], ly[KMAX], lr[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    g[q] = 0;
    lx[q] = ly[q] = lr[q] = 0.0f;
    if (q < n) {
      gs_rank_slot(a, lay, ty, tx, q, &g[q], &lr[q]);
      lx[q] = a.ox[g[q]];  // not __ldg: earlier colors wrote them
      ly[q] = a.oy[g[q]];
    }
  }
  // the warp's largest n: the pairs past it are skipped by a branch the
  // whole warp takes (a lane still sweeps only its own b < n)
  const int nw = __reduce_max_sync(__activemask(), n);
#pragma unroll
  for (int p = 0; p < KMAX - 1; ++p) {
    if (p + 1 >= nw) break;
#pragma unroll
    for (int b = p + 1; b < KMAX; ++b) {
      if (b >= nw) break;
      if (b < n) gs_pair(lx[p], ly[p], lx[b], ly[b], lr[p], lr[b],
                         a.stiffness);
    }
  }
#pragma unroll
  for (int q = 0; q < KMAX; ++q)
    if (q < n) {
      a.ox[g[q]] = lx[q];
      a.oy[g[q]] = ly[q];
    }
}

// Cell (ty, tx) of a color with n > kGsRankedRegK valid ranks: rank p in
// registers while it meets ranks p + 1 .. n - 1 in device memory.
template <class L>
__device__ __forceinline__ void gs_ranked_cell_deep(const GsWindowArgs& a,
                                                    const L& lay, int ty,
                                                    int tx, int n) {
  for (int p = 0; p < n - 1; ++p) {
    int gp, gb;
    float rp, rb;
    gs_rank_slot(a, lay, ty, tx, p, &gp, &rp);
    float xp = a.ox[gp], yp = a.oy[gp];
    for (int b = p + 1; b < n; ++b) {
      gs_rank_slot(a, lay, ty, tx, b, &gb, &rb);
      float xb = a.ox[gb], yb = a.oy[gb];
      gs_pair(xp, yp, xb, yb, rp, rb, a.stiffness);
      a.ox[gb] = xb;  // unchanged where the pair does not overlap
      a.oy[gb] = yb;
    }
    a.ox[gp] = xp;
    a.oy[gp] = yp;
  }
}

template <class L>
__device__ __forceinline__ void gs_ranked_color(const GsWindowArgs& a,
                                                const int* __restrict__ count,
                                                const L& lay, int color) {
  const int TY = lay.TY, TX = lay.TX, K = a.K;
  // color c = 1 + ((tx-1)&1) + 2*((ty-1)&1): its rows' (columns') parity
  const int pa = ((color - 1) >> 1) ^ 1, pb = ((color - 1) & 1) ^ 1;
  const int ny = TY > pa ? (TY - pa + 1) >> 1 : 0;
  const int nx = TX > pb ? (TX - pb + 1) >> 1 : 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < ny * nx;
       i += gridDim.x * blockDim.x) {
    const int cy = i / nx;
    const int ty = pa + 2 * cy, tx = pb + 2 * (i - cy * nx);
    const int n = min(__ldg(count + lay.at(0, 1, ty, tx)), K);
    if (n < 2) continue;  // no pair: the members stay where they are
    if (n <= kGsRankedRegK)
      gs_ranked_cell_regs(a, lay, ty, tx, n);
    else
      gs_ranked_cell_deep(a, lay, ty, tx, n);
  }
}

// Phase `phase` (kGsPhaseCopy, a color 1-4 or kGsPhaseTail) of MODE over
// `slots` storage slots.  vec: bit 0 x, y, ox and oy are 16-byte aligned,
// bit 1 the pid plane is.
template <class L, int MODE>
__global__ void __launch_bounds__(kGsRankedThreads) gs_colors_ranked_kernel(
    GsWindowArgs a, const int* __restrict__ count, L lay, int phase,
    int slots, int vec) {
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  if (MODE == kGsRankedCopy) {
    int done = 0;
    if (vec & 1) {
      const int n4 = slots >> 2;
      const float4* x4 = reinterpret_cast<const float4*>(a.x);
      const float4* y4 = reinterpret_cast<const float4*>(a.y);
      float4* ox4 = reinterpret_cast<float4*>(a.ox);
      float4* oy4 = reinterpret_cast<float4*>(a.oy);
      for (int i = i0; i < n4; i += stride) {
        const float4 vx = __ldg(x4 + i), vy = __ldg(y4 + i);
        ox4[i] = vx;
        oy4[i] = vy;
      }
      done = n4 << 2;
    }
    for (int i = done + i0; i < slots; i += stride) {
      a.ox[i] = __ldg(a.x + i);
      a.oy[i] = __ldg(a.y + i);
    }
  } else if (MODE == kGsRankedTail) {
    // the pid plane in 16-byte words (where it is aligned), the occupied
    // slots one by one: about one slot in 300 at the GS caps
    auto step = [&](int i) {
      const float qx = a.px[i], qy = a.py[i];
      const float vx = a.ox[i], vy = a.oy[i];
      a.px[i] = vx;
      a.py[i] = vy;
      const float2 v = gs_verlet_slot(vx, vy, qx, qy, a.prm, a.vc);
      a.ox[i] = v.x;
      a.oy[i] = v.y;
    };
    int done = 0;
    if (vec & 2) {
      const int n4 = slots >> 2;
      const int4* p4 = reinterpret_cast<const int4*>(a.pid);
      for (int i = i0; i < n4; i += stride) {
        const int4 p = __ldg(p4 + i);
        if (p.x >= 0) step(4 * i);
        if (p.y >= 0) step(4 * i + 1);
        if (p.z >= 0) step(4 * i + 2);
        if (p.w >= 0) step(4 * i + 3);
      }
      done = n4 << 2;
    }
    for (int i = done + i0; i < slots; i += stride)
      if (__ldg(a.pid + i) >= 0) step(i);
  } else {
    gs_ranked_color(a, count, lay, phase);
  }
}

}  // namespace gpe
