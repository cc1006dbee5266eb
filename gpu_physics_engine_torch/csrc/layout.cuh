// Storage layouts of the tile fields, for the kernels templated on them
// (csrc/tiled_kernels.cuh, csrc/gs_kernels.cuh).
//
// A layout maps (plane s of C, full tile (ty, tx)) to a storage offset, and
// thread i of a launch to the full tile it works on.  The sweeps, the rank
// selection and the relocate matching then exist once and run on either:
//
//   FlatLayout  slot-major [C, TY, TX] (the persistent tile storage);
//   ParLayout   four parity sub-grids, parity-major [4, C, DY, DX]: full
//               tile (ty, tx) is cell (si, sj) of parity p = 2*pa + pb with
//               ty = 2*si + pa + o and tx = 2*sj + pb + o.  Origin o = 0 is
//               the mx/par convention (parity = full-space parity), o = -1
//               the dec one (parity of the interior index ty - 1).  Sub-grid
//               cells whose full tile lies outside [0, TY) x [0, TX) are pad
//               cells; they hold empty slots.
//
// A full-space neighbour at offset (dy, dx) of a parity-(pa, pb) tile lies
// in parity ((pa + dy) & 1, (pb + dx) & 1); ParLayout::at computes that
// parity and the sub-grid cell from the neighbour's full coordinates, so
// callers only ever add offsets in full space.
#pragma once

namespace gpe {

struct FlatLayout {
  int TY, TX;
  // this launch's cells: (ty0 + step*cy, tx0 + step*cx), cx < W
  int ty0, tx0, step, W;

  __device__ __forceinline__ void cell(int i, int* ty, int* tx) const {
    const int cy = i / W;
    *ty = ty0 + step * cy;
    *tx = tx0 + step * (i - cy * W);
  }
  __device__ __forceinline__ int at(int s, int C, int ty, int tx) const {
    (void)C;  // every plane has the same stride
    return (s * TY + ty) * TX + tx;
  }
};

struct ParLayout {
  int TY, TX, DY, DX;
  int o;   // origin: 0 (mx/par) or -1 (dec)
  int p0;  // this launch's first parity; it covers every cell from there

  __device__ __forceinline__ void cell(int i, int* ty, int* tx) const {
    const int A = DY * DX;
    const int pl = i / A;
    const int r = i - pl * A;
    const int si = r / DX;
    const int p = p0 + pl;
    *ty = 2 * si + (p >> 1) + o;
    *tx = 2 * (r - si * DX) + (p & 1) + o;
  }
  // (ty - o, tx - o) >= 0 for every in-grid tile and every pad cell
  __device__ __forceinline__ int at(int s, int C, int ty, int tx) const {
    const int q = ty - o;
    const int r = tx - o;
    const int p = ((q & 1) << 1) | (r & 1);
    return ((p * C + s) * DY + (q >> 1)) * DX + (r >> 1);
  }
};

}  // namespace gpe
