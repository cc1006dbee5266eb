// Storage layouts of the tile fields, for the kernels templated on them
// (csrc/tiled_kernels.cuh, csrc/gs_kernels.cuh), and the limits their
// launchers share.
//
// A layout maps (plane s of C, full tile (ty, tx)) to a storage offset.
// The sweeps, the rank selection and the relocate matching then exist once
// and run on either:
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

#include <cuda_runtime.h>

namespace gpe {

constexpr int kMaxCap = 32;  // slots of a tile: per-tile slot masks are 32 bits
constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block, sm_90

// Raise a kernel's limit of dynamic shared memory where a launch needs
// more than the default 48 KB.  The launchers call it before every such
// launch; a size the card cannot give is refused here, and the error
// returns to the caller.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

struct FlatLayout {
  int TY, TX;

  __device__ __forceinline__ int at(int s, int C, int ty, int tx) const {
    (void)C;  // every plane has the same stride
    return (s * TY + ty) * TX + tx;
  }
  // the storage offset from plane s to s + 1
  __device__ __forceinline__ int plane() const { return TY * TX; }
};

struct ParLayout {
  int TY, TX, DY, DX;
  int o;   // origin: 0 (mx/par) or -1 (dec)
  int p0;  // K5-par: the launch's first parity; it covers every cell from
           // there

  // (ty - o, tx - o) >= 0 for every in-grid tile and every pad cell
  __device__ __forceinline__ int at(int s, int C, int ty, int tx) const {
    const int q = ty - o;
    const int r = tx - o;
    const int p = ((q & 1) << 1) | (r & 1);
    return ((p * C + s) * DY + (q >> 1)) * DX + (r >> 1);
  }
  // the storage offset from plane s to s + 1 (within one parity)
  __device__ __forceinline__ int plane() const { return DY * DX; }
};

}  // namespace gpe
