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
#include <stdint.h>

namespace gpe {

// Slots of a tile.  The mask kernels keep a mask of a tile's slots in one
// word, a template parameter: 32 bits (unsigned) up to cap 32 (kNarrowCap),
// 64 bits (Mask64) for caps 33-64 (kWideCap), each its own instantiation.
// Past cap 64 K1, the relocate window and the GS kernels keep no mask as
// wide as the cap (csrc/tiled_kernels.cuh, csrc/gs_simple.cuh): no kernel
// has a largest cap.
using Mask64 = unsigned long long;
constexpr int kWideCap = 64;
constexpr int kNarrowCap = 32;
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

// The mask word's operations for every width (Mask64 is unsigned long
// long, the type of the 64-bit atomics): the lowest set bit's index and
// the number of set bits.
__device__ __forceinline__ int mask_low(unsigned m) {
  return __ffs((int)m) - 1;
}
__device__ __forceinline__ int mask_low(unsigned long long m) {
  return __ffsll((long long)m) - 1;
}
__device__ __forceinline__ int mask_count(unsigned m) { return __popc(m); }
__device__ __forceinline__ int mask_count(unsigned long long m) {
  return __popcll(m);
}
// The width class of a mask type (0: 32 bits, 1: 64) and of a cap (2:
// past 64, no mask): the kernels pick their regions by it.
template <class M>
__host__ __device__ constexpr int mask_class() {
  return sizeof(M) == 4 ? 0 : 1;
}
__host__ __device__ constexpr int cap_class(int cap) {
  return cap <= kNarrowCap ? 0 : cap <= kWideCap ? 1 : 2;
}
// Bits a slot index takes in a packed (index << bits | slot) code.
template <class M>
__host__ __device__ constexpr int slot_bits() {
  return sizeof(M) == 4 ? 5 : 6;
}
// The mask word's bytes at cap, as the launches size shared memory.
__host__ __device__ constexpr int mask_bytes(int cap) {
  return cap > kWideCap ? 32 : cap > kNarrowCap ? 8 : 4;
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
