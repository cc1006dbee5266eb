"""The Gauss-Seidel path's two hand kernels, their wrappers and the flat
driver (the counterpart of the flat layout of
``gpu_physics_engine_tpu.ops.gs_pallas``).  Their plain PyTorch versions,
``rank_plain`` and ``color_plain_``, are the plain GS solve's own
(ops/gs_tiled) and are imported here.

Each wrapper launches its CUDA kernel (csrc/gs_kernels.cuh) for a CUDA
tensor, runs the plain version for a CPU tensor, and raises for anything
else; there is no fallback from a CUDA tensor to the plain version.  A
wrapper adds one to ``LAUNCHES[name]`` each time it launches its kernel.

K5 ``rank`` replaces ``_rank_full``
(gpu_physics_engine_tpu/ops/gs_pallas.py:467; kernels ``_rank_kernel``
:219 and ``_rank_kernel_net`` :362).
  Bound: device memory.  The function reads the pid plane and the
  occupied slots' x, y and radius (an empty slot is no candidate), and
  writes three K-deep rank planes and the count: at the 1M-GS shape
  [4, 960, 2773] with K = 8 and 1,048,576 particles that is 0.055 GB read
  and 0.27 GB written, 0.096 ms at 3.35 TB/s (0.130 counting every slot's
  four fields).  Its arithmetic (a box clip and a distance per candidate)
  is far below the card's f32 rate.
  Design: one block per 4 x 64 cells (``gs_rank_kernel`` in
  csrc/gs_kernels.cuh) stages the region and a one-tile ring in shared
  memory: each pid read once, and the occupants' x, y, radius, coalesced
  along tx, with a mask of the occupied slots per tile.  A thread per cell
  then walks only the occupied candidates of its 9 window tiles, tests
  them with the reference's strict circle-vs-box overlap and keeps the K
  smallest member pids in registers by insertion.  pids are unique, so
  the visiting order cannot change the tables, and gs_rank "minloop",
  "net" and "auto" all run this kernel.  The tables and the count are
  written by the same thread, a warp per 32 cells of a row, coalesced.
  Its times: PERF.md and ``utils/kernel_study.py --k5``.

K6 ``color_`` replaces ``gs_solve_pallas_flat`` (gs_pallas.py:543;
``_solve_kernel`` :390 with ``_sweep`` :77, and ``_apply_kernel`` :431).
  Bound: per launch, the active quarter's rank entries (source code and
  radius) and its occupants' x, y, read once and written once: about 0.1 GB
  per launch at the 1M-GS shape, 0.03 ms.  The sweep itself is a chain of
  dependent f32 operations per cell (up to K(K-1)/2 pairs, each with an
  IEEE sqrt and four IEEE divisions), so latency, not bytes, sets the
  kernel's time.
  Design: one launch per color over that color's cells only (a quarter of
  the grid).  Each thread loads its <= K occupants' current x, y straight
  from their source slots (the TPU's 36-way select exists only because
  Mosaic has no dynamic indexing), runs the sweep in registers with the
  __f*_rn intrinsics (no FMA contraction, IEEE division and sqrt), and
  writes each updated position back to its source slot, in place.  Cells
  of one color are particle-disjoint (cell edge >= 2 r_max), so every slot
  has at most one writer per launch and no cell reads a slot that another
  cell writes: race-free and deterministic.  This one kernel replaces the
  TPU's solve + pid-matched pull-apply pair.  The driver copies x and y
  once per frame, so the caller's state is never written.
"""

from __future__ import annotations

import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.ops import _cuda
from gpu_physics_engine_torch.ops.gs_tiled import (  # the plain versions
    color_plain_, rank_plain, solve_frame)
from gpu_physics_engine_torch.ops.integrate import f32
from gpu_physics_engine_torch.ops.tiled import TileState, tile_geometry
from gpu_physics_engine_torch.ops.tiled_kernels import (MAX_CAP,
                                                        _check_cuda_state,
                                                        _ptrs, _stream)

LAUNCHES = {"gs_rank": 0, "gs_color": 0}

MAX_K = 16  # the kernels keep K occupants per cell in registers

# K5's window (csrc/gs_kernels.cuh kRankRows, kRankCols,
# rank_window_bytes): a block ranks RANK_REGION = (rows, columns)
# full-space tiles on either layout (on the parity layout rows/2 x
# columns/2 cells of each sub-grid)
RANK_REGION = (4, 64)


def rank_window_bytes(cap: int, uniform: bool) -> int:
    """Shared memory of one K5 block: per tile of the window (the region
    and a one-tile ring) cap slots of pid, x and y (and radius unless
    ``uniform``), and an occupancy mask."""
    rows, cols = RANK_REGION
    return (rows + 2) * (cols + 2) * (cap * (12 if uniform else 16) + 4)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_k(K: int, cap: int, what: str) -> None:
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{what}: max_occupancy {K} outside 1..{MAX_K}")
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"{what}: tile_cap {cap} outside 1..{MAX_CAP}")


# ---------------------------------------------------------------------------
# K5: rank (once per frame)
# ---------------------------------------------------------------------------

def rank(state: TileState, config: SimConfig):
    """Frozen rank tables of the frame: (src, rpid, rrad, count), with src
    i32 [K, TY, TX] the source code j*cap + s of each rank (or -1), rpid
    its pid (or INT32_MAX), rrad its radius (or 0), count i32 [TY, TX]
    the number of members (past K too)."""
    if state.device.type == "cpu":
        return rank_plain(state, config)
    return rank_cuda(state, config)


def rank_cuda(state: TileState, config: SimConfig):
    """Launch K5 on the state's CUDA device."""
    _check_cuda_state(state, "gs rank")
    cap, TY, TX = state.dims
    K = config.max_occupancy
    _check_k(K, cap, "gs rank")
    dev = state.device
    src = torch.empty((K, TY, TX), dtype=torch.int32, device=dev)
    rpid = torch.empty_like(src)
    rrad = torch.empty((K, TY, TX), dtype=torch.float32, device=dev)
    count = torch.empty((TY, TX), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.gpe_gs_rank(
            *_ptrs(state.x, state.y, state.radius, state.pid, src, rpid,
                   rrad, count),
            cap, TY, TX, K, f32(tile_geometry(config)[0]), _stream(dev))
    _cuda.check(rc, "gs rank")
    LAUNCHES["gs_rank"] += 1
    return src, rpid, rrad, count


# ---------------------------------------------------------------------------
# K6: one color pass (four per frame)
# ---------------------------------------------------------------------------

def color_(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
           rrad: torch.Tensor, config: SimConfig, color: int) -> None:
    """Color pass ``color`` (1..4) in place on x, y [cap, TY, TX]: every
    cell of that color sweeps its ranked occupants at their current
    positions and writes them back to their source slots."""
    if x.device.type == "cpu":
        return color_plain_(x, y, src, rrad, config, color)
    return color_cuda_(x, y, src, rrad, config, color)


def _check_color_args(x, y, src, rrad, K: int) -> None:
    cap, TY, TX = x.shape
    for name, a, dtype, shape in (
            ("x", x, torch.float32, (cap, TY, TX)),
            ("y", y, torch.float32, (cap, TY, TX)),
            ("src", src, torch.int32, (K, TY, TX)),
            ("rrad", rrad, torch.float32, (K, TY, TX))):
        if a.device.type != "cuda" or a.device != x.device:
            raise RuntimeError(f"gs color: {name} must be a CUDA tensor on "
                               f"{x.device}, got {a.device}")
        if a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"gs color: {name} must be contiguous {dtype} "
                             f"{list(shape)}, got {a.dtype} "
                             f"{list(a.shape)}")
    if max(cap, K) * TY * TX >= 2 ** 31:
        raise ValueError(f"gs color: {cap}x{TY}x{TX} overflows int32")


def color_cuda_(x, y, src, rrad, config: SimConfig, color: int) -> None:
    """Launch K6 for one color on x's CUDA device."""
    if x.device.type != "cuda":
        raise RuntimeError(f"gs color: the CUDA kernel needs CUDA tensors, "
                           f"got {x.device}")
    cap, TY, TX = x.shape
    K = config.max_occupancy
    _check_k(K, cap, "gs color")
    _check_color_args(x, y, src, rrad, K)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        rc = lib.gpe_gs_color(*_ptrs(x, y, src, rrad), cap, TY, TX, K,
                              int(color), f32(config.stiffness),
                              _stream(x.device))
    _cuda.check(rc, "gs color")
    LAUNCHES["gs_color"] += 1


# ---------------------------------------------------------------------------
# the flat driver
# ---------------------------------------------------------------------------

def gs_solve_flat(state: TileState, config: SimConfig) -> TileState:
    """One frame of the 4-color solve through the kernel wrappers."""
    return solve_frame(state, config, rank, color_)[0]
