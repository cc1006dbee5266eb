"""The Gauss-Seidel path's two hand kernels, their wrappers and the flat
driver (the counterpart of the flat layout of
``gpu_physics_engine_tpu.ops.gs_pallas``).  Their plain PyTorch versions,
``rank_plain`` and ``colors_plain``, are the plain GS solve's own
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
  Design: one block per 4 x 64 cells (4 x 32 past cap 32, with 64-bit
  slot masks; ``gs_rank_kernel`` in csrc/gs_kernels.cuh) stages the region and a one-tile ring in shared
  memory: each pid read once, and the occupants' x, y, radius, coalesced
  along tx, with a mask of the occupied slots per tile.  A thread per cell
  then walks only the occupied candidates of its 9 window tiles, tests
  them with the reference's strict circle-vs-box overlap and keeps the K
  smallest member pids in registers by insertion.  pids are unique, so
  the visiting order cannot change the tables, and gs_rank "minloop",
  "net" and "auto" all run this kernel.  The tables and the count are
  written by the same thread, a warp per 32 cells of a row, coalesced.
  Past K 16 (the list would not fit the registers) or cap 64 (the window
  grows with the cap, and nearly every staged slot is empty), the packed
  kernel ``gs_rank_pack_kernel`` (csrc/gs_simple.cuh; ``rank_kernel``
  names the route): a block counts its window's occupants from the pid
  plane a word of 32 slots at a time and packs them per tile in shared
  memory (K1's packed kernel's counting and scan, csrc/pack.cuh); a cell
  tests the 9 tiles' packed occupants and takes its ranks in rounds, each
  the smallest member pid not yet taken (a thread a cell in a sparse
  window, a warp a cell, each round a warp minimum, in a dense one),
  over the tables' fill written first in one coalesced pass; a window
  whose occupants pass the buffer streams from device memory.  The same
  tables.  Its times: PERF.md and ``utils/kernel_study.py --k5
  --gs-wide``.

K6 ``colors`` replaces ``gs_solve_pallas_flat`` (gs_pallas.py:543;
``_solve_kernel`` :390 with ``_sweep`` :77, and ``_apply_kernel`` :431).
  Bound: device memory, per solve.  The function reads each valid rank's
  source code and radius and its occupant's x, y, and writes the x, y of
  the occupants: at the 1M-GS shape [4, 960, 2773] with K = 8 about 3.6 M
  valid ranks (8 B each) and 1,048,576 occupants (16 B each), 0.046 GB,
  0.014 ms at 3.35 TB/s (``chip_smoke.py``'s ``bounds`` counts this run's
  data).
  Design: one launch of ``gs_colors_window_kernel`` on FlatLayout per
  solve, for colors 1..4 (csrc/gs_kernels.cuh).  A block stages x and y of
  every slot of its region (32 x 48 tiles at cap <= 4, down to 4 x 6 at
  caps 33-64) and an 8-tile halo
  in shared memory, runs the four colors there with a barrier between
  them (a thread per cell: its K source codes loaded as one batch, the
  sweep in registers with the __f*_rn intrinsics, written back to shared
  memory), and writes the region's slots to new planes.  Each color
  shrinks the part of the window that is right by two tiles a side, so
  the halo is recomputed by the neighbours and no grid synchronisation is
  needed; x and y are written out of place because the neighbours' halos
  read the region's inputs.  Cells of one color are particle-disjoint
  (cell edge >= 2 r_max), so every slot has at most one writer per color.
  The tables are read from device memory once, by the color that sweeps
  the cell.  Past cap 64 no whole-solve window fits a block, and past K
  16 a cell's ranks leave the registers: there (``color_kernel``)
  ``gs_colors_ranked_kernel`` (csrc/gs_simple.cuh) stages nothing.  x and
  y are copied to the outputs in 16-byte words, then a launch a color
  runs a thread a cell of the color on its ranked slots in place (n =
  min(count, K) from K5's count table; up to 8 ranks in registers, past
  that read from the tables as the sweep uses them), then, with the tail,
  a launch over every slot: the same cells, pairs and f32 order.  Its
  floor is the copy the out-of-place contract asks for (PERF.md;
  ``utils/kernel_study.py --k6 --gs-wide``).  The sweeps (the halo makes
  1.5x as many cells) and the copy of every empty slot set the window's
  time, not the bound's bytes.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.ops import _cuda
from gpu_physics_engine_torch.ops.gs_tiled import (  # the plain versions
    colors_plain, rank_plain, solve_frame)
from gpu_physics_engine_torch.ops.integrate import f32
from gpu_physics_engine_torch.ops.tiled import TileState, tile_geometry
from gpu_physics_engine_torch.ops.tiled_kernels import (SLOTS_LIMIT,
                                                        WIDE_CAP,
                                                        _check_cuda_state,
                                                        _ptrs, _stream,
                                                        cap_class,
                                                        mask_bytes)

LAUNCHES = {"gs_rank": 0, "gs_color": 0, "gs_rank_pack": 0,
            "gs_color_ranked": 0}

REG_K = 16  # up to this K the window kernels keep a cell's ranks in registers


def windowed(cap: int, K: int) -> bool:
    """Whether (cap, K) takes the window kernels (csrc/gs_kernels.cuh
    gs_windowed): caps up to WIDE_CAP and K up to REG_K.  Past either the
    packed rank and the ranked-slot solve (csrc/gs_simple.cuh)."""
    return cap <= WIDE_CAP and K <= REG_K


def rank_kernel(cap: int, K: int) -> str:
    """The kernel K5 (and K5-par) launches at (cap, K)."""
    return "gs_rank_kernel" if windowed(cap, K) else "gs_rank_pack_kernel"


def color_kernel(cap: int, K: int) -> str:
    """The kernel K6 (K6-par, K6-mx/dec, colors_mega) launches at (cap,
    K)."""
    return ("gs_colors_window_kernel" if windowed(cap, K)
            else "gs_colors_ranked_kernel")


# K5's window (csrc/gs_kernels.cuh kRankRows, rank_cols): a block ranks
# (rows, columns) full-space tiles on either layout (on the parity layout
# rows/2 x columns/2 cells of each sub-grid), RANK_REGIONS[cap_class(cap)]
RANK_REGIONS = ((4, 64), (4, 32))


def rank_region(cap: int):
    """The (rows, columns) region of K5's window at ``cap`` (up to
    WIDE_CAP)."""
    return RANK_REGIONS[cap_class(cap)]


# K6's window (csrc/gs_kernels.cuh gs_window_side, gs_window_bytes): the
# region (rows, columns) of full-space tiles a block owns, by the largest
# cap of its class
WINDOW_REGIONS = ((4, (32, 48)), (8, (32, 32)), (16, (8, 32)), (32, (8, 16)),
                  (WIDE_CAP, (4, 6)))


def window_region(cap: int):
    """The (rows, columns) region of K6's window at ``cap`` (None past
    WIDE_CAP: no window)."""
    return next((r for top, r in WINDOW_REGIONS if cap <= top), None)


def colors_window_bytes(cap: int, colors: int = 4, K: int = 8) -> int:
    """Shared memory of one K6 window block: x and y of every slot of the
    region and a halo of two tiles per color of the launch on every side;
    0 past WIDE_CAP or REG_K (the ranked-slot solve stages nothing)."""
    if not windowed(cap, K):
        return 0
    rows, cols = window_region(cap)
    return (rows + 4 * colors) * (cols + 4 * colors) * cap * 8


def rank_window_bytes(cap: int, uniform: bool, K: int = 8) -> int:
    """Shared memory of one K5 window block: per tile of the window (the
    region and a one-tile ring) cap slots of pid, x and y (and radius
    unless ``uniform``), and an occupancy mask; 0 past WIDE_CAP or REG_K
    (the packed kernel's plan is the library's own:
    ``gpe_gs_rank_pack_bytes``)."""
    if not windowed(cap, K):
        return 0
    rows, cols = rank_region(cap)
    return (rows + 2) * (cols + 2) * (cap * (12 if uniform else 16)
                                      + mask_bytes(cap))


def count_route(cap: int, K: int, color: bool) -> None:
    """Count a launch of the new kernels at (cap, K): K5's packed kernel
    (``color`` False) or K6's ranked-slot solve in ``LAUNCHES``, beside the
    wrapper's own count."""
    if not windowed(cap, K):
        LAUNCHES["gs_color_ranked" if color else "gs_rank_pack"] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_card_k(K: int, device, tiles: int = 1) -> None:
    """Refuse a max_occupancy that no table can hold: on a CUDA device a K
    below 1, or one whose ``tiles`` cells pass the int32 index (K x TY x
    TX < 2^31), raises ValueError naming the limit; on any other device
    every K passes.  TiledEngine calls it where the GS config is chosen,
    before any state exists."""
    if torch.device(device).type == "cuda" and (
            int(K) < 1 or int(K) * max(1, int(tiles)) >= SLOTS_LIMIT):
        raise ValueError(f"max_occupancy {K} outside 1 <= K and K x "
                         f"{max(1, int(tiles))} cells < 2^31: the GS "
                         "tables index as int32")


def _check_k(K: int, cap: int, what: str) -> None:
    if K < 1:
        raise ValueError(f"{what}: max_occupancy {K} below 1")
    if cap < 1:
        raise ValueError(f"{what}: tile_cap {cap} below 1")


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
    count_route(cap, K, color=False)
    return src, rpid, rrad, count


# ---------------------------------------------------------------------------
# K6: the four colors of a solve, one launch
# ---------------------------------------------------------------------------

def colors(x: torch.Tensor, y: torch.Tensor, src: torch.Tensor,
           rrad: torch.Tensor, config: SimConfig, c1: int = 4,
           count: Optional[torch.Tensor] = None):
    """Colors 1..c1 of one solve on x, y [cap, TY, TX]: every cell of each
    color sweeps its ranked occupants at their current positions.
    ``count``: K5's count table [TY, TX] beside the tables (the ranked-slot
    solve past the window reads each cell's rank count from it, and needs
    it).  Returns the new (x, y); x and y are not written."""
    if x.device.type == "cpu":
        return colors_plain(x, y, src, rrad, config, c1)
    return colors_cuda(x, y, src, rrad, config, c1, count)


def _check_color_args(x, y, src, rrad, K: int, count=None) -> None:
    cap, TY, TX = x.shape
    for name, a, dtype, shape in (
            ("x", x, torch.float32, (cap, TY, TX)),
            ("y", y, torch.float32, (cap, TY, TX)),
            ("src", src, torch.int32, (K, TY, TX)),
            ("rrad", rrad, torch.float32, (K, TY, TX)),
            ("count", count, torch.int32, (TY, TX))):
        if a is None:
            continue
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


def window_cuda(what: str, x, y, src, rrad, config: SimConfig, grid,
                c1: int, tail=None, consts=None, r0: float = 0.0,
                count=None):
    """One solve of K6 on checked CUDA tensors (the window kernel, or past
    it the ranked-slot solve: ``color_kernel``): colors 1..c1 of x, y,
    then with ``tail`` = (px, py, pid, prm) the Verlet step (``consts``:
    the host float[6] of ``gs_parity._verlet_consts``; px, py in place).
    ``grid`` = (TY, TX, DY, DX, origin, par) with par 0 for FlatLayout;
    ``rrad`` None: every valid rank has radius ``r0``; ``count``: K5's
    count table in the tables' layout, each cell's rank count, which the
    ranked-slot solve needs (the window kernel reads none: None there).
    Returns the new (x, y)."""
    cap, K = int(x.shape[-3]), config.max_occupancy
    if count is None and not windowed(cap, K):
        raise ValueError(f"{what}: past cap {WIDE_CAP} or K {REG_K} the "
                         "solve needs K5's count table (count=)")
    ox, oy = torch.empty_like(x), torch.empty_like(y)
    px = py = pid = prm = None
    if tail is not None:
        px, py, pid, prm = tail
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        rc = lib.gpe_gs_colors_window(
            *_ptrs(x, y), ptr(px), ptr(py), ptr(pid), src.data_ptr(),
            ptr(rrad), ptr(count), ptr(prm), *_ptrs(ox, oy), cap, *grid, K,
            int(c1), f32(r0), f32(config.stiffness), int(tail is not None),
            None if consts is None else consts.ctypes.data,
            _stream(x.device))
    _cuda.check(rc, what)
    count_route(cap, K, color=True)
    return ox, oy


def colors_cuda(x, y, src, rrad, config: SimConfig, c1: int = 4,
                count=None):
    """Launch K6 (colors 1..c1) on x's CUDA device."""
    if x.device.type != "cuda":
        raise RuntimeError(f"gs color: the CUDA kernel needs CUDA tensors, "
                           f"got {x.device}")
    cap, TY, TX = x.shape
    K = config.max_occupancy
    _check_k(K, cap, "gs color")
    _check_color_args(x, y, src, rrad, K, count)
    out = window_cuda("gs color", x, y, src, rrad, config,
                      (TY, TX, 0, 0, 0, 0), c1, count=count)
    LAUNCHES["gs_color"] += 1
    return out


# ---------------------------------------------------------------------------
# the flat driver
# ---------------------------------------------------------------------------

def gs_solve_flat(state: TileState, config: SimConfig) -> TileState:
    """One frame of the 4-color solve through the kernel wrappers."""
    return solve_frame(state, config, rank, colors)[0]
