"""The tiled pipeline's hand kernels K1-K3, their wrappers and their plain
PyTorch versions (the counterpart of ``gpu_physics_engine_tpu.ops.tiled_pallas``).

Each wrapper launches its CUDA kernel (csrc/tiled_kernels.cuh) for a CUDA
tensor, runs the plain version for a CPU tensor, and raises for anything
else; there is no fallback from a CUDA tensor to the plain version.  A
wrapper adds one to ``LAUNCHES[name]`` each time it launches its kernel,
so a run can show that it went through the kernels.

K1 ``collide_integrate`` replaces ``collide_integrate_pallas``
(gpu_physics_engine_tpu/ops/tiled_pallas.py:524).
  Bound: device memory.  At the 4M shape [8, 640, 1850] the function reads
  x, y, px, py, pid and writes x, y, px, py: 0.34 GB, 0.10 ms at 3.35
  TB/s.  Read from device memory by a thread per (slot, tile), the 9 x CAP
  candidates would cost ~8 GB of L1/L2 traffic for that.
  Design: one block per 8 x 32 tiles (4 x 16 past cap 32, where the slot
  masks are 64-bit words) stages its region and a one-tile ring in shared
  memory (each plane read once, coalesced), deals its occupied particles
  to its threads, and each particle gathers its own half of every pair
  from shared memory in the plain version's order (dy, dx, k), so it owns
  its output and equals the plain version bit for bit: no atomics, no
  carry between blocks (the TPU Newton form's band-seam carry needs
  sequential grid steps, which CUDA blocks are not).  Past cap 64
  ``collide_integrate_pack_kernel`` keeps no slot mask: it packs the
  window's occupants per tile (counts and prefixes from 32-slot words),
  sizes shared memory by occupants, not slots (K1_PACK), and streams a
  window whose occupants do not fit, tile by tile in (dy, dx) order.
  The write phase runs Verlet per slot, coalesced, reading [dt, mx, my,
  pressed] from device memory, so a step never syncs with the host.
  Its times, and what bounds it now: PERF.md (the kernel table) and
  ``utils/kernel_study.py``.

K3 ``collide`` replaces ``collide_pallas``
(gpu_physics_engine_tpu/ops/tiled_pallas.py:455; kernel
``_collide_band_kernel`` :355).
  Bound: as K1's sweep.  At the 4M shape [8, 640, 1850] the function reads
  x, y, pid (and radius in the general variant) and writes x, y: 0.19 GB,
  0.06 ms at 3.35 TB/s.
  Design: K1's kernel with its Verlet tail switched off at compile time
  (INTEGRATE = false), so the two share one sweep; the step then runs the
  plain ``integrate``.  Uniform and general radius as K1.

K2 ``relocate_pull`` replaces ``relocate_pallas``
(gpu_physics_engine_tpu/ops/tiled_pallas.py:945).
  Bound: device memory.  The function reads the pid plane, and x, y,
  px, py, radius of the occupied slots only (an empty slot moves
  nothing), and writes six fresh planes and the defer plane: at the 4M
  shape [8, 640, 1850] with 4,194,304 particles 0.35 GB, 0.106 ms on an
  H100 at 3.35 TB/s (chip_smoke.py ``bounds``).
  Design: one launch, ``relocate_window_kernel`` (csrc/tiled_kernels.cuh).
  A block owns 8 x 64 tiles and stages the region and a two-tile halo: per
  tile a mask of its occupied slots and one of the slots hopping in each
  direction, each particle's step computed once (the plan of the two
  launches it replaced computed it 8 times) and each plane read once,
  coalesced.  It plans the region and a one-tile ring in shared memory (the
  matching of ``_plan_choose`` on register masks), applies the region
  (leavers, deferrals, the outputs in slot order), and writes a thread per
  (output slot, tile), coalesced, with the zero fill in the same pass.  The
  plan never goes through device memory.  Past cap 64
  ``relocate_warp_kernel`` plans a tile per warp, its slots in chunks of 32
  lanes (each matching mode by lanes; greedy as two ballot-word merges),
  with a byte per slot and 32-bit words in shared memory, on a region
  chosen by cap (``k2_warp_region``; past the smallest one, device
  scratch).  Built with -fmad=false so the tile-boundary decisions equal the
  plain version's bit for bit.  Its times, what bounds it now, and the
  two-launch variant it was chosen over: PERF.md and
  ``utils/kernel_study.py --k2``.

K4 ``relocate_one`` replaces ``relocate_pallas_one``
(gpu_physics_engine_tpu/ops/tiled_pallas.py:1187; kernel
``_relocate_one_kernel`` :1068).
  Bound: as K2: the pid plane and the occupied slots' fields read, six
  planes and the defer plane written: 0.106 ms at the 4M shape
  [8, 640, 1850] (H100, 3.35 TB/s).
  Design: K2's kernel, ``relocate_window_kernel`` on FlatLayout
  (csrc/tiled_kernels.cuh), with K4's step rule (``DivHome``): the
  shared-memory window, each particle's step computed once, the plan kept
  in shared memory (the TPU kernel recomputed every neighbour's plan from
  5x5 views).  Its rule is the JAX kernel's: flip matching, no
  hysteresis, and the home tile floor(pos / t) by a correctly rounded
  division (``__fdiv_rn``), where K2 compares with products; the two part
  only for a particle within an ulp of a tile edge.  The matching is K2's,
  so K4 equals K2 under flip with delta 0 everywhere else.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.ops import _cuda
from gpu_physics_engine_torch.ops.integrate import f32, verlet_integrate
from gpu_physics_engine_torch.ops.tiled import (FIELDS, MIN_DISTANCE,
                                                TileState, _tile_of,
                                                pair_sweep, shift_tiles,
                                                step_offsets, tile_geometry)

LAUNCHES = {"collide_integrate": 0, "relocate_pull": 0, "collide": 0,
            "relocate_one": 0}

# The card's mask kernels keep a mask of a tile's slots: one 32-bit word up
# to NARROW_CAP, one 64-bit word up to WIDE_CAP (csrc/layout.cuh kWideCap,
# kNarrowCap); past WIDE_CAP K1 and the relocate window keep no mask.  No
# kernel has a largest cap: a CUDA state is limited only by its int32 slot
# count and the card's memory, as the plain versions are.
WIDE_CAP = 64
NARROW_CAP = 32
SLOTS_LIMIT = 2 ** 31  # cap x TY x TX slots index as int32


def check_card_cap(cap: int, device, tiles: int = 1) -> None:
    """Refuse a tile_cap that no state can hold: on a CUDA device a cap
    below 1, or one whose ``tiles`` tiles pass the int32 slot count
    (cap x TY x TX < 2^31, as both packages index), raises ValueError
    naming the limit; on any other device every cap passes.  The engines
    call it with their grid's TY x TX where they choose a cap, before a
    state is built or changed (a sharded engine with a halo-extended
    slab's); every launch holds its state to it again
    (``_check_cuda_state``)."""
    if torch.device(device).type != "cuda":
        return
    if int(cap) < 1 or int(cap) * max(1, int(tiles)) >= SLOTS_LIMIT:
        raise ValueError(
            f"tile_cap {cap} outside 1 <= cap and cap x {max(1, int(tiles))}"
            f" tiles < 2^31: the kernels index slots as int32")


def grown_cap(cap: int, device) -> int:
    """The cap a growth step (the watchdog's level 3, ``tiled_auto_cap_pct``)
    takes from ``cap`` on ``device``: cap + 1 on the card as on the CPU, as
    in the JAX package.  No device stops growth short of the int32 slot
    index, which the re-tile holds with its grid (``check_card_cap``)."""
    del device  # the same on every device
    return int(cap) + 1


def cap_class(cap: int) -> int:
    """The kernels' class at ``cap`` (csrc/layout.cuh cap_class): 0 up to
    NARROW_CAP, 1 up to WIDE_CAP, 2 past it (K1, the relocate window and
    the GS kernels without a mask)."""
    return 0 if cap <= NARROW_CAP else 1 if cap <= WIDE_CAP else 2


def mask_bytes(cap: int) -> int:
    """Bytes of the mask kernels' slot mask at ``cap``."""
    return (4, 8, 32)[cap_class(cap)]


# K1's window (csrc/tiled_kernels.cuh k1_rows, k1_cols, k1_mask_bytes): a
# block's region is K1_REGION[cap_class(cap)] = (rows, columns) tiles up
# to WIDE_CAP; past it the packed kernel's plan K1_PACK (k1_pack_plan:
# rows, columns, shared bytes of a block whatever the cap)
K1_REGION = ((8, 32), (4, 16))
K1_PACK = (2, 8, 49_152)


def k1_smem_bytes(cap: int, uniform: bool) -> int:
    """Shared memory of one K1 (or K3) block: up to WIDE_CAP per window
    tile (the region and a one-tile ring) cap slots of x, y (and radius
    unless ``uniform``) and a mask, per region tile cap sums (x, y) and
    cap u16 list entries; past it the packed kernel's fixed bytes."""
    if cap > WIDE_CAP:
        return K1_PACK[2]
    rows, cols = K1_REGION[cap_class(cap)]
    win = (rows + 2) * (cols + 2)
    return (win * (cap * (8 if uniform else 12) + mask_bytes(cap))
            + rows * cols * cap * 10)


# K2's window (csrc/tiled_kernels.cuh k2_rows, k2_width, k2_mask_bytes): up
# to WIDE_CAP a block's region is K2_REGION[par] = (rows, columns) storage
# cells (on the parity layout, of each of the four sub-grids); past it the
# warp kernel's full-space region (k2_warp_region)
K2_REGION = {False: (8, 64), True: (4, 32)}
K2_WARP_REGIONS = ((4, 16), (2, 16), (2, 8), (2, 4), (2, 2))
K2_WARP_BUDGET = 113_664  # a region's bytes: two blocks an SM
SMEM_LIMIT = 232_448  # dynamic shared memory of a block, sm_90


def k2_warp_bytes(cap: int, rows: int, cols: int) -> int:
    """Bytes of one warp-kernel block's arrays (csrc/tiled_kernels.cuh
    k2_warp_bytes): per window tile (the region and a two-tile halo) its
    direction bits, taken words and a direction byte a slot, per region
    tile cap source codes and an output count."""
    nch = (cap + 31) // 32
    win = (rows + 4) * (cols + 4)
    return (4 * win * (1 + nch) + 4 * cap * ((rows * cols) | 1)
            + 4 * rows * cols + win * (32 * nch + 4))


def k2_warp_region(cap: int):
    """(rows, columns, in shared memory) of the warp kernel at ``cap``: the
    largest region of K2_WARP_REGIONS whose arrays fit K2_WARP_BUDGET (the
    smallest where it fits a block), else (4, 16) on device scratch."""
    for i, (ry, rx) in enumerate(K2_WARP_REGIONS):
        b = k2_warp_bytes(cap, ry, rx)
        if b <= K2_WARP_BUDGET or (i == len(K2_WARP_REGIONS) - 1
                                   and b <= SMEM_LIMIT):
            return ry, rx, True
    return 4, 16, False


def k2_window_bytes(cap: int, par: bool) -> int:
    """Shared memory of one K2 block.  Up to WIDE_CAP: occupancy and eight
    direction masks per window tile (the region and a two-tile full-space
    halo), eight taken masks per planned tile (the region and a one-tile
    ring), and an output count and cap u16 source codes per region tile.
    Past it the warp kernel's arrays at its region, or 0 where they go to
    device scratch (``k2_scratch``)."""
    if cap > WIDE_CAP:
        ry, rx, smem = k2_warp_region(cap)
        return k2_warp_bytes(cap, ry, rx) if smem else 0
    rows, cols = K2_REGION[par]
    ry, rx = (2 * rows, 2 * cols) if par else (rows, cols)
    return (mask_bytes(cap) * (9 * (ry + 4) * (rx + 4)
                               + 8 * (ry + 2) * (rx + 2))
            + (4 + 2 * cap) * ry * rx)


def k2_scratch(cap: int, rows: int, cols: int, par: bool, device):
    """The device scratch a relocate launch at ``cap`` on ``rows`` x
    ``cols`` storage cells (on the parity layout DY x DX of each sub-grid)
    needs, sized by the library itself (``gpe_relocate_scratch_bytes``:
    the warp kernel's region, arrays and grid); None where its arrays fit
    shared memory."""
    n = _cuda.library().gpe_relocate_scratch_bytes(cap, rows, cols,
                                                    int(par))
    return torch.empty(n, dtype=torch.uint8, device=device) if n else None


# fixed claim priority: the first matching neighbour wins a free slot
NEIGHBORS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
             (0, 1), (1, -1), (1, 0), (1, 1))
_MATCH_CODE = {"flip": 0, "flip2": 1, "greedy": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_cuda_state(state: TileState, what: str) -> None:
    if state.device.type != "cuda":
        raise RuntimeError(f"{what}: the CUDA kernel needs CUDA tensors, "
                           f"got {state.device}")
    cap, TY, TX = state.dims
    check_card_cap(cap, state.device, TY * TX)
    for name in FIELDS:
        a = getattr(state, name)
        want = torch.int32 if name == "pid" else torch.float32
        if a.dtype != want or tuple(a.shape) != (cap, TY, TX):
            raise ValueError(f"{what}: {name} must be {want} "
                             f"[{cap}, {TY}, {TX}], got {a.dtype} "
                             f"{list(a.shape)}")
        if not a.is_contiguous() or a.device != state.device:
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{state.device}")


def _ptrs(*tensors) -> list:
    """Device addresses, passed to the C entry points as void*."""
    return [a.data_ptr() for a in tensors]


def _ptr(a):
    """A tensor's device address, or None (a null void*) for None."""
    return None if a is None else a.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: fused collide + integrate
# ---------------------------------------------------------------------------

def collide_integrate(state: TileState, prm: torch.Tensor,
                      config: SimConfig) -> TileState:
    """One fused substep (pair sweep + Verlet).  ``prm`` = f32[4]
    [dt * dt_scale, mouse_x, mouse_y, pressed] on the state's device."""
    if state.device.type == "cpu":
        return collide_integrate_plain(state, prm, config)
    return collide_integrate_cuda(state, prm, config)


def collide_integrate_plain(state: TileState, prm: torch.Tensor,
                            config: SimConfig) -> TileState:
    """Plain PyTorch version of K1 (any device): the 9-offset gather
    sweep of ``_pair_sweep`` (uniform-radius constants when
    config.tiled_uniform_radius), then Verlet with the world constraint."""
    r0 = config.initial_radius if config.tiled_uniform_radius else None
    acc_x, acc_y = pair_sweep(state.x, state.y, state.radius, state.pid,
                              config, r0=r0)
    radius = f32(r0) if r0 is not None else state.radius
    nx, ny, npx, npy = verlet_integrate(state.x + acc_x, state.y + acc_y,
                                        state.px, state.py, radius,
                                        state.occupied(), prm, config)
    return state.replace(x=nx, y=ny, px=npx, py=npy)


def _k1_consts(config: SimConfig) -> np.ndarray:
    """Host float[14] in K1Consts order, each rounded to f32 the way the
    JAX package rounds the same Python constants."""
    r0 = config.initial_radius
    return np.array([
        r0, 2.0 * r0, (2.0 * r0) * (2.0 * r0), 0.5 * config.stiffness,
        config.stiffness, MIN_DISTANCE * MIN_DISTANCE,
        config.mouse_strength, config.gravity[0], config.gravity[1],
        config.world_width, config.world_height,
        config.world_width / 2.0, config.world_height / 2.0,
        min(config.world_width, config.world_height) / 2.0,
    ], np.float32)


def collide_integrate_cuda(state: TileState, prm: torch.Tensor,
                           config: SimConfig) -> TileState:
    """Launch K1 on the state's CUDA device (raises for other tensors)."""
    _check_cuda_state(state, "collide_integrate")
    if (prm.dtype != torch.float32 or tuple(prm.shape) != (4,)
            or prm.device != state.device or not prm.is_contiguous()):
        raise ValueError("collide_integrate: prm must be a contiguous f32[4] "
                         f"on {state.device}")
    cap, TY, TX = state.dims
    outs = [torch.empty_like(state.x) for _ in range(4)]
    consts = _k1_consts(config)
    lib = _cuda.library()
    with torch.cuda.device(state.device):
        rc = lib.gpe_collide_integrate(
            *_ptrs(*(getattr(state, f) for f in FIELDS), prm, *outs),
            cap, TY, TX,
            int(config.tiled_uniform_radius),
            int(config.world_shape == "circle"),
            consts.ctypes.data, _stream(state.device))
    _cuda.check(rc, "collide_integrate")
    LAUNCHES["collide_integrate"] += 1
    return state.replace(x=outs[0], y=outs[1], px=outs[2], py=outs[3])


# ---------------------------------------------------------------------------
# K3: collide only (K1's sweep without the Verlet step)
# ---------------------------------------------------------------------------

def collide(state: TileState, config: SimConfig) -> TileState:
    """One Jacobi relaxation over the 3x3 x CAP neighbourhood; positions
    move, nothing else changes."""
    if state.device.type == "cpu":
        return collide_plain(state, config)
    return collide_cuda(state, config)


def collide_plain(state: TileState, config: SimConfig) -> TileState:
    """Plain PyTorch version of K3 (any device): K1's sweep (uniform-radius
    constants when config.tiled_uniform_radius), x + acc_x, y + acc_y."""
    r0 = config.initial_radius if config.tiled_uniform_radius else None
    acc_x, acc_y = pair_sweep(state.x, state.y, state.radius, state.pid,
                              config, r0=r0)
    return state.replace(x=state.x + acc_x, y=state.y + acc_y)


def collide_cuda(state: TileState, config: SimConfig) -> TileState:
    """Launch K3 on the state's CUDA device (raises for other tensors)."""
    _check_cuda_state(state, "collide")
    cap, TY, TX = state.dims
    ox = torch.empty_like(state.x)
    oy = torch.empty_like(state.y)
    consts = _k1_consts(config)
    lib = _cuda.library()
    with torch.cuda.device(state.device):
        rc = lib.gpe_collide(
            *_ptrs(state.x, state.y, state.radius, state.pid, ox, oy),
            cap, TY, TX, int(config.tiled_uniform_radius),
            consts.ctypes.data, _stream(state.device))
    _cuda.check(rc, "collide")
    LAUNCHES["collide"] += 1
    return state.replace(x=ox, y=oy)


# ---------------------------------------------------------------------------
# K2: pull relocation (plan, then apply)
# ---------------------------------------------------------------------------

def resolve_match(config: SimConfig, cap: int, TY: int, TX: int) -> str:
    """tiled_match with "auto" resolved as the JAX package does: greedy on
    grids of <= 800k tiles with cap <= 8, flip2 otherwise."""
    if config.tiled_match != "auto":
        return config.tiled_match
    return "greedy" if (TY * TX <= 800_000 and cap <= 8) else "flip2"


def _k2_args(state: TileState, config: SimConfig, global_rows):
    cap, TY, TX = state.dims
    return (resolve_match(config, cap, TY, TX), tile_geometry(config)[0],
            config.hysteresis_delta, TY if global_rows is None
            else int(global_rows))


def relocate_pull(state: TileState, config: SimConfig, row0: int = 0,
                  global_rows: int | None = None) -> TileState:
    """Bufferless relocation: every mover takes at most one hop toward its
    home tile; deferrals add to overflow_count.  ``row0`` (the slab's first
    global tile row) and ``global_rows`` (the full grid's row count) are
    0 and TY on one device."""
    if state.device.type == "cpu":
        return relocate_pull_plain(state, config, row0, global_rows)[0]
    return relocate_pull_cuda(state, config, row0, global_rows)[0]


def relocate_pull_cuda(state: TileState, config: SimConfig, row0: int = 0,
                       global_rows: int | None = None
                       ) -> Tuple[TileState, torch.Tensor]:
    """Launch K2 (plan + apply) on the state's CUDA device.  Returns (new
    state, defer i32 [TY, TX])."""
    _check_cuda_state(state, "relocate_pull")
    cap, TY, TX = state.dims
    match, t, delta, gTY = _k2_args(state, config, global_rows)
    outs = [torch.empty_like(state.x) for _ in range(5)]
    opid = torch.empty_like(state.pid)
    defer = torch.empty((TY, TX), dtype=torch.int32, device=state.device)
    scratch = k2_scratch(cap, TY, TX, False, state.device)
    lib = _cuda.library()
    with torch.cuda.device(state.device):
        rc = lib.gpe_relocate_pull(
            *_ptrs(*(getattr(state, f) for f in FIELDS), *outs, opid, defer),
            cap, TY, TX, int(row0), gTY, TX, _MATCH_CODE[match], f32(t),
            f32(delta), _stream(state.device), _ptr(scratch))
    _cuda.check(rc, "relocate_pull")
    LAUNCHES["relocate_pull"] += 1
    return _relocated(state, outs, opid, defer), defer


def _relocated(state, outs, opid, defer) -> TileState:
    return state.replace(
        x=outs[0], y=outs[1], px=outs[2], py=outs[3], radius=outs[4],
        pid=opid, overflow_count=state.overflow_count
        + torch.sum(defer, dtype=torch.int32))


def _grid_coords(shape, row0: int, device):
    """(my_row, my_ty, my_tx): local row, global row, column index
    tensors broadcastable to ``shape`` = (cap, TY, TX)."""
    _, TY, TX = shape
    my_row = torch.arange(TY, dtype=torch.int32, device=device).view(1, TY, 1)
    my_tx = torch.arange(TX, dtype=torch.int32, device=device).view(1, 1, TX)
    return my_row, my_row + int(row0), my_tx


def home_offsets(x, y, sty, stx, *, t: float, gTY: int, gTX: int):
    """K4's one-hop offsets (``tiled_pallas._home_tile``): the home tile
    floor(pos / t) + 1 by a correctly rounded division, clipped to the
    interior, and the step toward it clipped to one tile.  No
    hysteresis."""
    wy, wx = _tile_of(x, y, t)
    wy = torch.clamp(wy, 1, gTY - 2)
    wx = torch.clamp(wx, 1, gTX - 2)
    return torch.clamp(wy - sty, -1, 1), torch.clamp(wx - stx, -1, 1)


def _plan_plain(state: TileState, match: str, offsets, row0: int,
                gTY: int) -> torch.Tensor:
    """Plain version of K2's plan (``_relocate_plan_kernel`` +
    ``_plan_choose``) over the whole grid, i32 [cap, TY, TX], under
    ``match``; ``offsets(x, y, sty, stx)`` is where a particle stored in
    global tile (sty, stx) steps."""
    cap, TY, TX = state.dims
    my_row, my_ty, my_tx = _grid_coords(state.dims, row0, state.device)

    # claims[e, s]: neighbour e's slot-s occupant hops to me this step
    claims = []
    for ey, ex in NEIGHBORS:
        x_e = shift_tiles(state.x, ey, ex)
        y_e = shift_tiles(state.y, ey, ex)
        p_e = shift_tiles(state.pid, ey, ex)
        valid = ((my_row + ey >= 0) & (my_row + ey <= TY - 1)
                 & (my_tx + ex >= 0) & (my_tx + ex <= TX - 1))
        dty, dtx = offsets(x_e, y_e, my_ty + ey, my_tx + ex)
        claims.append(valid & (p_e >= 0) & (dty == -ey) & (dtx == -ex))
    claims = torch.stack(claims)                      # [8, cap, TY, TX]

    free = state.pid < 0
    chosen = torch.full_like(state.pid, -1)
    if match == "flip":
        for e in range(8):
            # free slot k pulls the neighbour's slot cap-1-k mover
            c = claims[e].flip(0)
            chosen = torch.where(c & (chosen < 0),
                                 torch.full_like(chosen, e), chosen)
    elif match == "flip2":
        claimed = torch.zeros_like(claims)
        for k in range(cap):
            chosen_k = chosen[k]
            for rule, s in ((0, cap - 1 - k), (1, k)):
                for e in range(8):
                    take = (free[k] & claims[e, s] & ~claimed[e, s]
                            & (chosen_k < 0))
                    chosen_k = torch.where(
                        take, torch.full_like(chosen_k, e + 8 * rule),
                        chosen_k)
                    claimed[e, s] |= take
            chosen[k] = chosen_k
    else:
        chosen = _greedy_plain(claims, free)
    interior = ((my_ty >= 1) & (my_ty <= gTY - 2) & (my_tx >= 1)
                & (my_tx <= TX - 2) & (my_row <= TY - 1))
    return torch.where(free & interior, chosen, torch.full_like(chosen, -1))


def _greedy_plain(claims: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Greedy matching (``_plan_choose``'s greedy loop) by prefix counts:
    the free slots of a tile, ascending, take its movers in (neighbour,
    slot) order, the i-th free slot the i-th mover; i32 [cap, TY, TX] of
    codes e * cap + s, -1 where none.  ``claims`` [8, cap, TY, TX],
    ``free`` [cap, TY, TX]."""
    cap, TY, TX = free.shape
    movers = claims.reshape(8 * cap, TY * TX).t()  # (e, s) order
    seen = torch.cumsum(movers, dim=1, dtype=torch.int32)  # movers <= m
    rank = (torch.cumsum(free, dim=0, dtype=torch.int32) - 1).reshape(
        cap, TY * TX).t()  # a free slot's place among the free, ascending
    m = torch.searchsorted(seen.contiguous(), rank.contiguous(), right=True)
    take = free.reshape(cap, TY * TX).t() & (rank < seen[:, -1:])
    return torch.where(take, m.to(torch.int32), -1).t().reshape(cap, TY, TX)


def relocate_pull_plain(state: TileState, config: SimConfig, row0: int = 0,
                        global_rows: int | None = None
                        ) -> Tuple[TileState, torch.Tensor]:
    """Plain PyTorch version of K2 on any device: the plan above, then
    ``_relocate_apply_kernel`` + ``_apply_merge`` as whole-grid tensor
    ops.  Returns (new state, defer i32 [TY, TX])."""
    match, t, delta, gTY = _k2_args(state, config, global_rows)
    offsets = functools.partial(step_offsets, t=t, delta=delta, gTY=gTY,
                                gTX=state.dims[2])
    return _pull_plain(state, match, offsets, row0, gTY)


def _pull_plain(state: TileState, match: str, offsets, row0: int,
                gTY: int) -> Tuple[TileState, torch.Tensor]:
    """One pull relocate under ``match`` and ``offsets`` (as
    ``_plan_plain``): the plan, then the apply.  Returns (new state, defer
    i32 [TY, TX])."""
    cap, TY, TX = state.dims
    plan = _plan_plain(state, match, offsets, row0, gTY)
    my_row, my_ty, my_tx = _grid_coords(state.dims, row0, state.device)

    fields = {n: getattr(state, n) for n in FIELDS}
    dty, dtx = offsets(state.x, state.y, my_ty, my_tx)
    in_slab = (my_row + dty >= 0) & (my_row + dty <= TY - 1)
    moving = (state.pid >= 0) & in_slab & ((dty != 0) | (dtx != 0))

    accepted = torch.zeros_like(moving)
    new = dict(fields)
    slot_codes = torch.arange(cap, dtype=torch.int32,
                              device=state.device).view(cap, 1, 1)
    for e_idx, (ey, ex) in enumerate(NEIGHBORS):
        me = NEIGHBORS.index((-ey, -ex))  # my index in the target's order
        views = {n: shift_tiles(a, ey, ex) for n, a in fields.items()}
        plan_e = shift_tiles(plan, ey, ex)
        sel = moving & (dty == ey) & (dtx == ex)
        if match == "flip":
            accepted |= sel & (plan_e.flip(0) == me)
            hit = plan == e_idx
            for n in new:
                new[n] = torch.where(hit, views[n].flip(0), new[n])
        elif match == "flip2":
            accepted |= sel & ((plan_e.flip(0) == me) | (plan_e == me + 8))
            hit0 = plan == e_idx
            hit1 = plan == e_idx + 8
            for n in new:
                new[n] = torch.where(
                    hit1, views[n], torch.where(hit0, views[n].flip(0),
                                                new[n]))
        else:  # greedy: codes e*cap + source slot
            named = (plan_e[None] == (me * cap + slot_codes)[:, None]).any(1)
            accepted |= sel & named
            for s in range(cap):
                hit = plan == e_idx * cap + s
                for n in new:
                    new[n] = torch.where(hit, views[n][s:s + 1], new[n])

    take_in = plan >= 0
    new["pid"] = torch.where(accepted & ~take_in,
                             torch.full_like(new["pid"], -1), new["pid"])
    defer = torch.sum(moving & ~accepted, dim=0, dtype=torch.int32)

    # compact occupants to the low slots, zero-fill the rest
    occ = new["pid"] >= 0
    rank = torch.cumsum(occ.to(torch.int32), dim=0) - occ.to(torch.int32)
    ntiles = TY * TX
    tile_lin = torch.arange(ntiles, device=state.device).view(1, TY, TX)
    dst = (rank.long() * ntiles + tile_lin)[occ]
    outs = []
    for n in FIELDS:
        o = torch.full((cap * ntiles,), -1 if n == "pid" else 0,
                       dtype=new[n].dtype, device=state.device)
        o[dst] = new[n][occ]
        outs.append(o.view(cap, TY, TX))
    return _relocated(state, outs[:5], outs[5], defer), defer


# ---------------------------------------------------------------------------
# K4: the pull relocate in one launch (flip matching, no hysteresis)
# ---------------------------------------------------------------------------

def relocate_one(state: TileState, config: SimConfig, row0: int = 0,
                 global_rows: int | None = None) -> TileState:
    """``relocate_pallas_one``: one pull relocate with the plan and the
    apply in one launch.  It matches by flip and steps toward the home
    tile floor(pos / t) without hysteresis, whatever the config's
    tiled_match and hysteresis say; deferrals add to overflow_count."""
    if state.device.type == "cpu":
        return relocate_one_plain(state, config, row0, global_rows)[0]
    return relocate_one_cuda(state, config, row0, global_rows)[0]


def relocate_one_plain(state: TileState, config: SimConfig, row0: int = 0,
                       global_rows: int | None = None
                       ) -> Tuple[TileState, torch.Tensor]:
    """Plain version of K4: K2's plain plan and apply under flip matching,
    with ``home_offsets`` (the home tile by division) for the steps.
    Returns (new state, defer i32 [TY, TX])."""
    gTY = state.dims[1] if global_rows is None else int(global_rows)
    t = tile_geometry(config)[0]
    offsets = functools.partial(home_offsets, t=t, gTY=gTY,
                                gTX=state.dims[2])
    return _pull_plain(state, "flip", offsets, row0, gTY)


def relocate_one_cuda(state: TileState, config: SimConfig, row0: int = 0,
                      global_rows: int | None = None
                      ) -> Tuple[TileState, torch.Tensor]:
    """Launch K4 on the state's CUDA device.  Returns (new state, defer
    i32 [TY, TX])."""
    _check_cuda_state(state, "relocate_one")
    cap, TY, TX = state.dims
    gTY = TY if global_rows is None else int(global_rows)
    outs = [torch.empty_like(state.x) for _ in range(5)]
    opid = torch.empty_like(state.pid)
    defer = torch.empty((TY, TX), dtype=torch.int32, device=state.device)
    scratch = k2_scratch(cap, TY, TX, False, state.device)
    lib = _cuda.library()
    with torch.cuda.device(state.device):
        rc = lib.gpe_relocate_one(
            *_ptrs(*(getattr(state, f) for f in FIELDS), *outs, opid, defer),
            cap, TY, TX, int(row0), gTY, TX, f32(tile_geometry(config)[0]),
            _stream(state.device), _ptr(scratch))
    _cuda.check(rc, "relocate_one")
    LAUNCHES["relocate_one"] += 1
    return _relocated(state, outs, opid, defer), defer
