"""The fused Gauss-Seidel kernels of the parity pipeline (the counterpart of
``gpu_physics_engine_tpu.ops.gs_mega``): the four color passes with the
Verlet tail in one launch, and the pull relocate's plan and apply in one
launch.  ``ops/gs_parity`` takes them where the JAX package does: under
``SimConfig.gs_colors_mega`` / ``gs_relocate_mega`` with a uniform radius.

Each wrapper launches its kernel for a CUDA tensor, runs its plain version
for a CPU tensor, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version, nor to the per-color kernels.  A
wrapper adds one to ``LAUNCHES[name]`` each time it launches its kernel.
The plain versions are the sequential path's plain versions, in order:
the fused kernels change how the work is launched, not one operation.

colors_mega (K11) replaces ``colors_mega``
(gpu_physics_engine_tpu/ops/gs_mega.py:503; kernel ``_mega_kernel`` :136).
  Bound: device memory.  The function reads each valid rank's code and
  radius and its occupant's x, y once and writes x, y once per color, and
  the tail reads pid and reads and writes the occupied slots' x, y, px,
  py: 4 x 0.0065 + 0.023 ms at the 1M-GS shape [4, 4, 480, 1387] (3.35
  TB/s), as four K6-par launches and the tail.
  Design: a persistent cooperative kernel (``gs_colors_mega_kernel`` in
  csrc/gs_kernels.cuh), launched with cudaLaunchCooperativeKernel on as
  many blocks as the card holds at once.  Each color is a grid-stride loop
  of K6-par's per-cell body over the color's sub-grid, and the grid
  synchronises between colors and before the tail (K6-par's per-slot
  Verlet body), so the result equals four K6-par launches plus the tail
  bit for bit.  It saves the launch gaps, not bytes.  The TPU's VMEM
  window with its 8-sub-row halo was a VMEM artifact and is not carried
  over; a shared-memory window is later work (ROADMAP).  A refused launch
  (too many blocks, or a card without cooperative launch) raises.

relocate_mega (K11) replaces ``relocate_mega``
(gpu_physics_engine_tpu/ops/gs_mega.py:443; kernel ``_reloc_mega_kernel``
:311).
  Bound: device memory, as K2-par: the pid plane and the occupied slots'
  x, y, px, py read; the fields, pid and the defer plane written: 0.085 ms
  at the 1M-GS shape (H100, 3.35 TB/s).
  Design: K2-par's kernel, ``relocate_window_kernel`` on ParLayout
  (csrc/tiled_kernels.cuh), in one launch over all four parities, whatever
  ``gs_par_fused`` says (the JAX kernel always fuses them): the shared-
  memory window, the plan kept in shared memory, pad cells written empty.
  The config's matching ("auto" resolved on the full grid) and
  hysteresis, as ``relocate_parity``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.ops import _cuda, gs_kernels
from gpu_physics_engine_torch.ops import gs_parity as gp
from gpu_physics_engine_torch.ops.integrate import f32
from gpu_physics_engine_torch.ops.tiled import tile_geometry
from gpu_physics_engine_torch.ops.tiled_kernels import (_MATCH_CODE, _ptrs,
                                                        _stream,
                                                        resolve_match)

LAUNCHES = {"gs_colors_mega": 0, "relocate_mega": 0}
_I32 = torch.int32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# colors_mega: the four colors and the Verlet tail in one launch
# ---------------------------------------------------------------------------

def colors_mega(ps: gp.ParityState, src: torch.Tensor, rrad: torch.Tensor,
                config: SimConfig, prm: Optional[torch.Tensor] = None
                ) -> None:
    """Colors 1..4 in place on ps.x, ps.y with the rank tables src, rrad
    [4, K, DY, DX]; with ``prm`` (f32[4], this substep's dt) the substep's
    Verlet step follows in place on x, y, px, py (uniform radius, box
    world)."""
    if ps.device.type == "cpu":
        return colors_mega_plain(ps, src, rrad, config, prm)
    return colors_mega_cuda(ps, src, rrad, config, prm)


def colors_mega_plain(ps: gp.ParityState, src, rrad, config: SimConfig,
                      prm=None) -> None:
    """Plain version: the four ``color_par_plain_`` passes, then
    ``verlet_plain_``."""
    for color in (1, 2, 3, 4):
        gp.color_par_plain_(ps.x, ps.y, src, rrad, config, ps.geo, color)
    if prm is not None:
        gp._check_fusable(config)
        gp.verlet_plain_(ps.x, ps.y, ps.px, ps.py, ps.pid, prm, config)


def colors_mega_cuda(ps: gp.ParityState, src, rrad, config: SimConfig,
                     prm=None) -> None:
    """Launch the cooperative colors kernel on the state's CUDA device."""
    gp._check_par_state(ps, "gs colors mega")
    cap, K, geo = ps.cap, config.max_occupancy, ps.geo
    gs_kernels._check_k(K, cap, "gs colors mega")
    tables = (4, K, geo.DY, geo.DX)
    gp._check_cuda("gs colors mega", ps.device, src=(src, _I32, tables),
                   rrad=(rrad, torch.float32, tables))
    if prm is not None:
        gp._check_fusable(config)
        gp._check_cuda("gs colors mega", ps.device,
                       prm=(prm, torch.float32, (4,)))
    consts = gp._verlet_consts(config)
    lib = _cuda.library()
    with torch.cuda.device(ps.device):
        rc = lib.gpe_gs_colors_mega(
            *_ptrs(ps.x, ps.y, ps.px, ps.py, ps.pid, src, rrad),
            gp._ptr(prm), cap, *gp._geo_args(geo), K, f32(config.stiffness),
            int(prm is not None), consts.ctypes.data, _stream(ps.device))
    _cuda.check(rc, "gs colors mega")
    LAUNCHES["gs_colors_mega"] += 1


# ---------------------------------------------------------------------------
# relocate_mega: K2-par's plan and apply in one launch
# ---------------------------------------------------------------------------

def relocate_mega(ps: gp.ParityState, config: SimConfig) -> gp.ParityState:
    """One pull-relocate pass in parity space (fresh tensors), plan and
    apply fused; deferrals add to overflow_count."""
    if ps.device.type == "cpu":
        return relocate_mega_plain(ps, config)[0]
    return relocate_mega_cuda(ps, config)[0]


def relocate_mega_plain(ps: gp.ParityState, config: SimConfig
                        ) -> Tuple[gp.ParityState, torch.Tensor]:
    """Plain version: K2-par's (``relocate_par_plain``).  Returns (new
    state, defer i32 [4, DY, DX])."""
    return gp.relocate_par_plain(ps, config)


def relocate_mega_cuda(ps: gp.ParityState, config: SimConfig
                       ) -> Tuple[gp.ParityState, torch.Tensor]:
    """Launch the fused relocate on the state's CUDA device.  Returns (new
    state, defer i32 [4, DY, DX])."""
    gp._check_par_state(ps, "relocate mega")
    geo, dev, cap = ps.geo, ps.device, ps.cap
    match = resolve_match(config, cap, geo.TY, geo.TX)  # full grid dims
    outs = [torch.empty_like(ps.x) for _ in range(4)]
    orad = None if ps.radius is None else torch.empty_like(ps.radius)
    opid = torch.empty_like(ps.pid)
    defer = torch.empty((4, geo.DY, geo.DX), dtype=_I32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.gpe_relocate_mega(
            *_ptrs(ps.x, ps.y, ps.px, ps.py), gp._ptr(ps.radius),
            *_ptrs(ps.pid, *outs), gp._ptr(orad), *_ptrs(opid, defer), cap,
            *gp._geo_args(geo), _MATCH_CODE[match],
            f32(tile_geometry(config)[0]), f32(config.hysteresis_delta),
            _stream(dev))
    _cuda.check(rc, "relocate mega")
    LAUNCHES["relocate_mega"] += 1
    return ps.replace(x=outs[0], y=outs[1], px=outs[2], py=outs[3],
                      radius=orad, pid=opid,
                      overflow_count=ps.overflow_count
                      + torch.sum(defer, dtype=_I32)), defer
