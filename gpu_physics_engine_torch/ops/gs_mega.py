"""The fused Gauss-Seidel kernels of the parity pipeline (the counterpart of
``gpu_physics_engine_tpu.ops.gs_mega``): the four color passes with the
Verlet tail in one launch, and the pull relocate's plan and apply in one
launch.  ``ops/gs_parity`` takes them where the JAX package does: under
``SimConfig.gs_colors_mega`` / ``gs_relocate_mega`` with a uniform radius.

Each wrapper launches its kernel for a CUDA tensor, runs its plain version
for a CPU tensor, and raises for anything else; there is no fallback from
a CUDA tensor to the plain version.  A wrapper adds one to
``LAUNCHES[name]`` each time it launches its kernel.
The plain versions are the sequential path's plain versions, in order:
the fused kernels change how the work is launched, not one operation.

colors_mega (K11) replaces ``colors_mega``
(gpu_physics_engine_tpu/ops/gs_mega.py:503; kernel ``_mega_kernel`` :136).
  Bound: device memory, per solve: each valid rank's source code (under
  the uniform-radius gate every valid rank has radius r0, so no radius is
  read) and its occupant's x, y read, the occupants' x, y written, and for
  the tail the pid plane read and the occupied slots' px, py read and
  written: about 0.09 GB at the 1M-GS shape [4, 4, 480, 1387], 0.027 ms at
  3.35 TB/s (``chip_smoke.py``'s ``bounds`` counts this run's data).
  Design: K6-par's window kernel (``gs_colors_window_kernel`` on
  ParLayout, csrc/gs_kernels.cuh), as the TPU kernel does it: a block
  stages its region and a halo of 8 tiles on every side once (the JAX
  kernel keeps 8 sub-rows, 16 full rows, for its solve and pull-apply;
  the in-place cell body needs two tiles a color), runs the four colors
  and the Verlet tail there, and writes the region's x and y out of place;
  the halo is recomputed by the neighbouring blocks, so no grid
  synchronisation is needed.  Par and mega run the same kernels: this
  route differs from K6-par's only in its gate and in reading no radius
  table.

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
                                                        _stream, k2_scratch,
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
                config: SimConfig, prm: Optional[torch.Tensor] = None,
                count: Optional[torch.Tensor] = None) -> gp.ParityState:
    """Colors 1..4 with the rank tables src, rrad [4, K, DY, DX]; with
    ``prm`` (f32[4], this substep's dt) the substep's Verlet step follows
    (uniform radius, box world).  ``count``: K5-par's count table (the
    ranked-slot solve's rank counts, which it needs past the window).  Returns the state with new x, y;
    ps.x and ps.y are not written, ps.px and ps.py are (the tail)."""
    if ps.device.type == "cpu":
        out = ps.replace(x=ps.x.clone(), y=ps.y.clone())
        colors_mega_plain(out, src, rrad, config, prm)
        return out
    return colors_mega_cuda(ps, src, rrad, config, prm, count)


def colors_mega_plain(ps: gp.ParityState, src, rrad, config: SimConfig,
                      prm=None) -> None:
    """Plain version, in place on ps.x, ps.y (ps.px, ps.py): the four
    ``color_par_plain_`` passes, then ``verlet_plain_``."""
    for color in (1, 2, 3, 4):
        gp.color_par_plain_(ps.x, ps.y, src, rrad, config, ps.geo, color)
    if prm is not None:
        gp._check_fusable(config)
        gp.verlet_plain_(ps.x, ps.y, ps.px, ps.py, ps.pid, prm, config)


def colors_mega_cuda(ps: gp.ParityState, src, rrad, config: SimConfig,
                     prm=None, count=None) -> gp.ParityState:
    """Launch the window on the state's CUDA device (without a radius
    plane in the state every valid rank has radius r0, and no radius
    table is read)."""
    gp._check_par_state(ps, "gs colors mega")
    cap, K, geo = ps.cap, config.max_occupancy, ps.geo
    gs_kernels._check_k(K, cap, "gs colors mega")
    tables = (4, K, geo.DY, geo.DX)
    gp._check_cuda("gs colors mega", ps.device, src=(src, _I32, tables),
                   rrad=(rrad, torch.float32, tables))
    if count is not None:
        gp._check_cuda("gs colors mega", ps.device,
                       count=(count, _I32, (4, geo.DY, geo.DX)))
    tail = consts = None
    if prm is not None:
        gp._check_fusable(config)
        gp._check_cuda("gs colors mega", ps.device,
                       prm=(prm, torch.float32, (4,)))
        tail, consts = (ps.px, ps.py, ps.pid, prm), gp._verlet_consts(config)
    x, y = gs_kernels.window_cuda(
        "gs colors mega", ps.x, ps.y, src,
        None if ps.radius is None else rrad, config,
        gp._geo_args(geo) + (1,), 4, tail, consts, config.initial_radius,
        count)
    LAUNCHES["gs_colors_mega"] += 1
    return ps.replace(x=x, y=y)


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
    scratch = k2_scratch(cap, geo.DY, geo.DX, True, dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.gpe_relocate_mega(
            *_ptrs(ps.x, ps.y, ps.px, ps.py), gp._ptr(ps.radius),
            *_ptrs(ps.pid, *outs), gp._ptr(orad), *_ptrs(opid, defer), cap,
            *gp._geo_args(geo), _MATCH_CODE[match],
            f32(tile_geometry(config)[0]), f32(config.hysteresis_delta),
            _stream(dev), gp._ptr(scratch))
    _cuda.check(rc, "relocate mega")
    LAUNCHES["relocate_mega"] += 1
    return ps.replace(x=outs[0], y=outs[1], px=outs[2], py=outs[3],
                      radius=orad, pid=opid,
                      overflow_count=ps.overflow_count
                      + torch.sum(defer, dtype=_I32)), defer
