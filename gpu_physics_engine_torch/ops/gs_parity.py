"""Parity-space Gauss-Seidel pipeline (gs_layout="par"; the counterpart of
``gpu_physics_engine_tpu.ops.gs_parity``) and the "mx"/"dec" solve layouts
of ``gs_pallas``.

Layout.  A field [C, TY, TX] becomes one parity-major tensor [4, C, DY, DX]:
``sub[p, k, si, sj] = full[k, 2*si + pa + o, 2*sj + pb + o]`` with p = 2*pa
+ pb.  Origin o = 0 is the mx/par convention (the JAX package's
``_mx_parity``); o = -1 is the dec one, whose parities count from the
interior (``_color_parity``).  DY = ceil((TY - o) / 2), DX likewise; sub-grid
cells whose full tile lies outside the grid are pad cells and hold empty
slots (pid -1, x = y = 0).  On the card the relayout is a strided copy; the
TPU's one-hot-matmul relayout and its 256-lane padding are not needed, so
the shapes differ from the JAX package's by design and the tests compare
states in full space.  Every color's cells are one whole sub-grid, and one
launch can cover all four parities of a field.  Under uniform radius the
radius planes are dropped, as in the JAX package: ``from_parity_state``
rebuilds the plane as where(pid >= 0, r0, 0).

Kernels (csrc/, templated on csrc/layout.cuh's ParLayout; flat K5, K6 and
K2 are the same kernels on FlatLayout).  Each wrapper launches its kernel
for a CUDA tensor, runs its plain version for a CPU tensor, and raises for
anything else; it adds one to ``LAUNCHES[name]`` per kernel launch.  The
plain versions relayout to full space, run the flat plain versions and
relayout back (the Verlet tail is elementwise and runs ``tiled.verlet``).

K5-par ``rank_par`` replaces ``rank_parity``
(gpu_physics_engine_tpu/ops/gs_parity.py:275; ``_rank_kernel_par`` :160,
``_rank_kernel_par_all`` :206).
  Bound: device memory, as K5: x, y, pid read once, the K-deep tables and
  the count written once: 0.13 GB read and 0.26 GB written at the 1M-GS
  shape [4, 4, 480, 1387], K = 8 (0.12 ms at 3.35 TB/s).
  Design: K5's kernel on the parity layout, one thread per sub-grid cell;
  a neighbour at full offset (dy, dx) is read from parity ((pa+dy)&1,
  (pb+dx)&1).  Border and pad cells keep the fill tables and count 0
  (``_rank_kernel_par``'s interior mask).  ``gs_par_fused`` None/True: one
  launch over all four parities; False: one per parity.

K6-par ``color_par_`` replaces the color passes of ``solve_parity``
(gs_parity.py:433; ``_solve_dec_kernel`` and ``_apply_dec_kernel``), of
``gs_solve_pallas_mx`` (gs_pallas.py:1045) and of ``gs_solve_pallas_dec``
(gs_pallas.py:783).
  Bound: as K6, the active cells' rank entries and their occupants' x, y,
  read and written once per launch; the sweep's dependent IEEE divisions
  and roots set the time.
  Design: K6's kernel on the parity layout.  A color is one contiguous
  sub-grid, so neighbouring threads read neighbouring table entries (flat
  K6 strides by 2).  Written back in place through the source codes; cells
  of one color are particle-disjoint, so the launch is race-free.

K6-par Verlet tail ``verlet_`` replaces the Verlet half of
``_apply_integrate_dec_kernel`` (gs_parity.py:353).
  Bound: device memory: the pid plane read, and the occupied slots' x, y,
  px, py read and written: 0.08 GB at the 1M-GS shape (0.023 ms); the
  kernel takes 0.063 ms in the step on an H100 80GB HBM3 at 700 W
  (PERF.md).
  Design: one thread per slot, in place, launched right after the color-4
  pass (a color-4 cell owns only its members' slots, and every occupied
  slot must step).  ``ops/tiled.integrate``'s op order with IEEE-rounded,
  uncontracted operations; box world and uniform radius only, as the TPU's
  fusion.  One launch replaces about 30 PyTorch elementwise passes.

K2-par ``relocate_par`` replaces ``relocate_parity``
(gs_parity.py:689; ``_plan_kernel_par``/``_apply_kernel_par`` :539/:573 and
their ``_all`` variants :617/:651).
  Bound: as K2, one thread per tile with serial slot loops.
  Design: K2's plan and apply kernels on the parity layout; every plan is
  written before any apply reads one (two launches, or four plus four per
  parity when ``gs_par_fused`` is False).  The apply also rewrites the pad
  cells (empty).  Under uniform radius no radius plane moves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.ops import _cuda, gs_kernels
from gpu_physics_engine_torch.ops.gs_tiled import (BIGPID, color_plain_,
                                                   rank_plain)
from gpu_physics_engine_torch.ops.integrate import f32
from gpu_physics_engine_torch.ops.tiled import TileState, tile_geometry, verlet
from gpu_physics_engine_torch.ops.tiled_kernels import (
    MAX_CAP, _MATCH_CODE, _ptrs, _stream, relocate_pull_plain, resolve_match)

PARS = ((0, 0), (0, 1), (1, 0), (1, 1))  # p = 2 * row parity + col parity
LAUNCHES = {"gs_rank_par": 0, "gs_color_par": 0, "relocate_par": 0,
            "gs_verlet": 0}
_I32 = torch.int32

# gs_layout="auto" on a CUDA state: chip_smoke.py measured the par engine
# at about half the flat engine's ms/step at 1M-GS on an H100 (PERF.md).
# Off the card "auto" is the flat layout, as in the JAX package off its TPU.
AUTO_LAYOUT_CUDA = "par"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# geometry and relayout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParityGeometry:
    """Full grid TY x TX and the origin o of ``full = 2*sub + parity + o``
    (0: mx/par, -1: dec)."""
    TY: int
    TX: int
    origin: int = 0

    @property
    def DY(self) -> int:
        return (self.TY - self.origin + 1) // 2

    @property
    def DX(self) -> int:
        return (self.TX - self.origin + 1) // 2

    def _axis(self, n: int, par: int):
        first = (par + self.origin) % 2  # the first full index of parity par
        sub0 = (first - par - self.origin) // 2
        return slice(first, None, 2), slice(sub0, sub0 + (n - first + 1) // 2)

    def views(self, p: int):
        """(full-space index, sub-grid index) of parity p's in-grid cells,
        for the last two axes."""
        pa, pb = PARS[p]
        (fy, sy), (fx, sx) = self._axis(self.TY, pa), self._axis(self.TX, pb)
        return (fy, fx), (sy, sx)


def to_parity(a: torch.Tensor, geo: ParityGeometry, fill) -> torch.Tensor:
    """[C, TY, TX] -> [4, C, DY, DX]; pad cells hold ``fill``."""
    out = a.new_full((4, a.shape[0], geo.DY, geo.DX), fill)
    _assign_parity(out, a, geo)
    return out


def from_parity(s: torch.Tensor, geo: ParityGeometry) -> torch.Tensor:
    """[4, C, DY, DX] -> [C, TY, TX] (pad cells dropped)."""
    out = s.new_empty((s.shape[1], geo.TY, geo.TX))
    for p in range(4):
        full, sub = geo.views(p)
        out[(slice(None),) + full] = s[(p, slice(None)) + sub]
    return out


def _assign_parity(dst: torch.Tensor, a: torch.Tensor,
                   geo: ParityGeometry) -> None:
    """dst [4, C, DY, DX] takes a [C, TY, TX]'s values in its in-grid cells
    (pad cells untouched)."""
    for p in range(4):
        full, sub = geo.views(p)
        dst[(p, slice(None)) + sub] = a[(slice(None),) + full]


@dataclasses.dataclass
class ParityState:
    """A TileState in parity space: every field [4, cap, DY, DX]; radius is
    None under uniform radius (rebuilt by ``from_parity_state``)."""
    x: torch.Tensor
    y: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pid: torch.Tensor
    radius: Optional[torch.Tensor]
    num_active: torch.Tensor
    overflow_count: torch.Tensor
    geo: ParityGeometry

    @property
    def cap(self) -> int:
        return int(self.x.shape[1])

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kw) -> "ParityState":
        return dataclasses.replace(self, **kw)


def to_parity_state(state: TileState, config: SimConfig,
                    origin: int = 0) -> ParityState:
    """Full-space TileState -> ParityState (copies)."""
    _, TY, TX = state.dims
    geo = ParityGeometry(TY, TX, origin)
    radius = (None if config.tiled_uniform_radius
              else to_parity(state.radius, geo, 0.0))
    return ParityState(
        x=to_parity(state.x, geo, 0.0), y=to_parity(state.y, geo, 0.0),
        px=to_parity(state.px, geo, 0.0), py=to_parity(state.py, geo, 0.0),
        pid=to_parity(state.pid, geo, -1), radius=radius,
        num_active=state.num_active, overflow_count=state.overflow_count,
        geo=geo)


def from_parity_state(ps: ParityState, config: SimConfig) -> TileState:
    """Inverse of ``to_parity_state``; under uniform radius the radius plane
    is where(pid >= 0, r0, 0), which is what the full-space relocate leaves
    (it zero-fills every dead slot)."""
    geo = ps.geo
    x = from_parity(ps.x, geo)
    pid = from_parity(ps.pid, geo)
    if ps.radius is None:
        radius = torch.where(pid >= 0,
                             torch.full_like(x, f32(config.initial_radius)),
                             torch.zeros_like(x))
    else:
        radius = from_parity(ps.radius, geo)
    return TileState(x=x, y=from_parity(ps.y, geo),
                     px=from_parity(ps.px, geo), py=from_parity(ps.py, geo),
                     radius=radius, pid=pid, num_active=ps.num_active,
                     overflow_count=ps.overflow_count)


# ---------------------------------------------------------------------------
# kernel wrappers: shared checks
# ---------------------------------------------------------------------------

def par_fused(config: SimConfig, device: torch.device) -> bool:
    """gs_par_fused: None = one launch over all four parities on the card
    (the plain versions have no launches to fuse)."""
    if config.gs_par_fused is None:
        return device.type == "cuda"
    return bool(config.gs_par_fused)


def _groups(fused: bool):
    """(first parity, parities) of each launch."""
    return [(0, 4)] if fused else [(p, 1) for p in range(4)]


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


def _check_cuda(what: str, device: torch.device, **tensors) -> None:
    """Every tensor a contiguous one of its expected dtype and shape on
    ``device``, a CUDA device; the slots index as int32."""
    if device.type != "cuda":
        raise RuntimeError(f"{what}: the CUDA kernel needs CUDA tensors, "
                           f"got {device}")
    for name, (a, dtype, shape) in tensors.items():
        if a.device != device:
            raise RuntimeError(f"{what}: {name} must be on {device}, got "
                               f"{a.device}")
        if a.dtype != dtype or tuple(a.shape) != tuple(shape) \
                or not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype} "
                             f"{list(shape)}, got {a.dtype} {list(a.shape)}")
        if a.numel() >= 2 ** 31:
            raise ValueError(f"{what}: {name} {list(a.shape)} overflows int32")


def _check_par_state(ps: ParityState, what: str) -> None:
    cap, geo = ps.cap, ps.geo
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"{what}: tile_cap {cap} outside 1..{MAX_CAP}")
    shape = (4, cap, geo.DY, geo.DX)
    f = torch.float32
    planes = dict(x=(ps.x, f, shape), y=(ps.y, f, shape),
                  px=(ps.px, f, shape), py=(ps.py, f, shape),
                  pid=(ps.pid, _I32, shape))
    if ps.radius is not None:
        planes["radius"] = (ps.radius, f, shape)
    _check_cuda(what, ps.device, **planes)


def _geo_args(geo: ParityGeometry):
    return geo.TY, geo.TX, geo.DY, geo.DX, geo.origin


# ---------------------------------------------------------------------------
# K5-par: rank in parity space
# ---------------------------------------------------------------------------

def rank_par(ps: ParityState, config: SimConfig):
    """The frame's rank tables in parity space: (src, rpid, rrad) [4, K,
    DY, DX] and count [4, DY, DX], as K5 computes them per cell; border and
    pad cells hold the fill tables and count 0."""
    if ps.device.type == "cpu":
        return rank_par_plain(ps, config)
    return rank_par_cuda(ps, config)


def rank_par_plain(ps: ParityState, config: SimConfig):
    """Plain version of K5-par: relayout, ``rank_plain``, interior mask,
    relayout back."""
    full = from_parity_state(ps, config)
    src, rpid, rrad, count = rank_plain(full, config)
    _, TY, TX = full.dims
    ty = torch.arange(TY, device=ps.device).view(1, TY, 1)
    tx = torch.arange(TX, device=ps.device).view(1, 1, TX)
    inner = (ty >= 1) & (ty <= TY - 2) & (tx >= 1) & (tx <= TX - 2)
    geo = ps.geo
    return (to_parity(torch.where(inner, src, -1), geo, -1),
            to_parity(torch.where(inner, rpid, BIGPID), geo, BIGPID),
            to_parity(torch.where(inner, rrad, 0.0), geo, 0.0),
            to_parity(torch.where(inner, count, 0), geo, 0)[:, 0])


def rank_par_cuda(ps: ParityState, config: SimConfig):
    """Launch K5-par on the state's CUDA device."""
    _check_par_state(ps, "gs rank par")
    K = config.max_occupancy
    gs_kernels._check_k(K, ps.cap, "gs rank par")
    geo, dev = ps.geo, ps.device
    src = torch.empty((4, K, geo.DY, geo.DX), dtype=_I32, device=dev)
    rpid = torch.empty_like(src)
    rrad = torch.empty((4, K, geo.DY, geo.DX), dtype=torch.float32,
                       device=dev)
    count = torch.empty((4, geo.DY, geo.DX), dtype=_I32, device=dev)
    lib = _cuda.library()
    t = f32(tile_geometry(config)[0])
    with torch.cuda.device(dev):
        for p0, n in _groups(par_fused(config, dev)):
            rc = lib.gpe_gs_rank_par(
                ps.x.data_ptr(), ps.y.data_ptr(), _ptr(ps.radius),
                *_ptrs(ps.pid, src, rpid, rrad, count), ps.cap,
                *_geo_args(geo), p0, n, K, t, f32(config.initial_radius),
                _stream(dev))
            _cuda.check(rc, "gs rank par")
            LAUNCHES["gs_rank_par"] += 1
    return src, rpid, rrad, count


# ---------------------------------------------------------------------------
# K6-par: one color pass on the color's sub-grid
# ---------------------------------------------------------------------------

def color_par_(x, y, src, rrad, config: SimConfig, geo: ParityGeometry,
               color: int) -> None:
    """Color pass ``color`` (1..4) in place on x, y [4, cap, DY, DX], with
    the tables src, rrad [4, K, DY, DX]."""
    if x.device.type == "cpu":
        return color_par_plain_(x, y, src, rrad, config, geo, color)
    return color_par_cuda_(x, y, src, rrad, config, geo, color)


def color_par_plain_(x, y, src, rrad, config: SimConfig,
                     geo: ParityGeometry, color: int) -> None:
    """Plain version of K6-par: relayout, ``color_plain_``, relayout back."""
    fx, fy = from_parity(x, geo), from_parity(y, geo)
    color_plain_(fx, fy, from_parity(src, geo), from_parity(rrad, geo),
                 config, color)
    _assign_parity(x, fx, geo)
    _assign_parity(y, fy, geo)


def color_par_cuda_(x, y, src, rrad, config: SimConfig, geo: ParityGeometry,
                    color: int) -> None:
    """Launch K6-par for one color on x's CUDA device."""
    cap, K = int(x.shape[1]), config.max_occupancy
    gs_kernels._check_k(K, cap, "gs color par")
    planes, tables = (4, cap, geo.DY, geo.DX), (4, K, geo.DY, geo.DX)
    _check_cuda("gs color par", x.device,
                x=(x, torch.float32, planes), y=(y, torch.float32, planes),
                src=(src, _I32, tables), rrad=(rrad, torch.float32, tables))
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        rc = lib.gpe_gs_color_par(*_ptrs(x, y, src, rrad), cap,
                                  *_geo_args(geo), K, int(color),
                                  f32(config.stiffness), _stream(x.device))
    _cuda.check(rc, "gs color par")
    LAUNCHES["gs_color_par"] += 1


# ---------------------------------------------------------------------------
# K6-par's Verlet tail
# ---------------------------------------------------------------------------

def _check_fusable(config: SimConfig) -> None:
    if not (config.tiled_uniform_radius and config.world_shape == "box"):
        raise ValueError("the fused Verlet step needs a uniform radius and "
                         "a box world")


def verlet_(x, y, px, py, pid, prm: torch.Tensor, config: SimConfig) -> None:
    """One Verlet step in place on x, y, px, py (any layout, uniform radius,
    box world); ``prm`` = f32[4] [dt * dt_scale, mouse_x, mouse_y,
    pressed] on their device."""
    _check_fusable(config)
    if x.device.type == "cpu":
        return verlet_plain_(x, y, px, py, pid, prm, config)
    return verlet_cuda_(x, y, px, py, pid, prm, config)


def verlet_plain_(x, y, px, py, pid, prm, config: SimConfig) -> None:
    """Plain version of the Verlet tail: ``tiled.verlet``, written back."""
    out = verlet(x, y, px, py, pid >= 0, f32(config.initial_radius), prm,
                 config)
    for dst, v in zip((x, y, px, py), out):
        dst.copy_(v)


def _verlet_consts(config: SimConfig) -> np.ndarray:
    """Host float[6] in VerletConsts order, each rounded as the plain
    version rounds it."""
    r0 = np.float32(config.initial_radius)
    return np.array([r0, np.float32(config.world_width) - r0,
                     np.float32(config.world_height) - r0,
                     config.gravity[0], config.gravity[1],
                     config.mouse_strength], np.float32)


def verlet_cuda_(x, y, px, py, pid, prm, config: SimConfig) -> None:
    """Launch the Verlet tail on x's CUDA device."""
    shape = tuple(x.shape)
    f = torch.float32
    _check_cuda("gs verlet", x.device, x=(x, f, shape), y=(y, f, shape),
                px=(px, f, shape), py=(py, f, shape),
                pid=(pid, _I32, shape), prm=(prm, f, (4,)))
    consts = _verlet_consts(config)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        rc = lib.gpe_gs_verlet(*_ptrs(x, y, px, py, pid, prm), x.numel(),
                               consts.ctypes.data, _stream(x.device))
    _cuda.check(rc, "gs verlet")
    LAUNCHES["gs_verlet"] += 1


# ---------------------------------------------------------------------------
# K2-par: pull relocate in parity space
# ---------------------------------------------------------------------------

def relocate_par(ps: ParityState, config: SimConfig) -> ParityState:
    """One pull-relocate pass in parity space (fresh tensors); deferrals
    add to overflow_count."""
    if ps.device.type == "cpu":
        return relocate_par_plain(ps, config)[0]
    return relocate_par_cuda(ps, config)[0]


def relocate_par_plain(ps: ParityState, config: SimConfig
                       ) -> Tuple[ParityState, torch.Tensor]:
    """Plain version of K2-par: relayout, ``relocate_pull_plain``, relayout
    back.  Returns (new state, defer i32 [4, DY, DX])."""
    new, defer = relocate_pull_plain(from_parity_state(ps, config), config)
    out = to_parity_state(new, config, ps.geo.origin)
    return out, to_parity(defer[None], ps.geo, 0)[:, 0]


def relocate_par_cuda(ps: ParityState, config: SimConfig
                      ) -> Tuple[ParityState, torch.Tensor]:
    """Launch K2-par (plans, then applies) on the state's CUDA device.
    Returns (new state, defer i32 [4, DY, DX])."""
    _check_par_state(ps, "relocate par")
    geo, dev, cap = ps.geo, ps.device, ps.cap
    match = resolve_match(config, cap, geo.TY, geo.TX)  # full grid dims
    t, delta = tile_geometry(config)[0], config.hysteresis_delta
    plan = torch.empty_like(ps.pid)
    outs = [torch.empty_like(ps.x) for _ in range(4)]
    orad = None if ps.radius is None else torch.empty_like(ps.radius)
    opid = torch.empty_like(ps.pid)
    defer = torch.empty((4, geo.DY, geo.DX), dtype=_I32, device=dev)
    groups = _groups(par_fused(config, dev))
    tail = (_MATCH_CODE[match], f32(t), f32(delta), _stream(dev))
    lib = _cuda.library()
    with torch.cuda.device(dev):
        for p0, n in groups:  # every plan before any apply
            rc = lib.gpe_relocate_plan_par(
                *_ptrs(ps.x, ps.y, ps.pid, plan), cap, *_geo_args(geo), p0,
                n, *tail)
            _cuda.check(rc, "relocate par (plan)")
        for p0, n in groups:
            rc = lib.gpe_relocate_apply_par(
                *_ptrs(ps.x, ps.y, ps.px, ps.py), _ptr(ps.radius),
                *_ptrs(ps.pid, plan, *outs), _ptr(orad),
                *_ptrs(opid, defer), cap, *_geo_args(geo), p0, n, *tail)
            _cuda.check(rc, "relocate par (apply)")
    LAUNCHES["relocate_par"] += len(groups)
    return ps.replace(x=outs[0], y=outs[1], px=outs[2], py=outs[3],
                      radius=orad, pid=opid,
                      overflow_count=ps.overflow_count
                      + torch.sum(defer, dtype=_I32)), defer


# ---------------------------------------------------------------------------
# solve, integrate, step
# ---------------------------------------------------------------------------

def fuse_integrate(config: SimConfig, device: torch.device) -> bool:
    """gs_fuse_integrate, None following gs_par_fused's resolution; legal
    only under uniform radius in a box world (the JAX package's gate)."""
    fuse = (config.gs_fuse_integrate if config.gs_fuse_integrate is not None
            else par_fused(config, device))
    return bool(fuse and config.tiled_uniform_radius
                and config.world_shape == "box")


def solve_parity(ps: ParityState, config: SimConfig,
                 prm=None) -> ParityState:
    """One GS solve in parity space, in place on ps's x and y: K5-par once,
    then K6-par for colors 1..4; the occupants clamped past K add to
    overflow_count.  With ``prm`` (f32[4], this substep's dt) the
    substep's Verlet step follows color 4 (the Verlet tail, in place on
    x, y, px, py), which needs a uniform radius and a box world."""
    src, _, rrad, count = rank_par(ps, config)
    overflow = torch.sum(torch.clamp(count - config.max_occupancy, min=0),
                         dtype=_I32)
    for color in (1, 2, 3, 4):
        color_par_(ps.x, ps.y, src, rrad, config, ps.geo, color)
    if prm is not None:
        verlet_(ps.x, ps.y, ps.px, ps.py, ps.pid, prm, config)
    return ps.replace(overflow_count=ps.overflow_count + overflow)


def integrate_parity(ps: ParityState, prm: torch.Tensor,
                     config: SimConfig) -> ParityState:
    """The plain Verlet step over parity space (elementwise)."""
    radius = (ps.radius if ps.radius is not None
              else f32(config.initial_radius))
    x, y, px, py = verlet(ps.x, ps.y, ps.px, ps.py, ps.pid >= 0, radius, prm,
                          config)
    return ps.replace(x=x, y=y, px=px, py=py)


def gs_parity_step_fn(ps: ParityState, params, config: SimConfig,
                      prm=None) -> ParityState:
    """One GS frame in parity space: K2-par, then per substep the solve and
    the Verlet step (fused as the Verlet tail where ``fuse_integrate``
    allows, else the plain integrate).  The solve works in place on the
    relocate's fresh tensors.  ``prm`` = the substep's f32[4] on the
    device (built from ``params`` if None)."""
    if prm is None:
        prm = params.as_tensor(ps.device, 1.0 / config.substeps)
    ps = relocate_par(ps, config)
    fuse = fuse_integrate(config, ps.device)
    for _ in range(config.substeps):
        ps = solve_parity(ps, config, prm=prm if fuse else None)
        if not fuse:
            ps = integrate_parity(ps, prm, config)
    return ps


def gs_parity_tile_step(state: TileState, params, config: SimConfig,
                        n_steps: int = 1, prm=None) -> TileState:
    """Full-space facade: to parity space, ``n_steps`` parity steps, back."""
    ps = to_parity_state(state, config)
    for _ in range(n_steps):
        ps = gs_parity_step_fn(ps, params, config, prm)
    return from_parity_state(ps, config)


def gs_solve_parity_full(state: TileState, config: SimConfig) -> TileState:
    """Solve-only full-space facade of the par layout: relayout, K5-par and
    the K6-par colors, relayout back (positions move, nothing else)."""
    out = solve_parity(to_parity_state(state, config), config)
    return state.replace(x=from_parity(out.x, out.geo),
                         y=from_parity(out.y, out.geo),
                         overflow_count=out.overflow_count)


def gs_solve_sub(state: TileState, config: SimConfig,
                 origin: int) -> TileState:
    """The "mx" (origin 0) and "dec" (origin -1) solves: rank in full space
    (K5), relayout x, y and the tables, the K6-par colors, relayout back."""
    src, _, rrad, count = gs_kernels.rank(state, config)
    overflow = torch.sum(torch.clamp(count - config.max_occupancy, min=0),
                         dtype=_I32)
    _, TY, TX = state.dims
    geo = ParityGeometry(TY, TX, origin)
    x, y = to_parity(state.x, geo, 0.0), to_parity(state.y, geo, 0.0)
    psrc, prrad = to_parity(src, geo, -1), to_parity(rrad, geo, 0.0)
    for color in (1, 2, 3, 4):
        color_par_(x, y, psrc, prrad, config, geo, color)
    return state.replace(x=from_parity(x, geo), y=from_parity(y, geo),
                         overflow_count=state.overflow_count + overflow)


def resolve_gs_layout(config: SimConfig, device: torch.device) -> str:
    """gs_layout with "auto" resolved: AUTO_LAYOUT_CUDA on a CUDA state,
    "flat" elsewhere."""
    if config.gs_layout != "auto":
        return config.gs_layout
    return AUTO_LAYOUT_CUDA if torch.device(device).type == "cuda" else "flat"


def gs_solve_layout(state: TileState, config: SimConfig) -> TileState:
    """One GS solve through the kernel wrappers in the configured layout
    (``gs_solve_pallas``'s dispatch, with its fallback to flat on grids too
    small to decompose)."""
    layout = resolve_gs_layout(config, state.device)
    _, TY, TX = state.dims
    if layout == "dec" and (TY - 2 < 2 or TX - 2 < 2):
        layout = "flat"
    if layout in ("mx", "par") and (TY < 2 or TX < 2):
        layout = "flat"
    if layout == "par":
        return gs_solve_parity_full(state, config)
    if layout in ("mx", "dec"):
        return gs_solve_sub(state, config, 0 if layout == "mx" else -1)
    return gs_kernels.gs_solve_flat(state, config)
