"""Device compositor for the tiled engine
(``gpu_physics_engine_tpu.render.device``) on PyTorch tensors.

The persistent tile storage ``[CAP, TY, TX]`` is a coarse framebuffer, and
a frame is drawn where the state lives; only the finished u8 image leaves
the device:

  1. **Composite** — each tile is sampled at S x S points
     (``render_supersample``).  At a sample every slot's soft-circle alpha
     is ``1 - smoothstep(0.2304, 0.25, d^2 / span^2)`` (the reference's
     particle_drawer.wgsl:69-81, the span clamped to 1.5 sample spacings
     so that a small particle still lights its sample), and its color the
     reference's velocity ramp (wgsl:39-67, ``render/colormap.py``).  The
     brightest slot wins, the first in slot order on a tie; the color is
     scaled by its alpha over black.  r, g and b stay separate planes.
  2. **Resample** — each sample grid is resampled to the viewport by two
     matrix products with tent weights built on the device from the
     camera rectangle, and the grids are summed with one separable
     normalisation at the end (bilinear interpolation over the union of
     the grids).  The products round as the JAX package's do: both
     operands of the first are rounded to bf16 and accumulated in f32, its
     result rounded to bf16, and the second accumulates the bf16 weights
     and that result in f32 and keeps f32.  Here the operands are
     bf16-valued f32 tensors multiplied in f32 (TF32 on the card, which
     holds bf16 values exactly), so no product rounds its result to bf16.
  3. **Finish** — divide by the normalisation, flip from world y-up to
     image y-down, clip and cast to u8 (truncating ``x * 255 + 0.5``).

A particle renders at its tile's sample points, within half a sample
spacing of its true position.  Divisions by a constant divide by a 0-d f32
tensor on the operand's device (on the card ``x / c`` for a Python float
multiplies by the reciprocal), and compound constants are computed in
Python double and rounded to f32, as the JAX package's weak typing does.
The JAX package's jitted composite may contract ``a * b + c`` into a
fused multiply-add, which eager PyTorch never does, so frames agree with
it within one u8 step, not bit for bit.

The JAX package's ``_render_window`` (many frames inside one scanned
program, to time the device through the TPU's remote runtime) is not
ported: ``render_throughput_ms`` times eager frames with CUDA events.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import statistics
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gpu_physics_engine_torch.core.config import SimConfig
from gpu_physics_engine_torch.ops import gs_parity
from gpu_physics_engine_torch.ops.integrate import f32, sqrt_rn
from gpu_physics_engine_torch.ops.tiled import TileState, tile_geometry

MAX_VELOCITY = 0.3  # particle_drawer.wgsl:21
_F32 = torch.float32

Rect = Tuple[float, float, float, float]


@functools.lru_cache(maxsize=None)
def _const(c: float, device: torch.device) -> torch.Tensor:
    """f32(c) as a 0-d tensor on ``device``, made once."""
    return torch.full((), f32(c), dtype=_F32, device=device)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / f32(c), correctly rounded on every device."""
    return a / _const(c, a.device)


def _smoothstep(e0: float, e1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(_div(x - f32(e0), e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _velocity_rgb(vx: torch.Tensor, vy: torch.Tensor):
    """The reference ramp, blue -> pink -> yellow (wgsl:39-67), as three
    separate planes (r, g, b)."""
    speed = sqrt_rn(vx * vx + vy * vy)
    t = torch.clamp(_div(speed, MAX_VELOCITY), 0.0, 1.0)
    s1 = _smoothstep(0.0, 0.5, t)
    s2 = _smoothstep(0.5, 1.0, t)
    # lerp(lerp(low, mid, s1), high, s2) per channel:
    # low = (0, 0, 1), mid = (1, 0.5, 1), high = (1, 1, 0)
    b = 1.0 - s2
    r = s1 * b + s2
    g = 0.5 * s1 * b + s2
    return r, g, b


def _bilinear_weights(out_px: int, x0: float, x1: float,
                      centers: torch.Tensor, normalize: bool = True,
                      spacing: Optional[float] = None) -> torch.Tensor:
    """[out_px, n_src] bilinear weights: output pixel centers sampled over
    source sample centers (world units).  ``x0``, ``x1`` are f32 values.
    ``normalize=False`` returns the raw tent weights (callers that sum
    several sample grids normalise once).  ``spacing`` overrides the tent
    width, which is otherwise the first gap of ``centers`` (the parity
    renderer passes the full grid's pitch)."""
    dev = centers.device
    ox = (f32(x0) + _div(torch.arange(out_px, dtype=_F32, device=dev) + 0.5,
                         out_px) * float(np.float32(x1) - np.float32(x0)))
    diff = torch.abs(ox[:, None] - centers[None, :])
    if spacing is None:
        d = diff / torch.clamp(centers[1] - centers[0], min=f32(1e-6))
    else:
        d = _div(diff, spacing)
    w = torch.clamp(1.0 - d, min=0.0)
    if not normalize:
        return w
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=f32(1e-6))


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bf16 (to nearest, ties to even), held in f32."""
    return a.to(torch.bfloat16).to(_F32)


@contextlib.contextmanager
def _tf32(device: torch.device):
    """TF32 matrix products on the card for the block only (bf16-valued
    operands are exact in TF32; the accumulation stays f32)."""
    if device.type != "cuda":
        yield
        return
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@dataclasses.dataclass
class Resample:
    """The viewport's weights: bf16-valued row weights ``wy[(par, i)]``
    [H, rows] and transposed column weights ``wxT[(par, j)]`` [cols, W] for
    each row / column parity and sample offset, and the separable
    normalisation ``norm`` [H, W].  Full space has parity 0 only."""
    wy: Dict[Tuple[int, int], torch.Tensor]
    wxT: Dict[Tuple[int, int], torch.Tensor]
    norm: torch.Tensor


def _centers(full: torch.Tensor, k: int, S: int, t: float) -> torch.Tensor:
    """World positions of sample offset k along an axis, for the full-grid
    indices ``full``: (index - 1 + (k + 0.5) / S) * t, in f32."""
    return (full.to(_F32) - 1.0 + f32((k + 0.5) / S)) * f32(t)


def resample_weights(config: SimConfig, rect: Rect, width: int, height: int,
                     device, parity: bool = False) -> Resample:
    """The weights ``render_core`` (``parity=False``) or
    ``render_parity_core`` (``parity=True``) builds for this viewport; they
    depend only on the config, the rect and the frame size."""
    t, TY, TX = tile_geometry(config)
    S = config.render_supersample
    x0, y0, x1, y1 = (float(np.float32(v)) for v in rect)
    device = torch.device(device)
    wy, wxT = {}, {}
    ny = torch.zeros((height,), dtype=_F32, device=device)
    nx = torch.zeros((width,), dtype=_F32, device=device)
    pars = (0, 1) if parity else (0,)
    geo = gs_parity.ParityGeometry(TY, TX)
    for axis, n_full, out_px, lo, hi in (("y", TY, height, y0, y1),
                                         ("x", TX, width, x0, x1)):
        for par in pars:
            if parity:
                n_sub = geo.DY if axis == "y" else geo.DX
                full = 2 * torch.arange(n_sub, device=device) + par
                valid = (full < n_full).to(_F32)
            else:
                full = torch.arange(n_full, device=device)
            for k in range(S):
                w = _bilinear_weights(out_px, lo, hi,
                                      _centers(full, k, S, t),
                                      normalize=False,
                                      spacing=t if parity else None)
                if parity:
                    w = w * valid[None, :]
                if axis == "y":
                    ny = ny + w.sum(dim=1)  # once per (row parity, i)
                    wy[(par, k)] = _bf16(w)
                else:
                    nx = nx + w.sum(dim=1)  # once per (column parity, j)
                    wxT[(par, k)] = _bf16(w.t()).contiguous()
    norm = torch.clamp(ny[:, None] * nx[None, :], min=f32(1e-6))
    return Resample(wy=wy, wxT=wxT, norm=norm)


class _Planes:
    """P sub-grids' fields ``[P, CAP, R, C]``, prepared once a frame for
    their samples: velocity planes, the squared span and the occupancy,
    with the full-grid row index ``rows`` [P, R] and column index ``cols``
    [P, C] of each cell.  Full space is one sub-grid; the parity layout's
    four composite together, one launch an operation."""

    def __init__(self, x, y, px, py, radius, pid, rows, cols, spacing):
        self.x, self.y = x, y
        self.vx, self.vy = x - px, y - py
        self.occ = pid >= 0
        # effective quad span: 2r, or 1.5 x the sample spacing if bigger
        span = torch.clamp(2.0 * radius, min=f32(1.5 * spacing))
        self.r2 = torch.clamp(span * span, min=f32(1e-8))
        self.rows, self.cols = rows, cols

    def sample(self, i: int, j: int, S: int, t: float) -> torch.Tensor:
        """Brightest-wins composite at sub-sample (i, j): [P, 3, R, C]
        (r, g, b over black)."""
        cx = _centers(self.cols, j, S, t)[:, None, None, :]
        cy = _centers(self.rows, i, S, t)[:, None, :, None]
        dx = self.x - cx
        dy = self.y - cy
        alpha = 1.0 - _smoothstep(0.2304, 0.25, (dx * dx + dy * dy) / self.r2)
        alpha = torch.where(self.occ, alpha, 0.0)
        # the first slot of the largest alpha, as jnp.argmax; an empty
        # tile takes slot 0 (x = px = 0 there) times alpha 0
        amax, best = torch.max(alpha, dim=1)
        vx = torch.gather(self.vx, 1, best[:, None])[:, 0]
        vy = torch.gather(self.vy, 1, best[:, None])[:, 0]
        return torch.stack([c * amax for c in _velocity_rgb(vx, vy)], dim=1)


def _resample_add(acc: torch.Tensor, planes: torch.Tensor,
                  wy: torch.Tensor, wxT: torch.Tensor) -> torch.Tensor:
    """acc + wy @ bf16(bf16(planes) @ wxT) per channel, f32 accumulation."""
    c, rows, cols = planes.shape
    with _tf32(planes.device):
        o = torch.mm(_bf16(planes).reshape(c * rows, cols), wxT)
        return acc + torch.matmul(wy, _bf16(o).reshape(c, rows, -1))


def _finish(acc: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """[3, H, W] sums -> u8 [H, W, 3], world y-up to image y-down."""
    out = torch.clamp(acc / norm, 0.0, 1.0) * 255.0 + 0.5
    return torch.flip(out.to(torch.uint8), (1,)).permute(1, 2, 0).contiguous()


def render_core(x, y, px, py, radius, pid, rect: Rect, config: SimConfig,
                width: int, height: int,
                weights: Optional[Resample] = None) -> torch.Tensor:
    """One frame of full-space tile planes ``[CAP, TY, TX]`` -> u8
    ``[height, width, 3]`` on their device (``_render_core``).  ``weights``
    are ``resample_weights(config, rect, width, height, x.device)``, built
    here when not given."""
    t, TY, TX = tile_geometry(config)
    S = config.render_supersample
    dev = x.device
    if weights is None:
        weights = resample_weights(config, rect, width, height, dev)
    f = _Planes(x[None], y[None], px[None], py[None], radius[None],
                pid[None], torch.arange(TY, device=dev)[None],
                torch.arange(TX, device=dev)[None], t / S)
    acc = torch.zeros((3, height, width), dtype=_F32, device=dev)
    for i in range(S):
        for j in range(S):
            acc = _resample_add(acc, f.sample(i, j, S, t)[0],
                                weights.wy[(0, i)], weights.wxT[(0, j)])
    return _finish(acc, weights.norm)


def render_parity_core(ps: gs_parity.ParityState, rect: Rect,
                       config: SimConfig, width: int, height: int,
                       weights: Optional[Resample] = None) -> torch.Tensor:
    """``render_core`` of a parity-space GS state (``gs_parity``'s par
    layout, origin 0: ``full = 2 * sub + parity``), drawn without
    recomposing full space.  Tiles are disjoint across parities, so the
    four sub-grids composite on their own (together, one launch an
    operation), and their grids join the sample grids of the resample,
    each keeping the full grid's tent width.  Rows and columns whose full
    index lies outside the grid are pad cells: their weights are masked.
    The accumulation order differs from ``render_core``'s, so frames agree
    with it within one u8 step.  ``weights`` are
    ``resample_weights(..., parity=True)``."""
    t, _, _ = tile_geometry(config)
    S = config.render_supersample
    dev = ps.device
    if ps.geo.origin != 0:
        raise ValueError("render_parity_core draws the par layout (origin 0)")
    if weights is None:
        weights = resample_weights(config, rect, width, height, dev,
                                   parity=True)
    p = torch.arange(4, device=dev)[:, None]  # p = 2 * pa + pb
    # no radius plane under uniform radius (the par step drops it)
    radius = (ps.radius if ps.radius is not None
              else torch.where(ps.pid >= 0, f32(config.initial_radius), 0.0))
    f = _Planes(ps.x, ps.y, ps.px, ps.py, radius, ps.pid,
                2 * torch.arange(ps.geo.DY, device=dev) + p // 2,
                2 * torch.arange(ps.geo.DX, device=dev) + p % 2, t / S)
    samples = {(i, j): f.sample(i, j, S, t)
               for i in range(S) for j in range(S)}
    acc = torch.zeros((3, height, width), dtype=_F32, device=dev)
    for pa in (0, 1):
        for i in range(S):
            for pb in (0, 1):
                for j in range(S):
                    acc = _resample_add(
                        acc, samples[(i, j)][2 * pa + pb],
                        weights.wy[(pa, i)], weights.wxT[(pb, j)])
    return _finish(acc, weights.norm)


def autofit_rect(config: SimConfig, width: int, height: int,
                 fill: float = 0.9) -> Rect:
    """World rectangle that fits the whole world at ``fill`` coverage,
    aspect-corrected — the reference camera's auto-fit (camera.rs:30-42)."""
    ww, wh = config.world_width, config.world_height
    zoom = fill * min(width / ww, height / wh)
    vw, vh = width / zoom, height / zoom
    cx, cy = ww / 2.0, wh / 2.0
    return (cx - vw / 2.0, cy - vh / 2.0, cx + vw / 2.0, cy + vh / 2.0)


def _state_planes(state: TileState) -> Sequence[torch.Tensor]:
    return (state.x, state.y, state.px, state.py, state.radius, state.pid)


def frame_drawer(config: SimConfig, width: int, height: int, device,
                 parity: bool = False) -> Callable:
    """``draw(s)`` -> the u8 frame of ``s`` on its device, at the auto-fit
    rect with the resample weights built once: the frame
    ``TiledEngine.render_run`` draws after each step.  ``s`` is a
    TileState, or with ``parity`` a ParityState of the par layout."""
    rect = autofit_rect(config, width, height)
    weights = resample_weights(config, rect, width, height, device,
                               parity=parity)
    if parity:
        return lambda ps: render_parity_core(ps, rect, config, width,
                                             height, weights=weights)
    return lambda st: render_core(*_state_planes(st), rect, config, width,
                                  height, weights=weights)


def render_throughput_ms(state, config: SimConfig, frames: int = 16,
                         width: int = 1280, height: int = 720) -> float:
    """Median ms a frame over three runs of ``frames`` frames, drawn as
    ``render_run`` draws them (``frame_drawer``: weights built once, before
    the timing), after one warm-up frame.  ``state`` is a TileState, or a
    ParityState, which is drawn from parity space.  On the card CUDA events
    around each run time the device; on the CPU, wall time."""
    parity = isinstance(state, gs_parity.ParityState)
    draw = frame_drawer(config, width, height, state.device, parity=parity)
    cuda = state.device.type == "cuda"
    draw(state)
    runs = []
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(frames):
                draw(state)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / frames)
        else:
            t0 = time.perf_counter()
            for _ in range(frames):
                draw(state)
            runs.append((time.perf_counter() - t0) * 1e3 / frames)
    return statistics.median(runs)


def render_tiles_device(state: TileState, config: SimConfig,
                        rect: Optional[Rect] = None, width: int = 1280,
                        height: int = 720) -> np.ndarray:
    """A frame of a TileState drawn on its device -> host u8
    ``[height, width, 3]``.  ``rect`` = (x0, y0, x1, y1), the world window
    (default: the 90% auto-fit)."""
    if rect is None:
        rect = autofit_rect(config, width, height)
    img = render_core(*_state_planes(state), rect, config, width, height)
    return img.cpu().numpy()
