"""The port's device compositor (gpu_physics_engine_torch/render/) and the
TiledEngine's render entry points, against the JAX package's
render/device.py on the same numpy inputs, on the CPU.

  * ``velocity_colors`` and ``autofit_rect`` bit-equal to the JAX package's.
  * ``render_core`` against the jitted JAX ``_render_core`` within one u8
    step on every pixel (XLA may contract a product into a sum; the port
    never does): S = 1 and 2, uniform and mixed radii, the auto-fit and a
    zoomed, off-centre rect, with two particles tied at alpha 1 in one
    tile, where the first slot must win.
  * ``render_parity_core`` on a par GS state (cap 4, K 4, an odd TX, so
    the parity sub-grids have a pad column) against the JAX function on
    the JAX package's own parity decomposition of the same state, and
    against the port's ``render_core`` of the full-space state.
  * The engine: ``render_run`` leaves the state bit-equal to ``run()``
    over two windows (Jacobi at relocate interval 2, and GS par), its
    checksum is the int32-wrapped pixel sum of ``step()`` +
    ``render_frame()``, ``step_render_frame`` equals ``step()`` +
    ``render_frame()`` and keeps the relocate phase, an empty scene is
    black, a sparse off-centre particle stays visible, and
    ``render_throughput_ms`` returns a positive time.

The scenes are tests/test_device_render.py's: a 44 x 22 world, cap 4,
32-48 particles, frames of 64 x 32.  The JAX composite compiles once per
config, and the par state and its JAX parity decomposition are built once
for the four parity cases.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu.ops import gs_parity as jgp
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_tpu.render import colormap as jcolormap
from gpu_physics_engine_tpu.render import device as jdev
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine
from gpu_physics_engine_torch.core.tuned import gs_config
from gpu_physics_engine_torch.ops import gs_parity as gp
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.render import colormap, device

W, H = 64, 32
ZOOM = (5.3, 2.1, 30.7, 14.9)  # off-centre, about 2.5 px per world unit
STATE = tt.FIELDS + ("num_active", "overflow_count")


def cfgs(**kw):
    base = dict(max_particles=64, initial_particles=0, world_width=44.0,
                world_height=22.0, initial_radius=0.5, pipeline="tiled",
                tile_cap=4, tile_multiplier=4.4, sort_interval_steps=0)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def scene(n=48, seed=5, mixed=False, tie=False):
    """Random particles over the world with some velocity; ``tie`` puts two
    more first, both within 0.1 of tile (4, 4)'s center, so both reach
    alpha 1 at its sample: a slow one and a fast one."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(1.0, 43.0, n),
                    rng.uniform(1.0, 21.0, n)], -1).astype(np.float32)
    prev = (pos + rng.normal(0.0, 0.15, pos.shape)).astype(np.float32)
    rad = (rng.uniform(0.3, 0.5, n) if mixed
           else np.full(n, 0.5)).astype(np.float32)
    if tie:
        c = 2.2 * 3.5  # tile (4, 4) covers [6.6, 8.8) on both axes
        two = np.array([[c - 0.05, c + 0.05], [c + 0.05, c - 0.05]],
                       np.float32)
        vel = np.array([[0.01, 0.0], [0.0, 0.29]], np.float32)
        pos = np.concatenate([two, pos])
        prev = np.concatenate([two - vel, prev])
        rad = np.concatenate([np.full(2, 0.5, np.float32), rad])
    return pos, rad, prev


def states(jcfg, tcfg, pos, rad, prev):
    a = jt.init_tiles(jcfg, pos, rad, previous_positions=prev)
    b = tt.init_tiles(tcfg, pos, rad, previous_positions=prev)
    for f in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy())
    return a, b


def planes(st):
    return [getattr(st, f) for f in tt.FIELDS]


def assert_within_one(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, f"{int((d > 1).sum())} pixels differ by more " \
                         f"than 1 (max {d.max()})"


def test_velocity_colors_bit_equal():
    rng = np.random.default_rng(0)
    v = rng.normal(0.0, 0.2, (4096, 2)).astype(np.float32)
    v[:3] = [[0.0, 0.0], [0.3, 0.0], [1.0, -1.0]]
    np.testing.assert_array_equal(colormap.velocity_colors(v),
                                  jcolormap.velocity_colors(v))
    for e0, e1 in ((0.0, 0.5), (0.2304, 0.25)):
        x = rng.uniform(-0.1, 1.1, 1000).astype(np.float32)
        np.testing.assert_array_equal(colormap.smoothstep(e0, e1, x),
                                      jcolormap.smoothstep(e0, e1, x))
    assert colormap.MAX_VELOCITY == jcolormap.MAX_VELOCITY == \
        device.MAX_VELOCITY


@pytest.mark.parametrize("width, height", [(1280, 720), (64, 32), (33, 97)])
@pytest.mark.parametrize("world", [(44.0, 22.0), (3048.0, 1048.0)])
def test_autofit_rect_equal(width, height, world):
    jcfg, tcfg = cfgs(world_width=world[0], world_height=world[1])
    assert device.autofit_rect(tcfg, width, height) == \
        jdev.autofit_rect(jcfg, width, height)


@pytest.mark.parametrize("rect", ["auto", "zoom"])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("S", [1, 2])
def test_render_core_matches_jax(S, mixed, rect):
    jcfg, tcfg = cfgs(render_supersample=S)
    a, b = states(jcfg, tcfg, *scene(mixed=mixed, tie=True))
    r = device.autofit_rect(tcfg, W, H) if rect == "auto" else ZOOM
    want = np.asarray(jdev._render_core(
        *planes(a), jnp.asarray(r, jnp.float32), jcfg, W, H))
    got = device.render_core(*planes(b), r, tcfg, W, H)
    assert got.dtype == torch.uint8 and got.shape == (H, W, 3)
    assert_within_one(got.numpy(), want)
    assert want.max() > 0


def test_tie_takes_the_first_slot():
    """Two particles at alpha 1 in one tile: the first slot's color wins,
    as jnp.argmax's first maximum does.  A pixel center on the tile's
    sample point carries the winner's color, unblended."""
    jcfg, tcfg = cfgs()
    pos, rad, prev = scene(n=0, tie=True)
    a, b = states(jcfg, tcfg, pos, rad, prev)
    slot0 = int(b.pid[0, 4, 4])
    assert int(b.pid[1, 4, 4]) >= 0
    rect = (1.2, 1.2, 41.2, 21.2)  # 1 px per world unit, centers on x.7
    got = device.render_tiles_device(b, tcfg, rect=rect, width=40, height=20)
    want = np.asarray(jdev._render_core(*planes(a),
                                        jnp.asarray(rect, jnp.float32),
                                        jcfg, 40, 20))
    assert_within_one(got, want)
    px = got[20 - 1 - 6, 6].astype(np.float32) / 255.0  # world (7.7, 7.7)
    rgb = colormap.velocity_colors((pos - prev)[[slot0, 1 - slot0]])
    np.testing.assert_allclose(px, rgb[0], atol=1.5 / 255.0)
    assert np.abs(px - rgb[1]).max() > 0.2  # not the other particle


def _par_state(uniform: bool):
    """A par GS state after 3 steps of the port's par engine: cap 4, K 4,
    TX = 23 (odd), so every parity sub-grid with column parity 1 has a pad
    column."""
    jcfg, tcfg = cfgs(max_particles=48, initial_particles=48,
                      tiled_solver="gs", max_occupancy=4, tile_multiplier=4.2,
                      tiled_uniform_radius=uniform, tiled_match="flip")
    tcfg = tcfg.replace(gs_layout="par")
    pos, rad, prev = scene(mixed=not uniform, seed=3)
    e = TiledEngine.from_arrays(tcfg, pos, rad, previous_positions=prev,
                                device="cpu")
    e.run(3)
    assert e.parity_space and e.state.dims[2] % 2 == 1
    return jcfg, e


@functools.lru_cache(maxsize=None)
def _par_case(uniform: bool):
    jcfg, e = _par_state(uniform)
    js = jt.TileState(**{k: jnp.asarray(v)
                         for k, v in tt.to_numpy(e.state).items()})
    return jcfg, e, jgp.to_parity(js, jcfg)[0]


@pytest.mark.parametrize("rect", ["auto", "zoom"])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("uniform", [True, False])
def test_render_parity_core_matches_jax(uniform, S, rect):
    jcfg, e, subs = _par_case(uniform)
    jcfg, tcfg = jcfg.replace(render_supersample=S), \
        e.config.replace(render_supersample=S)
    _, TY, TX = tt.tile_geometry(tcfg)
    r = device.autofit_rect(tcfg, W, H) if rect == "auto" else ZOOM
    ps = gp.to_parity_state(e.state, tcfg)
    assert (ps.radius is None) == uniform
    got = device.render_parity_core(ps, r, tcfg, W, H).numpy()
    want = np.asarray(jdev.render_parity_core(
        subs, jnp.asarray(r, jnp.float32), jcfg, W, H, TY, TX))
    assert_within_one(got, want)
    full = device.render_core(*planes(e.state), r, tcfg, W, H).numpy()
    assert_within_one(got, full)
    assert got.max() > 0


def _engine(pos, rad, prev=None, **kw):
    _, tcfg = cfgs(max_particles=max(len(pos), 1), **kw)
    return TiledEngine.from_arrays(tcfg, pos, rad, previous_positions=prev,
                                   device="cpu")


def test_empty_scene_renders_black():
    e = _engine(np.zeros((0, 2), np.float32), np.zeros(0, np.float32))
    img = e.render_frame(width=32, height=16)
    assert img.shape == (16, 32, 3) and img.dtype == np.uint8
    assert (img == 0).all()


def test_offcenter_sparse_particle_always_visible():
    """tests/test_device_render.py's case: a small particle far from its
    tile's sample point still renders (the span is clamped to the sample
    spacing), and S = 2 places it closer than S = 1."""
    t = 2.2
    true = np.array([[t * 1.5 + 1.0, t * 1.5 + 1.0]], np.float32)
    e = _engine(true, np.array([0.3], np.float32), prev=true)
    rect = (0.0, 0.0, 44.0, 22.0)

    def err(cfg):
        img = device.render_tiles_device(e.state, cfg, rect=rect, width=88,
                                         height=44)
        ys, xs = np.nonzero(img.max(axis=-1) > 0)
        assert len(xs), "particle dropped from the frame"
        # 2 px per world unit, y flipped
        c = ((xs.mean() + 0.5) / 2.0, (44.0 - (ys.mean() + 0.5)) / 2.0)
        return np.hypot(c[0] - true[0, 0], c[1] - true[0, 1])

    assert err(e.config) < t
    assert err(e.config.replace(render_supersample=2)) < 0.75 * t


def _twins(kind: str, chunk: int = 4):
    """Two engines on one seeded scene: Jacobi at relocate interval 2 with
    the sweep every 8 steps, or the par GS engine (sweep every 8)."""
    if kind == "jacobi":
        _, cfg = cfgs(max_particles=48, initial_particles=32,
                      tiled_relocate_interval=2, sort_interval_steps=8)
    else:
        cfg = gs_config(48, world_width=44.0, world_height=22.0, tile_cap=4,
                        max_occupancy=4, gs_layout="par",
                        sort_interval_steps=8)
    return [TiledEngine(cfg, seed=1, chunk=chunk, device="cpu")
            for _ in range(2)]


def assert_same_state(a, b):
    for f in STATE:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


@pytest.mark.parametrize("kind", ["jacobi", "gs_par"])
def test_render_run_matches_run(kind):
    """Two windows of 8 steps, each crossing a 4-step window boundary and
    the second starting at the sweep: render_run's trajectory is run()'s
    bit for bit, and its relocate phase too.  (Windows are whole CHUNKs
    here: a run() remainder shorter than CHUNK takes single steps, which
    keep the relocate phase where render_run's window restarts it, as in
    the JAX package.)"""
    a, b = _twins(kind)
    assert b.parity_space == (kind == "gs_par")
    for _ in range(2):
        a.run(8)
        acc = b.render_run(8, width=40, height=20)
        assert isinstance(acc, int) and acc > 0
        assert_same_state(a, b)
        assert (a._since_reloc, a._steps_done, a._sweep_count) == \
            (b._since_reloc, b._steps_done, b._sweep_count)


def test_render_run_checksum_is_the_frames_sum():
    """render_run's checksum = the int32-wrapped sum of every pixel of the
    frames step() + render_frame() draw (6 steps: a window of 4 and one
    of 2, a sweep at 8 not reached)."""
    a, b = _twins("jacobi")
    total = 0
    for _ in range(6):
        a.step()
        total += int(a.render_frame(width=40, height=20)
                     .astype(np.int64).sum())
    acc = b.render_run(6, width=40, height=20)
    assert acc == (total + 2**31) % 2**32 - 2**31 == total
    assert_same_state(a, b)


@pytest.mark.parametrize("kind, interval", [("jacobi", 1), ("jacobi", 2),
                                            ("gs_par", 1)])
def test_step_render_frame_matches_step_and_render(kind, interval):
    """step_render_frame = step() + render_frame(): image and state bit for
    bit, the relocate phase in lockstep (interval 2), across the sweep at
    step 8."""
    a, b = _twins(kind)
    if interval != 1:
        for e in (a, b):
            e.config = e.config.replace(tiled_relocate_interval=interval)
            e._configure()
    for _ in range(9):
        fused = a.step_render_frame(rect=ZOOM, width=40, height=20)
        b.step()
        np.testing.assert_array_equal(
            fused, b.render_frame(rect=ZOOM, width=40, height=20))
        assert (a._since_reloc, a._steps_done) == \
            (b._since_reloc, b._steps_done)
    assert_same_state(a, b)
    assert fused.max() > 0


@pytest.mark.parametrize("layout", ["full", "parity"])
def test_render_throughput_ms_positive(layout):
    """A finite positive time, from a TileState and from a ParityState."""
    if layout == "full":
        _, tcfg = cfgs()
        st = tt.init_tiles(tcfg, *scene()[:2])
    else:
        _, e = _par_state(True)
        tcfg = e.config
        st = gp.to_parity_state(e.state, tcfg)
    ms = device.render_throughput_ms(st, tcfg, frames=2, width=64,
                                     height=32)
    assert np.isfinite(ms) and ms > 0
