"""The port's host render layer (gpu_physics_engine_torch/render/: camera,
lines, the rasterizer's ``draw_axis_lines``, tilemap, viewer; utils/png)
against the JAX package's on the same numpy inputs, on the CPU.

  * ``Camera`` after one call sequence (pan keys, cursor, wheel, updates,
    a resize): every transform equal in float64 within 1e-12.
  * ``grid_line_segments`` and ``encode_png`` (levels 6 and 1) equal;
    ``draw_axis_lines`` frames equal (both packages' C++ builds take the
    same g++ flags); a bad frame raises, and so does a failed build.
  * ``tile_stats`` on a TileState carried across from the JAX package's
    arrays: counts exactly, mean |v| bit for bit (the port folds the CAP
    sum in slot order, as XLA:CPU reduces the axis here; 2e-7 relative
    is the tolerance the JAX function itself gives no more than);
    ``render_tilemap`` frames within one u8.
  * ``Viewer.render`` (the host splat, grid on and off) frames equal;
    ``Viewer.render_engine``'s device path (``TiledEngine.render_frame``
    under the camera's rect, the grid on, ``preview_scale`` 2) within one
    u8 of JAX's, from engines built by ``from_arrays`` on the same arrays.

Scenes: a 44 x 22 world, cap 4, 48 particles, frames of 96 x 48 or less.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu.core.tiled_engine import TiledEngine as JEngine
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_tpu.render import camera as jcamera
from gpu_physics_engine_tpu.render import lines as jlines
from gpu_physics_engine_tpu.render import rasterizer as jras
from gpu_physics_engine_tpu.render import tilemap as jtilemap
from gpu_physics_engine_tpu.render import viewer as jviewer
from gpu_physics_engine_tpu.utils import png as jpng
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.ops import _native
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.render import camera, lines, rasterizer
from gpu_physics_engine_torch.render import tilemap, viewer
from gpu_physics_engine_torch.utils import png

STATE = tt.FIELDS + ("num_active", "overflow_count")
WORLD = (44.0, 22.0)


def cfgs(**kw):
    base = dict(max_particles=64, initial_particles=0, world_width=WORLD[0],
                world_height=WORLD[1], initial_radius=0.5, pipeline="tiled",
                tile_cap=4, tile_multiplier=4.4, sort_interval_steps=0)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def scene(n=48, seed=5, vel=0.15):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(1.0, 43.0, n),
                    rng.uniform(1.0, 21.0, n)], -1).astype(np.float32)
    prev = (pos + rng.normal(0.0, vel, pos.shape)).astype(np.float32)
    return pos, np.full(n, 0.5, np.float32), prev


@pytest.fixture(scope="module")
def carried():
    """The scene tiled by the JAX package, and the same arrays carried
    into the port (``from_numpy``)."""
    jcfg, tcfg = cfgs()
    pos, rad, prev = scene()
    a = jt.init_tiles(jcfg, pos, rad, previous_positions=prev)
    arrays = {f: np.asarray(getattr(a, f)) for f in STATE}
    return jcfg, tcfg, a, tt.from_numpy(arrays)


def assert_within_one(got, want, scale=1.0):
    """u8 frames (scale 1) or [0, 1] float frames (scale 255) within one
    u8 step on every value."""
    assert got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)) * scale
    assert d.max() <= 1.0 + 1e-4, f"{int((d > 1.0 + 1e-4).sum())} values " \
                                  f"differ by more than one u8 step"


# ---------------------------------------------------------------------------
# camera, lines, PNG
# ---------------------------------------------------------------------------

def _drive_camera(mod):
    cam = mod.Camera((3048.0, 1048.0), (1280, 720))
    out = [cam.zoom, *cam.world_rect()]
    cam.move_camera("right", True)
    cam.move_camera("up", True)
    cam.update(1 / 60)
    cam.move_camera("right", False)
    cam.set_mouse_position((900.0, 200.0))
    cam.zoom_camera(1.0)
    cam.zoom_camera(1.0)
    cam.update(1 / 30)
    cam.move_camera("left", True)
    cam.zoom_camera(-3.0)
    cam.update(0.013)
    cam.screen_size = (640.0, 480.0)
    for _ in range(40):  # past ZOOM_MAX: the clamp
        cam.zoom_camera(5.0)
        cam.update(1 / 60)
    out += [cam.zoom, *cam.position, *cam.world_rect(),
            *cam.screen_to_world((17.0, 300.5))]
    pts = np.array([[0.0, 0.0], [1524.0, 524.0], [3048.0, 1048.0],
                    [-5.5, 2000.25]])
    return np.array(out), cam.world_to_screen(pts), cam.view_proj()


def test_camera_matches_jax():
    got, want = _drive_camera(camera), _drive_camera(jcamera)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    assert (camera.ZOOM_MIN, camera.ZOOM_MAX) == (jcamera.ZOOM_MIN,
                                                  jcamera.ZOOM_MAX)


@pytest.mark.parametrize("world, cell", [((44.0, 22.0), 2.2),
                                         ((3048.0, 1048.0), 7.0),
                                         ((10.0, 7.5), 3.3)])
def test_grid_line_segments_equal(world, cell):
    for g, w in zip(lines.grid_line_segments(world, cell),
                    jlines.grid_line_segments(world, cell)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert lines.GRID_COLOR == jlines.GRID_COLOR


def _lines_input():
    rng = np.random.default_rng(3)
    n = 40
    a = rng.uniform(-20.0, 120.0, (n, 2)).astype(np.float32)
    b = (a + rng.uniform(0.0, 90.0, (n, 2))).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return a, b, rgb, (np.arange(n) % 2).astype(np.uint8)


def test_draw_axis_lines_matches_jax():
    args = _lines_input()
    base = np.random.default_rng(4).uniform(0, 1, (48, 96, 3)).astype(
        np.float32)
    got = rasterizer.draw_axis_lines(base.copy(), *args)
    want = jras.draw_axis_lines(base.copy(), *args)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, base)
    with pytest.raises(ValueError, match="float32"):
        rasterizer.draw_axis_lines(base.astype(np.float64), *args)


def test_draw_lines_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: a rasterizer that does not build raises."""
    bad = tmp_path / "rasterizer.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(rasterizer, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    rasterizer.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            rasterizer.draw_axis_lines(np.zeros((4, 4, 3), np.float32),
                                       *_lines_input())
    finally:
        rasterizer.library.cache_clear()


@pytest.mark.parametrize("level", [6, 1])
@pytest.mark.parametrize("kind", ["u8", "float"])
def test_encode_png_bytes_equal(level, kind, tmp_path):
    rng = np.random.default_rng(level)
    img = rng.uniform(-0.1, 1.1, (23, 37, 3)).astype(np.float32)
    if kind == "u8":
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    got = png.encode_png(img, level=level)
    assert got == jpng.encode_png(img, level=level)
    assert got.startswith(b"\x89PNG\r\n\x1a\n")
    png.write_png(str(tmp_path / "a.png"), img)
    assert (tmp_path / "a.png").read_bytes() == jpng.encode_png(img)


# ---------------------------------------------------------------------------
# the tile map
# ---------------------------------------------------------------------------

def test_tile_stats_matches_jax(carried):
    _, _, a, b = carried
    want_count, want_v = jax.jit(
        jtilemap.tile_stats.__wrapped__,
        compiler_options={"xla_backend_optimization_level": 0})(a)
    jit_count, jit_v = jtilemap.tile_stats(a)  # the package's own program
    count, mean_v = tilemap.tile_stats(b)
    assert count.dtype == torch.int32 and mean_v.dtype == torch.float32
    np.testing.assert_array_equal(count.numpy(), np.asarray(want_count))
    assert int(count.sum()) == 48
    np.testing.assert_array_equal(mean_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(mean_v.numpy(), np.asarray(jit_v),
                               rtol=2e-7, atol=0)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jit_count))
    assert float(mean_v.max()) > 0


@pytest.mark.parametrize("scale, cap_reference", [(1, None), (3, 2)])
def test_render_tilemap_matches_jax(carried, scale, cap_reference):
    _, _, a, b = carried
    got = tilemap.render_tilemap(b, scale=scale, cap_reference=cap_reference)
    want = jtilemap.render_tilemap(a, scale=scale,
                                   cap_reference=cap_reference)
    assert got.dtype == np.uint8 and got.max() > 0
    assert_within_one(got, want)


# ---------------------------------------------------------------------------
# the viewer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [False, True])
def test_viewer_render_matches_jax(grid):
    pos, _, prev = scene(n=300, seed=8)
    rad = np.random.default_rng(8).uniform(0.3, 1.5, 300).astype(np.float32)
    frames = []
    for mod in (viewer, jviewer):
        v = mod.Viewer(WORLD, (96, 48))
        v.draw_grid = grid
        v.camera.zoom_camera(2.0)
        v.camera.set_mouse_position((30.0, 20.0))
        v.camera.update(1 / 60)
        frames.append(v.render(pos, prev, rad, cell_size=2.2))
    assert frames[0].dtype == np.float32 and frames[0].max() > 0
    np.testing.assert_array_equal(frames[0], frames[1])


def test_viewer_render_engine_device_path_matches_jax():
    """Engines from ``from_arrays`` on the same arrays; the camera panned
    and zoomed, the grid on, preview scale 2, against JAX's within one u8.
    (The window's sides are multiples of 2: JAX's viewer passes a cropped
    frame, a non-contiguous view, to its C++ line drawer, which refuses
    it; the port's copies it first, tested below.)"""
    jcfg, tcfg = cfgs()
    pos, rad, prev = scene()
    je = JEngine.from_arrays(jcfg, pos, rad, previous_positions=prev)
    te = TEngine.from_arrays(tcfg, pos, rad, previous_positions=prev,
                             device="cpu")
    frames = []
    for mod, eng in ((viewer, te), (jviewer, je)):
        v = mod.Viewer(WORLD, (96, 48))
        v.toggle_grid()
        v.camera.set_mouse_position((60.0, 10.0))
        v.camera.zoom_camera(1.0)
        v.camera.move_camera("left", True)
        v.camera.update(1 / 60)
        frames.append(v.render_engine(eng, preview_scale=2))
    got, want = frames
    assert got.shape == (48, 96, 3) and got.dtype == np.float32
    assert_within_one(got, want, scale=255.0)
    assert got.max() > 0.3  # particles drawn, not only the grid
    # the grid lines are drawn over the upscaled frame at full resolution
    assert np.isclose(got, lines.GRID_COLOR[0]).all(-1).any()
    # a window the scale does not divide: the upscaled frame is cropped
    v = viewer.Viewer(WORLD, (97, 49))
    v.toggle_grid()
    odd = v.render_engine(te, preview_scale=2)
    assert odd.shape == (49, 97, 3) and odd.flags.c_contiguous


def test_viewer_host_path_for_engines_without_a_device_frame():
    """An engine without ``render_frame`` (the array Engine) is splatted
    on the host from its downloaded arrays, the grid at its cell size."""
    from gpu_physics_engine_torch import Engine
    _, tcfg = cfgs(pipeline="sorted")
    pos, rad, prev = scene()
    ae = Engine.from_arrays(tcfg, pos, rad, previous_positions=prev,
                            device="cpu")
    assert not hasattr(ae, "render_frame")
    v = viewer.Viewer(WORLD, (96, 48))
    v.toggle_grid()
    got = v.render_engine(ae, preview_scale=2)
    want = v.render(ae.positions(), ae.previous_positions(), ae.radii(),
                    ae.cell_size())
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0
