"""The port's big-particle overlay (gpu_physics_engine_torch/ops/bigs.py)
and the TiledEngine's spawn path against the JAX package's, on the CPU.

  * ``window_halfwidth`` equal on several configs (the tuned 4M, 1M and
    256k rows among them), its ValueError too.
  * ``couple_bigs``, ``integrate_bigs`` and ``hybrid_step_fn`` (a
    relocating and an off step) from the same (TileState, BigState):
    integer fields equal, floats within 2e-6 world units (the worlds are
    32 units, where one f32 ulp is at most 3.8e-6).  Both packages add the
    partners' shares in update order; each big's own terms are summed in
    a fixed tree here and in XLA's order there.
  * The engines: ``from_arrays`` plus ``_insert_bigs`` of the same bigs,
    20 steps with the JAX kernels in interpret mode against the port's
    plain versions: pids exact, positions within 1e-4 (the tolerance of
    tests/test_torch_engine.py).  No mouse: the JAX step runs compiled,
    where XLA may contract a product into a sum, and a mouse pile-up
    amplifies those last-bit differences past 1e-4 within 20 steps.
  * ``rasterizer.splat`` bit-equal to the JAX package's on the same
    inputs; ``render_frame`` with an overlay within one u8 of the JAX
    engine's frame of the same state.

The rest mirrors tests/test_bigs.py on the port alone: the geometry is
kept, the counts, the merged export, the overlay's capacity overflow, the
relocate interval, a contact-free pass, tiled_spawn="retile", GS without
fitting tiles, ``render_run``, and the watchdog's re-tile with an overlay.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu.core.state import StepParams as JParams
from gpu_physics_engine_tpu.core.tiled_engine import TiledEngine as JEngine
from gpu_physics_engine_tpu.core.tuned import tuned_config as jtuned
from gpu_physics_engine_tpu.ops import bigs as jb
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_tpu.render import rasterizer as jras
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.core.tuned import gs_config, tuned_config
from gpu_physics_engine_torch.ops import bigs as tb
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.render import rasterizer
from test_torch_tiled import assert_same

ATOL = 2e-6


def cfgs(**kw):
    base = dict(max_particles=512, initial_particles=160, world_width=32.0,
                world_height=32.0, initial_radius=0.5, pipeline="tiled",
                sort_interval_steps=0, tile_cap=4, mover_capacity=1024,
                tiled_match="flip", tiled_relocate_interval=2,
                gravity=(0.0, -30.0))
    base.update(kw)
    return JConfig(**base), TConfig(**base)


# bigs: two overlapping bigs with a small in both windows and in contact
# with both, one big by the wall, one alone, one empty slot between them
BIG_POS = np.array([[10.0, 10.0], [12.6, 10.0], [0.0, 0.0], [2.2, 28.5],
                    [22.0, 17.0], [23.1, 18.0]], np.float32)
BIG_RAD = np.array([2.0, 1.0, 0.0, 3.0, 1.0, 2.0], np.float32)
BIG_PID = np.array([500, 501, -1, 502, 503, 504], np.int32)


@functools.lru_cache(maxsize=None)
def scene():
    """(positions, radii, previous) of the smalls: random, plus one small
    touching both of the first two bigs."""
    rng = np.random.default_rng(7)
    n = 159
    pos = np.stack([rng.uniform(0.6, 31.4, n), rng.uniform(0.6, 31.4, n)],
                   -1).astype(np.float32)
    pos = np.concatenate([pos, [[11.7, 10.3]]]).astype(np.float32)
    rad = rng.uniform(0.3, 0.5, n + 1).astype(np.float32)
    prev = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    return pos, rad, prev


def big_arrays(capacity=8):
    m = len(BIG_PID)
    a = {"x": np.zeros(capacity, np.float32), "y": np.zeros(capacity,
                                                             np.float32),
         "radius": np.zeros(capacity, np.float32),
         "pid": np.full(capacity, -1, np.int32)}
    a["x"][:m], a["y"][:m] = BIG_POS[:, 0], BIG_POS[:, 1]
    a["radius"][:m], a["pid"][:m] = BIG_RAD, BIG_PID
    rng = np.random.default_rng(8)
    live = a["pid"] >= 0
    a["px"] = np.where(live, a["x"] + rng.normal(0, 0.05, capacity),
                       0.0).astype(np.float32)
    a["py"] = np.where(live, a["y"] + rng.normal(0, 0.05, capacity),
                       0.0).astype(np.float32)
    a["num_active"] = np.int32(live.sum())
    return a


def both(jcfg, tcfg):
    """The same (TileState, BigState) in both packages."""
    pos, rad, prev = scene()
    ja = jt.init_tiles(jcfg, pos, rad, previous_positions=prev)
    ta = tt.init_tiles(tcfg, pos, rad, previous_positions=prev)
    assert_same(ja, ta)
    a = big_arrays()
    jbig = jb.BigState(**{k: jnp.asarray(v) for k, v in a.items()})
    return ja, jbig, ta, tb.from_numpy(a)


def assert_bigs(jbig, tbig, atol):
    want = {k: np.asarray(getattr(jbig, k)) for k in tb.to_numpy(tbig)}
    got = tb.to_numpy(tbig)
    for f in ("pid", "num_active"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("x", "y", "px", "py", "radius"):
        np.testing.assert_allclose(got[f], want[f], atol=atol, rtol=0,
                                   err_msg=f)


@pytest.mark.parametrize("kw", [
    dict(), dict(tiled_relocate_interval=1), dict(world_width=200.0),
    dict(tile_max_radius=1.0), dict(world_width=4.0, world_height=4.0)])
def test_window_halfwidth_matches_jax(kw):
    jcfg, tcfg = cfgs(**kw)
    try:
        want = jb.window_halfwidth(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError, match="too small"):
            tb.window_halfwidth(tcfg)
        assert "too small" in str(e)
        return
    assert tb.window_halfwidth(tcfg) == want


@pytest.mark.parametrize("n, w", [(4_194_304, 3), (1_048_576, 2),
                                  (256_000, 1)])
def test_window_halfwidth_at_the_tuned_rows(n, w):
    assert tb.window_halfwidth(tuned_config(n)) == w
    assert jb.window_halfwidth(jtuned(n)) == w


def test_couple_bigs_matches_jax():
    jcfg, tcfg = cfgs()
    ja, jbig, ta, tbig = both(jcfg, tcfg)
    ja, jbig = jb.couple_bigs(ja, jbig, jcfg)
    t2, b2 = tb.couple_bigs(ta, tbig, tcfg)
    assert_same(ja, t2, atol=ATOL)
    assert_bigs(jbig, b2, ATOL)
    # the pass moved the shared small and both bigs it touches
    moved = t2.x != ta.x
    assert int(moved.sum()) >= 2
    assert float(b2.x[0]) != float(tbig.x[0])
    assert float(b2.x[1]) != float(tbig.x[1])
    # the inputs are left as they were
    assert_same(jt.init_tiles(jcfg, *scene()[:2],
                              previous_positions=scene()[2]), ta)


def test_couple_bigs_is_a_noop_without_contact():
    """A big far from every small: the tiles bit for bit as they were."""
    _, tcfg = cfgs(initial_particles=8)
    e = TEngine(tcfg, seed=2, device="cpu")
    a = big_arrays(16)
    for f in ("pid", "x", "y", "px", "py", "radius"):
        a[f][1:] = -1 if f == "pid" else 0.0
    a["x"][0] = a["y"][0] = a["px"][0] = a["py"][0] = 5.0
    a["num_active"] = np.int32(1)
    # every small within 8 (L1) of the big moves 12 to the right
    e.state = e.state.replace(x=torch.where(
        (e.state.x - 5.0).abs() + (e.state.y - 5.0).abs() < 8.0,
        e.state.x + 12.0, e.state.x))
    x0 = e.state.x.clone()
    tiles, big = tb.couple_bigs(e.state, tb.from_numpy(a), tcfg)
    assert torch.equal(tiles.x, x0) and torch.equal(tiles.y, e.state.y)
    np.testing.assert_array_equal(big.x.numpy(), a["x"])


def test_integrate_bigs_matches_jax():
    jcfg, tcfg = cfgs()
    _, jbig, _, tbig = both(jcfg, tcfg)
    for pressed in (False, True):
        jp = JParams.make(0.016, mouse=(12.0, 20.0), pressed=pressed)
        tp = TParams.make(0.016, mouse=(12.0, 20.0), pressed=pressed)
        assert_bigs(jb.integrate_bigs(jbig, jp, jcfg),
                    tb.integrate_bigs(tbig, tp, tcfg), 0.0)


@pytest.mark.parametrize("relocate", [True, False])
def test_hybrid_step_matches_jax(relocate):
    """The overlay's step on the slice's path: the JAX kernels in
    interpret mode (general radius), the port's plain versions."""
    jcfg, tcfg = cfgs()
    jcfg = jcfg.replace(tiled_collide="pallas", tiled_relocate="pallas")
    ja, jbig, ta, tbig = both(jcfg, tcfg)
    jp = JParams.make(0.016, mouse=(16.0, 16.0), pressed=True)
    tp = TParams.make(0.016, mouse=(16.0, 16.0), pressed=True)
    ja, jbig = jb.hybrid_step_fn(ja, jbig, jp, jcfg, do_relocate=relocate)
    ta, tbig = tb.hybrid_step_fn(ta, tbig, tp, tcfg, do_relocate=relocate)
    assert_same(ja, ta, atol=ATOL)
    assert_bigs(jbig, tbig, ATOL)


def _engines(jcfg, tcfg):
    pos, rad, prev = scene()
    je = JEngine.from_arrays(jcfg, pos, rad, previous_positions=prev)
    te = TEngine.from_arrays(tcfg, pos, rad, previous_positions=prev,
                             device="cpu")
    a = big_arrays()
    live = a["pid"] >= 0
    bpos = np.stack([a["x"], a["y"]], -1)[live]
    bprev = np.stack([a["px"], a["py"]], -1)[live]
    for e in (je, te):
        e._insert_bigs(bpos, a["radius"][live], a["pid"][live], prev=bprev)
    return je, te


def test_engines_match_jax_over_20_steps():
    jcfg, tcfg = cfgs(tiled_relocate_interval=1)
    jcfg = jcfg.replace(tiled_collide="pallas", tiled_relocate="pallas")
    je, te = _engines(jcfg, tcfg)
    assert te.big.capacity == je.big.capacity == 128
    for _ in range(20):
        je.step()  # one compiled JAX program; the port's run() windows
    te.run(20)     # take the same relocate-every-step schedule
    jp, jpos, jprev, jrad = je._export()
    tp, tpos, tprev, trad = te._export()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tp, np.sort(np.concatenate(
        [np.arange(160), BIG_PID[BIG_PID >= 0]])))
    np.testing.assert_allclose(tpos, jpos, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tprev, jprev, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(trad, jrad)
    assert int(te.state.overflow_count) == int(je.state.overflow_count)


def test_splat_is_bit_equal_to_jax():
    rng = np.random.default_rng(9)
    n = 40
    sx = rng.uniform(-5, 85, n).astype(np.float32)
    sy = rng.uniform(-5, 53, n).astype(np.float32)
    sr = rng.uniform(0.3, 9.0, n).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    base = rng.uniform(0, 1, (48, 80, 3)).astype(np.float32)
    want = jras.splat(base.copy(), sx, sy, sr, rgb)
    got = rasterizer.splat(base.copy(), sx, sy, sr, rgb)
    assert (want != base).any()
    np.testing.assert_array_equal(got, want)


def test_render_frame_with_overlay_matches_jax():
    jcfg, tcfg = cfgs()
    je, te = _engines(jcfg, tcfg)
    want = je.render_frame(width=160, height=96)
    got = te.render_frame(width=160, height=96)
    assert got.shape == (96, 160, 3) and got.dtype == np.uint8
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    # the bigs light their own pixels over the device frame
    plain = tt.TileState(**{f: getattr(te.state, f) for f in
                            tt.FIELDS + ("num_active", "overflow_count")})
    te_none = TEngine(tcfg, initial_state=plain)
    assert (got != te_none.render_frame(width=160, height=96)).any()


# ---- the port alone (tests/test_bigs.py) ----

def _tcfg(**kw):
    base = dict(max_particles=512, initial_particles=64, world_width=64.0,
                world_height=64.0, initial_radius=0.5, sort_interval_steps=0,
                tile_cap=4, mover_capacity=1024, pipeline="tiled")
    base.update(kw)
    return TConfig(**base)


def test_spawn_keeps_the_geometry_and_counts():
    e = TEngine(_tcfg(), seed=5, device="cpu")
    t0 = e.cell_size()
    e.spawn_at((32.0, 32.0), count=30, verbose=False)
    assert e.cell_size() == t0
    assert e.config.tile_max_radius_effective == 0.5
    assert e.num_particles() == 94
    assert e.big is not None and int(e.big.num_active) == 30
    assert e.big.capacity == 128
    brad = e.big.radius[e.big.pid >= 0].numpy()
    assert set(np.unique(brad)) <= {1.0, 2.0, 3.0} and brad.max() >= 2.0
    pid, pos, prev, rad = e._export()
    np.testing.assert_array_equal(pid, np.arange(94))  # each pid once
    np.testing.assert_array_equal(e.radii(), rad)
    assert e.velocities().shape == (94, 2)
    e.run(20)
    assert e.num_particles() == 94
    np.testing.assert_array_equal(e._export()[0], np.arange(94))
    assert np.isfinite(e.positions()).all()


def test_spawn_turns_uniform_radius_off_and_fills_tiles_with_smalls():
    """A uniform-radius engine whose tiles fit radius 1: the radius-1
    spawns go into the tiles, the larger ones into the overlay."""
    e = TEngine(_tcfg(tile_max_radius=None, initial_radius=1.0,
                      tile_multiplier=2.2, tiled_uniform_radius=True),
                seed=1, device="cpu")
    e.spawn_at((32.0, 32.0), count=40, verbose=False)
    assert not e.config.tiled_uniform_radius
    tiles_r = e.state.radius[e.state.pid >= 64].numpy()
    assert len(tiles_r) and (tiles_r == 1.0).all()
    assert (e.big.radius[e.big.pid >= 0].numpy() > 1.0).all()
    assert e.num_particles() == 104


def test_overlay_capacity_overflow_counts():
    e = TEngine(_tcfg(big_capacity=4), seed=3, device="cpu")
    of0 = int(e.state.overflow_count)
    e.spawn_at((32.0, 32.0), count=10, verbose=False)
    assert int(e.big.num_active) == 4
    assert int(e.state.overflow_count) == of0 + 6
    assert e.num_particles() == 68


def test_overlay_grows_by_doubling():
    e = TEngine(_tcfg(), seed=3, device="cpu")
    for k in range(3):
        e.spawn_at((20.0 + 10 * k, 32.0), count=100, verbose=False)
    assert e.big.capacity == 512 and int(e.big.num_active) == 300
    np.testing.assert_array_equal(e._export()[0], np.arange(364))


@pytest.mark.parametrize("pair", ["big_small", "big_big"])
def test_coupling_separates_overlap(pair):
    if pair == "big_small":
        e = TEngine.from_arrays(_tcfg(initial_particles=1),
                                np.array([[32.0, 32.0]], np.float32),
                                np.array([0.5], np.float32), device="cpu")
        e._insert_bigs(np.array([[33.0, 32.0]], np.float32),
                       np.array([2.0], np.float32),
                       np.array([100], np.int32))
        a, b = 0, 100
    else:
        e = TEngine(_tcfg(initial_particles=2), seed=0, device="cpu")
        e._insert_bigs(np.array([[30.0, 32.0], [32.0, 32.0]], np.float32),
                       np.array([2.0, 2.0], np.float32),
                       np.array([50, 51], np.int32))
        a, b = 50, 51
    p0 = {k: v for k, v in zip(*e._export()[:2])}
    for _ in range(30):
        e.step()
    pid, pos, _, _ = e._export()
    p1 = {k: v for k, v in zip(pid, pos)}
    assert np.isfinite(pos).all()
    assert abs(p1[a][0] - p1[b][0]) > abs(p0[a][0] - p0[b][0])
    if pair == "big_small":  # the small takes the larger share
        assert abs(p1[0][0] - 32.0) > abs(p1[100][0] - 33.0)


def test_overlay_respects_the_relocate_interval(monkeypatch):
    """Off-steps skip the tiles' relocate with an overlay too: run()'s
    windows and step()'s counter keep the schedule of an engine without
    one, and every particle survives."""
    calls = []
    step = tb.tiled_step_fn

    def spy(state, params, config, do_relocate=True, prm=None):
        calls.append(do_relocate)
        return step(state, params, config, do_relocate=do_relocate, prm=prm)

    monkeypatch.setattr(tb, "tiled_step_fn", spy)
    e = TEngine(_tcfg(tiled_relocate_interval=2, gravity=(0.0, -30.0)),
                seed=5, chunk=8, device="cpu")
    e.spawn_at((32.0, 32.0), count=10, verbose=False)
    n0 = e.num_particles()
    e.run(12)
    e.step()
    e.step()
    assert calls == [True, False] * 4 + [True, False, True, False] \
        + [True, False]
    assert e.num_particles() == n0
    assert np.isfinite(e.positions()).all()


def test_retile_spawn_grows_the_cell():
    e = TEngine(_tcfg(tiled_spawn="retile"), seed=5, device="cpu")
    pid0, pos0, prev0, _ = tt.export_particles(e.state)
    e.spawn_at((32.0, 32.0), count=30, verbose=False)
    assert e.big is None
    assert e.config.tile_max_radius_effective == 3.0
    assert e.cell_size() == 2.2 * 3.0
    assert e.num_particles() == 94
    pid1, pos1, prev1, rad1 = tt.export_particles(e.state)
    np.testing.assert_array_equal(pid1[:64], pid0)
    np.testing.assert_array_equal(pos1[:64], pos0)
    np.testing.assert_array_equal(prev1[:64], prev0)
    assert rad1[64:].max() >= 2.0
    e.run(10)
    assert e.num_particles() == 94 and np.isfinite(e.positions()).all()


def test_gs_without_fitting_tiles_refuses_a_big_spawn():
    e = TEngine(gs_config(300, world_width=40.0, world_height=30.0),
                device="cpu")
    with pytest.raises(ValueError, match="gs"):
        e.spawn_at((20.0, 15.0), count=5, verbose=False)


def test_render_run_raises_with_an_overlay():
    e = TEngine(_tcfg(), seed=1, device="cpu")
    assert isinstance(e.render_run(2, width=32, height=32), int)
    e.spawn_at((32.0, 32.0), count=5, verbose=False)
    with pytest.raises(NotImplementedError, match="overlay"):
        e.render_run(2, width=32, height=32)
    frame = e.step_render_frame(width=64, height=64)
    assert frame.shape == (64, 64, 3) and frame.max() > 0


def test_watchdog_retile_keeps_the_overlay():
    """The watchdog's level 3 (+1 slot capacity, a re-tile) and its forced
    sweep leave the overlay and every pid in place."""
    cfg = _tcfg(tile_cap=4, initial_particles=300, tiled_relocate="jnp",
                tiled_collide="jnp")
    e = TEngine(cfg, seed=4, device="cpu")
    e.spawn_at((32.0, 32.0), count=20, verbose=False)
    big0 = tb.to_numpy(e.big)
    t = tt.tile_geometry(e.config)[0]
    e._wd_level = 2  # the next growing boundary escalates to level 3
    occ = e.state.pid >= 0
    far = (e.state.pid % 3 == 0) & occ
    e.state = e.state.replace(
        x=torch.where(far, torch.clamp(e.state.x + 2.5 * t, max=63.0),
                      e.state.x))
    e._wd_prev = 0.5
    e._watchdog()
    assert e.watchdog_events == 1 and e.config.tile_cap == 5
    assert e.state.dims[0] == 5
    for f, v in tb.to_numpy(e.big).items():
        np.testing.assert_array_equal(v, big0[f], err_msg=f)
    np.testing.assert_array_equal(e._export()[0], np.arange(320))
    assert float(tt.stale_pair_fraction(e.state, e.config)) < 0.02
    e.run(4)
    assert e.num_particles() == 320
