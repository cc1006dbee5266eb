"""The port's plain tensor ops (gpu_physics_engine_torch/ops/tiled.py) against
the JAX package's ops/tiled.py on the same numpy-seeded inputs.

Integer state (pid placement, counters) must match exactly; float state to
f32 rounding (1e-6 world units: the worlds here are <= 64 units, where one
f32 ulp is <= 3.8e-6, and the pair math differs only by rsqrt rounding).
"""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu.core.state import StepParams as JParams
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.ops import tiled as tt

FIELDS = tt.FIELDS


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """``fn`` compiled once per static arguments (a whole-function compile
    costs a fraction of the op-by-op dispatch of the same ops).  Only for
    functions that move data and decide tiles by floor(x / t): they have no
    float mul+add for XLA to contract, so jit and eager agree exactly."""
    return jax.jit(fn, static_argnums=static)


def cfgs(**kw):
    base = dict(max_particles=512, initial_particles=256, world_width=64.0,
                world_height=64.0, initial_radius=0.5, pipeline="tiled",
                sort_interval_steps=0, tile_cap=4, mover_capacity=1024)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def scene(n, seed, w=64.0, h=64.0, rmin=0.3, rmax=0.5, vel=0.05):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0.6, w - 0.6, n),
                    rng.uniform(0.6, h - 0.6, n)], -1).astype(np.float32)
    rad = rng.uniform(rmin, rmax, n).astype(np.float32)
    prev = (pos + rng.normal(0.0, vel, pos.shape)).astype(np.float32)
    return pos, rad, prev


def jnp_state(st):
    return {f: np.asarray(getattr(st, f)) for f in
            FIELDS + ("num_active", "overflow_count")}


def both_states(jcfg, tcfg, pos, rad, prev=None, **kw):
    """The same scene tiled by both packages (asserted identical)."""
    a = jt.init_tiles(jcfg, pos, rad, previous_positions=prev, **kw)
    b = tt.init_tiles(tcfg, pos, rad, previous_positions=prev, **kw)
    assert_same(a, b)
    return a, b


def teleport(a, b, rng, scale):
    """Displace live particles by up to ``scale`` world units (same noise
    into both packages' states)."""
    jd = jnp_state(a)
    live = jd["pid"] >= 0
    dx = rng.uniform(-scale, scale, live.shape).astype(np.float32)
    dy = rng.uniform(-scale, scale, live.shape).astype(np.float32)
    jd["x"] = np.where(live, jd["x"] + dx, jd["x"]).astype(np.float32)
    jd["y"] = np.where(live, jd["y"] + dy, jd["y"]).astype(np.float32)
    a = jt.TileState(**{k: jnp.asarray(v) for k, v in jd.items()})
    return a, tt.from_numpy(jd)


def assert_same(a, b, atol=0.0, fields=FIELDS):
    jd = jnp_state(a)
    td = tt.to_numpy(b)
    for f in fields:
        if f == "pid" or atol == 0.0:
            np.testing.assert_array_equal(td[f], jd[f], err_msg=f)
        else:
            np.testing.assert_allclose(td[f], jd[f], atol=atol, rtol=0,
                                       err_msg=f)
    assert int(td["num_active"]) == int(jd["num_active"])
    assert int(td["overflow_count"]) == int(jd["overflow_count"])


# ---------------------------------------------------------------------------
# geometry, init, export, state round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(tile_multiplier=3.3, world_width=16.0, world_height=60.0),
    dict(tile_max_radius=1.0), dict(world_width=3048.0, world_height=1048.0,
                                    tile_multiplier=3.3),
])
def test_tile_geometry_matches(kw):
    jcfg, tcfg = cfgs(**kw)
    assert jt.tile_geometry(jcfg) == tt.tile_geometry(tcfg)


@pytest.mark.parametrize("case", ["random", "spill", "pids_prev", "pile"])
def test_init_tiles_matches_native_tiler(case):
    """The port's tiler (numpy, its spill pass in C++) lays particles out
    exactly as the JAX package's native tiler does, spills included."""
    if case == "random":
        jcfg, tcfg = cfgs(tile_cap=4)
        pos, rad, prev = scene(300, 1)
        both_states(jcfg, tcfg, pos, rad, prev)
    elif case == "spill":
        # a dense clump: many tiles past cap, spills onto rings 1 and 2
        jcfg, tcfg = cfgs(tile_cap=2)
        rng = np.random.default_rng(2)
        pos = (np.array([20.0, 30.0], np.float32)
               + rng.normal(0, 2.0, (120, 2))).astype(np.float32)
        rad = np.full(120, 0.3, np.float32)
        a, b = both_states(jcfg, tcfg, pos, rad)
        assert int(b.num_active) == 120
    elif case == "pile":
        # a pile against a wall, past the grid's room: spills out to far
        # rings (through the neighbours' cursors), then drops
        jcfg, tcfg = cfgs(tile_cap=2, world_width=20.0, world_height=12.0,
                          tile_multiplier=2.2, max_particles=2000,
                          initial_particles=2000)
        rng = np.random.default_rng(4)
        pos = np.clip(np.array([2.0, 6.0]) + rng.normal(0, 2.0, (2000, 2)),
                      0.01, [19.99, 11.99]).astype(np.float32)
        a, b = both_states(jcfg, tcfg, pos, np.full(2000, 0.3, np.float32))
        _, TY, TX = tt.tile_geometry(tcfg)
        full = 2 * (TY - 2) * (TX - 2)  # every interior slot
        assert int(b.num_active) == full and int(b.overflow_count) > 0
    else:
        jcfg, tcfg = cfgs(tile_cap=3)
        pos, rad, prev = scene(200, 3)
        pids = np.random.default_rng(3).permutation(1000)[:200].astype(
            np.int32)
        both_states(jcfg, tcfg, pos, rad, prev, pids=pids)


def test_init_refuses_oversized_radius():
    _, tcfg = cfgs()
    with pytest.raises(ValueError, match="tile edge"):
        tt.init_tiles(tcfg, np.array([[10.0, 10.0]], np.float32),
                      np.array([5.0], np.float32))


def test_export_and_numpy_round_trip():
    jcfg, tcfg = cfgs(tile_cap=4)
    pos, rad, prev = scene(250, 4)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    for x, y in zip(jt.export_particles(a), tt.export_particles(b)):
        np.testing.assert_array_equal(x, y)
    pid, p, pp, r = tt.export_particles(b)
    np.testing.assert_array_equal(pid, np.arange(250))
    np.testing.assert_array_equal(p, pos)
    np.testing.assert_array_equal(pp, prev)
    np.testing.assert_array_equal(r, rad)
    # to_numpy/from_numpy round trip, and from_numpy of a JAX state
    c = tt.from_numpy(tt.to_numpy(b))
    d = tt.from_numpy(jnp_state(a))
    for s in (c, d):
        assert_same(a, s)
        assert s.pid.dtype == torch.int32 and s.num_active.dtype == torch.int32
        assert s.num_active.dim() == 0 and s.overflow_count.dim() == 0


def test_stale_and_displaced_fractions_match():
    jcfg, tcfg = cfgs(tile_cap=4)
    pos, rad, _ = scene(300, 5)
    a, b = both_states(jcfg, tcfg, pos, rad)
    t = jt.tile_geometry(jcfg)[0]
    a, b = teleport(a, b, np.random.default_rng(5), 2.5 * t)
    for jf, tf in ((jt.stale_pair_fraction, tt.stale_pair_fraction),
                   (jt.displaced_fraction, tt.displaced_fraction)):
        want = np.float32(jf(a, jcfg))
        got = tf(b, tcfg)
        assert got.dtype == torch.float32
        assert float(got) == float(want)
        assert 0.0 < float(got) < 1.0


# ---------------------------------------------------------------------------
# plain collide and integrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [6, 7])
def test_collide_matches(seed):
    jcfg, tcfg = cfgs(tile_cap=4, initial_particles=400)
    pos, rad, _ = scene(400, seed, rmin=0.25)
    a, b = both_states(jcfg, tcfg, pos, rad)
    assert_same(jt.collide(a, jcfg), tt.collide(b, tcfg), atol=1e-6)


@pytest.mark.parametrize("world", ["box", "circle"])
@pytest.mark.parametrize("pressed", [False, True])
def test_integrate_matches(world, pressed):
    jcfg, tcfg = cfgs(tile_cap=4, world_shape=world, gravity=(1.5, -9.8))
    pos, rad, prev = scene(250, 8, vel=0.3)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    mouse = (30.0, 20.0)
    pa = JParams.make(0.02, mouse=mouse, pressed=pressed)
    pb = TParams.make(0.02, mouse=mouse, pressed=pressed)
    for dt_scale in (1.0, 0.5):
        assert_same(jt.integrate(a, pa, jcfg, dt_scale=dt_scale),
                    tt.integrate(b, pb, tcfg, dt_scale=dt_scale), atol=1e-6)


# ---------------------------------------------------------------------------
# claim relocate and rebuild (the periodic sweeps)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "overflow_offset", "delta"])
def test_claim_relocate_matches(case):
    jcfg, tcfg = cfgs(tile_cap=4, initial_particles=400)
    pos, rad, _ = scene(400, 9)
    a, b = both_states(jcfg, tcfg, pos, rad)
    t = jt.tile_geometry(jcfg)[0]
    a, b = teleport(a, b, np.random.default_rng(9), 2.2 * t)
    kw = {}
    if case == "overflow_offset":
        kw = dict(m_cap=24)  # the mover buffer overflows: deferrals
        for off in (0, 7, 123457):
            ja = _jit(jt.relocate, 1, 2)(a, jcfg, 24, np.int32(off))
            tb = tt.relocate(b, tcfg, tile_offset=off, **kw)
            assert_same(ja, tb)
            assert int(tb.overflow_count) > 0
        return
    if case == "delta":  # eager: the band test multiplies and adds
        kw = dict(delta=jcfg.hysteresis_delta)
        j_reloc = functools.partial(jt.relocate, config=jcfg, **kw)
    else:
        j_reloc = functools.partial(_jit(jt.relocate, 1), config=jcfg)
    ja = j_reloc(a)
    tb = tt.relocate(b, tcfg, **kw)
    assert_same(ja, tb)
    # a second pass sees the first's leftovers identically
    assert_same(j_reloc(ja), tt.relocate(tb, tcfg, **kw))


@pytest.mark.parametrize("loser_cap", [1 << 16, 5])
def test_rebuild_matches(loser_cap):
    """Winners at (rank, home); losers (home demand past cap) zipped into
    the lowest free slots; past loser_cap they are lost, loudly."""
    jcfg, tcfg = cfgs(tile_cap=3, initial_particles=400)
    rng = np.random.default_rng(10)
    pos, rad, _ = scene(300, 10)
    clump = (np.array([30.0, 30.0]) + rng.normal(0, 1.5, (100, 2)))
    pos = np.concatenate([pos, clump]).astype(np.float32)
    rad = np.full(400, 0.3, np.float32)
    a, b = both_states(jcfg, tcfg, pos, rad)
    t = jt.tile_geometry(jcfg)[0]
    a, b = teleport(a, b, rng, 1.5 * t)
    ja = _jit(jt.rebuild, 1, 2)(a, jcfg, loser_cap)
    tb = tt.rebuild(b, tcfg, loser_cap=loser_cap)
    assert_same(ja, tb)
    if loser_cap == 5:
        assert int(tb.num_active) < 400
    else:
        assert int(tb.num_active) == 400
        assert float(tt.displaced_fraction(tb, tcfg)) > 0.0  # losers


# ---------------------------------------------------------------------------
# the step's dispatch
# ---------------------------------------------------------------------------

def test_jnp_step_matches_jax_jnp_step():
    """tiled_collide/relocate="jnp" runs what the JAX package runs under
    "jnp": claim relocate, then separate collide and integrate."""
    jcfg, tcfg = cfgs(tile_cap=4, initial_particles=300, substeps=2,
                      tiled_collide="jnp", tiled_relocate="jnp",
                      gravity=(0.0, -20.0))
    pos, rad, prev = scene(300, 11, vel=0.2)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    pa = JParams.make(jcfg.dt, mouse=(10.0, 50.0), pressed=True)
    pb = TParams.make(tcfg.dt, mouse=(10.0, 50.0), pressed=True)
    for _ in range(3):
        a = jt.tiled_step_fn(a, pa, jcfg)
        b = tt.tiled_step_fn(b, pb, tcfg)
    assert_same(a, b, atol=2e-5)


@pytest.mark.parametrize("kw, exc", [
    (dict(tiled_collide="pallas"), RuntimeError),
    (dict(tiled_relocate="pallas"), RuntimeError),
])
def test_step_refuses_what_it_cannot_run(kw, exc):
    _, tcfg = cfgs(**kw)
    pos, rad, _ = scene(50, 12)
    st = tt.init_tiles(tcfg, pos, rad)
    with pytest.raises(exc):
        tt.tiled_step_fn(st, TParams.make(tcfg.dt), tcfg)
