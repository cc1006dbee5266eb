"""The port's spawn insert path (gpu_physics_engine_torch/ops/tiled.py:
``insert_batch``, ``insert_at_tiles``, ``far_targets``,
``spawn_insert_into``, ``insert_particles``) against the JAX package's on
the same numpy inputs, on the CPU.

An insert only copies values into free slots, so the whole TileState must
be equal: pid placement, slot occupancy, num_active and overflow_count,
and the float planes bit for bit.  The scenes are tests/test_spawn.py's:
a 16 x 16 world, cap 4, tiles filled to capacity around a home tile.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.core.tiled_engine import TiledEngine as JEngine
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.ops import tiled as tt
from test_torch_tiled import assert_same, cfgs

HOME = (3, 3)
BLOCK = [(HOME[0] + dy, HOME[1] + dx) for dy in (-1, 0, 1)
         for dx in (-1, 0, 1)]


def _cfgs(**kw):
    base = dict(max_particles=1024, initial_particles=0, world_width=16.0,
                world_height=16.0, tile_cap=4, tiled_collide="jnp")
    base.update(kw)
    return cfgs(**base)


def _fill_tiles(cfg, tiles, per_tile):
    """Positions filling each (ty, tx) tile with ``per_tile`` particles
    spread inside it (tests/test_spawn.py's helper)."""
    t = tt.tile_geometry(cfg)[0]
    pos = []
    for ty, tx in tiles:
        for i in range(per_tile):
            fx = 0.2 + 0.6 * ((i * 7) % per_tile) / max(per_tile, 1)
            fy = 0.2 + 0.6 * i / max(per_tile, 1)
            pos.append(((tx - 1 + fx) * t, (ty - 1 + fy) * t))
    return np.asarray(pos, np.float32).reshape(-1, 2)


def _interior(cfg):
    _, TY, TX = tt.tile_geometry(cfg)
    return [(ty, tx) for ty in range(1, TY - 1) for tx in range(1, TX - 1)]


def _states(jcfg, tcfg, tiles, per_tile=4):
    """Both packages' TileStates with ``tiles`` filled to ``per_tile``."""
    fill = _fill_tiles(tcfg, tiles, per_tile)
    rad = np.full(len(fill), 0.5, np.float32)
    a = jt.init_tiles(jcfg, fill, rad)
    b = tt.init_tiles(tcfg, fill, rad)
    assert_same(a, b)
    return a, b


def _burst(cfg, n, seed, tiles=(HOME,)):
    """``n`` entries (positions in ``tiles``, radius 0.5, pids from 1000)."""
    pos = _fill_tiles(cfg, list(tiles), n)[:n]
    rng = np.random.default_rng(seed)
    pos = pos + rng.uniform(-0.1, 0.1, pos.shape).astype(np.float32)
    return (pos, np.full(n, 0.5, np.float32),
            np.arange(1000, 1000 + n, dtype=np.int32))


@pytest.mark.parametrize("case", ["empty", "home_full", "block_full",
                                  "some_placed"])
def test_insert_batch_matches_jax(case):
    jcfg, tcfg = _cfgs()
    tiles = {"empty": [], "home_full": [HOME], "block_full": BLOCK,
             "some_placed": [HOME]}[case]
    a, b = _states(jcfg, tcfg, tiles)
    pos, rad, ids = _burst(tcfg, 6, seed=1)
    placed = np.zeros(6, bool)
    if case == "some_placed":
        placed[[1, 4]] = True
    a, pa = jt.insert_batch(a, jcfg, jnp.asarray(pos), rad, ids,
                            jnp.asarray(placed), jt.INSERT_OFFSETS)
    b, pb = tt.insert_batch(b, tcfg, pos, rad, ids, torch.as_tensor(placed),
                            tt.INSERT_OFFSETS)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(pa))
    assert_same(a, b)
    if case == "block_full":
        assert not pb.any()


def test_insert_at_tiles_matches_jax():
    jcfg, tcfg = _cfgs()
    a, b = _states(jcfg, tcfg, [HOME, (5, 6)], per_tile=3)
    pos, rad, ids = _burst(tcfg, 7, seed=2)
    # two entries aimed at one tile with one free slot, one at a free tile,
    # the rest pre-placed or at empty tiles
    ty = np.array([3, 3, 5, 7, 8, 2, 9], np.int32)
    tx = np.array([3, 3, 6, 2, 4, 7, 5], np.int32)
    placed = np.array([0, 0, 0, 1, 0, 0, 1], bool)
    a, pa = jt.insert_at_tiles(a, jnp.asarray(pos), rad, ids, ty, tx,
                               jnp.asarray(placed))
    b, pb = tt.insert_at_tiles(b, pos, rad, ids, ty, tx,
                               torch.as_tensor(placed))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(pa))
    assert_same(a, b)
    assert list(pb.numpy()) == [True, False, True, True, True, True, True]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_far_targets_matches_jax(seed):
    rng = np.random.default_rng(seed)
    TY, TX = 16, 10
    free = rng.integers(0, 3, (TY, TX)) * (rng.random((TY, TX)) < 0.15)
    hty = rng.integers(1, TY - 1, 40)
    htx = rng.integers(1, TX - 1, 40)
    todo = rng.random(40) < 0.7
    want = jt.far_targets(free, hty, htx, todo, TY - 2, TX)
    got = tt.far_targets(free, hty, htx, todo, TY - 2, TX)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # greedy: entries past the grid's free slots stay unfound
    assert got[2].sum() == min(todo.sum(), free[1:TY - 1, 1:TX - 1].sum())


def test_far_targets_full_grid_finds_nothing():
    free = np.zeros((16, 10), np.int64)
    free[0, :] = 3  # the border ring is no storage
    free[:, 9] = 3
    for pkg in (jt, tt):
        ty, tx, found = pkg.far_targets(free, np.full(5, 3), np.full(5, 4),
                                        np.ones(5, bool), 14, 10)
        assert not found.any()
        np.testing.assert_array_equal(ty, np.full(5, 3))


def _jax_spawn_insert(state, cfg, pos, rad, ids):
    """The JAX ``spawn_insert_into`` through its eager insert functions."""
    eng = types.SimpleNamespace(config=cfg, state=state)

    def ring1(s, p, r, i, placed):
        return jt.insert_batch(s, cfg, p, r, i, placed, jt.INSERT_OFFSETS)

    return jt.spawn_insert_into(eng, ring1, jt.insert_at_tiles,
                                jnp.asarray(pos), rad, ids)


@pytest.mark.parametrize("case", ["home_full", "block_full", "grid_full"])
def test_spawn_insert_into_matches_jax(case):
    """Home and ring 1, then the far spill; a full interior grid refuses
    every entry, into overflow_count."""
    jcfg, tcfg = _cfgs()
    tiles = {"home_full": [HOME], "block_full": BLOCK,
             "grid_full": _interior(tcfg)}[case]
    a, b = _states(jcfg, tcfg, tiles)
    n0 = int(b.num_active)
    pos, rad, ids = _burst(tcfg, 5, seed=3)
    a = _jax_spawn_insert(a, jcfg, pos, rad, ids)
    b = tt.spawn_insert_into(b, tcfg, pos, rad, ids)
    assert_same(a, b)
    if case == "grid_full":
        assert int(b.num_active) == n0
        assert int(b.overflow_count) == 5
    else:
        assert int(b.num_active) == n0 + 5
        assert int(b.overflow_count) == 0


@pytest.mark.parametrize("case", ["home_full", "block_full"])
def test_insert_particles_matches_jax(case):
    jcfg, tcfg = _cfgs()
    a, b = _states(jcfg, tcfg, [HOME] if case == "home_full" else BLOCK)
    pos, rad, ids = _burst(tcfg, 3, seed=4)
    a = jt.insert_particles(a, jcfg, jnp.asarray(pos), rad, ids)
    b = tt.insert_particles(b, tcfg, pos, rad, ids)
    assert_same(a, b)


def test_full_home_falls_back_to_neighbour():
    """tests/test_spawn.py: three more into a full home tile land within
    one tile of it, at their exact positions."""
    _, tcfg = _cfgs()
    fill = _fill_tiles(tcfg, [HOME], 4)
    st = tt.init_tiles(tcfg, fill, np.full(4, 0.5, np.float32))
    extra = _fill_tiles(tcfg, [HOME], 3)
    st = tt.insert_particles(st, tcfg, extra, np.full(3, 0.5, np.float32),
                             np.arange(4, 7, dtype=np.int32))
    assert int(st.num_active) == 7 and int(st.overflow_count) == 0
    pid, pos, _, _ = tt.export_particles(st)
    np.testing.assert_array_equal(pid, np.arange(7))
    np.testing.assert_array_equal(pos[4:], extra)
    for _, ty, tx in np.argwhere(st.pid.numpy() >= 4):
        assert abs(ty - HOME[0]) <= 1 and abs(tx - HOME[1]) <= 1


def test_full_block_refuses_loudly_in_insert_particles():
    _, tcfg = _cfgs()
    fill = _fill_tiles(tcfg, BLOCK, 4)
    st = tt.init_tiles(tcfg, fill, np.full(len(fill), 0.5, np.float32))
    n0 = int(st.num_active)
    st = tt.insert_particles(st, tcfg, _fill_tiles(tcfg, [HOME], 1),
                             np.full(1, 0.5, np.float32),
                             np.asarray([9999], np.int32))
    assert int(st.num_active) == n0
    assert int(st.overflow_count) == 1


def test_engine_far_spill_places_at_ring_2_like_jax():
    """The engines' ``_spawn_insert``: a full 3 x 3 spills to ring 2, the
    same slots in both packages."""
    jcfg, tcfg = _cfgs(max_particles=64)
    a, b = _states(jcfg, tcfg, BLOCK)
    je = JEngine(jcfg, seed=0, initial_state=a)
    te = TEngine(tcfg, seed=0, initial_state=b)
    extra = _fill_tiles(tcfg, [HOME], 2)
    ids = np.arange(1000, 1002, dtype=np.int32)
    for e in (je, te):
        n0 = e.num_particles()
        e._spawn_insert(extra, np.full(2, 0.5, np.float32), ids)
        assert e.num_particles() == n0 + 2
    assert_same(je.state, te.state)
    where = np.argwhere(te.state.pid.numpy() >= 1000)
    assert len(where) == 2
    for _, ty, tx in where:
        assert max(abs(ty - HOME[0]), abs(tx - HOME[1])) == 2
