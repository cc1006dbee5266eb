"""The band drain and the hybrid sweep of the port's TiledEngine against the
JAX package's, on the CPU.

``stale_per_row`` and ``rebuild_band`` (gpu_physics_engine_torch/ops/
tiled.py) must equal the JAX functions exactly in every plane: they move
slots and decide tiles by floor(x / t), with no float arithmetic to round
differently.  The engines (tiled_sweep="bands", and the claim sweep with
tiled_rebuild_every=2) start from the same arrays and run the "jnp" step
on both sides (plain collide + integrate, the claim relocate with a
3-mover buffer, so stale slots pile up between the sweeps): the sweep,
rebuild and band counters, the band starts and the pid placement must be
equal, positions within 1e-4 world units (XLA may contract a product
into a sum in the JAX step).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.core.tiled_engine import TiledEngine as JEngine
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.ops import tiled as tt
from test_torch_tiled import assert_same, both_states, cfgs, jnp_state, \
    scene, teleport

ROWS = 6


def _cfgs(**kw):
    base = dict(world_width=24.0, world_height=24.0, max_particles=256,
                initial_particles=96, tile_cap=4, tile_multiplier=3.3)
    base.update(kw)
    return cfgs(**base)


@functools.lru_cache(maxsize=None)
def _jax_band(jcfg):
    """JAX's rebuild_band at ROWS rows, one compile a config (row0 is
    traced)."""
    return jax.jit(lambda s, r0: jt.rebuild_band(s, jcfg, r0, rows=ROWS))


def _displaced(jcfg, tcfg, seed, scale=5.0, n=96):
    """The same tiled scene in both packages, then every live position
    moved by up to ``scale`` world units (up to 3 tiles) with storage
    kept: stale slots at every distance."""
    pos, rad, prev = scene(n, seed, w=24.0, h=24.0)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    a, b = teleport(a, b, np.random.default_rng(seed), scale)
    x = np.clip(jnp_state(a)["x"], 0.6, 23.4)
    y = np.clip(jnp_state(a)["y"], 0.6, 23.4)
    d = dict(jnp_state(a), x=x, y=y)
    return (jt.TileState(**{k: jax.numpy.asarray(v) for k, v in d.items()}),
            tt.from_numpy(d))


@pytest.mark.parametrize("max_dy", [0, 2])
def test_stale_per_row_equals_jax(max_dy):
    jcfg, tcfg = _cfgs()
    a, b = _displaced(jcfg, tcfg, seed=1)
    want = np.asarray(jt.stale_per_row(a, jcfg, max_dy=max_dy))
    got = tt.stale_per_row(b, tcfg, max_dy=max_dy)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 20
    if max_dy:  # the filter drops the far ones
        assert want.sum() < np.asarray(jt.stale_per_row(a, jcfg)).sum()


def test_rebuild_band_equals_jax_at_every_row_start():
    """Row starts clamped below 0 and past TY - rows, the middle and the
    last: every plane equal; conservation; rows outside the band
    untouched."""
    jcfg, tcfg = _cfgs()
    a, b = _displaced(jcfg, tcfg, seed=2)
    TY = tt.tile_geometry(tcfg)[1]
    pid0 = b.pid.clone()
    moved = 0
    for r0 in (-4, 0, TY // 2 - 3, TY - ROWS, TY + 2):
        want = _jax_band(jcfg)(a, np.int32(r0))
        got = tt.rebuild_band(b, tcfg, r0, rows=ROWS)
        assert_same(want, got)
        lo = min(max(r0, 0), TY - ROWS)
        out = torch.ones(TY, dtype=torch.bool)
        out[lo:lo + ROWS] = False
        assert torch.equal(got.pid[:, out], pid0[:, out])
        assert int(got.num_active) == int(b.num_active)
        moved += int((got.pid != pid0).sum())
        pid = got.pid[got.pid >= 0]
        assert torch.equal(torch.sort(pid).values,
                           torch.sort(pid0[pid0 >= 0]).values)
    assert moved > 0


def test_rebuild_band_demand_past_dead_slots_equals_jax():
    """Five particles whose home is one cap-2 tile: the drain fills the
    tile's dead slots and leaves the rest where they were, exactly as the
    JAX package does (its tests/test_band_rebuild.py)."""
    jcfg, tcfg = _cfgs(tile_cap=2, initial_particles=24)
    pos, rad, prev = scene(24, 5, w=24.0, h=24.0)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    d = {k: np.array(v) for k, v in jnp_state(a).items()}
    for k, ty, tx in np.argwhere(d["pid"] >= 0)[:5]:
        d["x"][k, ty, tx] = d["y"][k, ty, tx] = 5.0
    a = jt.TileState(**{k: jax.numpy.asarray(v) for k, v in d.items()})
    b = tt.from_numpy(d)
    got = tt.rebuild_band(b, tcfg, 0, rows=ROWS)
    assert_same(_jax_band(jcfg)(a, np.int32(0)), got)
    t = tt.tile_geometry(tcfg)[0]
    home = int(5.0 // t) + 1
    assert int((got.pid[:, home, home] >= 0).sum()) == 2
    assert int(got.num_active) == 24


def _engines(sweep, every):
    """The JAX and the port engine from the same arrays, chunk 4, a sweep
    every 8 steps, the "jnp" step with a 3-mover relocate buffer."""
    jcfg, tcfg = _cfgs(initial_particles=96, max_particles=128,
                       sort_interval_steps=8, tiled_sweep=sweep,
                       tiled_rebuild_every=every, tiled_band_rows=4,
                       tiled_band_k=2, tiled_collide="jnp",
                       tiled_relocate="jnp", mover_capacity=3,
                       sweep_mover_capacity=8)
    pos, rad, prev = scene(96, 5, w=24.0, h=24.0, vel=0.15)
    je = JEngine(jcfg, initial_state=jt.init_tiles(
        jcfg, pos, rad, previous_positions=prev), chunk=4)
    te = TEngine(tcfg, initial_state=tt.init_tiles(
        tcfg, pos, rad, previous_positions=prev), chunk=4)
    return je, te


@pytest.mark.parametrize("sweep,every", [("bands", 0), ("relocate", 2)],
                         ids=["bands", "hybrid"])
def test_engine_sweeps_match_jax(sweep, every, monkeypatch):
    je, te = _engines(sweep, every)
    starts = {"jax": [], "port": []}
    if je._band_fn is not None:
        band = je._band_fn
        je._band_fn = lambda s, r0: (starts["jax"].append(int(r0)),
                                     band(s, r0))[1]
    band_t = tt.rebuild_band
    monkeypatch.setattr(tt, "rebuild_band", lambda s, c, r0, rows=16: (
        starts["port"].append(int(r0)), band_t(s, c, r0, rows))[1])
    for e in (je, te):
        e.run(16)
        e.run(16)  # sweeps before steps 8, 16 and 24
    assert starts["port"] == starts["jax"]
    for f in ("band_rebuilds", "rebuild_sweeps", "_sweep_count",
              "watchdog_events", "_band_rot"):
        assert getattr(te, f) == getattr(je, f), f
    # three periodic sweeps, one watchdog drain (a forced sweep counts
    # in _sweep_count but is not a counted rebuild, as in JAX)
    assert te.watchdog_events == 1 and te._sweep_count == 4
    if sweep == "bands":
        assert te.band_rebuilds == 8 == len(starts["port"])
    else:
        assert te.rebuild_sweeps >= 1 and not starts["port"]
    assert_same(je.state, te.state, atol=1e-4)
    assert te.num_particles() == 96
    assert int(te.state.overflow_count) > 0  # the 3-mover buffer deferred
