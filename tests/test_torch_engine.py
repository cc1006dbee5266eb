"""The port's TiledEngine (the whole slice) against the JAX package's.

Both engines start from the same numpy scene through ``from_arrays``; the
JAX engine runs its Pallas kernels in interpret mode, the port (on the
CPU) the plain versions of its CUDA kernels.  pid placement and
overflow_count must match exactly, positions within 1e-4 world units
(Newton vs gather sum order, compounded over the steps).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.core.tiled_engine import TiledEngine as JEngine
from gpu_physics_engine_torch import make_engine, make_tuned_engine
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.ops import tiled as tt
from test_torch_tiled import assert_same, cfgs, jnp_state, scene


def _slice_cfgs(**kw):
    # production flags (Newton + uniform radius, relocate interval 2) at
    # 25% area fill (denser scenes amplify the sum-order difference past
    # 1e-4 within 12 steps, with pid placement still exact);
    # flip matching: greedy inside an interpret-mode engine step is a very
    # long CPU compile; greedy is held exact at kernel level instead.
    # Cap 3: the interpret-mode step compiles faster than at cap 4
    return cfgs(world_width=16.0, world_height=60.0, max_particles=300,
                initial_particles=300, tile_cap=3, tiled_newton=True,
                tiled_uniform_radius=True, tiled_relocate_interval=2,
                sort_interval_steps=6, tiled_match="flip", **kw)


@pytest.mark.parametrize("sweep", ["relocate", "rebuild"])
def test_whole_slice_matches_jax(sweep):
    jcfg, tcfg = _slice_cfgs(tiled_sweep=sweep)
    jcfg = jcfg.replace(tiled_collide="pallas", tiled_relocate="pallas")
    pos, _, prev = scene(300, 31, w=16.0, h=60.0, vel=0.05)
    rad = np.full(300, 0.5, np.float32)
    je = JEngine.from_arrays(jcfg, pos, rad, previous_positions=prev)
    te = TEngine.from_arrays(tcfg, pos, rad, previous_positions=prev,
                             device="cpu")
    for e in (je, te):
        # two equal windows (the JAX engine compiles one 6-step program)
        # with the sweep at step 6 between them
        e.press_mouse((8.0, 20.0))
        e.run(6)
        e.release_mouse()
        e.run(6)
    assert_same(je.state, te.state, atol=1e-4)
    assert te.num_particles() == 300
    assert je.watchdog_events == te.watchdog_events
    np.testing.assert_allclose(te.positions(), je.positions(), atol=1e-4)


def test_run_schedule_relocates_every_interval(monkeypatch):
    """The relocate pattern of run(): at interval 2 and the 4M row's window
    (chunk 32, sweep every 240), 150 + 150 steps relocate 150 times,
    the count chip_smoke.py asserts on the card."""
    calls = []

    def spy(state, params, config, do_relocate=True, prm=None):
        calls.append(do_relocate)  # the schedule only: no physics needed
        return state

    monkeypatch.setattr(tt, "tiled_step_fn", spy)
    _, tcfg = cfgs(tile_cap=4, initial_particles=64, world_width=16.0,
                   world_height=16.0, tiled_relocate_interval=2,
                   sort_interval_steps=240)
    e = TEngine(tcfg, seed=1, chunk=32, device="cpu")
    e.run(150)
    e.press_mouse((8.0, 8.0))
    e.run(150)
    assert len(calls) == 300
    assert sum(calls) == 150
    # no two consecutive off-steps anywhere (the interval-2 drift bound)
    assert all(a or b for a, b in zip(calls, calls[1:]))


def test_tuned_engine_on_cpu_conserves_and_stays_in_bounds():
    e = make_tuned_engine(3000, seed=3, device="cpu", world_width=96.0,
                          world_height=48.0, tile_multiplier=4.4,
                          tile_cap=6, sort_interval_steps=20)
    assert e.device.type == "cpu"
    assert e.config.tiled_match == "greedy" and e.config.tiled_newton
    e.press_mouse((48.0, 24.0))
    e.run(25)
    pid, pos, _, rad = tt.export_particles(e.state)
    n = e.num_particles()
    assert n == 3000 == int((e.state.pid >= 0).sum())
    np.testing.assert_array_equal(pid, np.arange(n))
    assert np.isfinite(pos).all()
    assert (pos[:, 0] >= rad - 1e-4).all() and (pos[:, 0] <= 96 - rad + 1e-4).all()
    assert (pos[:, 1] >= rad - 1e-4).all() and (pos[:, 1] <= 48 - rad + 1e-4).all()
    assert e.velocities().shape == (n, 2)
    assert e.timer.frame_count == 25


def test_watchdog_escalates_on_growing_stale_population():
    """A stale population that grows between run() boundaries trips the
    watchdog, which sweeps it away (and escalates on repeats)."""
    _, tcfg = cfgs(tile_cap=4, initial_particles=300, sort_interval_steps=0,
                   tiled_relocate="jnp", tiled_collide="jnp")
    pos, rad, _ = scene(300, 33, rmax=0.4)
    e = TEngine.from_arrays(tcfg, pos, rad, device="cpu")
    e.run(1)
    assert e.watchdog_events == 0
    t = tt.tile_geometry(tcfg)[0]
    for trip in (1, 2):
        occ = e.state.pid >= 0
        big = (e.state.pid % 3 == 0) & occ  # a third of them, 2+ tiles off
        e.state = e.state.replace(
            x=torch.where(big, torch.clamp(e.state.x + 2.5 * t, max=63.0),
                          e.state.x))
        e._wd_prev = 0.5  # a healthy previous boundary
        e.run(1)
        assert e.watchdog_events == trip
        assert float(tt.stale_pair_fraction(e.state, e.config)) < 0.02
    assert e.config.tiled_hysteresis == 0.0  # level 2: hysteresis off
    assert e.num_particles() == 300


def _wd_engines():
    """The JAX package's watchdog scene (tests/test_watchdog.py: 48
    particles in the left half of a 96 x 8 world, cap 3, flip, hysteresis
    0.2, bound 4%) under the hybrid (tiled_rebuild_every=2), in both
    packages, on the "jnp" step with a one-mover relocate buffer, so a
    teleported population stays stale until the watchdog drains it."""
    jcfg, tcfg = cfgs(max_particles=64, initial_particles=64,
                      world_width=96.0, world_height=8.0, tile_cap=3,
                      max_occupancy=4, tile_multiplier=2.2,
                      tiled_match="flip", tiled_hysteresis=0.2,
                      tiled_watchdog_pct=4.0, sweep_mover_capacity=64,
                      mover_capacity=1, tiled_collide="jnp",
                      tiled_relocate="jnp", tiled_rebuild_every=2,
                      sort_interval_steps=240)
    rng = np.random.default_rng(0)
    pos = np.stack([rng.uniform(1.0, 40.0, 48),
                    rng.uniform(1.0, 7.0, 48)], -1).astype(np.float32)
    rad = np.full(48, 0.5, np.float32)
    return (JEngine.from_arrays(jcfg, pos, rad),
            TEngine.from_arrays(tcfg, pos, rad, device="cpu"))


def _inject(je, te, count, hops=5.0):
    """Teleport the first ``count`` live slots +hops tiles in x, storage
    kept (px moves too: no velocity), in both engines alike."""
    import jax.numpy as jnp
    d = jnp_state(je.state)
    t = te.cell_size()
    x, px = d["x"].copy(), d["px"].copy()
    idx = np.nonzero(d["pid"].ravel() >= 0)[0][:count]
    xf, pf = x.reshape(-1), px.reshape(-1)
    shift = np.minimum(xf[idx] + hops * t, 95.0) - xf[idx]
    xf[idx] += shift
    pf[idx] += shift
    je.state = dataclasses.replace(je.state, x=jnp.asarray(x),
                                   px=jnp.asarray(px))
    te.state = te.state.replace(x=torch.from_numpy(x),
                                px=torch.from_numpy(px))


def test_watchdog_matches_jax():
    """The port's escalation against JAX TiledEngine._watchdog on one
    scene: the forced sweep, hysteresis off, +1 slot capacity, then the
    futility self-disarm when the re-tile did not cut the stale
    population; each drain through the hybrid's rebuild.  Levels,
    events, configs, sweep counters and states must agree."""
    je, te = _wd_engines()
    levels = []
    for count in (0, 16, 24, 32, 40):
        if count:
            _inject(je, te, count)
        for e in (je, te):
            e.run(2)
        for f in ("watchdog_events", "_wd_level", "_wd_prev",
                  "_wd_retile_pct", "_sweep_count", "rebuild_sweeps"):
            assert getattr(te, f) == getattr(je, f), (count, f)
        for k in ("tile_cap", "tiled_hysteresis"):
            assert getattr(te.config, k) == getattr(je.config, k), k
        assert_same(je.state, te.state, atol=1e-4)
        levels.append((te.watchdog_events, te._wd_level,
                       te.config.tile_cap))
    # baseline; forced sweep; hysteresis off; cap 3 -> 4; futility
    assert levels == [(0, 0, 3), (1, 1, 3), (2, 2, 3), (3, 2, 4),
                      (4, 1, 4)]
    assert te.config.tiled_hysteresis == 0.0
    assert te._sweep_count == 4 and te.rebuild_sweeps == 0
    assert te.num_particles() == 48


def test_step_matches_run_single_steps():
    """step() keeps the same relocate counter as run()'s single steps."""
    _, tcfg = cfgs(tile_cap=4, initial_particles=200, tiled_relocate_interval=2,
                   sort_interval_steps=5)
    pos, rad, _ = scene(200, 34)
    a = TEngine.from_arrays(tcfg, pos, rad, device="cpu")
    b = TEngine.from_arrays(tcfg, pos, rad, device="cpu")
    a.run(9)
    for _ in range(9):
        b.step()
    for f in ("x", "y", "pid", "overflow_count"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


def test_profile_run_reports_a_breakdown():
    from gpu_physics_engine_torch.utils.profiling import profile_run
    _, tcfg = cfgs(tile_cap=4, initial_particles=100, world_width=16.0,
                   world_height=16.0)
    e = TEngine(tcfg, seed=2, device="cpu")
    out = profile_run(e, steps=2)
    assert out["steps"] == 2 and out["host_wall_ms"] > 0
    # a CPU engine has no device timeline: no device numbers at all
    assert out["device_span_ms"] is None and out["idle_share"] is None
    assert out["kernels"] == []
    assert e.num_particles() == 100


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    """The engine runs on the card by default; without one it raises and
    never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = cfgs(tile_cap=4, initial_particles=16)
    pos, rad, _ = scene(16, 35)
    for call in (lambda: make_tuned_engine(3000, world_width=96.0,
                                           world_height=48.0),
                 lambda: make_engine(tcfg),
                 lambda: TEngine(tcfg),
                 lambda: TEngine.from_arrays(tcfg, pos, rad)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert TEngine.from_arrays(tcfg, pos, rad,
                               device="cpu").device.type == "cpu"
