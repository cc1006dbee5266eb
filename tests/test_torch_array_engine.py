"""The port's array Engine (gpu_physics_engine_torch/core/engine.py, the
default SimConfig's path: sorted pairs, 4-color Gauss-Seidel, Morton
resort) against the JAX package's Engine on the CPU.

The JAX engine starts from a numpy scene (``from_arrays``); its state
crosses into the port through ``state.from_numpy``, and both run 12 steps
with the mouse pressed, crossing Morton resorts (every 5 steps).  The JAX
package holds its own radix engine equal to its lax engine bit for bit
(tests/test_radix_sort.py), so both port sort_impls are held to the JAX
lax engine.  num_active, overflow_count and steps_since_sort are exact.
Positions are within 1e-4 world units for the colored solver and 1e-3 for
Jacobi, not bit-equal: the stages are bit-equal to the JAX functions run
op by op (tests/test_torch_array.py), but the JAX engine's compiled step
lets XLA:CPU contract products into sums (one ulp on a few particles in
the first step), and later contacts carry such an ulp on.  Jacobi's
correction sums contract too and, undamped by the ordered sweep, drift
further.  The fast solver (sort + shift Jacobi) is held at the Jacobi
tolerance on the scene without the jam, at K 10, where no cell run passes
K: past K a run drops the pairs its window misses, and which ones depends
on the order of equal cell ids, which JAX's unstable sort leaves to XLA.
The port's radix engine equals its lax engine bit for bit.
Also here: the state constructors and the spawn ring.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.core import state as jstate
from gpu_physics_engine_tpu.core.config import SimConfig as JConfig
from gpu_physics_engine_tpu.core.engine import Engine as JEngine
from gpu_physics_engine_torch import Engine, SimConfig, make_engine
from gpu_physics_engine_torch.core import state as tstate
from gpu_physics_engine_torch.ops import radix_sort
from gpu_physics_engine_torch.ops import spawn as tspawn
from test_torch_array import _assert_states_equal, cfgs

MOUSE = (24.0, 16.0)


def cfg_kw(**kw):
    # max_occupancy 4: the JAX step unrolls K(K-1)/2 pairs per color, and
    # compiles in a third of the time it takes at 6; the jam under the
    # mouse still overflows it
    base = dict(max_particles=400, initial_particles=300, world_width=48.0,
                world_height=32.0, initial_radius=0.5, max_occupancy=4,
                sort_interval_steps=5)
    base.update(kw)
    return base


def scene(n=300, seed=21, jam=True):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0.5, 47.5, n), rng.uniform(0.5, 31.5, n)],
                   -1).astype(np.float32)
    if jam:  # a jam under the mouse
        pos[:40] = (np.array(MOUSE) + rng.normal(0.0, 0.6, (40, 2))).astype(
            np.float32)
    rad = np.full(n, 0.5, np.float32)
    prev = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    return pos, rad, prev


def jax_numpy(st) -> dict:
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _run(e, steps=12):
    e.press_mouse(MOUSE)
    e.run(steps)
    return e


@functools.lru_cache(maxsize=None)
def _jax_run(pipeline: str, solver: str, pack: bool = True, K: int = 4):
    """(the JAX engine's initial state, its state after ``_run``), as numpy;
    one compile per JAX config for the module; the fast solver's scene has
    no jam."""
    pos, rad, prev = scene(jam=solver != "fast")
    je = JEngine.from_arrays(
        JConfig(**cfg_kw(pipeline=pipeline, solver=solver,
                         fast_pack_bf16=pack, max_occupancy=K)), pos, rad,
        previous_positions=prev)
    start = jax_numpy(je.state)
    return start, jax_numpy(_run(je).state)


@pytest.mark.parametrize("variant", [
    dict(pipeline="sorted", solver="colored", sort_impl="lax"),
    dict(pipeline="sorted", solver="colored", sort_impl="radix"),
    dict(pipeline="bucket", solver="colored"),
    dict(pipeline="sorted", solver="jacobi"),
    dict(pipeline="sorted", solver="fast", max_occupancy=10),
    dict(pipeline="sorted", solver="fast", max_occupancy=10,
         fast_pack_bf16=False),
], ids=["sorted-lax", "sorted-radix", "bucket", "jacobi", "fast",
        "fast-f32"])
def test_engine_matches_jax_engine(variant):
    # the JAX side sorts with lax: JAX radix == JAX lax (its own test)
    start, want = _jax_run(variant["pipeline"], variant["solver"],
                           variant.get("fast_pack_bf16", True),
                           variant.get("max_occupancy", 4))
    te = Engine(SimConfig(**cfg_kw(**variant)),
                initial_state=tstate.from_numpy(start))
    radix_sort.reset_launches()
    got = tstate.to_numpy(_run(te).state)
    pos = scene(jam=variant["solver"] != "fast")[0]
    for f in ("num_active", "overflow_count", "steps_since_sort",
              "max_radius"):
        assert got[f] == want[f], f
    assert int(got["steps_since_sort"]) == 2  # resorted at steps 5 and 10
    atol = 1e-4 if variant["solver"] == "colored" else 1e-3
    for f in ("x", "y", "px", "py"):
        np.testing.assert_allclose(got[f], want[f], atol=atol, rtol=0,
                                   err_msg=f)
    np.testing.assert_array_equal(got["radius"], want["radius"])
    assert not np.allclose(got["x"][:300], pos[:, 0])
    if variant["solver"] == "colored":
        assert int(got["overflow_count"]) > 0  # the jam passes K
    if variant["solver"] == "fast":
        assert int(got["overflow_count"]) == 0
    # on the CPU the wrapper ran the plain version: no kernel launches
    assert radix_sort.LAUNCHES["radix_rank_hist"] == 0


@pytest.mark.parametrize("pipeline", ["sorted", "bucket"])
def test_radix_engine_equals_lax_engine(pipeline):
    pos, rad, prev = scene()
    engines = [Engine.from_arrays(
        SimConfig(**cfg_kw(pipeline=pipeline, sort_impl=impl)), pos, rad,
        previous_positions=prev, device="cpu") for impl in ("lax", "radix")]
    for e in engines:
        _run(e, 8)
        e.spawn_at((10.0, 10.0), count=50, verbose=False)
        e.release_mouse()
        e.run(4)
    a, b = (tstate.to_numpy(e.state) for e in engines)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert engines[0].num_particles() == 350


def test_step_matches_run_and_resort_cadence():
    pos, rad, prev = scene()
    cfg = SimConfig(**cfg_kw(sort_interval_steps=3))
    a = Engine.from_arrays(cfg, pos, rad, previous_positions=prev,
                           device="cpu")
    b = Engine.from_arrays(cfg, pos, rad, previous_positions=prev,
                           device="cpu")
    a.run(7)
    since = []
    for _ in range(7):
        b.step()
        since.append(int(b.state.steps_since_sort))
    assert since == [1, 2, 3, 1, 2, 3, 1]  # resorts at steps 3 and 6
    for f in ("x", "y", "px", "py", "overflow_count"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


def test_spawn_and_downloads():
    cfg = SimConfig(**cfg_kw(max_particles=450, sort_interval_steps=0))
    e = make_engine(cfg, seed=4, device="cpu")
    assert isinstance(e, Engine) and e.device.type == "cpu"
    assert e.num_particles() == 300
    assert np.isclose(e.cell_size(), 2.2 * 0.5)
    e.spawn_at((24.0, 16.0), verbose=False)
    assert e.num_particles() == 400
    r = e.radii()[300:]
    assert set(np.unique(r)) <= {1.0, 2.0, 3.0}
    assert float(e.state.max_radius) == r.max()
    assert e.cell_size() == 2.2 * float(e.state.max_radius)
    e.spawn_at((24.0, 16.0), verbose=False)  # 400 + 100 > 450: refused
    assert e.num_particles() == 400
    e.run(3)
    assert np.isfinite(e.positions()).all()
    assert e.velocities().shape == e.previous_positions().shape == (400, 2)
    assert e.timer.frame_count == 3


def test_debug_downloads_546_duplicates():
    cfg = SimConfig(max_particles=546, initial_particles=546,
                    world_width=32.0, world_height=32.0, initial_radius=1.0)
    pos = np.tile(np.array([[2.25, 2.25]], np.float32), (546, 1))
    e = Engine.from_arrays(cfg, pos, np.ones(546, np.float32), device="cpu")
    sc, so = e.debug_grid()
    assert sc.shape[0] == so.shape[0] == 4 * cfg.capacity
    cells, total = e.debug_collision_cells()
    assert total == 4
    assert cells[:4].tolist() == [0, 546, 1092, 1638]


def test_entry_points(monkeypatch):
    """Engine for sorted/bucket x colored/jacobi/fast on the CPU when
    asked; without a card the default raises."""
    base = cfg_kw(max_particles=64, initial_particles=64, world_width=16.0,
                  world_height=16.0)
    for pipeline in ("sorted", "bucket"):
        for solver in ("colored", "jacobi", "fast"):
            e = make_engine(SimConfig(**base, pipeline=pipeline,
                                      solver=solver), device="cpu")
            assert type(e) is Engine
            e.run(2)
            assert e.num_particles() == 64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(**base)
    pos = np.full((4, 2), 8.0, np.float32)
    for call in (lambda: make_engine(cfg), lambda: Engine(cfg),
                 lambda: Engine.from_arrays(cfg, pos, np.ones(4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_engine(SimConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_engine(cfg.replace(solver="fast"))


def test_state_constructors():
    jcfg, tcfg = cfgs(track_colors=True)
    _assert_states_equal(tstate.zeros(tcfg), jstate.zeros(jcfg))
    st = tstate.init_uniform(tcfg, torch.Generator().manual_seed(3))
    assert st.x.shape == (jcfg.capacity,) and st.color.shape == (1024, 4)
    live = st.active_mask().numpy()
    assert live.sum() == 256 and live[:256].all()
    x = st.x.numpy()
    assert (x[live] < 48.0).all() and (x[~live] == 0).all()
    assert (st.radius.numpy()[live] == 1.0).all()
    assert torch.equal(st.x, st.px) and st.x.data_ptr() != st.px.data_ptr()
    back = tstate.from_numpy(tstate.to_numpy(st))
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(back, f.name), getattr(st, f.name))




def test_ring_burst_geometry():
    g = torch.Generator().manual_seed(0)
    sx, sy, r = tspawn.ring_burst(g, 256.0, 256.0, 100)
    d = torch.sqrt((sx - 256.0) ** 2 + (sy - 256.0) ** 2).numpy()
    assert (d >= 10.0 - 1e-4).all() and (d <= 50.0 + 1.5 * 99 + 1e-3).all()
    assert set(np.unique(r.numpy())) <= {1.0, 2.0, 3.0}
    c = tspawn.burst_colors(g, 100)
    assert c.shape == (100, 4) and (c[:, 3] == 1.0).all()
    assert (c[:, :3] >= 0.3).all() and (c[:, :3] < 1.0).all()
