"""The port's array-pipeline slab step (parallel/halo.py) and its sharded
headless runner (app/multichip.py) against the JAX package's on the 8
virtual CPU devices (4 of them for the step, 2 for the runner).

The halo step: alive masks, the per-slab drop and resort counters exact,
float state within 1e-4 over 10 steps that cross a resort (the port sorts
with its hand radix sort, whose plain version on the CPU equals the JAX
package's stable lax sort).
"""

import functools

import jax
import numpy as np
import pytest

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu import StepParams as JParams
from gpu_physics_engine_tpu.app import multichip as jmultichip
from gpu_physics_engine_tpu.parallel import halo as jhalo
from gpu_physics_engine_tpu.parallel import mesh as jmesh
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.app import multichip as tmultichip
from gpu_physics_engine_torch.parallel import halo as thalo
from gpu_physics_engine_torch.parallel import mesh as tmesh

EXACT = ("alive", "dropped", "steps_since_sort")
FLOATS = ("x", "y", "px", "py", "radius")


def cfgs(**kw):
    base = dict(max_particles=256, initial_particles=256, world_width=128.0,
                world_height=32.0, initial_radius=0.5, sort_interval_steps=4,
                halo_capacity=64, migration_capacity=32,
                gravity=(40.0, -10.0))
    base.update(kw)
    return JConfig(**base), TConfig(**base).replace(sort_impl="radix")


def scene(n, seed):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(1.0, 127.0, n), rng.uniform(1.0, 31.0, n)],
                   -1).astype(np.float32)
    return pos, np.full(n, 0.5, np.float32)


@functools.lru_cache(maxsize=None)
def halo_runs():
    """A dense scene (200 particles) and an overlapping pair across the
    slab 0 / 1 edge, 10 steps each through JAX's compiled step and the
    port's on 4 slabs."""
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    jc, tc = cfgs()
    jm, tm = jmesh.make_mesh(4), tmesh.make_mesh(4, device="cpu")
    jstep, tstep = jhalo.make_sharded_step(jc, jm), thalo.make_sharded_step(
        tc, tm)
    p, q = JParams.make(jc.dt), TParams.make(tc.dt)
    b = 32.0  # the slab 0 / 1 edge
    pair = (np.array([[b - 0.4, 16.0], [b + 0.4, 16.0]], np.float32),
            np.full(2, 0.5, np.float32))
    out = []
    for pos, rad in (scene(200, 1), pair):
        js = jhalo.init_sharded(jc, jm, pos, rad, slots_per_shard=64)
        ts = thalo.init_sharded(tc, tm, pos, rad, slots_per_shard=64)
        trace = []
        for _ in range(10):
            js, ts = jstep(js, p), tstep(ts, q)
            trace.append(({f: np.asarray(getattr(js, f))
                           for f in EXACT + FLOATS},
                          {f: thalo.gather(ts, f) for f in EXACT + FLOATS},
                          ts))
        out.append(trace)
    return out


@pytest.mark.parametrize("which", ["dense", "edge_pair"])
def test_halo_step_matches_jax(which):
    trace = halo_runs()[("dense", "edge_pair").index(which)]
    for k, (jd, td, _) in enumerate(trace):
        for f in EXACT:
            np.testing.assert_array_equal(td[f], jd[f], err_msg=f"{k} {f}")
        for f in FLOATS:
            np.testing.assert_allclose(td[f], jd[f], atol=1e-4, rtol=0,
                                       err_msg=f"{k} {f}")
    n = 200 if which == "dense" else 2
    last = trace[-1][1]
    assert int(last["alive"].sum()) + int(last["dropped"].sum()) == n
    pos, _ = thalo.gather_alive(trace[-1][2])
    assert np.isfinite(pos).all()
    if which == "edge_pair":
        # the pair is seen only through the halo: it was pushed apart
        assert abs(pos[0, 0] - pos[1, 0]) >= 1.0 - 1e-5


def test_halo_resort_compacts_each_slab():
    """After the resort (every 4 steps) the alive slots of every slab are
    a prefix of its pool, as in the JAX package."""
    trace = halo_runs()[0]
    for k in (4, 8):  # the steps that resorted (since_sort reached 4)
        assert int(trace[k][1]["steps_since_sort"][0]) == 1
        for a in trace[k][2].alive:
            a = a.numpy()
            if a.any():
                assert a[:np.nonzero(a)[0][-1] + 1].all()


def test_init_sharded_gives_particles_to_their_slab():
    jc, tc = cfgs()
    pos, rad = scene(200, 4)
    js = jhalo.init_sharded(jc, jmesh.make_mesh(4), pos, rad, 40)
    ts = thalo.init_sharded(tc, tmesh.make_mesh(4, device="cpu"), pos, rad,
                            40)
    for f in EXACT + FLOATS:
        np.testing.assert_array_equal(thalo.gather(ts, f),
                                      np.asarray(getattr(js, f)))
    a, b = thalo.gather_alive(ts), jhalo.gather_alive(js)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_multichip_main_matches_jax(capsys):
    """The sharded runner on 2 slabs of a small world: the same summary
    keys, particle count and deferrals as the JAX package's runner on 2
    virtual devices; finite positions."""
    argv = ["--devices", "2", "--particles", "1500", "--world", "96", "64",
            "--steps", "6", "--tile-cap", "6", "--summary-json"]
    want = jmultichip.main(argv + ["--cpu"])
    got = tmultichip.main(argv + ["--device", "cpu"])
    assert set(got) == set(want)
    for k in ("devices", "particles", "deferred", "per_chip_deferred",
              "steps", "finite"):
        assert got[k] == want[k], k
    assert got["finite"] and got["particles"] == 1500
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("{") and lines[-3].startswith("{")
