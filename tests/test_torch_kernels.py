"""The port's two kernels (gpu_physics_engine_torch/ops/tiled_kernels.py).

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's Pallas kernels in interpret mode, on the same
numpy-seeded scenes:

  * K1 (fused collide + integrate) within 1e-5 world units, pid exact: the
    port's gather sweep equals the standard Pallas sweep up to rsqrt
    rounding, and the Newton sweep up to the order of the f32 sums
    (tests/test_newton.py holds those two within 1e-5 as well);
  * K2 (pull relocate) exactly: all six fields and overflow_count.

The CUDA kernels themselves are compared with the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_physics_engine_tpu.core.state import StepParams as JParams
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_tpu.ops.tiled_pallas import (collide_integrate_pallas,
                                                     relocate_pallas)
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk
from test_torch_tiled import (FIELDS, assert_same, both_states, cfgs,
                              jnp_state, scene)


@functools.lru_cache(maxsize=None)
def _jitted(fn):
    """``fn(state, config)`` compiled once per config (configs are frozen
    and hashable): eager Pallas calls in interpret mode recompile on every
    call.  XLA:CPU compiles at backend optimisation level 0, which spares
    part of LLVM's work on the interpret-mode programs; the tests hold the
    results exactly either way."""
    return jax.jit(fn, static_argnums=(1,),
                   compiler_options={"xla_backend_optimization_level": 0})


def j_relocate(state, config):
    """The JAX package's pull relocate.  It reads neither the particle
    counts nor the pass count, so those are normalised: scenes that differ
    only there share one compile."""
    return _jitted(relocate_pallas)(state, config.replace(
        initial_particles=0, max_particles=0, tiled_relocate_passes=1))


def tall(**kw):
    """16 x 60 world at cap 4: 4 bands of 8 tile rows, so the Pallas
    kernels' band seams (and the Newton seam carry) all run."""
    kw.setdefault("tile_cap", 4)
    return cfgs(world_width=16.0, world_height=60.0, max_particles=600,
                initial_particles=600, **kw)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("newton", [False, True])
@pytest.mark.parametrize("uniform", [False, True])
def test_k1_plain_matches_pallas(newton, uniform):
    jcfg, tcfg = tall(tiled_newton=newton, tiled_uniform_radius=uniform,
                      gravity=(0.0, -9.8))
    pos, rad, prev = scene(600, 21, w=16.0, h=60.0, vel=0.1)
    if uniform:
        rad = np.full_like(rad, 0.5)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    pa = JParams.make(0.02, mouse=(8.0, 31.0), pressed=True)
    pb = TParams.make(0.02, mouse=(8.0, 31.0), pressed=True)
    for dt_scale in (1.0, 0.5):
        ja = collide_integrate_pallas(a, pa, jcfg, dt_scale=dt_scale)
        tb = tk.collide_integrate(b, pb.as_tensor("cpu", dt_scale), tcfg)
        assert_same(ja, tb, atol=1e-5)
    assert tk.LAUNCHES["collide_integrate"] == 0  # CPU: no kernel launch


def test_k1_circle_world_matches_plain_integrate():
    """The fused pass in a circle world equals the separate plain collide
    and integrate of the JAX package's jnp path."""
    jcfg, tcfg = tall(world_shape="circle")
    pos, rad, prev = scene(400, 22, w=16.0, h=60.0, vel=0.2)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    pa = JParams.make(0.02, mouse=(3.0, 3.0), pressed=True)
    pb = TParams.make(0.02, mouse=(3.0, 3.0), pressed=True)
    ja = jt.integrate(jt.collide(a, jcfg), pa, jcfg)
    tb = tk.collide_integrate(b, pb.as_tensor("cpu"), tcfg)
    assert_same(ja, tb, atol=1e-5)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def _shifted(a, b, shifts):
    """Add per-pid x/y shifts {pid: (dx, dy)} to both packages' states."""
    jd = jnp_state(a)
    for p, (dx, dy) in shifts.items():
        sel = jd["pid"] == p
        jd["x"] = np.where(sel, jd["x"] + np.float32(dx), jd["x"])
        jd["y"] = np.where(sel, jd["y"] + np.float32(dy), jd["y"])
    return (jt.TileState(**{k: jnp.asarray(v) for k, v in jd.items()}),
            tt.from_numpy(jd))


def _tile_of_pid(st, p):
    k, ty, tx = np.nonzero(tt.to_numpy(st)["pid"] == p)
    return int(ty[0]), int(tx[0])


def _relocate_both(a, b, jcfg, tcfg, passes=1):
    jcfg = jcfg.replace(tiled_relocate_passes=passes)
    tcfg = tcfg.replace(tiled_relocate_passes=passes)
    ja = jt._relocate_passes(j_relocate, a, jcfg)
    tb = tt._relocate_passes(tk.relocate_pull, b, tcfg)
    assert_same(ja, tb)
    return ja, tb


def test_k2_hysteresis_keeps_boundary_dancers():
    """A particle just past a tile edge (inside the hysteresis band) keeps
    its slot; a deeper one relocates."""
    # cap 3 in a 16 x 16 world: the interpret-mode relocate compiles in
    # about 60% of its cap-4 time; two particles need no more room
    jcfg, tcfg = cfgs(initial_particles=2, tile_cap=3, world_width=16.0,
                      world_height=16.0)
    t, _, _ = tt.tile_geometry(tcfg)
    delta = tcfg.hysteresis_delta
    pos = np.array([[1.5 * t, 1.5 * t], [1.5 * t, 2.5 * t]], np.float32)
    a, b = both_states(jcfg, tcfg, pos, np.full(2, 0.4, np.float32))
    a, b = _shifted(a, b, {0: (0.5 * t + 0.5 * delta, 0.0), 1: (t, 0.0)})
    _, tb = _relocate_both(a, b, jcfg, tcfg)
    assert _tile_of_pid(tb, 0) == (2, 2)
    assert _tile_of_pid(tb, 1) == (3, 3)
    assert int(tb.overflow_count) == 0


def test_k2_multi_hop_converges():
    # a 3-tile jump is far past any hysteresis band; with none the test
    # shares the compile of test_k2_contention's flip case
    jcfg, tcfg = cfgs(initial_particles=1, tile_cap=4, tiled_match="flip",
                      tiled_hysteresis=0.0)
    t, _, _ = tt.tile_geometry(tcfg)
    pos = np.array([[0.5 * t, 0.5 * t]], np.float32)
    a, b = both_states(jcfg, tcfg, pos, np.array([0.5], np.float32))
    a, b = _shifted(a, b, {0: (3 * t, 0.0)})
    for _ in range(3):
        a, b = _relocate_both(a, b, jcfg, tcfg)
    assert _tile_of_pid(b, 0) == (1, 4)
    assert int(b.overflow_count) == 0


def test_k2_full_target_defers():
    # "auto" resolves to greedy here; naming it shares the compile of the
    # greedy tests below
    jcfg, tcfg = cfgs(tile_cap=4, initial_particles=6, tiled_hysteresis=0.0,
                      tiled_match="greedy")
    t, _, _ = tt.tile_geometry(tcfg)
    fill = [[0.2 * t + 0.1 * i, 0.5 * t] for i in range(4)]
    movers = [[1.2 * t, 0.3 * t], [1.4 * t, 0.6 * t]]
    pos = np.array(fill + movers, np.float32)
    a, b = both_states(jcfg, tcfg, pos, np.full(6, 0.01, np.float32))
    a, b = _shifted(a, b, {4: (-t, 0.0), 5: (-t, 0.0)})
    _, tb = _relocate_both(a, b, jcfg, tcfg)
    assert int(tb.overflow_count) == 2
    assert int((tb.pid >= 0).sum()) == 6


@pytest.mark.parametrize("match, deferred", [("flip", 1), ("greedy", 0)])
def test_k2_contention(match, deferred):
    """Two movers from different neighbours, both in slot 0, target one
    empty tile: flip gives them one shared slot, greedy places both."""
    jcfg, tcfg = cfgs(tile_cap=4, initial_particles=2, tiled_hysteresis=0.0,
                      tiled_match=match)
    t = 2.2
    pos = np.array([[0.5 * t, 1.5 * t], [2.5 * t, 1.5 * t]], np.float32)
    a, b = both_states(jcfg, tcfg, pos, np.full(2, 0.01, np.float32))
    a, b = _shifted(a, b, {0: (t, 0.0), 1: (-t, 0.0)})
    _, tb = _relocate_both(a, b, jcfg, tcfg)
    assert int(tb.overflow_count) == deferred


def test_k2_greedy_with_occupied_target_slots_and_second_pass():
    """Occupied slots claim nothing; a second pass places an arrival that
    the first pass's pre-departure occupancy blocked."""
    jcfg, tcfg = cfgs(tile_cap=4, initial_particles=5, tiled_match="greedy",
                      tiled_hysteresis=0.0)
    t = 2.2
    pos = np.array([[1.2 * t, 1.5 * t], [1.4 * t, 1.5 * t],
                    [1.6 * t, 1.5 * t], [1.8 * t, 1.5 * t],
                    [0.5 * t, 1.5 * t]], np.float32)
    a, b = both_states(jcfg, tcfg, pos, np.full(5, 0.01, np.float32))
    a, b = _shifted(a, b, {p: (t, 0.0) for p in range(5)})
    _, one = _relocate_both(a, b, jcfg, tcfg, passes=1)
    assert int(one.overflow_count) == 1
    _, two = _relocate_both(a, b, jcfg, tcfg, passes=2)
    assert int(two.overflow_count) == 0
    assert _tile_of_pid(two, 4) == (2, 2)


def test_wrappers_raise_on_unsupported_tensors():
    _, tcfg = cfgs(tile_cap=4)
    pos, rad, _ = scene(30, 25)
    st = tt.init_tiles(tcfg, pos, rad)
    prm = TParams.make(0.02).as_tensor("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.collide_integrate_cuda(st, prm, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.relocate_pull_cuda(st, tcfg)
    meta = st.replace(**{f: getattr(st, f).to("meta") for f in FIELDS})
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.relocate_pull(meta, tcfg)
