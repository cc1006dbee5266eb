"""The port's array-pipeline stages (gpu_physics_engine_torch/ops: morton,
scan, grid, collision, resort, spawn, integrate) against the JAX
package's on the CPU, from the same numpy inputs (the radix sort and its
pass's tile ranks: tests/test_torch_array_sort.py).

Tolerances: integer outputs (cell ids, coords, pairs, ranks, histograms,
occupant tables, bucket entries, permutations, counters) are exact.  The
colored Gauss-Seidel solve is bit-equal to the JAX function and to the
scalar model (tests/reference_model.py), and so are the Jacobi solve and
Verlet: the JAX functions run op by op here, so XLA has no program to
contract a product and a sum in, and the port takes correctly rounded
square roots (ops/integrate.sqrt_rn).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_model as ref
from gpu_physics_engine_tpu.core import state as jstate
from gpu_physics_engine_tpu.core.config import SimConfig as JConfig
from gpu_physics_engine_tpu.core.state import StepParams as JParams
from gpu_physics_engine_tpu.ops import collision as jcol
from gpu_physics_engine_tpu.ops import grid as jgrid
from gpu_physics_engine_tpu.ops import integrate as jint
from gpu_physics_engine_tpu.ops import morton as jmorton
from gpu_physics_engine_tpu.ops import resort as jresort
from gpu_physics_engine_tpu.ops import spawn as jspawn
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.core import state as tstate
from gpu_physics_engine_torch.core.config import UNUSED_CELL_ID
from gpu_physics_engine_torch.ops import collision as tcol
from gpu_physics_engine_torch.ops import grid as tgrid
from gpu_physics_engine_torch.ops import integrate as tint
from gpu_physics_engine_torch.ops import morton as tmorton
from gpu_physics_engine_torch.ops import resort as tresort
from gpu_physics_engine_torch.ops import scan as tscan
from gpu_physics_engine_torch.ops import spawn as tspawn

CELL = 2.2  # cell size for radius-1 particles (tests/test_grid.py's)
# every array has this many slots (the configs' capacity), so the JAX
# package's eager ops compile once per shape for the whole module
CAP = 1024


# the JAX package's integer stages, compiled once each (eagerly, their
# scans and scatter rounds dispatch op by op and take seconds)
j_collision_cells = jax.jit(jcol.build_collision_cells)
j_occupants_from_sorted = jax.jit(jcol.occupants_from_sorted,
                                  static_argnames=("K", "max_cells"))
j_build_buckets = jax.jit(jgrid.build_buckets,
                          static_argnames=("config", "home_only"))


def cfgs(**kw):
    base = dict(max_particles=300, initial_particles=256, world_width=48.0,
                world_height=32.0, initial_radius=1.0, max_occupancy=6,
                sort_interval_steps=0)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def scene(n, seed, w=48.0, h=32.0, rmin=0.6, rmax=1.0, vel=0.05):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0.0, w, n), rng.uniform(0.0, h, n)],
                   -1).astype(np.float32)
    rad = rng.uniform(rmin, rmax, n).astype(np.float32)
    prev = (pos + rng.normal(0.0, vel, pos.shape)).astype(np.float32)
    return pos, rad, prev


def jax_arrays(pos, rad, cap):
    n = len(rad)
    x = np.zeros(cap, np.float32)
    y = np.zeros(cap, np.float32)
    r = np.zeros(cap, np.float32)
    x[:n], y[:n], r[:n] = pos[:, 0], pos[:, 1], rad
    active = np.arange(cap) < n
    return x, y, r, active


def both(*arrays):
    """The numpy arrays as (jax arrays, torch CPU tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def u32(a) -> np.ndarray:
    """u32 values as int64, from either package."""
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def dense_scene(n=220, seed=11, cluster=40):
    """A spread scene plus a jammed cluster (cells with more than K
    occupants), 20 free slots."""
    pos, rad, prev = scene(n - cluster, seed, w=40.0, h=24.0)
    rng = np.random.default_rng(seed + 1)
    jam = (np.array([20.0, 12.0]) + rng.normal(0.0, 0.8, (cluster, 2))
           ).astype(np.float32)
    return (np.concatenate([pos, jam]),
            np.concatenate([rad, np.full(cluster, 1.0, np.float32)]),
            np.concatenate([prev, jam]))


def arrays_and_candidates(pos, rad):
    """((x, y, r, active) for JAX, the same for torch, JAX candidates,
    torch candidates) of a scene in CAP slots, cell size CELL."""
    ja, ta = both(*jax_arrays(pos, rad, CAP))
    jc = jgrid.build_candidates(*ja, jnp.float32(CELL))
    tc = tgrid.build_candidates(*ta, torch.tensor(np.float32(CELL)))
    return ja, ta, jc, tc


def candidates(pos, rad):
    return arrays_and_candidates(pos, rad)[2:]


# ---------------------------------------------------------------------------
# morton, scan
# ---------------------------------------------------------------------------

def test_morton_golden_values_and_the_minus_one_wrap():
    t = torch.tensor
    assert int(tmorton.morton_encode(t(3), t(3))) == 15
    assert int(tmorton.unsplit_by_bits(t(5))) == 3
    assert int(tmorton.split_by_bits(t(3))) == 5
    # cell (-1, -1) is the UNUSED sentinel, as the u32 cast makes it
    assert int(tmorton.morton_encode(t(-1), t(-1))) == UNUSED_CELL_ID
    assert int(tmorton.morton_encode(t(-1), t(0))) == 0x55555555
    rng = np.random.default_rng(1)
    cx = rng.integers(-1, 1 << 16, 500)
    cy = rng.integers(-1, 1 << 16, 500)
    got = tmorton.morton_encode(torch.from_numpy(cx), torch.from_numpy(cy))
    want = jmorton.morton_encode(jnp.asarray(cx, jnp.int32),
                                 jnp.asarray(cy, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), u32(want))
    assert got.numpy()[:50].tolist() == [
        ref.morton_encode(int(a) & 0xFFFF, int(b) & 0xFFFF)
        for a, b in zip(cx[:50], cy[:50])]
    dx, dy = tmorton.morton_decode(got)
    np.testing.assert_array_equal(dx.numpy(), cx & 0xFFFF)
    np.testing.assert_array_equal(dy.numpy(), cy & 0xFFFF)


def test_scans():
    x = torch.tensor([3, 0, 2, 5, 1], dtype=torch.int32)
    assert tscan.inclusive_scan(x).tolist() == [3, 3, 5, 10, 11]
    assert tscan.exclusive_scan(x).tolist() == [0, 3, 3, 5, 10]
    assert tscan.inclusive_scan(x).dtype == torch.int32


# ---------------------------------------------------------------------------
# grid: candidates, cell ids, sort_map, buckets
# ---------------------------------------------------------------------------

def test_corner_particle_has_three_phantoms():
    _, tc = candidates(np.array([[CELL * 2 + 0.05, CELL * 2 + 0.05]],
                                np.float32), np.array([1.0], np.float32))
    assert tc.cells[0].tolist() == [ref.morton_encode(2, 2),
                                    ref.morton_encode(1, 1),
                                    ref.morton_encode(2, 1),
                                    ref.morton_encode(1, 2)]


@pytest.mark.parametrize("seed", [7, 8])
def test_candidates_and_cell_ids_match_jax(seed):
    # positions from 0 (low-edge phantoms at coordinate -1) to the far
    # edges, free slots after them
    pos, rad, _ = scene(256, seed)
    jc, tc = candidates(pos, rad)
    np.testing.assert_array_equal(tc.cells.numpy(), u32(jc.cells))
    np.testing.assert_array_equal(tc.coords.numpy(), np.asarray(jc.coords))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    assert (tc.cells.numpy() == UNUSED_CELL_ID).any()
    jids, jobj = jgrid.build_cell_ids(jc)
    tids, tobj = tgrid.build_cell_ids(tc)
    np.testing.assert_array_equal(tids.numpy(), u32(jids))
    np.testing.assert_array_equal(tobj.numpy(), np.asarray(jobj))
    # the scalar model writes object 0 into unused slots
    want_cells, want_objs = ref.build_cell_ids(pos, rad, CELL)
    used = want_cells != UNUSED_CELL_ID
    np.testing.assert_array_equal(tids.numpy()[:4 * 256], want_cells)
    np.testing.assert_array_equal(tobj.numpy()[:4 * 256][used],
                                  want_objs[used])


@pytest.mark.parametrize("impl", ["lax", "radix"])
def test_sort_map_matches_jax(impl):
    pos, rad, _ = scene(256, 9)
    jc, tc = candidates(pos, rad)
    jsc, jso = jgrid.sort_map(*jgrid.build_cell_ids(jc))
    tsc, tso = tgrid.sort_map(*tgrid.build_cell_ids(tc), impl=impl)
    np.testing.assert_array_equal(tsc.numpy(), u32(jsc))
    np.testing.assert_array_equal(tso.numpy(), np.asarray(jso))
    wc, wo = ref.sort_map(*ref.build_cell_ids(pos, rad, CELL))
    used = wc != UNUSED_CELL_ID  # a prefix of both
    np.testing.assert_array_equal(tsc.numpy()[:len(wc)][used], wc[used])
    np.testing.assert_array_equal(tso.numpy()[:len(wo)][used], wo[used])


@pytest.mark.parametrize("home_only", [False, True])
def test_build_buckets_matches_jax(home_only):
    jcfg, tcfg = cfgs(max_particles=220, initial_particles=220,
                      world_width=40.0, world_height=24.0)
    pos, rad, _ = dense_scene()
    jc, tc = candidates(pos, rad)
    jb = j_build_buckets(jc, config=jcfg, home_only=home_only)
    tb = tgrid.build_buckets(tc, tcfg, home_only=home_only)
    np.testing.assert_array_equal(tb.entries.numpy(), np.asarray(jb.entries))
    assert int(tb.overflow) == int(jb.overflow) > 0
    for u, v in zip(tb.occupants(), jb.occupants()):
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))
    lin, ok = tgrid.linear_cell_ids(tc.coords, tc.valid, tcfg)
    jlin, jok = jgrid.linear_cell_ids(jc.coords, jc.valid, jcfg)
    np.testing.assert_array_equal(lin.numpy(), np.asarray(jlin))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


# ---------------------------------------------------------------------------
# collision cells and occupant tables
# ---------------------------------------------------------------------------

def _sorted_pairs(pos, rad, impl="lax"):
    _, tc = candidates(pos, rad)
    return tgrid.sort_map(*tgrid.build_cell_ids(tc), impl=impl)


def test_546_duplicates_collision_cells():
    # the reference's 546 identical particles near a cell corner: 4
    # collision cells (home + 3 phantoms) starting at 0, 546, 1092, 1638
    n = 546
    pos = np.tile(np.array([[CELL + 0.05, CELL + 0.05]], np.float32), (n, 1))
    sc, _ = _sorted_pairs(pos, np.ones(n, np.float32), impl="radix")
    cells, total = tcol.build_collision_cells(sc)
    assert int(total) == 4
    assert cells[:4].tolist() == [0, 546, 1092, 1638]
    assert (cells[4:] == UNUSED_CELL_ID).all()


def test_collision_cells_match_jax_and_golden_model():
    pos, rad, _ = scene(200, 12, w=30.0, h=30.0)
    jc, tc = candidates(pos, rad)
    jsc, _ = jgrid.sort_map(*jgrid.build_cell_ids(jc))
    tsc, _ = tgrid.sort_map(*tgrid.build_cell_ids(tc))
    jcells, jtotal = j_collision_cells(jsc)
    tcells, ttotal = tcol.build_collision_cells(tsc)
    np.testing.assert_array_equal(tcells.numpy(), u32(jcells))
    assert int(ttotal) == int(jtotal)
    want = ref.collision_cells(ref.sort_map(*ref.build_cell_ids(
        pos, rad, CELL))[0])
    assert tcells[:len(want)].tolist() == list(want)
    np.testing.assert_array_equal(tcol.run_starts(tsc).numpy(),
                                  np.asarray(jcol.run_starts(jsc)))


@pytest.mark.parametrize("max_cells", [None, 40])
def test_occupants_from_sorted_matches_jax(max_cells):
    # the jammed cluster overflows K; max_cells=40 also drops cells
    jcfg, _ = cfgs()
    pos, rad, _ = dense_scene()
    jc, tc = candidates(pos, rad)
    jsc, jso = jgrid.sort_map(*jgrid.build_cell_ids(jc))
    tsc, tso = tgrid.sort_map(*tgrid.build_cell_ids(tc), impl="radix")
    K = jcfg.max_occupancy
    jt = j_occupants_from_sorted(jsc, jso, K=K, max_cells=max_cells)
    tt = tcol.occupants_from_sorted(tsc, tso, K, max_cells=max_cells)
    for f in ("obj", "valid", "color", "active"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert int(tt.overflow) == int(jt.overflow) > 0


def test_occupants_from_buckets_matches_jax():
    jcfg, tcfg = cfgs(max_particles=220, initial_particles=220,
                      world_width=40.0, world_height=24.0)
    pos, rad, _ = dense_scene()
    jc, tc = candidates(pos, rad)
    jt = jcol.occupants_from_buckets(j_build_buckets(jc, config=jcfg), jcfg)
    tt = tcol.occupants_from_buckets(tgrid.build_buckets(tc, tcfg), tcfg)
    for f in ("obj", "valid", "color", "active"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    assert int(tt.overflow) == int(jt.overflow)


# ---------------------------------------------------------------------------
# solvers and Verlet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [6, 8])
def test_solve_colored_bitmatches_jax_and_scalar_model(K):
    rng = np.random.default_rng(4)
    n = 90
    pos = rng.uniform(3.0, 25.0, size=(n, 2)).astype(np.float32)
    rad = rng.uniform(0.6, 1.0, size=n).astype(np.float32)
    (jx, jy, jr, ja), (tx, ty, tr, ta), jc, tc = arrays_and_candidates(
        pos, rad)
    jtab = j_occupants_from_sorted(*jgrid.sort_map(
        *jgrid.build_cell_ids(jc)), K=K)
    ttab = tcol.occupants_from_sorted(*tgrid.sort_map(
        *tgrid.build_cell_ids(tc), impl="radix"), K)
    jnx, jny = jcol.solve_colored(jx, jy, jr, jtab, jnp.float32(0.6))
    tnx, tny = tcol.solve_colored(tx, ty, tr, ttab, 0.6)
    np.testing.assert_array_equal(tnx.numpy(), np.asarray(jnx))
    np.testing.assert_array_equal(tny.numpy(), np.asarray(jny))
    wc, wo = ref.sort_map(*ref.build_cell_ids(pos, rad, CELL))
    want = ref.solve_colored(pos, rad, wc, wo, 0.6, max_occupancy=K)
    np.testing.assert_array_equal(tnx.numpy()[:n], want[:, 0])
    np.testing.assert_array_equal(tny.numpy()[:n], want[:, 1])
    assert not np.array_equal(tnx.numpy()[:n], pos[:, 0])


def test_solve_colored_on_buckets_bitmatches_jax():
    jcfg, tcfg = cfgs(max_particles=220, initial_particles=220,
                      world_width=40.0, world_height=24.0)
    pos, rad, _ = dense_scene()
    (jx, jy, jr, ja), (tx, ty, tr, ta), jc, tc = arrays_and_candidates(
        pos, rad)
    jtab = jcol.occupants_from_buckets(j_build_buckets(jc, config=jcfg), jcfg)
    ttab = tcol.occupants_from_buckets(tgrid.build_buckets(tc, tcfg), tcfg)
    jnx, jny = jcol.solve_colored(jx, jy, jr, jtab, jnp.float32(0.6))
    tnx, tny = tcol.solve_colored(tx, ty, tr, ttab, 0.6)
    np.testing.assert_array_equal(tnx.numpy(), np.asarray(jnx))
    np.testing.assert_array_equal(tny.numpy(), np.asarray(jny))


def test_solve_jacobi_bitmatches_jax():
    jcfg, tcfg = cfgs(max_particles=220, initial_particles=220,
                      world_width=40.0, world_height=24.0, solver="jacobi")
    pos, rad, _ = dense_scene()
    (jx, jy, jr, ja), (tx, ty, tr, ta), jc, tc = arrays_and_candidates(
        pos, rad)
    jhb = j_build_buckets(jc, config=jcfg, home_only=True)
    thb = tgrid.build_buckets(tc, tcfg, home_only=True)
    jnx, jny = jcol.solve_jacobi(jx, jy, jr, jhb, jc, jcfg, ja)
    tnx, tny = tcol.solve_jacobi(tx, ty, tr, thb, tc, tcfg, ta)
    np.testing.assert_array_equal(tnx.numpy(), np.asarray(jnx))
    np.testing.assert_array_equal(tny.numpy(), np.asarray(jny))
    assert not np.allclose(tnx.numpy()[:220], pos[:, 0])


@pytest.mark.parametrize("world", ["box", "circle"])
@pytest.mark.parametrize("pressed", [False, True])
def test_verlet_integrate_bitmatches_jax(world, pressed):
    jcfg, tcfg = cfgs(world_shape=world, gravity=(1.5, -9.8))
    pos, rad, prev = scene(256, 13, vel=0.3)
    x, y, r, active = jax_arrays(pos, rad, CAP)
    px, py, _, _ = jax_arrays(prev, rad, CAP)
    (jx, jy, jpx, jpy, jr, ja), (tx, ty, tpx, tpy, tr, ta) = both(
        x, y, px, py, r, active)
    jp = JParams.make(0.02, mouse=(30.0, 20.0), pressed=pressed)
    tp = TParams.make(0.02, mouse=(30.0, 20.0), pressed=pressed)
    for scale in (1.0, 0.5):
        jp2 = dataclasses.replace(jp, dt=jp.dt * jnp.float32(scale))
        want = jint.verlet_integrate(jx, jy, jpx, jpy, jr, ja, jp2, jcfg)
        got = tint.verlet_integrate(tx, ty, tpx, tpy, tr, ta,
                                    tp.as_tensor("cpu", scale), tcfg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Morton resort, spawn (the state constructors and the spawn ring:
# tests/test_torch_array_engine.py)
# ---------------------------------------------------------------------------

def _both_particle_states(jcfg, tcfg, pos, rad, prev=None):
    js = jstate.from_arrays(jcfg, pos, rad, previous_positions=prev)
    ts = tstate.from_numpy({f.name: np.asarray(getattr(js, f.name))
                            for f in dataclasses.fields(js)})
    direct = tstate.from_arrays(tcfg, pos, rad, previous_positions=prev)
    for f in dataclasses.fields(ts):
        assert torch.equal(getattr(ts, f.name), getattr(direct, f.name))
    return js, ts


def _assert_states_equal(ts, js):
    got = tstate.to_numpy(ts)
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(got[f.name],
                                      np.asarray(getattr(js, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("impl", ["lax", "radix"])
def test_morton_resort_matches_jax(impl):
    jcfg, tcfg = cfgs(track_colors=True)
    pos, rad, prev = scene(256, 14)
    js, ts = _both_particle_states(jcfg, tcfg, pos, rad, prev)
    colors = np.random.default_rng(14).random(
        (jcfg.capacity, 4)).astype(np.float32)
    js = dataclasses.replace(js, color=jnp.asarray(colors),
                             steps_since_sort=jnp.int32(7))
    ts = ts.replace(color=torch.from_numpy(colors),
                    steps_since_sort=torch.tensor(7, dtype=torch.int32))
    jn, jperm = jresort.morton_resort(js, jnp.float32(CELL))
    tn, tperm = tresort.morton_resort(ts, torch.tensor(np.float32(CELL)),
                                      sort_impl=impl)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    assert sorted(tperm.tolist()) == list(range(jcfg.capacity))
    assert (tperm.numpy()[256:] >= 256).all()  # inactive slots stay last
    _assert_states_equal(tn, jn)
    assert int(tn.steps_since_sort) == 0


def test_add_particles_matches_jax_given_the_burst():
    # the burst is the one the JAX package drew (its jitted ring_burst
    # rounds as XLA fuses it); given it, the port's state is the same
    jcfg, tcfg = cfgs(max_particles=400, initial_particles=256)
    pos, rad, _ = scene(256, 15)
    js, ts = _both_particle_states(jcfg, tcfg, pos, rad)
    import jax
    jn = jspawn.add_particles(jcfg, js, jax.random.key(5), jnp.float32(24.0),
                              jnp.float32(16.0), count=100)
    burst = [torch.from_numpy(np.array(getattr(jn, f)[256:356]))
             for f in ("x", "y", "radius")]
    tn = tspawn.add_particles(tcfg, ts, *burst)
    _assert_states_equal(tn, jn)
    assert int(tn.num_active) == 356 and float(tn.max_radius) == float(
        burst[2].max()) > 1.0
    # a burst past max_particles is refused whole
    assert tspawn.add_particles(tcfg.replace(max_particles=300), ts,
                                *burst) is ts
