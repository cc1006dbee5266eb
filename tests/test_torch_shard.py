"""The port's slab mesh and sharded tiled pipeline (parallel/mesh.py,
parallel/tiled_shard.py) against the JAX package's on 2 and 4 of the 8
virtual CPU devices.

The port's meshes put every slab on the CPU (``make_mesh(n,
device="cpu")``), where the kernel wrappers run their plain versions; the
JAX package runs its Pallas kernels in interpret mode.  Each JAX program
is compiled once for the file (module-level caches).  pid planes and
counters must match exactly, float planes within 1e-4 (the single-chip
engine tests' tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu import StepParams as JParams
from gpu_physics_engine_tpu.parallel import mesh as jmesh
from gpu_physics_engine_tpu.parallel import tiled_shard as jts
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.parallel import mesh as tmesh
from gpu_physics_engine_torch.parallel import tiled_shard as tts

FIELDS = tt.FIELDS
ATOL = 1e-4


def cfgs(**kw):
    base = dict(max_particles=512, initial_particles=200, world_width=64.0,
                world_height=64.0, initial_radius=0.5, sort_interval_steps=0,
                pipeline="tiled", tile_cap=4, migration_capacity=64,
                mover_capacity=1024, tiled_collide="jnp",
                tiled_relocate="jnp")
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def scene(n, seed, vel=0.05):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(1.0, 63.0, n), rng.uniform(1.0, 63.0, n)],
                   -1).astype(np.float32)
    prev = (pos + rng.normal(0.0, vel, pos.shape)).astype(np.float32)
    return pos, np.full(n, 0.5, np.float32), prev


@functools.lru_cache(maxsize=None)
def jax_mesh(n):
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jmesh.make_mesh(n)


def cpu_mesh(n):
    return tmesh.make_mesh(n, device="cpu")


def jax_planes(st):
    return {f: np.asarray(getattr(st, f)) for f in
            FIELDS + ("num_active", "overflow_count")}


def assert_same(jd, slabs, atol=ATOL, what=""):
    """JAX planes ``jd`` (a dict) against the port's slabs, gathered."""
    td = tt.to_numpy(tmesh.gather_tiles(slabs, device="cpu"))
    for f in FIELDS:
        if f == "pid" or atol == 0.0:
            np.testing.assert_array_equal(td[f], jd[f], err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(td[f], jd[f], atol=atol, rtol=0,
                                       err_msg=f"{what} {f}")
    assert int(td["num_active"]) == int(jd["num_active"]), what
    assert int(td["overflow_count"]) == int(jd["overflow_count"]), what


def slab_of(slabs, pid):
    for i, s in enumerate(slabs):
        if bool((s.pid == pid).any()):
            return i
    raise AssertionError(f"pid {pid} is in no slab")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [1, -1])
def test_ppermute_moves_by_shift_and_zero_fills_the_edges(shift):
    mesh = cpu_mesh(4)
    per = [torch.full((2, 3), float(i + 1)) for i in range(4)]
    out = mesh.ppermute(per, shift)
    for j, o in enumerate(out):
        src = j - shift
        want = float(src + 1) if 0 <= src < 4 else 0.0
        assert torch.equal(o, torch.full((2, 3), want))
        assert o.data_ptr() != per[j].data_ptr()  # a copy, never an alias
    got = mesh.ppermute([torch.ones(3, dtype=torch.bool)] * 4, shift)
    edge = 0 if shift == 1 else 3
    assert not bool(got[edge].any()) and all(
        bool(g.all()) for j, g in enumerate(got) if j != edge)


def test_psum_and_make_mesh():
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.devices == [torch.device("cpu")] * 3
    out = mesh.psum([torch.tensor(v, dtype=torch.int32) for v in (1, 2, 7)])
    assert len(out) == 3 and all(int(o) == 10 for o in out)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tmesh.make_mesh(have + 1)
    if not have:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            tmesh.make_mesh()


@pytest.mark.parametrize("n", [2, 4])
def test_shard_and_gather_round_trip_jax_planes(n):
    """JAX's sharded TileState gathered with np.asarray gives the same
    planes as the port's slabs gathered; sharding those planes gives the
    port's slabs, and gather inverts shard."""
    jc, tc = cfgs()
    pos, rad, prev = scene(200, 1)
    jd = jax_planes(jts.init_sharded_tiles(jc, jax_mesh(n), pos, rad,
                                           previous_positions=prev))
    slabs = tts.init_sharded_tiles(tc, cpu_mesh(n), pos, rad,
                                   previous_positions=prev)
    assert len(slabs) == n and slabs[0].dims == (4, 32 // n, 32)
    assert_same(jd, slabs, atol=0.0)
    again = tmesh.shard_tiles(jd, cpu_mesh(n))
    for a, b in zip(again, slabs):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert all(s.num_active is slabs[0].num_active for s in slabs)
    assert_same(jd, tmesh.shard_tiles(tmesh.gather_tiles(slabs),
                                      cpu_mesh(n)), atol=0.0)


# ---------------------------------------------------------------------------
# the sharded step against JAX's
# ---------------------------------------------------------------------------

def _run_both(jc, tc, n, scenes, steps):
    """Each scene through JAX's compiled sharded step (one compile for
    all) and the port's, step by step: [(jax planes, jax drops, port
    slabs, port drops) per step] per scene."""
    jstep = jax.jit(jts.make_sharded_tiled_step_fn(jc, jax_mesh(n)))
    tstep = tts.make_sharded_tiled_step_fn(tc, cpu_mesh(n))
    p, q = JParams.make(jc.dt), TParams.make(tc.dt)
    out = []
    for pos, rad, prev in scenes:
        js = jts.init_sharded_tiles(jc, jax_mesh(n), pos, rad,
                                    previous_positions=prev)
        ts = tts.init_sharded_tiles(tc, cpu_mesh(n), pos, rad,
                                    previous_positions=prev)
        trace = []
        for _ in range(steps):
            js, jd = jstep(js, p)
            ts, td = tstep(ts, q)
            trace.append((jax_planes(js), np.asarray(jd), ts, td))
        out.append(trace)
    return out


@functools.lru_cache(maxsize=None)
def jnp_route(n):
    jc, tc = cfgs(gravity=(0.0, -60.0))
    # one particle at y = 33.6: tile row 16, the first row of slab 1 of 2
    # and of slab 2 of 4; it falls about 1.9 units in 15 steps
    one = (np.array([[20.0, 33.6]], np.float32),
           np.array([0.5], np.float32), None)
    return _run_both(jc, tc, n, [scene(200, 0), one], 15)


@pytest.mark.parametrize("n", [2, 4])
def test_jnp_route_matches_jax(n):
    """The plain collide + integrate and the claim relocate with the
    two-phase migration, 15 steps under gravity: every step's planes and
    per-slab deferrals equal JAX's; particles cross slab boundaries."""
    dense = jnp_route(n)[0]
    start = tts.init_sharded_tiles(cfgs()[1], cpu_mesh(n), *scene(200, 0)[:2])
    for k, (jd, jdrop, ts, tdrop) in enumerate(dense):
        assert_same(jd, ts, what=f"step {k + 1}")
        np.testing.assert_array_equal(tdrop.numpy(), jdrop)
    ts = dense[-1][2]
    moved = [p for p in range(200) if slab_of(start, p) != slab_of(ts, p)]
    assert len(moved) >= 2
    assert int(ts[0].num_active) == 200


@pytest.mark.parametrize("n", [2, 4])
def test_single_particle_migrates_across_slabs(n):
    """One particle falls from slab 1 (of 2 or 4) across a slab
    boundary under gravity, as in JAX."""
    _, tc = cfgs()
    trace = jnp_route(n)[1]
    before = tts.init_sharded_tiles(tc, cpu_mesh(n),
                                    np.array([[20.0, 33.6]], np.float32),
                                    np.array([0.5], np.float32))
    for k, (jd, jdrop, ts, tdrop) in enumerate(trace):
        assert_same(jd, ts, what=f"step {k + 1}")
    assert slab_of(trace[-1][2], 0) < slab_of(before, 0)
    assert int(trace[-1][2][0].overflow_count) == 0


def test_kernel_route_matches_jax_and_never_duplicates():
    """The kernel route (K1 fused on the extended slabs, the crossers by
    K2's step offsets, K2 at row0 = 16 on slab 1; plain versions on the
    CPU) against JAX's Pallas route in interpret mode, 8 steps on 2 slabs.
    A one-entry migration buffer under strong gravity defers crossers:
    the deferrals per slab equal JAX's, and no pid is lost or doubled."""
    jc, tc = cfgs(gravity=(0.0, -400.0), migration_capacity=1,
                  tiled_collide="pallas", tiled_relocate="pallas",
                  tiled_fuse_integrate=True, tiled_match="flip")
    tc = tc.replace(tiled_collide="auto", tiled_relocate="auto")
    trace = _run_both(jc, tc, 2, [scene(120, 11)], 8)[0]
    total = 0
    for k, (jd, jdrop, ts, tdrop) in enumerate(trace):
        assert_same(jd, ts, what=f"step {k + 1}")
        np.testing.assert_array_equal(tdrop.numpy(), jdrop)
        pid = torch.cat([s.pid.reshape(-1) for s in ts])
        live = pid[pid >= 0]
        assert torch.equal(torch.sort(live).values, torch.arange(120,
                                                                 dtype=torch.int32))
        total += int(tdrop.sum())
    assert total > 0  # the buffer did overflow


# ---------------------------------------------------------------------------
# spawn inserts
# ---------------------------------------------------------------------------

def _blocked_scene(cfg, rows):
    """Fill a home tile in the top row of slab 0, the row below it and
    both side tiles to cap: the free neighbour in INSERT_OFFSETS order is
    the tile above, in slab 1; plus 16 random particles."""
    t = tt.tile_geometry(cfg)[0]
    cap = cfg.tile_cap
    g = rows - 1
    pos = []
    for ty, tx in [(g, 4), (g, 5), (g, 6), (g - 1, 4), (g - 1, 5),
                   (g - 1, 6)]:
        for i in range(cap):
            fx = 0.15 + 0.7 * ((i * 5) % cap) / cap
            fy = 0.15 + 0.7 * i / cap
            pos.append(((tx - 1 + fx) * t, (ty - 1 + fy) * t))
    rng = np.random.default_rng(4)
    far = np.stack([rng.uniform(30.0, 63.0, 16), rng.uniform(1.0, 63.0, 16)],
                   -1)
    pos = np.concatenate([np.asarray(pos), far]).astype(np.float32)
    spawn = np.stack([rng.uniform(1.0, 63.0, 24),
                      rng.uniform(1.0, 63.0, 24)], -1).astype(np.float32)
    spawn[:3] = ((5 - 0.5) * t, (g - 0.5) * t)
    spawn[:3, 0] += np.asarray([-0.3, 0.0, 0.3], np.float32)
    return pos, spawn, g


def test_insert_and_place_at_match_jax():
    """The ring-1 insert round with a full home tile at the top row of
    slab 0 (its fallback lands in slab 1's bottom row) and the far-spill
    placement at host-chosen tiles in both slabs: planes and the placed
    mask equal JAX's; nothing lost or doubled."""
    jc, tc = cfgs(max_particles=256)
    rows = tts.sharded_tile_geometry(tc, 2)[3]
    pos, spawn, g = _blocked_scene(tc, rows)
    n0 = len(pos)
    rad = np.full(n0, 0.5, np.float32)
    sr = np.full(24, 0.5, np.float32)
    ids = np.arange(n0, n0 + 24, dtype=np.int32)
    js = jts.init_sharded_tiles(jc, jax_mesh(2), pos, rad)
    ts = tts.init_sharded_tiles(tc, cpu_mesh(2), pos, rad)
    js, jplaced = jts.make_sharded_insert(jc, jax_mesh(2))(
        js, jnp.asarray(spawn), jnp.asarray(sr), jnp.asarray(ids),
        jnp.zeros(24, bool))
    ts, tplaced = tts.make_sharded_insert(tc, cpu_mesh(2))(
        ts, spawn, sr, ids, torch.zeros(24, dtype=torch.bool))
    np.testing.assert_array_equal(tplaced.numpy(), np.asarray(jplaced))
    assert bool(tplaced.all())
    assert_same(jax_planes(js), ts, atol=0.0)
    where = np.argwhere(tmesh.gather_tiles(ts).pid.numpy() >= n0)
    homes = {(int(ty), int(tx)) for k, ty, tx in where
             if int(tmesh.gather_tiles(ts).pid[k, ty, tx]) < n0 + 3}
    assert homes == {(g + 1, 5)}  # the fallback crossed into slab 1

    # the far spill: six more at chosen tiles (rows in both slabs), two of
    # them marked as placed already, one aimed at the full home tile
    more = spawn[:6] + 1.0
    ids2 = np.arange(n0 + 24, n0 + 30, dtype=np.int32)
    ty_t = np.array([2, 5, g, g + 1, 20, 29], np.int32)
    tx_t = np.array([3, 9, 5, 5, 17, 30], np.int32)
    pre = np.array([False, True, False, False, True, False])
    js, jp2 = jts.make_sharded_place_at(jc, jax_mesh(2))(
        js, jnp.asarray(more), jnp.asarray(sr[:6]), jnp.asarray(ids2),
        jnp.asarray(ty_t), jnp.asarray(tx_t), jnp.asarray(pre))
    ts, tp2 = tts.make_sharded_place_at(tc, cpu_mesh(2))(
        ts, more, sr[:6], ids2, ty_t, tx_t, torch.as_tensor(pre))
    np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
    assert tp2.tolist() == [True, True, False, True, True, True]
    assert_same(jax_planes(js), ts, atol=0.0)
    pid = tmesh.gather_tiles(ts).pid
    live = pid[pid >= 0]
    assert len(live) == len(torch.unique(live)) == n0 + 24 + 3


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _Spy:
    """A stand-in for a step function that records its kind and returns
    the state with no drops (the schedule only: no physics)."""

    def __init__(self, log, kind, n, torch_side):
        self.log, self.kind, self.n, self.torch = log, kind, n, torch_side

    def __call__(self, state, p):
        self.log.append(self.kind)
        drops = (torch.zeros(self.n, dtype=torch.int32) if self.torch
                 else jnp.zeros(self.n, jnp.int32))
        return state, drops


def _jax_spied(engine, log):
    iv = engine._reloc_iv
    n = engine.mesh.devices.size
    engine._step = _Spy(log, "R", n, False)
    engine._step_nr = _Spy(log, "N", n, False) if iv > 1 else engine._step
    engine._sweep = _Spy(log, "S", n, False)

    def chunk_of(k):
        def chunk(state, p):
            full, rem = divmod(k, iv)
            for m in [iv] * full + ([rem] if rem else []):
                log.extend(["R"] + ["N"] * (m - 1))
            return state, jnp.zeros(n, jnp.int32)
        return chunk
    engine._chunk_of = chunk_of
    engine._chunk = chunk_of(engine.CHUNK)


def test_engine_schedule_counts_as_jax():
    """run() windows, single steps, the relocate interval and the sweep at
    its cadence (240 on the kernel route): the same sequence of relocating
    steps, off-steps and sweeps as the JAX engine over 520 steps of run()
    and step() calls."""
    jc, tc = cfgs(initial_particles=64, tiled_relocate="pallas",
                  tiled_relocate_interval=3)
    tc = tc.replace(tiled_relocate="auto")
    pos, rad, _ = scene(64, 5)
    arr = (pos, rad, None, None)
    je = jts.ShardedTiledEngine(jc, mesh=jax_mesh(2), initial_arrays=arr)
    te = tts.ShardedTiledEngine(tc, mesh=cpu_mesh(2), initial_arrays=arr)
    assert je._sweep_interval == te._sweep_interval == 240
    jlog, tlog = [], []
    _jax_spied(je, jlog)
    te._step = _Spy(tlog, "R", 2, True)
    te._step_nr = _Spy(tlog, "N", 2, True)
    te._sweep = _Spy(tlog, "S", 2, True)
    for e in (je, te):
        e.step()
        e.step()
        e.run(250)
        e.step()
        e.run(5)
        e.run(262)
    assert jlog == tlog
    assert tlog.count("S") == 2 and len(tlog) == 520 + 2


@functools.lru_cache(maxsize=None)
def engines_run():
    """The JAX engine and the port's on 4 slabs, the claim route with
    relocate interval 2, a one-entry migration buffer and strong gravity
    (deferrals on most slabs): 12 steps of run() and 2 of step()."""
    jc, tc = cfgs(initial_particles=160, gravity=(0.0, -400.0),
                  migration_capacity=1, tiled_relocate_interval=2)
    pos, rad, prev = scene(160, 3)
    arr = (pos, rad, None, prev)
    je = jts.ShardedTiledEngine(jc, mesh=jax_mesh(4), initial_arrays=arr)
    te = tts.ShardedTiledEngine(tc, mesh=cpu_mesh(4), initial_arrays=arr)
    for e in (je, te):
        e.press_mouse((20.0, 40.0))
        e.run(12)
        e.release_mouse()
        e.step()
        e.step()
    return je, te


def test_engine_matches_jax_with_per_slab_deferrals():
    je, te = engines_run()
    np.testing.assert_array_equal(te.per_chip_overflow, je.per_chip_overflow)
    assert te.per_chip_overflow.sum() > 0
    assert_same(jax_planes(je.state), te.state)
    assert te.num_particles() == je.num_particles() == 160
    jp, jx, jv, jr = (je._export()[0], je.positions(), je.velocities(),
                      je.radii())
    np.testing.assert_array_equal(te._export()[0], jp)
    np.testing.assert_allclose(te.positions(), jx, atol=ATOL, rtol=0)
    np.testing.assert_allclose(te.velocities(), jv, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(te.radii(), jr)


def test_checkpoint_across_topologies(tmp_path):
    """JAX's 4-slab save loads in the port's 2-slab engine and in
    TiledEngine; the port's 2-slab save loads in JAX's 4-slab engine."""
    je, _ = engines_run()
    path = str(tmp_path / "jax4.npz")
    je.save_checkpoint(path)
    pid, pos, prev, rad = je._export()
    overflow = int(je.state.overflow_count)
    two = tts.ShardedTiledEngine.from_checkpoint(path, mesh=cpu_mesh(2))
    one = TiledEngine.from_checkpoint(path, device="cpu")
    for e in (two, one):
        got = e._export()
        for a, b in zip(got, (pid, pos, prev, rad)):
            np.testing.assert_array_equal(a, b)
    assert int(two.state[0].overflow_count) == overflow
    assert int(one.state.overflow_count) == overflow
    assert two.per_chip_overflow.tolist() == [0, 0]

    two.run(3)
    path2 = str(tmp_path / "port2.npz")
    two.save_checkpoint(path2)
    back = jts.ShardedTiledEngine.from_checkpoint(path2, mesh=jax_mesh(4))
    for a, b in zip(back._export(), two._export()):
        np.testing.assert_array_equal(a, b)
    assert int(back.state.overflow_count) == int(two.state[0].overflow_count)


def test_step_one_equals_tiled_engine_bit_for_bit():
    """From a freshly tiled scene at the production flags (uniform
    radius, relocate interval 2, the kernel route), one sharded step on 4
    slabs leaves every pid's position and previous position bit-equal to
    TiledEngine's first step (which relocates first, then collides)."""
    _, tc = cfgs(initial_particles=400, tiled_collide="auto",
                 tiled_relocate="auto", tiled_uniform_radius=True,
                 tiled_relocate_interval=2, tiled_match="greedy",
                 gravity=(0.0, -30.0))
    pos, rad, prev = scene(400, 8, vel=0.2)
    single = TiledEngine.from_arrays(tc, pos, rad, device="cpu",
                                     previous_positions=prev)
    sharded = tts.ShardedTiledEngine(tc, mesh=cpu_mesh(4),
                                     initial_arrays=(pos, rad, None, prev))
    for e in (single, sharded):
        e.press_mouse((30.0, 30.0))
        e.step()
    a, b = single._export(), sharded._export()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(tiled_sweep="rebuild"), dict(tiled_sweep="bands"),
    dict(tiled_rebuild_every=4), dict(tiled_solver="gs",
                                      tile_multiplier=2.2),
    dict(tiled_relocate_passes=2)])
def test_single_chip_options_are_refused(kw):
    _, tc = cfgs(**kw)
    pos, rad, _ = scene(50, 2)
    with pytest.raises(ValueError, match="single-chip"):
        tts.ShardedTiledEngine(tc, mesh=cpu_mesh(2),
                               initial_arrays=(pos, rad, None, None))


def test_spawn_disables_uniform_radius_and_counts():
    """A ring burst of radii 1 on a tile_max_radius=1 engine (cap sized
    from the scene) turns the uniform-radius sweep off and rebuilds the
    step; the count rises by the burst less overflow_count and the pid
    set stays exact."""
    _, tc = cfgs(initial_particles=64, tile_max_radius=1.0, tile_cap=0,
                 tiled_uniform_radius=True, tiled_collide="auto",
                 tiled_relocate="auto")
    e = tts.ShardedTiledEngine(tc, mesh=cpu_mesh(4), seed=0)
    assert e.config.tile_cap >= 8 and e.config.tiled_uniform_radius
    e.run(3)
    step_before = e._step
    e.spawn_at((32.0, 33.0), count=40, verbose=False)
    assert not e.config.tiled_uniform_radius and e._step is not step_before
    lost = int(e.state[0].overflow_count)
    assert e.num_particles() == 64 + 40 - lost
    e.run(3)
    pid = e._export()[0]
    np.testing.assert_array_equal(np.sort(pid), np.sort(np.unique(pid)))
    assert len(pid) == e.num_particles()
    assert np.isfinite(e.positions()).all()
    with pytest.raises(ValueError, match="tile_max_radius"):
        tts.ShardedTiledEngine(cfgs()[1], mesh=cpu_mesh(2)).spawn_at(
            (3.0, 3.0))


# ---------------------------------------------------------------------------
# the sync-free helpers against the forms they replace
# ---------------------------------------------------------------------------

def _nonzero_reference(mask, size, fill):
    idx = torch.nonzero(mask).flatten()[:size]
    pad = size - idx.shape[0]
    return torch.cat([idx, torch.full((pad,), fill, dtype=idx.dtype)])


def _insert_reference(state, ty_t, tx_t, fields, live):
    """The boolean-mask form of ``_insert_compacted``."""
    cap, TY, TX = state.dims
    ntiles = TY * TX
    tile_lin = ty_t.long() * TX + tx_t.long()
    enc = torch.arange(ty_t.shape[0], dtype=torch.int64)
    flat = [getattr(state, f).reshape(-1).clone() for f in FIELDS]
    placed = ~live
    for k in range(cap):
        base = k * ntiles
        can = ~placed & (flat[5][base + tile_lin] < 0)
        claim = torch.full((ntiles + 1,), 2 ** 31 - 1, dtype=torch.int64)
        claim.scatter_reduce_(0, torch.where(can, tile_lin, ntiles),
                              torch.where(can, enc, 2 ** 31 - 1), "amin")
        won = can & (claim[tile_lin] == enc)
        for i in range(6):
            flat[i][base + tile_lin[won]] = fields[i][won]
        placed = placed | won
    return [f.view(cap, TY, TX) for f in flat], placed & live


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sync_free_helpers_equal_the_forms_they_replace(seed):
    g = torch.Generator().manual_seed(seed)
    for n, p, size in ((1000, 0.05, 30), (1000, 0.01, 64), (50, 0.9, 8),
                       (7, 0.0, 4)):
        mask = torch.rand(n, generator=g) < p
        assert torch.equal(tt._nonzero_padded(mask, size, n),
                           _nonzero_reference(mask, size, n))
    _, tc = cfgs(tile_cap=3)
    pos, rad, prev = scene(300, seed)
    st = tt.init_tiles(tc, pos, rad, previous_positions=prev)
    m = 80
    rng = np.random.default_rng(seed)
    ty = torch.as_tensor(rng.integers(1, 31, m), dtype=torch.int32)
    tx = torch.as_tensor(rng.integers(1, 31, m), dtype=torch.int32)
    ty[:20] = 7  # crowd one row: claims collide and some lose
    tx[:20] = torch.as_tensor(rng.integers(3, 6, 20), dtype=torch.int32)
    fields = (torch.as_tensor(rng.uniform(0, 64, m), dtype=torch.float32),
              torch.as_tensor(rng.uniform(0, 64, m), dtype=torch.float32),
              torch.as_tensor(rng.uniform(0, 64, m), dtype=torch.float32),
              torch.as_tensor(rng.uniform(0, 64, m), dtype=torch.float32),
              torch.full((m,), 0.5),
              torch.arange(1000, 1000 + m, dtype=torch.int32))
    live = torch.as_tensor(rng.uniform(size=m) < 0.8)
    got, placed = tt._insert_compacted(st, ty, tx, fields, live)
    want, wplaced = _insert_reference(st, ty, tx, fields, live)
    assert torch.equal(placed, wplaced) and not bool(placed.all())
    for f, w in zip(FIELDS, want):
        assert torch.equal(getattr(got, f), w), f
    idx = torch.as_tensor(rng.integers(0, st.pid.numel(), m))
    ok = torch.as_tensor(rng.uniform(size=m) < 0.5)
    ref = st.pid.reshape(-1).clone()
    ref[idx[ok]] = -1
    assert torch.equal(tt.vacate(st, idx, ok).pid.reshape(-1), ref)
