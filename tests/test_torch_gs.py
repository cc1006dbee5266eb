"""The port's Gauss-Seidel path and K3 against the JAX package and the scalar
model, on numpy-seeded scenes (cap <= 4, K <= 6, worlds of 16 x 16).

  * One GS solve (the port's plain formulation ops/gs_tiled.gs_solve, and
    the flat driver ops/gs_kernels.gs_solve_flat, whose K5/K6 wrappers run
    their plain versions on the CPU) must be BIT-equal to the JAX
    package's ``gs_solve`` under jax.jit and to the scalar model
    (tests/reference_model.solve_colored): x, y and overflow_count.
  * The rank tables, resolved to (x, y, r, pid) per rank, equal the JAX
    package's ``_select_occupants`` exactly.
  * The GS engine matches the JAX engine over 8 steps: pid placement and
    counters exact, positions within 1e-4.  One solve is bit-equal, but
    the two packages' ``integrate`` may round differently (XLA:CPU may
    contract its mul+add chains, tests/test_gs_tiled.py:241-251), and
    contact dynamics amplify those ulps over the steps.
  * K3's plain version equals the JAX package's jnp ``collide`` (to
    rsqrt rounding, 1e-6; 1e-5 with the uniform-radius constants).

The JAX functions compile once per config and shape, so the cases of a
test share one config, and they run at cap 2, K 3 (three ordered pairs per
cell; the compile grows with cap x K).  The scalar model needs no compile
and takes the deeper K = 6 at cap 4.  The CUDA kernels are held against
these plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import reference_model as model
from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu.core.state import StepParams as JParams
from gpu_physics_engine_tpu.core.tiled_engine import TiledEngine as JEngine
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_tpu.ops.gs_tiled import (_memberships,
                                                 _select_occupants)
from gpu_physics_engine_tpu.ops.gs_tiled import gs_solve as j_gs_solve
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.ops import gs_kernels as gk
from gpu_physics_engine_torch.ops import gs_tiled as gt
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk
from test_torch_tiled import assert_same, both_states, cfgs, scene

CELL = 1.1  # tile edge = reference cell: tile_multiplier 2.2 x r_max 0.5


def gs_cfgs(n, cap=2, K=3, **kw):
    base = dict(max_particles=n, initial_particles=n, world_width=16.0,
                world_height=16.0, initial_radius=0.5, pipeline="tiled",
                tiled_solver="gs", tile_multiplier=2.2, tile_cap=cap,
                max_occupancy=K, sort_interval_steps=0, mover_capacity=256,
                tiled_collide="jnp", tiled_relocate="jnp")
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def gs_scene(kind, n, seed):
    """"random": radii 0.3-0.5 over the world; "jammed": a dense cluster of
    r = 0.5 whose cells hold more than K occupants."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        pos = rng.uniform(0.6, 15.4, (n, 2)).astype(np.float32)
        rad = rng.uniform(0.3, 0.5, n).astype(np.float32)
        rad[0] = 0.5  # the tile geometry's r_max
    else:
        pos = (np.array([8.0, 8.0]) + rng.normal(0.0, 2.6, (n, 2)))
        pos = np.clip(pos, 0.6, 15.4).astype(np.float32)
        rad = np.full(n, 0.5, np.float32)
    return pos, rad


def assert_at_home(st, t):
    """The scene packed without spills: storage tile == home cell, the
    premise of the scalar model comparison."""
    d = tt.to_numpy(st)
    occ = d["pid"] >= 0
    _, ty, tx = np.nonzero(occ)
    assert (ty == (d["y"][occ] // np.float32(t)).astype(int) + 1).all()
    assert (tx == (d["x"][occ] // np.float32(t)).astype(int) + 1).all()


SOLVES = {"gs_tiled": gt.gs_solve, "flat": gk.gs_solve_flat}


@functools.lru_cache(maxsize=None)
def _j_solve(config):
    return jax.jit(lambda s: j_gs_solve(s, config))


# ---------------------------------------------------------------------------
# (a) one solve against the JAX package, (b) against the scalar model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "jammed"])
@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_gs_solve_bitmatches_jax(kind, solve):
    jcfg, tcfg = gs_cfgs(120)
    pos, rad = gs_scene(kind, 120, seed=3)
    a, b = both_states(jcfg, tcfg, pos, rad)
    want = _j_solve(jcfg)(a)
    got = SOLVES[solve](b, tcfg)
    assert_same(want, got)  # x, y bit-equal; overflow_count exact
    if kind == "jammed":
        assert int(got.overflow_count) > 0  # the clamp ran
    assert gk.LAUNCHES == {"gs_rank": 0, "gs_color": 0}  # CPU: no kernel


@pytest.mark.parametrize("kind, K, n, seed", [("random", 6, 150, 5),
                                              ("jammed", 3, 60, 0)])
@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_gs_solve_bitmatches_scalar_model(kind, K, n, seed, solve):
    _, tcfg = gs_cfgs(n, cap=4, K=K)
    pos, rad = gs_scene(kind, n, seed)
    st = tt.init_tiles(tcfg, pos, rad)
    assert int(st.overflow_count) == 0
    assert_at_home(st, CELL)
    out = SOLVES[solve](st, tcfg)
    pid, got, _, _ = tt.export_particles(out)
    np.testing.assert_array_equal(pid, np.arange(n))
    cells, objs = model.build_cell_ids(pos, rad, CELL)
    sc, so = model.sort_map(cells, objs)
    want = model.solve_colored(pos, rad, sc, so, stiffness=0.6,
                               max_occupancy=K)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    if kind == "jammed":
        assert int(out.overflow_count) > 0  # the clamp ran


def test_sqrt_rn_is_the_ieee_square_root():
    """The sweep's square root is the correctly rounded one (numpy's, the
    scalar model's, __fsqrt_rn's), which torch.sqrt of an f32 CPU tensor
    is not on every CPU."""
    rng = np.random.default_rng(19)
    a = np.concatenate([rng.uniform(0.0, 4.0, 1 << 20),
                        rng.uniform(0.0, 1e-6, 1 << 12),
                        [0.0, 1e-38, 3.4e38]]).astype(np.float32)
    np.testing.assert_array_equal(gt.sqrt_rn(torch.from_numpy(a)).numpy(),
                                  np.sqrt(a))


# ---------------------------------------------------------------------------
# (c) the plain rank tables against _select_occupants
# ---------------------------------------------------------------------------

def test_rank_tables_match_select_occupants():
    jcfg, tcfg = gs_cfgs(120)
    pos, rad = gs_scene("jammed", 120, seed=7)
    a, b = both_states(jcfg, tcfg, pos, rad)
    t, TY, TX = tt.tile_geometry(tcfg)
    K = tcfg.max_occupancy
    ox, oy, orad, opid, over = jax.jit(
        lambda s: _select_occupants(s, _memberships(s, t), K))(a)
    src, rpid, rrad, count = gk.rank_plain(b, tcfg)
    assert src.shape == (K, TY, TX) and count.shape == (TY, TX)
    ty = torch.arange(TY).view(1, TY, 1)
    tx = torch.arange(TX).view(1, 1, TX)
    idx, valid = gt.source_index(src, tcfg.tile_cap, TY, TX, ty, tx)
    for q in range(K):
        np.testing.assert_array_equal(
            gt.gather(b.x, idx, valid)[q].numpy(), np.asarray(ox[q]))
        np.testing.assert_array_equal(
            gt.gather(b.y, idx, valid)[q].numpy(), np.asarray(oy[q]))
        np.testing.assert_array_equal(rrad[q].numpy(), np.asarray(orad[q]))
        np.testing.assert_array_equal(rpid[q].numpy(), np.asarray(opid[q]))
    np.testing.assert_array_equal((src >= 0).numpy(),
                                  (rpid < gt.BIGPID).numpy())
    overflow = int(torch.clamp(count - K, min=0).sum())
    assert overflow == int(over) > 0


@pytest.mark.parametrize("gs_rank", ["minloop", "net"])
def test_every_gs_rank_runs_the_same_step(gs_rank):
    """The TPU's selection methods all pick the K smallest unique pids, so
    the port serves every gs_rank value with its one selection: the step
    is the same as under "auto"."""
    _, tcfg = gs_cfgs(120, tiled_collide="auto", gs_rank=gs_rank)
    pos, rad = gs_scene("jammed", 120, seed=7)
    st = tt.init_tiles(tcfg, pos, rad)
    p = TParams.make(tcfg.dt)
    got = tt.tiled_step_fn(st, p, tcfg)
    want = tt.tiled_step_fn(st, p, tcfg.replace(gs_rank="auto"))
    for f in tt.FIELDS + ("overflow_count",):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# (d) the GS engine against the JAX engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_engine_run():
    """The JAX GS engine (jnp solve, claim relocate) after 8 steps, as
    numpy; computed once for every route of the port that is compared."""
    jcfg, _ = gs_cfgs(100, gravity=(0.0, -20.0))
    pos, rad = gs_scene("random", 100, seed=11)
    e = JEngine.from_arrays(jcfg, pos, rad)
    e.press_mouse((8.0, 4.0))
    e.run(8)
    st = {f: np.asarray(getattr(e.state, f)) for f in
          tt.FIELDS + ("num_active", "overflow_count")}
    return st, e.watchdog_events


@pytest.mark.parametrize("collide", ["jnp", "auto"])
def test_gs_engine_matches_jax_engine(collide):
    """tiled_collide="jnp" runs ops/gs_tiled.gs_solve, "auto" the flat
    driver through the K5/K6 wrappers (plain versions on the CPU)."""
    _, tcfg = gs_cfgs(100, gravity=(0.0, -20.0), tiled_collide=collide)
    pos, rad = gs_scene("random", 100, seed=11)
    e = TEngine.from_arrays(tcfg, pos, rad, device="cpu")
    e.press_mouse((8.0, 4.0))
    e.run(8)
    want, wd = _jax_engine_run()
    got = tt.to_numpy(e.state)
    np.testing.assert_array_equal(got["pid"], want["pid"])
    for f in ("num_active", "overflow_count"):
        assert int(got[f]) == int(want[f]), f
    for f in ("x", "y", "px", "py", "radius"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-4, rtol=0,
                                   err_msg=f)
    assert e.watchdog_events == wd
    assert e.num_particles() == 100
    assert gk.LAUNCHES == {"gs_rank": 0, "gs_color": 0}


def test_gs_step_relocates_then_solves_then_integrates():
    """The GS branch of the step: the relocate (K2's plain version under
    "auto"), the flat solve, then the plain integrate, exactly."""
    _, tcfg = gs_cfgs(120, cap=4, K=4, tiled_collide="auto",
                      tiled_relocate="auto", gravity=(0.0, -9.8))
    pos, rad = gs_scene("random", 120, seed=13)
    st = tt.init_tiles(tcfg, pos, rad)
    p = TParams.make(tcfg.dt, mouse=(3.0, 3.0), pressed=True)
    want = tk.relocate_pull(st, tcfg)
    want = tt.integrate(gk.gs_solve_flat(want, tcfg), p, tcfg)
    got = tt.tiled_step_fn(st, p, tcfg, do_relocate=False)  # GS ignores it
    for f in tt.FIELDS + ("overflow_count",):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("sweep", ["relocate", "rebuild"])
def test_sweep_study_follows_the_engine_schedule(sweep):
    """utils/profiling.sweep_windows drives engine.sweep() itself on an
    engine whose own cadence is off; the states equal those of the
    engine's own cadence (sweeps before steps 4 and 8 of 12)."""
    from gpu_physics_engine_torch.utils.profiling import sweep_windows
    pos, rad = gs_scene("random", 100, seed=11)
    engines = []
    for interval in (4, 13):
        _, tcfg = gs_cfgs(100, gravity=(0.0, -20.0), tiled_sweep=sweep,
                          sort_interval_steps=interval,
                          tiled_watchdog=False)
        engines.append(TEngine.from_arrays(tcfg, pos, rad, device="cpu"))
    engines[0].run(12)
    rows = list(sweep_windows(engines[1], steps=12, every=6, interval=4))
    assert [r["step"] for r in rows] == [6, 12]
    assert [len(r["sweep_ms"]) for r in rows] == [1, 1]
    assert rows[-1]["num_active"] == 100
    for f in tt.FIELDS + ("overflow_count",):
        assert torch.equal(getattr(engines[0].state, f),
                           getattr(engines[1].state, f)), f


# ---------------------------------------------------------------------------
# (e) K3: collide only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("uniform", [False, True])
def test_k3_plain_matches_jax_collide(uniform):
    jcfg, tcfg = cfgs(tile_cap=4, initial_particles=300,
                      tiled_uniform_radius=uniform)
    pos, rad, _ = scene(300, 41, rmin=0.25)
    if uniform:
        rad = np.full_like(rad, 0.5)
    a, b = both_states(jcfg, tcfg, pos, rad)
    assert_same(jt.collide(a, jcfg), tk.collide(b, tcfg),
                atol=1e-5 if uniform else 1e-6)
    assert tk.LAUNCHES["collide"] == 0


def test_unfused_step_is_k3_then_integrate():
    """tiled_fuse_integrate=False: K3 (plain on the CPU) and then the plain
    integrate; equal to the JAX package's collide + integrate."""
    jcfg, tcfg = cfgs(tile_cap=4, initial_particles=300,
                      tiled_fuse_integrate=False, gravity=(0.0, -9.8))
    pos, rad, prev = scene(300, 41, rmin=0.25, vel=0.1)
    a, b = both_states(jcfg, tcfg, pos, rad, prev)
    pa = JParams.make(0.02, mouse=(30.0, 20.0), pressed=True)
    pb = TParams.make(0.02, mouse=(30.0, 20.0), pressed=True)
    want = jt.integrate(jt.collide(a, jcfg), pa, jcfg)
    got = tt.tiled_step_fn(b, pb, tcfg, do_relocate=False)
    assert_same(want, got, atol=1e-5)
    # the engine's unfused step equals the "jnp" step exactly: same sweep
    engines = [TEngine.from_arrays(tcfg.replace(tiled_relocate="jnp",
                                                tiled_collide=c),
                                   pos, rad, device="cpu")
               for c in ("auto", "jnp")]
    for e in engines:
        e.run(3)
    for f in tt.FIELDS:
        assert torch.equal(getattr(engines[0].state, f),
                           getattr(engines[1].state, f)), f


# ---------------------------------------------------------------------------
# (f) what is not ported yet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(gs_layout="dec"), dict(gs_layout="mx"), dict(gs_layout="par"),
    dict(gs_colors_mega=True), dict(gs_relocate_mega=True)])
def test_unported_gs_options_raise(kw):
    """The mega kernels (K11) are not ported and raise; the dec, mx and par
    layouts are (ops/gs_parity) and step as the flat layout does."""
    _, tcfg = gs_cfgs(30, tiled_collide="auto", tiled_relocate="auto", **kw)
    pos, rad = gs_scene("random", 30, seed=17)
    st = tt.init_tiles(tcfg, pos, rad)
    p = TParams.make(tcfg.dt)
    if "gs_layout" in kw:
        TEngine.from_arrays(tcfg, pos, rad, device="cpu")
        want = tt.tiled_step_fn(st, p, tcfg.replace(gs_layout="flat"))
        got = tt.tiled_step_fn(st, p, tcfg)
        for f in tt.FIELDS + ("overflow_count",):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        return
    with pytest.raises(NotImplementedError, match="K11"):
        TEngine.from_arrays(tcfg, pos, rad, device="cpu")
    with pytest.raises(NotImplementedError, match="K11"):
        tt.tiled_step_fn(st, p, tcfg)
    # every layout runs without the mega flags
    for layout in ("flat", "auto", "dec", "mx", "par"):
        c = tcfg.replace(gs_layout=layout, gs_colors_mega=False,
                         gs_relocate_mega=False)
        tt.tiled_step_fn(st, TParams.make(c.dt), c)


def test_gs_wrappers_raise_on_unsupported_tensors():
    _, tcfg = gs_cfgs(30)
    pos, rad = gs_scene("random", 30, seed=17)
    st = tt.init_tiles(tcfg, pos, rad)
    src, _, rrad, _ = gk.rank(st, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        gk.rank_cuda(st, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        gk.color_cuda_(st.x.clone(), st.y.clone(), src, rrad, tcfg, 1)
    meta = st.replace(**{f: getattr(st, f).to("meta") for f in tt.FIELDS})
    with pytest.raises(RuntimeError, match="CUDA"):
        gk.rank(meta, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.collide(meta, tcfg)
