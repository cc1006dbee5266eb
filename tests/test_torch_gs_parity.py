"""The port's parity-space Gauss-Seidel pipeline (gpu_physics_engine_torch/
ops/gs_parity.py: gs_layout "par", and the "mx"/"dec" solve layouts) on the
CPU, where the kernel wrappers run their plain versions.

  * The relayout: the index convention sub[p, k, si, sj] = full[k, 2*si +
    pa + o, 2*sj + pb + o] for the mx/par (o = 0) and dec (o = -1) origins,
    the round trip, and the JAX package's ``to_parity`` on the same state
    (its pad cells differ by design; the shared cells are equal).  The
    JAX package's full-space state crosses over as numpy (``from_numpy``)
    and comes back bit for bit.
  * Against the port's flat path, which tests/test_torch_gs.py holds
    bit-equal to the JAX package and the scalar model: the parity
    relocate, the rank tables, the par/mx/dec solves, the par step under
    every gs_par_fused / gs_fuse_integrate setting, and the par engine over
    several windows and a sweep.  All bit-equal.
  * The JAX ``gs_parity_tile_step`` (2 steps, gs_par_fused=True,
    gs_fuse_integrate=True, K = 2; its relocate and solve stages compiled
    once each, run with the mouse released and pressed): pids and
    counters exact, and positions bit-equal with the mouse released.
    With the mouse pressed within 1e-4: one particle's mouse term rounds
    one ulp apart in the compiled JAX solve (the port's Verlet equals the
    JAX function run op by op, tests/test_torch_array.py; ROADMAP.md
    section 3), and the contact sweep carries it on.

The scenes are tests/test_gs_parity.py's scale: cap 2, K 3 (K 2 for the
JAX program), 64 particles in a 16 x 8 world, so that interpret-mode
Pallas compiles stay short.  The CUDA kernels are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu import SimConfig as JConfig
from gpu_physics_engine_tpu.core.state import StepParams as JParams
from gpu_physics_engine_tpu.ops import gs_parity as jgp
from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_torch import SimConfig as TConfig
from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.core.tiled_engine import TiledEngine as TEngine
from gpu_physics_engine_torch.ops import gs_kernels as gk
from gpu_physics_engine_torch.ops import gs_parity as gp
from gpu_physics_engine_torch.ops import gs_tiled as gt
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk

STATE = tt.FIELDS + ("num_active", "overflow_count")


def dense_cfgs(**kw):
    """tests/test_gs_parity.py's _dense_cfg for both packages; the port's
    kernel route is "auto" (plain versions on the CPU)."""
    base = dict(max_particles=64, initial_particles=64, world_width=16.0,
                world_height=8.0, initial_radius=0.5, pipeline="tiled",
                tiled_solver="gs", tile_multiplier=2.2, tile_cap=2,
                max_occupancy=3, tiled_match="flip")
    base.update(kw)
    jkw = dict(base, tiled_collide="pallas", tiled_relocate="pallas")
    return JConfig(**jkw), TConfig(**base)


def dense_scene(n=64, seed=0, w=16.0, h=8.0):
    """One particle per cell on a jittered grid (tests/test_gs_parity.py
    _init): no tile ever holds more than cap 2 at init."""
    rng = np.random.default_rng(seed)
    t = 1.1
    cols = int((w - 2.0) / t)
    cy, cx = np.divmod(np.arange(n), cols)
    pos = np.stack([1.0 + cx * t + rng.uniform(0.1, t - 0.1, n),
                    1.0 + cy * t + rng.uniform(0.1, t - 0.1, n)], -1)
    pos = np.clip(pos, 0.6, [w - 0.6, h - 0.6]).astype(np.float32)
    return pos, np.full(n, 0.5, np.float32)


def jammed_scene(n=60, seed=3, w=16.0, h=8.0):
    """A cluster whose cells hold more than K = 3 occupants (the clamp),
    radii 0.3-0.5 with the tile geometry's r_max."""
    rng = np.random.default_rng(seed)
    pos = np.clip(np.array([w / 2, h / 2]) + rng.normal(0.0, 1.6, (n, 2)),
                  0.6, [w - 0.6, h - 0.6]).astype(np.float32)
    rad = rng.uniform(0.3, 0.5, n).astype(np.float32)
    rad[0] = 0.5
    return pos, rad


def tstate(cfg, pos, rad, prev=None):
    return tt.init_tiles(cfg, pos, rad, previous_positions=prev)


def assert_states_equal(a, b, fields=STATE):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# the relayout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("origin", [0, -1])
def test_relayout_index_convention_and_round_trip(origin):
    TY, TX, C = 9, 7, 3
    geo = gp.ParityGeometry(TY, TX, origin)
    assert (geo.DY, geo.DX) == ((TY - origin + 1) // 2,
                                (TX - origin + 1) // 2)
    full = torch.arange(C * TY * TX, dtype=torch.int32).view(C, TY, TX)
    sub = gp.to_parity(full, geo, -7)
    assert sub.shape == (4, C, geo.DY, geo.DX)
    seen = 0
    for p, (pa, pb) in enumerate(gp.PARS):
        for si in range(geo.DY):
            for sj in range(geo.DX):
                ty, tx = 2 * si + pa + origin, 2 * sj + pb + origin
                got = sub[p, :, si, sj]
                if 0 <= ty < TY and 0 <= tx < TX:
                    assert torch.equal(got, full[:, ty, tx])
                    seen += 1
                else:  # pad cell
                    assert (got == -7).all()
    assert seen == TY * TX  # every tile exactly once
    assert torch.equal(gp.from_parity(sub, geo), full)
    # a color's cells (color = 1 + ((tx-1)&1) + 2*((ty-1)&1)) are exactly
    # one sub-grid's in-grid cells
    for p, (pa, pb) in enumerate(gp.PARS):
        colors = {1 + ((2 * sj + pb + origin - 1) & 1)
                  + 2 * ((2 * si + pa + origin - 1) & 1)
                  for si in range(geo.DY) for sj in range(geo.DX)}
        assert len(colors) == 1


@pytest.mark.parametrize("uniform", [True, False])
def test_state_carried_from_jax_into_parity_space(uniform):
    """The JAX package's full-space TileState, as numpy, crosses into the
    port (``from_numpy``), into parity space and back bit for bit; the
    parity planes equal the JAX package's ``to_parity`` sub-grids on every
    cell the two layouts share (the mx convention, origin 0)."""
    jcfg, tcfg = dense_cfgs(tiled_uniform_radius=uniform)
    pos, rad = jammed_scene()
    if uniform:
        rad = np.full_like(rad, 0.5)
    a = jt.init_tiles(jcfg, pos, rad)
    arrays = {f: np.asarray(getattr(a, f)) for f in STATE}
    b = tt.from_numpy(arrays)
    ps = gp.to_parity_state(b, tcfg)
    assert (ps.radius is None) == uniform
    back = tt.to_numpy(gp.from_parity_state(ps, tcfg))
    for f in STATE:
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)
    subs, _, _ = jgp.to_parity(a, jcfg)
    DY, DX = ps.geo.DY, ps.geo.DX
    names = {"x": "x", "y": "y", "px": "px", "py": "py", "pid": "pid"}
    if not uniform:
        names["radius"] = "r"
    for f, jf in names.items():
        for p, par in enumerate(gp.PARS):
            want = np.asarray(subs[jf][par])[:, :DY, :DX]
            np.testing.assert_array_equal(getattr(ps, f)[p].numpy(), want,
                                          err_msg=f"{f} {par}")


# ---------------------------------------------------------------------------
# the parity kernels' plain versions against the flat path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("match", ["flip", "flip2", "greedy"])
def test_relocate_parity_matches_flat_pull(match):
    """K2-par (plain on the CPU) moves storage as the flat pull relocate
    does, deferrals included: a jammed cluster kicked ~0.8 tile, cap 2."""
    _, tcfg = dense_cfgs(tiled_match=match, tiled_uniform_radius=True)
    pos, rad = jammed_scene()
    st = tstate(tcfg, pos, np.full_like(rad, 0.5))
    st = st.replace(x=torch.where(st.pid >= 0,
                                  torch.clamp(st.x + 0.88, 0.0, 16.0), st.x))
    flat, defer = tk.relocate_pull_plain(st, tcfg)
    ps, pdefer = gp.relocate_par_plain(gp.to_parity_state(st, tcfg), tcfg)
    assert ps.radius is None  # uniform: no radius plane moves
    assert_states_equal(flat, gp.from_parity_state(ps, tcfg))
    assert int(pdefer.sum()) == int(defer.sum()) > 0
    assert not torch.equal(flat.pid, st.pid)
    assert torch.equal(gp.relocate_par(gp.to_parity_state(st, tcfg),
                                       tcfg).pid, ps.pid)


def test_rank_parity_is_the_masked_flat_rank():
    """K5-par's tables, relayouted back, are K5's on interior cells and the
    fill (src -1, rpid BIGPID, rrad 0, count 0) on the border."""
    _, tcfg = dense_cfgs()
    pos, rad = jammed_scene()
    st = tstate(tcfg, pos, rad)
    flat = gk.rank(st, tcfg)
    par = gp.rank_par(gp.to_parity_state(st, tcfg), tcfg)
    _, TY, TX = st.dims
    geo = gp.ParityGeometry(TY, TX)
    inner = torch.zeros((TY, TX), dtype=torch.bool)
    inner[1:-1, 1:-1] = True
    fills = (-1, gt.BIGPID, 0.0)
    for q, (f, p, fill) in enumerate(zip(flat[:3], par[:3], fills)):
        back = gp.from_parity(p, geo)
        assert torch.equal(back[:, inner], f[:, inner]), q
        assert (back[:, ~inner] == fill).all(), q
    count = gp.from_parity(par[3][:, None], geo)[0]
    assert torch.equal(count[inner], flat[3][inner])
    assert int(torch.clamp(count - 3, min=0).sum()) > 0  # the clamp runs


@pytest.mark.parametrize("layout", ["par", "mx", "dec"])
def test_solve_layouts_match_flat_solve(layout):
    """One solve in each layout (K5 or K5-par, then K6-par on the layout's
    sub-grids) is bit-equal to the flat solve, clamp overflow included."""
    _, tcfg = dense_cfgs(tiled_uniform_radius=False)
    pos, rad = jammed_scene()
    st = tstate(tcfg, pos, rad)
    want = gk.gs_solve_flat(st, tcfg)
    got = gp.gs_solve_layout(st, tcfg.replace(gs_layout=layout))
    assert_states_equal(want, got, ("x", "y", "overflow_count"))
    assert int(got.overflow_count) > 0
    assert not torch.equal(got.x, st.x)
    assert gp.LAUNCHES == dict.fromkeys(gp.LAUNCHES, 0)  # CPU: no kernel


@pytest.mark.parametrize("fused, fuse_int", [(None, None), (True, None),
                                             (False, True), (True, False)])
def test_par_step_matches_flat_step(fused, fuse_int):
    """The par step (K2-par, K5-par, K6-par, then the Verlet tail or the
    plain integrate) equals the flat GS step bit for bit, whatever
    gs_par_fused and gs_fuse_integrate say, mouse pressed."""
    _, tcfg = dense_cfgs(tiled_uniform_radius=True, gravity=(0.0, -9.8))
    pos, rad = dense_scene()
    prev = pos + np.float32(0.05)
    st = tstate(tcfg, pos, rad, prev)
    p = TParams.make(tcfg.dt, mouse=(8.0, 4.0), pressed=True)
    want = tt.tiled_step_fn(st, p, tcfg.replace(gs_layout="flat"))
    cfg = tcfg.replace(gs_layout="par", gs_par_fused=fused,
                       gs_fuse_integrate=fuse_int)
    fuse = fuse_int if fuse_int is not None else bool(fused)  # CPU
    assert gp.fuse_integrate(cfg, st.device) == fuse
    assert_states_equal(want, tt.tiled_step_fn(st, p, cfg))


def test_par_engine_matches_flat_engine():
    """TiledEngine in the par layout (windows in parity space, single steps
    through the facade, the claim sweep in full space) against the flat
    engine: every field bit-equal after each call."""
    _, tcfg = dense_cfgs(tiled_uniform_radius=True, sort_interval_steps=4,
                         gravity=(0.0, -9.8), tile_cap=3)
    pos, rad = jammed_scene(n=48)
    rad = np.full_like(rad, 0.5)
    engines = [TEngine.from_arrays(tcfg.replace(gs_layout=lay), pos, rad,
                                   device="cpu") for lay in ("flat", "par")]
    assert [e._gs_par for e in engines] == [False, True]
    for e in engines:
        e.CHUNK = 2
    for act in ("press", "run6", "step", "release", "run3"):
        for e in engines:
            if act == "press":
                e.press_mouse((8.0, 4.0))
            elif act == "release":
                e.release_mouse()
            elif act == "step":
                e.step()
            else:
                e.run(int(act[3:]))
        assert_states_equal(engines[0].state, engines[1].state)
    assert engines[1]._steps_done == 10 and engines[1].num_particles() == 48
    assert gp.LAUNCHES == dict.fromkeys(gp.LAUNCHES, 0)


def test_par_wrappers_raise_on_unsupported_tensors():
    _, tcfg = dense_cfgs(tiled_uniform_radius=True)
    pos, rad = dense_scene()
    ps = gp.to_parity_state(tstate(tcfg, pos, rad), tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        gp.rank_par_cuda(ps, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        gp.relocate_par_cuda(ps, tcfg)
    src, _, rrad, _ = gp.rank_par(ps, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        gp.colors_par_cuda(ps.x, ps.y, src, rrad, tcfg, ps.geo)
    prm = TParams.make(tcfg.dt).as_tensor("cpu")
    tail = (ps.px, ps.py, ps.pid, prm)
    with pytest.raises(RuntimeError, match="CUDA"):
        gp.colors_par_cuda(ps.x, ps.y, src, rrad, tcfg, ps.geo, tail=tail)
    with pytest.raises(ValueError, match="uniform radius"):
        gp.colors_par(ps.x, ps.y, src, rrad,
                      tcfg.replace(world_shape="circle"), ps.geo, tail=tail)
    meta = ps.replace(x=ps.x.to("meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        gp.rank_par(meta, tcfg)


# ---------------------------------------------------------------------------
# one JAX gs_parity program
# ---------------------------------------------------------------------------

def _jax_par_cfgs():
    """K = 2 and the minloop selection: interpret-mode compiles grow with
    cap x K; the port serves every gs_rank value with its one selection,
    and both launch modes with one plain version.  The fused launch (one
    kernel for the four parities; tests/test_gs_parity.py holds it equal
    to one kernel per parity): its interpret-mode programs lower in about
    two thirds of the time of the per-parity ones."""
    return dense_cfgs(tiled_uniform_radius=True, gs_par_fused=True,
                      gs_fuse_integrate=True, gs_layout="par",
                      max_occupancy=2, gs_rank="minloop")


@functools.lru_cache(maxsize=None)
def _compiled_stages():
    """The JAX package's parity relocate, solve and rank, each compiled as
    a program of its own at XLA:CPU backend optimisation level 0: the
    interpret-mode step compiles superlinearly in its size, so its two
    stages compile in about 60% of the whole step's time (the results are
    the same; the assertions below hold them bit for bit).  The three are
    built together, each first called in a thread of its own on the
    shapes the tests give them: their lowering is Python, but XLA's
    compile releases the interpreter lock, so one program's compile runs
    beside the next one's lowering.  Returns (relocate, solve_parity,
    rank)."""
    opts = {"xla_backend_optimization_level": 0}
    relocate = jax.jit(jgp.relocate_parity, static_argnums=(1, 2, 3, 4, 5),
                       compiler_options=opts)
    solve = jax.jit(
        lambda subs, one, params, config, cap, K, t, gTY, gTX, dt_scale:
        _solve_parity(subs, one, config, cap, K, t, gTY, gTX,
                      integ=(params, dt_scale)),
        static_argnums=tuple(range(3, 10)), compiler_options=opts)
    rank = jax.jit(jgp.rank_parity, static_argnums=tuple(range(2, 8)),
                   compiler_options=opts)

    jcfg, _ = _jax_par_cfgs()
    a, subs, _ = _jax_carry(jcfg, 0.5)
    t, TY, TX = jt.tile_geometry(jcfg)
    cap, K = a.dims[0], jcfg.max_occupancy
    one = jax.numpy.ones((1,), jax.numpy.float32)
    params = JParams.make(jcfg.dt, mouse=(8.0, 4.0), pressed=False)
    with ThreadPoolExecutor(3) as pool:
        warm = [pool.submit(relocate, subs, jcfg, cap, t, TY, TX),
                pool.submit(solve, subs, one, params, jcfg, cap, K, t, TY,
                            TX, 1.0 / jcfg.substeps),
                pool.submit(rank, subs, one, jcfg, cap, K, t, TY, TX)]
        for f in warm:
            jax.block_until_ready(f.result())

    def solve_parity(subs, one, config, cap, K, t, gTY, gTX, integ):
        params, dt_scale = integ
        return solve(subs, one, params, config, cap, K, t, gTY, gTX,
                     dt_scale)
    return relocate, solve_parity, rank


_solve_parity = jgp.solve_parity


def _jax_carry(jcfg, kick):
    """The jammed scene (uniform radius, cap 2) as the JAX package stores
    it, every live x moved by ``kick`` (storage off home, as after a
    relocate), its parity sub-grids, and the same state in the port."""
    pos, rad = jammed_scene()
    a = jt.init_tiles(jcfg, pos, np.full_like(rad, 0.5))
    arrays = {f: np.asarray(getattr(a, f)) for f in STATE}
    live = arrays["pid"] >= 0
    arrays["x"] = np.where(live, np.clip(arrays["x"] + np.float32(kick),
                                         0.0, 16.0), arrays["x"])
    a = dataclasses.replace(a, x=jax.numpy.asarray(arrays["x"]))
    return a, jgp.to_parity(a, jcfg)[0], tt.from_numpy(arrays)


def test_rank_par_matches_jax_rank_parity():
    """K5-par's plain version against the JAX package's ``rank_parity``
    (interpret mode, one kernel per parity) on the jammed scene with its
    storage up to half a tile off home: the tables on every cell the two
    layouts share and the clamp overflow equal."""
    jcfg, tcfg = _jax_par_cfgs()
    a, subs, st = _jax_carry(jcfg, 0.5)
    t, TY, TX = jt.tile_geometry(jcfg)
    K = jcfg.max_occupancy
    rank = _compiled_stages()[2]
    tables, overflow = rank(subs, jax.numpy.ones((1,), jax.numpy.float32),
                            jcfg, a.dims[0], K, t, TY, TX)
    ps = gp.to_parity_state(st, tcfg)
    src, rpid, _, count = gp.rank_par(ps, tcfg)
    DY, DX = ps.geo.DY, ps.geo.DX
    for p, par in enumerate(gp.PARS):
        for name, got, want in (("src", src, tables[par][0]),
                                ("rpid", rpid, tables[par][1])):
            np.testing.assert_array_equal(
                got[p].numpy(), np.asarray(want)[:, :DY, :DX],
                err_msg=f"{name} {par}")
    clamp = int(torch.clamp(count - K, min=0).sum())
    assert clamp == int(overflow) > 0


def test_relocate_mega_plain_matches_jax_relocate_parity():
    """relocate_mega's plain version (K2-par's) against the JAX package's
    ``relocate_parity`` (interpret mode; the JAX ``relocate_mega`` itself
    runs only on its TPU) on the jammed scene kicked 0.6 tile: every field
    on the cells the two layouts share, and the deferrals, equal."""
    from gpu_physics_engine_torch.ops import gs_mega as gm
    jcfg, tcfg = _jax_par_cfgs()
    tcfg = tcfg.replace(gs_relocate_mega=True)
    a, subs, st = _jax_carry(jcfg, 0.66)
    t, TY, TX = jt.tile_geometry(jcfg)
    relocate = _compiled_stages()[0]
    subs2, defer = relocate(subs, jcfg, a.dims[0], t, TY, TX)
    ps = gp.to_parity_state(st, tcfg)
    got, gdefer = gm.relocate_mega_plain(ps, tcfg)
    assert torch.equal(gm.relocate_mega(ps, tcfg).pid, got.pid)
    DY, DX = ps.geo.DY, ps.geo.DX
    for f in ("x", "y", "px", "py", "pid"):
        for p, par in enumerate(gp.PARS):
            np.testing.assert_array_equal(
                getattr(got, f)[p].numpy(),
                np.asarray(subs2[f][par])[:, :DY, :DX], err_msg=f"{f} {par}")
    assert int(gdefer.sum()) == int(defer) > 0
    assert not torch.equal(got.pid, ps.pid)


@functools.lru_cache(maxsize=None)
def _jax_par_steps():
    """The JAX package's gs_parity_tile_step, run for 2 single steps with
    the mouse released and pressed; numpy states keyed by "released" /
    "pressed".  The step runs op by op around its relocate and solve
    stages, which are compiled once each (``_compiled_stages``; the step
    parameters are traced)."""
    jcfg, _ = _jax_par_cfgs()
    pos, rad = dense_scene()
    a = jt.init_tiles(jcfg, pos, rad)
    relocate, solve, _ = _compiled_stages()
    out = {}
    with mock.patch.object(jgp, "relocate_parity", relocate), \
            mock.patch.object(jgp, "solve_parity", solve):
        for mouse, pressed in (("released", False), ("pressed", True)):
            p = JParams.make(jcfg.dt, mouse=(8.0, 4.0), pressed=pressed)
            s = a
            for _ in range(2):
                s = jgp.gs_parity_tile_step(s, p, jcfg, n_steps=1)
            out[mouse] = {f: np.asarray(getattr(s, f)) for f in STATE}
    return out


@pytest.mark.parametrize("mouse", ["released", "pressed", "released-mega",
                                   "pressed-mega"])
def test_par_step_matches_jax_parity_step(mouse):
    """The "-mega" cases run the port with gs_colors_mega and
    gs_relocate_mega on (the fused route: ops/gs_mega) against the same
    JAX result.  That is the JAX package's own answer for those flags off
    its TPU: its gates (gs_parity.py:447-449, :695-697) take the
    sequential branch there, and on the TPU the fused kernels are held
    bit-exact to it (scripts/tpu_probe_gs_mega.py)."""
    mouse, _, mega = mouse.partition("-")
    _, tcfg = _jax_par_cfgs()
    if mega:
        tcfg = tcfg.replace(gs_colors_mega=True, gs_relocate_mega=True)
    pos, rad = dense_scene()
    st = tstate(tcfg, pos, rad)
    p = TParams.make(tcfg.dt, mouse=(8.0, 4.0), pressed=mouse == "pressed")
    got = tt.to_numpy(gp.gs_parity_tile_step(st, p, tcfg, n_steps=2))
    want = _jax_par_steps()[mouse]
    np.testing.assert_array_equal(got["pid"], want["pid"])
    for f in ("num_active", "overflow_count"):
        assert int(got[f]) == int(want[f]), f
    for f in ("x", "y", "px", "py", "radius"):
        if mouse == "released":
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want[f], atol=1e-4, rtol=0,
                                       err_msg=f)
    assert not np.array_equal(got["x"], tt.to_numpy(st)["x"])
