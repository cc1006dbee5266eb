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
  * One JAX ``gs_parity_tile_step`` program (2 steps, gs_par_fused=False,
    gs_fuse_integrate=True, K = 2; one compile, called with the mouse
    released and pressed): pids and counters exact, and positions
    bit-equal with the mouse released.  With the mouse pressed within
    1e-4: the mouse term takes a square root, which torch.sqrt on some
    CPUs rounds one ulp from XLA's (ROADMAP.md section 3), and the contact
    sweep carries it on.

The scenes are tests/test_gs_parity.py's scale: cap 2, K 3 (K 2 for the
JAX program), 64 particles in a 16 x 8 world, so that interpret-mode
Pallas compiles stay short.  The CUDA kernels are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

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

@pytest.mark.parametrize("match", ["flip", "greedy"])
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
        gp.color_par_cuda_(ps.x, ps.y, src, rrad, tcfg, ps.geo, 1)
    prm = TParams.make(tcfg.dt).as_tensor("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        gp.verlet_cuda_(ps.x, ps.y, ps.px, ps.py, ps.pid, prm, tcfg)
    with pytest.raises(ValueError, match="uniform radius"):
        gp.verlet_(ps.x, ps.y, ps.px, ps.py, ps.pid, prm,
                   tcfg.replace(world_shape="circle"))
    meta = ps.replace(x=ps.x.to("meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        gp.rank_par(meta, tcfg)


# ---------------------------------------------------------------------------
# one JAX gs_parity program
# ---------------------------------------------------------------------------

def _jax_par_cfgs():
    """K = 2 and the minloop selection: the JAX parity program compiles in
    about 60 s on the test machine this way, against about 85 s at K = 3
    with the selection network (interpret-mode compiles grow with cap x K);
    the port serves every gs_rank value with its one selection."""
    return dense_cfgs(tiled_uniform_radius=True, gs_par_fused=False,
                      gs_fuse_integrate=True, gs_layout="par",
                      max_occupancy=2, gs_rank="minloop")


@functools.lru_cache(maxsize=None)
def _jax_par_steps():
    """The JAX package's gs_parity_tile_step, 2 steps per call, compiled
    once (the step parameters are traced) and run with the mouse released
    and pressed; numpy states keyed by "released"/"pressed"."""
    jcfg, _ = _jax_par_cfgs()
    pos, rad = dense_scene()
    a = jt.init_tiles(jcfg, pos, rad)
    params = {mouse: JParams.make(jcfg.dt, mouse=(8.0, 4.0), pressed=pressed)
              for mouse, pressed in (("released", False), ("pressed", True))}
    fn = jax.jit(lambda s, p: jgp.gs_parity_tile_step(s, p, jcfg, n_steps=2))
    return {mouse: {f: np.asarray(getattr(fn(a, p), f)) for f in STATE}
            for mouse, p in params.items()}


@pytest.mark.parametrize("mouse", ["released", "pressed"])
def test_par_step_matches_jax_parity_step(mouse):
    _, tcfg = _jax_par_cfgs()
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
