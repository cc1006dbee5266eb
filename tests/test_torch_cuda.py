"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only, so it also runs where jax is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repository's conftest imports jax).  Without a CUDA device every test here
skips.  K1 and K3 equal their plain versions bit for bit at every cap
the engine can reach, in box and circle worlds, on grids smaller than one
shared-memory region and not a multiple of it; K2 and K2-par bit for bit
up to cap 32 and on a ragged grid, K5 and K5-par (the rank's window)
bit for bit up to cap 32 with K 16, on a ragged grid, at both parity
origins, K6's window (colors 1..c for each c, with and without the Verlet
tail) bit for bit on the flat and the parity layouts, up to cap 32, on a
grid smaller than one window and one several windows wide; the par engine
equals the flat engine.  colors_mega bit for bit and equal to the par
route's K6-par launch; relocate_mega and K4
(K2's window) bit for bit, relocate_mega equal to K2-par, also at cap 32
and on a ragged grid.  K12 (the radix sort's rank/histogram pass), the
digit offsets and the scatter bit for bit on all four passes at 1, 3 and
1,075 blocks, the radix sort equals torch.sort(stable=True), and the
array Engine's radix run on the card equals its lax run bit for bit.  The
device compositor's frames on the card (full space and parity space)
within one u8 of the CPU's, and render_run equal to run() there.  The
big-particle overlay's coupling pass on the card equals the CPU's bit for
bit, and the spawn engine's hybrid step on the card follows the CPU's.
The fast solver's engine (both packings), ``rebuild_band`` and
``stale_per_row`` on the card equal the CPU's bit for bit, and a tiled
checkpoint with an overlay loads on the card as on the CPU.
"""

import numpy as np
import pytest
import torch

from gpu_physics_engine_torch import SimConfig, StepParams
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA device")]

FIELDS = tt.FIELDS


def _scene(match="greedy", hysteresis=0.0, cap=4, uniform=True, n=500,
           jitter=1.0, **kw):
    cfg = SimConfig(max_particles=n, initial_particles=n, world_width=64.0,
                    world_height=64.0, pipeline="tiled", tile_cap=cap,
                    tiled_match=match, tiled_hysteresis=hysteresis,
                    tiled_uniform_radius=uniform, **kw)
    rng = np.random.default_rng(cap)
    pos = rng.uniform(0.6, 63.4, (n, 2)).astype(np.float32)
    rad = (np.full(n, 0.5, np.float32) if uniform
           else rng.uniform(0.3, 0.5, n).astype(np.float32))
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    st = tt.init_tiles(cfg, pos, rad, previous_positions=prev, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(cap)
    occ = st.pid >= 0
    d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 2 * jitter
    return cfg, st.replace(x=torch.where(occ, st.x + d, st.x))


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("world", ["box", "circle"])
def test_k1_cuda_matches_plain(uniform, world):
    cfg, st = _scene(uniform=uniform, jitter=0.0, world_shape=world,
                     gravity=(0.0, -9.8))
    prm = StepParams.make(0.02, mouse=(30.0, 20.0), pressed=True).as_tensor(
        "cuda")
    n0 = tk.LAUNCHES["collide_integrate"]
    a = tk.collide_integrate(st, prm, cfg)
    b = tk.collide_integrate_plain(st, prm, cfg)
    c = tk.collide_integrate(st, prm, cfg)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["collide_integrate"] == n0 + 2
    for f in ("x", "y", "px", "py"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f  # deterministic
    assert torch.equal(a.pid, b.pid)


@pytest.mark.parametrize("match", ["flip", "flip2", "greedy"])
@pytest.mark.parametrize("hysteresis", [0.0, -1.0])
@pytest.mark.parametrize("cap", [4, 8, 32])
@pytest.mark.parametrize("shape", ["square", "ragged"])
def test_k2_cuda_matches_plain(match, hysteresis, cap, shape):
    """K2 on its shared-memory window: bit-equal to the plain version and
    on repeat, nothing lost, up to cap 32 (the largest window), on a 64 x 64
    world and on a grid whose TY and TX are no multiples of the region
    ("ragged": 21 x 39 at cap 6)."""
    if shape == "square":
        cfg, st = _scene(match=match, hysteresis=hysteresis, cap=cap)
    else:
        cfg, st = _window_scene(cap, True, "box", 80.0, 33.0, 3)
        cfg = cfg.replace(tiled_match=match, tiled_hysteresis=hysteresis)
        g = torch.Generator(device="cuda").manual_seed(cap + 1)
        d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 1.6
        st = st.replace(x=torch.where(st.pid >= 0, st.x + d, st.x))
    n0 = tk.LAUNCHES["relocate_pull"]
    a, da = tk.relocate_pull_cuda(st, cfg)
    b, db = tk.relocate_pull_plain(st, cfg)
    c, dc = tk.relocate_pull_cuda(st, cfg)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["relocate_pull"] == n0 + 2
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    assert torch.equal(da, db) and torch.equal(da, dc)
    assert int((a.pid >= 0).sum()) == int((st.pid >= 0).sum())  # none lost
    assert not torch.equal(a.pid, st.pid)  # particles moved


@pytest.mark.parametrize("uniform", [False, True])
def test_k3_cuda_matches_plain(uniform):
    cfg, st = _scene(uniform=uniform, jitter=0.3)
    n0 = tk.LAUNCHES["collide"]
    a = tk.collide(st, cfg)
    b = tk.collide_plain(st, cfg)
    c = tk.collide(st, cfg)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["collide"] == n0 + 2
    for f in ("x", "y"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    for f in ("px", "py", "radius", "pid"):
        assert torch.equal(getattr(a, f), getattr(st, f)), f


def _window_scene(cap, uniform, world, width, height, cut):
    """A scene at ``cap`` in a ``width`` x ``height`` world, jittered off
    home; ``cut`` drops that many of the empty rows above the world, so TY
    is no multiple of 8 (one empty row stays, as the ring).  Density 0.6
    per unit area, less at small caps (the tiles must hold the scene)."""
    n = int(width * height * min(0.6, 0.12 * cap))
    cfg = SimConfig(max_particles=n, initial_particles=n, world_width=width,
                    world_height=height, pipeline="tiled", tile_cap=cap,
                    tiled_uniform_radius=uniform, world_shape=world,
                    gravity=(0.0, -9.8))
    rng = np.random.default_rng(cap)
    pos = np.stack([rng.uniform(0.6, width - 0.6, n),
                    rng.uniform(0.6, height - 0.6, n)], -1).astype(np.float32)
    rad = (np.full(n, 0.5, np.float32) if uniform
           else rng.uniform(0.3, 0.5, n).astype(np.float32))
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    st = tt.init_tiles(cfg, pos, rad, previous_positions=prev, device="cuda")
    if cut:
        rows = (st.pid >= 0).any(0).any(1).nonzero().max().item() + 2
        assert st.dims[1] - rows >= cut
        st = st.replace(**{f: getattr(st, f)[:, :st.dims[1] - cut].contiguous()
                           for f in FIELDS})
    g = torch.Generator(device="cuda").manual_seed(cap)
    occ = st.pid >= 0
    d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 0.6
    return cfg, st.replace(x=torch.where(occ, st.x + d, st.x),
                           y=torch.where(occ, st.y - d, st.y))


@pytest.mark.parametrize("cap", [2, 6, 9, 10, 16, 32])
@pytest.mark.parametrize("shape", ["small", "ragged", "wide"])
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("world", ["box", "circle"])
def test_k1_k3_window_matches_plain(cap, shape, uniform, world):
    """K1 and K3 on the shared-memory window: bit-equal to the plain
    versions and on repeat at caps from 2 to kMaxCap (past the tuned rows:
    the watchdog grows cap), on a grid smaller than one 8 x 32 region
    ("small"), one whose TY and TX are no multiples of it ("ragged") and
    one several regions wide ("wide")."""
    width, height, cut = {"small": (12.0, 5.0, 0), "ragged": (80.0, 33.0, 3),
                          "wide": (150.0, 40.0, 0)}[shape]
    cfg, st = _window_scene(cap, uniform, world, width, height, cut)
    prm = StepParams.make(0.02, mouse=(0.3 * width, 0.6 * height),
                          pressed=True).as_tensor("cuda")
    n0 = dict(tk.LAUNCHES)
    runs = ((tk.collide_integrate, lambda: tk.collide_integrate_plain(
        st, prm, cfg), ("x", "y", "px", "py"), "collide_integrate",
             (st, prm, cfg)),
            (tk.collide, lambda: tk.collide_plain(st, cfg), ("x", "y"),
             "collide", (st, cfg)))
    for kern, plain, fields, name, args in runs:
        a, c, b = kern(*args), kern(*args), plain()
        torch.cuda.synchronize()
        assert tk.LAUNCHES[name] == n0[name] + 2
        for f in fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
            assert torch.equal(getattr(a, f), getattr(c, f)), (name, f)
        assert int((a.x != st.x).sum()) > 0


def _gs_scene(cap, K, seed, width=40.0):
    """Mixed radii over a ``width`` x 30 world plus a jammed cluster (cells
    past K), stored up to a third of a tile off home as after the pull
    relocate."""
    from gpu_physics_engine_torch.core.tuned import gs_config
    cfg = gs_config(1500, world_width=width, world_height=30.0,
                    tile_cap=cap, max_occupancy=K)
    rng = np.random.default_rng(seed)
    hi = [width - 0.6, 29.4]
    pos = np.concatenate([rng.uniform(0.6, hi, (1000, 2)),
                          np.clip([width / 2, 15.0]
                                  + rng.normal(0, 2.0, (500, 2)), 0.6,
                                  hi)]).astype(np.float32)
    rad = rng.uniform(0.3, 0.5, 1500).astype(np.float32)
    st = tt.init_tiles(cfg, pos, rad, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    occ = st.pid >= 0
    d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 0.7
    return cfg, st.replace(x=torch.where(occ, st.x + d, st.x),
                           y=torch.where(occ, st.y - d, st.y))


@pytest.mark.parametrize("cap, K", [(4, 8), (6, 12), (2, 3)])
def test_gs_kernels_match_plain(cap, K):
    """K5's rank tables and K6's four colors (one window launch)
    bit-equal to the plain versions, clamp overflow included;
    deterministic on repeat."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    cfg, st = _gs_scene(cap, K, seed=cap)
    n0 = dict(gk.LAUNCHES)
    a, ta = gk.solve_frame(st, cfg, gk.rank, gk.colors)
    b, tb = gk.solve_frame(st, cfg, gk.rank_plain, gk.colors_plain)
    c, tc = gk.solve_frame(st, cfg, gk.rank, gk.colors)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gs_rank"] == n0["gs_rank"] + 2
    assert gk.LAUNCHES["gs_color"] == n0["gs_color"] + 2
    for u, v, w in zip(ta, tb, tc):
        assert torch.equal(u, v) and torch.equal(u, w)
    for f in ("x", "y", "overflow_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    assert int(a.overflow_count) > 0  # the jammed cluster clamps
    assert int((a.x != st.x).sum()) > 0


@pytest.mark.parametrize("cap, K", [(2, 3), (4, 8), (32, 16)])
@pytest.mark.parametrize("width", [40.0, 150.0])
@pytest.mark.parametrize("uniform", [False, True])
def test_rank_window_matches_plain(cap, K, width, uniform):
    """K5 and K5-par on the rank's shared-memory window: the tables
    bit-equal to the plain versions and on repeat, up to cap 32 with K 16
    (the largest window), on a ragged grid (width 40) and one several
    regions wide (TX 39 and 139: no multiple of the 64-column region), with
    and without a radius plane; K5-par at origins 0 and -1, in one launch
    over all parities and in one per parity."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    cfg, st = _gs_scene(cap, K, seed=cap + K, width=width)
    cfg = cfg.replace(tiled_uniform_radius=uniform)
    if uniform:
        st = st.replace(radius=torch.where(st.pid >= 0, 0.5, 0.0))
    n0 = gk.LAUNCHES["gs_rank"]
    a, b, c = gk.rank(st, cfg), gk.rank_plain(st, cfg), gk.rank(st, cfg)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gs_rank"] == n0 + 2
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v) and torch.equal(u, w)
    assert int((a[3] - K).clamp(min=0).sum()) > 0  # the jam clamps
    for origin in (0, -1):
        ps = gp.to_parity_state(st, cfg, origin)
        assert (ps.radius is None) == uniform
        for fused in (True, False):
            c = cfg.replace(gs_par_fused=fused)
            n0 = gp.LAUNCHES["gs_rank_par"]
            a, b = gp.rank_par(ps, c), gp.rank_par_plain(ps, c)
            again = gp.rank_par(ps, c)
            torch.cuda.synchronize()
            assert gp.LAUNCHES["gs_rank_par"] == n0 + (2 if fused else 8)
            for u, v, w in zip(a, b, again):
                assert torch.equal(u, v), (origin, fused)
                assert torch.equal(u, w), (origin, fused)


def _window_cases(cfg, st, layout, prm):
    """(label, kernel, plain) of K6's window on ``st``: colors 1..c for
    each c, and with a uniform radius the Verlet tail alone and after each
    c; flat (layout None, through ``window_cuda``) or parity at that
    origin.  Each call returns (x, y, px, py) from clones of px, py."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    uniform = cfg.tiled_uniform_radius
    if layout is None:
        src, _, rrad, _ = gk.rank(st, cfg)
        x, y, px, py, pid = st.x, st.y, st.px, st.py, st.pid
        geo, grid = None, tuple(st.dims[1:]) + (0, 0, 0, 0)
    else:
        ps = gp.to_parity_state(st, cfg, layout)
        src, _, rrad, _ = gp.rank_par(ps, cfg)
        x, y, px, py, pid, geo = ps.x, ps.y, ps.px, ps.py, ps.pid, ps.geo
        grid = gp._geo_args(geo) + (1,)
    cases = []
    for c1 in (0, 1, 2, 3, 4):
        for tail in ((False, True) if uniform else (False,)):
            if c1 == 0 and not tail:
                continue

            def kern(c1=c1, tail=tail):
                q, r = px.clone(), py.clone()
                t = (q, r, pid, prm) if tail else None
                out = gk.window_cuda(
                    "window", x, y, src, rrad, cfg, grid, c1, t,
                    gp._verlet_consts(cfg) if tail else None)
                return out + (q, r)

            def plain(c1=c1, tail=tail):
                q, r = px.clone(), py.clone()
                if geo is None:
                    a, b = gk.colors_plain(x, y, src, rrad, cfg, c1)
                    if tail:
                        gp.verlet_plain_(a, b, q, r, pid, prm, cfg)
                else:
                    a, b = gp.colors_par_plain(x, y, src, rrad, cfg, geo, c1,
                                               (q, r, pid, prm) if tail
                                               else None)
                return a, b, q, r
            cases.append((f"c1={c1} tail={tail}", kern, plain))
    return cases


@pytest.mark.parametrize("cap, K, width", [(2, 3, 20.0), (4, 8, 40.0),
                                           (6, 8, 150.0), (32, 16, 40.0)])
@pytest.mark.parametrize("layout", [None, 0, -1])
def test_colors_window_matches_plain(cap, K, width, layout):
    """K6's window kernel: colors 1..c for each c, with and without the
    Verlet tail, bit-equal to the plain passes and on repeat, on a grid
    smaller than one window (width 20 and 40: TX 21 and 39), one several
    regions wide (150: TX 139), at cap 32 with K 16, general and uniform
    radius, flat and parity (origins 0 and -1); its shared-memory bytes
    equal the Python mirror."""
    from gpu_physics_engine_torch.ops import _cuda
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    cfg, st = _gs_scene(cap, K, seed=cap + 50, width=width)
    prm = StepParams.make(0.02, mouse=(width / 2, 15.0), pressed=True
                          ).as_tensor("cuda")
    st = st.replace(px=st.x - 0.01, py=st.y + 0.02)
    for uniform in (False, True):
        c = cfg.replace(tiled_uniform_radius=uniform)
        s = st
        if uniform:
            s = st.replace(radius=torch.where(st.pid >= 0, 0.5, 0.0))
        for label, kern, plain in _window_cases(c, s, layout, prm):
            a, b, again = kern(), plain(), kern()
            torch.cuda.synchronize()
            for u, v, w in zip(a, b, again):
                assert torch.equal(u, v), (uniform, label)
                assert torch.equal(u, w), (uniform, label)
    for colors in range(5):
        assert _cuda.library().gpe_gs_colors_window_bytes(cap, colors) \
            == gk.colors_window_bytes(cap, colors)


def test_gs_engine_on_card_matches_cpu_engine():
    """The flat GS step on the card (K2, K5, K6) against the same engine on
    the CPU (plain versions): pid placement and counters exact, positions
    close (the plain integrate's sqrt may round apart on the CPU)."""
    from gpu_physics_engine_torch import TiledEngine
    cfg, st = _gs_scene(4, 8, seed=9)
    cfg = cfg.replace(gs_layout="flat")
    pid, pos, _, rad = tt.export_particles(st)
    engines = [TiledEngine.from_arrays(cfg, pos, rad, device=d)
               for d in ("cpu", "cuda")]
    for e in engines:
        e.press_mouse((20.0, 15.0))
        e.run(10)
    a, b = (tt.to_numpy(e.state) for e in engines)
    np.testing.assert_array_equal(a["pid"], b["pid"])
    assert int(a["overflow_count"]) == int(b["overflow_count"])
    for f in ("x", "y", "px", "py"):
        np.testing.assert_allclose(a[f], b[f], atol=1e-4, rtol=0)


def test_engine_on_card_matches_cpu_engine():
    """The whole step on the card (kernels) against the same engine on the
    CPU (plain versions): pid placement exact, positions close."""
    cfg = SimConfig(max_particles=300, initial_particles=300,
                    world_width=16.0, world_height=60.0, pipeline="tiled",
                    tile_cap=4, tiled_newton=True, tiled_uniform_radius=True,
                    tiled_relocate_interval=2, sort_interval_steps=6,
                    tiled_match="greedy")
    rng = np.random.default_rng(5)
    pos = np.stack([rng.uniform(0.6, 15.4, 300),
                    rng.uniform(0.6, 59.4, 300)], -1).astype(np.float32)
    rad = np.full(300, 0.5, np.float32)
    from gpu_physics_engine_torch import TiledEngine
    engines = [TiledEngine.from_arrays(cfg, pos, rad, device=d)
               for d in ("cpu", "cuda")]
    for e in engines:
        e.press_mouse((8.0, 20.0))
        e.run(12)
    a, b = (tt.to_numpy(e.state) for e in engines)
    np.testing.assert_array_equal(a["pid"], b["pid"])
    assert int(a["overflow_count"]) == int(b["overflow_count"])
    for f in ("x", "y", "px", "py"):
        np.testing.assert_allclose(a[f], b[f], atol=1e-4, rtol=0)


@pytest.mark.parametrize("cap, K, uniform", [(4, 8, True), (2, 3, False)])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("origin", [0, -1])
def test_par_kernels_match_plain(cap, K, uniform, fused, origin):
    """K5-par, K6-par (the window with colors 1..c for each c, and with the
    Verlet tail alone and after the four colors), K2-par bit-equal to their
    plain versions on the parity layout (origin 0: mx/par, -1: dec), in
    one launch over all parities and in one per parity."""
    from gpu_physics_engine_torch.ops import gs_parity as gp
    cfg, st = _gs_scene(cap, K, seed=cap + 20)
    cfg = cfg.replace(gs_par_fused=fused, tiled_uniform_radius=uniform)
    if uniform:
        st = st.replace(radius=torch.where(st.pid >= 0, 0.5, 0.0))
    ps = gp.to_parity_state(st, cfg, origin)
    n0 = dict(gp.LAUNCHES)
    ta, tb = gp.rank_par(ps, cfg), gp.rank_par_plain(ps, cfg)
    per = 1 if fused else 4
    assert gp.LAUNCHES["gs_rank_par"] == n0["gs_rank_par"] + per
    for u, v in zip(ta, tb):
        assert torch.equal(u, v)
    for c1 in (1, 2, 3, 4):
        xk, yk = gp.colors_par(ps.x, ps.y, ta[0], ta[2], cfg, ps.geo, c1)
        xp, yp = gp.colors_par_plain(ps.x, ps.y, tb[0], tb[2], cfg, ps.geo,
                                     c1)
        assert torch.equal(xk, xp) and torch.equal(yk, yp), c1
    assert gp.LAUNCHES["gs_color_par"] == n0["gs_color_par"] + 4
    assert int((xk != ps.x).sum()) > 0
    moved = ps.replace(x=ps.x + torch.where(ps.pid >= 0, 0.6, 0.0))
    a, da = gp.relocate_par_cuda(moved, cfg)
    b, db = gp.relocate_par_plain(moved, cfg)
    assert gp.LAUNCHES["relocate_par"] == n0["relocate_par"] + per
    for f in ("x", "y", "px", "py", "pid", "overflow_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.radius is None) == uniform
    assert uniform or torch.equal(a.radius, b.radius)
    assert torch.equal(da, db) and int(da.sum()) > 0
    if uniform:
        prm = StepParams.make(0.02, mouse=(20.0, 15.0), pressed=True
                              ).as_tensor("cuda")
        for c1 in (0, 4):  # the tail alone, and after the four colors
            k = [t.clone() for t in (ps.px, ps.py)]
            p = [t.clone() for t in k]
            got = gp.colors_par(ps.x, ps.y, ta[0], ta[2], cfg, ps.geo, c1,
                                tail=(*k, ps.pid, prm))
            want = gp.colors_par_plain(ps.x, ps.y, tb[0], tb[2], cfg,
                                       ps.geo, c1, tail=(*p, ps.pid, prm))
            for u, v in zip(tuple(got) + tuple(k), tuple(want) + tuple(p)):
                assert torch.equal(u, v), c1


@pytest.mark.parametrize("cap, shape", [(2, "square"), (32, "square"),
                                        (6, "ragged")])
@pytest.mark.parametrize("match", ["flip", "flip2", "greedy"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("origin", [0, -1])
def test_relocate_par_window_matches_plain(cap, shape, match, fused, origin):
    """K2-par on its shared-memory window: bit-equal to its plain version
    and on repeat, none lost, at cap 2 and cap 32 (the largest window) and
    on the ragged 21 x 39 grid, in one launch over all parities and in one
    per parity, for both origins; relocate_mega (the same window over all
    four parities, one launch) equal to both."""
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    if shape == "square":
        cfg, st = _gs_scene(cap, 8, seed=cap + 40)
    else:
        cfg, st = _window_scene(cap, False, "box", 80.0, 33.0, 3)
    cfg = cfg.replace(tiled_match=match, gs_par_fused=fused)
    g = torch.Generator(device="cuda").manual_seed(cap + 2)
    d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 1.4
    st = st.replace(y=torch.where(st.pid >= 0, st.y + d, st.y))
    ps = gp.to_parity_state(st, cfg, origin)
    n0 = gp.LAUNCHES["relocate_par"]
    a, da = gp.relocate_par_cuda(ps, cfg)
    b, db = gp.relocate_par_plain(ps, cfg)
    c, dc = gp.relocate_par_cuda(ps, cfg)
    torch.cuda.synchronize()
    assert gp.LAUNCHES["relocate_par"] == n0 + (2 if fused else 8)
    fields = ("x", "y", "px", "py", "pid", "overflow_count") + (
        () if ps.radius is None else ("radius",))
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    assert (a.radius is None) == (ps.radius is None)
    assert torch.equal(da, db) and torch.equal(da, dc)
    assert int((a.pid >= 0).sum()) == int((st.pid >= 0).sum())
    n0 = gm.LAUNCHES["relocate_mega"]
    m, dm = gm.relocate_mega_cuda(ps, cfg)
    assert gm.LAUNCHES["relocate_mega"] == n0 + 1
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(m, f)), f
    assert torch.equal(da, dm)


def test_par_engine_on_card_matches_flat_engine_on_card():
    """The par engine (K2-par, K5-par, K6-par, the Verlet tail) and the flat
    engine (K2, K5, K6, the plain integrate) on the card, mouse pressed:
    bit-equal in full space.  Every particle starts inside [r, W - r]: the
    par rank keeps border cells empty, as the JAX package's does."""
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.ops import gs_parity as gp
    cfg, st = _gs_scene(4, 8, seed=9)
    pid, pos, _, _ = tt.export_particles(st)
    pos = np.clip(pos, 0.6, [39.4, 29.4])
    rad = np.full(len(pid), 0.5, np.float32)
    n0 = dict(gp.LAUNCHES)
    engines = [TiledEngine.from_arrays(cfg.replace(gs_layout=lay), pos, rad,
                                       device="cuda")
               for lay in ("flat", "par")]
    for e in engines:
        e.CHUNK = 4
        e.press_mouse((20.0, 15.0))
        e.run(10)
    assert gp.LAUNCHES["gs_verlet"] == n0["gs_verlet"] + 10
    for f in FIELDS + ("overflow_count",):
        assert torch.equal(getattr(engines[0].state, f),
                           getattr(engines[1].state, f)), f


@pytest.mark.parametrize("cap, K, uniform", [(4, 8, True), (2, 3, False)])
@pytest.mark.parametrize("origin", [0, -1])
def test_fused_gs_kernels_match_plain(cap, K, uniform, origin):
    """colors_mega (with and without the Verlet tail) and relocate_mega
    bit-equal to their plain versions and to the par route's kernels
    (K6-par's launch with the tail; K2-par), one launch each."""
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    cfg, st = _gs_scene(cap, K, seed=cap + 30)
    cfg = cfg.replace(tiled_uniform_radius=uniform)
    if uniform:
        st = st.replace(radius=torch.where(st.pid >= 0, 0.5, 0.0))
    ps = gp.to_parity_state(st, cfg, origin)
    src, _, rrad, _ = gp.rank_par(ps, cfg)
    prm = StepParams.make(0.02, mouse=(20.0, 15.0), pressed=True
                          ).as_tensor("cuda")
    for tail in ((None, prm) if uniform else (None,)):
        runs = [ps.replace(**{f: getattr(ps, f).clone()
                              for f in ("x", "y", "px", "py")})
                for _ in range(3)]
        n0 = gm.LAUNCHES["gs_colors_mega"]
        runs[0] = gm.colors_mega(runs[0], src, rrad, cfg, tail)
        assert gm.LAUNCHES["gs_colors_mega"] == n0 + 1
        gm.colors_mega_plain(runs[1], src, rrad, cfg, tail)
        seq = runs[2]
        x, y = gp.colors_par_cuda(
            seq.x, seq.y, src, rrad, cfg, seq.geo,
            tail=None if tail is None else (seq.px, seq.py, ps.pid, tail))
        runs[2] = seq.replace(x=x, y=y)
        for f in ("x", "y", "px", "py"):
            assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
            assert torch.equal(getattr(runs[0], f), getattr(runs[2], f)), f
        assert int((runs[0].x != ps.x).sum()) > 0
    moved = ps.replace(x=ps.x + torch.where(ps.pid >= 0, 0.6, 0.0))
    n0 = gm.LAUNCHES["relocate_mega"]
    a, da = gm.relocate_mega_cuda(moved, cfg)
    assert gm.LAUNCHES["relocate_mega"] == n0 + 1
    for b, db in (gp.relocate_par_plain(moved, cfg),
                  gp.relocate_par_cuda(moved, cfg)):
        for f in ("x", "y", "px", "py", "pid", "overflow_count"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert uniform or torch.equal(a.radius, b.radius)
        assert torch.equal(da, db) and int(da.sum()) > 0


@pytest.mark.parametrize("uniform, cap, shape", [
    (False, 4, "square"), (True, 4, "square"), (True, 32, "square"),
    (True, 6, "ragged")])
def test_k4_cuda_matches_plain(uniform, cap, shape):
    """K4 (K2's window with K4's step rule) bit-equal to its plain version,
    whatever the config's matching and hysteresis, and to K2 under flip
    with delta 0 where no particle lies within an ulp of a tile edge (there
    the division and the products part); at cap 32 (the largest window)
    and on the ragged 21 x 39 grid."""
    if shape == "square":
        cfg, st = _scene(match="greedy", hysteresis=-1.0, uniform=uniform,
                         cap=cap)
    else:
        cfg, st = _window_scene(cap, uniform, "box", 80.0, 33.0, 3)
        cfg = cfg.replace(tiled_match="greedy", tiled_hysteresis=-1.0)
        g = torch.Generator(device="cuda").manual_seed(cap + 1)
        d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 1.6
        st = st.replace(x=torch.where(st.pid >= 0, st.x + d, st.x))
    n0 = tk.LAUNCHES["relocate_one"]
    a, da = tk.relocate_one_cuda(st, cfg)
    assert tk.LAUNCHES["relocate_one"] == n0 + 1
    b, db = tk.relocate_one_plain(st, cfg)
    for f in FIELDS + ("overflow_count",):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(da, db) and int((a.pid != st.pid).sum()) > 0
    flip = cfg.replace(tiled_match="flip", tiled_hysteresis=0.0)
    t, _, TX = tt.tile_geometry(cfg)
    TY = st.dims[1]  # the ragged grid's rows
    sty = torch.arange(TY, device="cuda").view(1, TY, 1)
    stx = torch.arange(TX, device="cuda").view(1, 1, TX)
    rule = [u != v for u, v in zip(
        tt.step_offsets(st.x, st.y, sty, stx, t=t, delta=0.0, gTY=TY,
                        gTX=TX),
        tk.home_offsets(st.x, st.y, sty, stx, t=t, gTY=TY, gTX=TX))]
    if not bool(((rule[0] | rule[1]) & (st.pid >= 0)).any()):
        c, _ = tk.relocate_pull_cuda(st, flip)
        for f in FIELDS + ("overflow_count",):
            assert torch.equal(getattr(a, f), getattr(c, f)), f


def _radix_keys(n=25_006, seed=12):
    """A reverse ramp with duplicates and 0xFFFFFFFF sentinels, as u32
    values in int64."""
    rng = np.random.default_rng(seed)
    keys = np.arange(n - 1, -1, -1, dtype=np.int64) * 40_503
    keys[rng.random(n) < 0.3] = 7
    keys[rng.random(n) < 0.1] = 0xFFFFFFFF
    return torch.from_numpy(keys & 0xFFFFFFFF)


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_k12_cuda_matches_plain(shift):
    from gpu_physics_engine_torch.ops import radix_sort as rs
    keys = _radix_keys()
    bits = rs.as_i32_bits(torch.cat([keys, keys.new_full(
        (-len(keys) % rs.BLOCK,), 0xFFFFFFFF)])).cuda()
    n0 = rs.LAUNCHES["radix_rank_hist"]
    a = rs.rank_hist(bits, shift)
    c = rs.rank_hist(bits, shift)
    b = rs.rank_hist_plain(bits, shift)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["radix_rank_hist"] == n0 + 2
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v) and torch.equal(u, w)


@pytest.mark.parametrize("nblocks", [1, 3, 1075])
def test_radix_offsets_and_scatter_match_plain(nblocks):
    """radix_offsets and radix_scatter bit-equal to their plain versions
    and on repeat on each of the four passes' real inputs (keys with
    duplicates and 0xFFFFFFFF sentinels), the last pass sorted."""
    from gpu_physics_engine_torch.ops import radix_sort as rs
    rng = np.random.default_rng(nblocks)
    keys = rng.integers(0, 2 ** 32, nblocks * rs.BLOCK, dtype=np.int64)
    keys[rng.random(keys.size) < 0.3] = 7
    keys[rng.random(keys.size) < 0.1] = 0xFFFFFFFF
    bits = rs.as_i32_bits(torch.from_numpy(keys)).cuda()
    vals = torch.arange(bits.shape[0], dtype=torch.int32, device="cuda")
    n0 = dict(rs.LAUNCHES)
    for p in range(4):
        rank, hist = rs.rank_hist(bits, 8 * p)
        off, off2 = rs.digit_offsets(hist), rs.digit_offsets(hist)
        assert torch.equal(off, rs.digit_offsets_plain(hist))
        assert torch.equal(off, off2)
        got = rs.scatter(bits, vals, rank, hist, off, 8 * p)
        again = rs.scatter(bits, vals, rank, hist, off, 8 * p)
        want = rs.scatter_plain(bits, vals, rank, off, 8 * p)
        torch.cuda.synchronize()
        for u, v, w in zip(got, want, again):
            assert torch.equal(u, v) and torch.equal(u, w)
        bits, vals = got
    assert rs.LAUNCHES["radix_offsets"] == n0["radix_offsets"] + 8
    assert rs.LAUNCHES["radix_scatter"] == n0["radix_scatter"] + 8
    u = rs.from_i32_bits(bits)
    assert bool((u[1:] >= u[:-1]).all())
    with pytest.raises(ValueError, match="payload"):
        rs.scatter(bits, vals.to(torch.int64), rank, hist, off, 0)


def test_radix_one_pass_on_card_matches_plain():
    """A pass on the card, with its own work tensors and with a sort's
    (given once, reused), equals the plain pass; an int64 payload is
    refused, not converted."""
    from gpu_physics_engine_torch.ops import radix_sort as rs
    keys = _radix_keys()
    bits = rs.as_i32_bits(torch.cat([keys, keys.new_full(
        (-len(keys) % rs.BLOCK,), 0xFFFFFFFF)])).cuda()
    vals = torch.arange(bits.shape[0], dtype=torch.int32, device="cuda")
    work = rs.pass_work(bits, vals)
    for shift in (0, 8, 16, 24):
        want = rs.one_pass(bits.cpu(), vals.cpu(), shift)
        got = rs.one_pass(bits, vals, shift)
        out = (torch.empty_like(bits), torch.empty_like(vals))
        again = rs.one_pass(bits, vals, shift, work, out)
        torch.cuda.synchronize()
        assert again[0] is out[0] and again[1] is out[1]
        for u, v, w in zip(got, want, again):
            assert torch.equal(u.cpu(), v) and torch.equal(u, w)
    with pytest.raises(ValueError, match="payload"):
        rs.one_pass(bits, vals.to(torch.int64), 0)


def test_radix_sort_on_card_matches_torch_sort():
    from gpu_physics_engine_torch.ops import radix_sort as rs
    keys = _radix_keys().cuda()
    vals = torch.arange(len(keys), dtype=torch.int32, device="cuda")
    sk, sv = rs.radix_sort_pairs(keys, vals)
    wk, wi = torch.sort(keys, stable=True)
    torch.cuda.synchronize()
    assert torch.equal(sk, wk) and torch.equal(sv, wi.to(torch.int32))


def test_array_engine_radix_equals_lax_on_card():
    """The array Engine on the card: the radix run (K12) equals the lax run
    bit for bit, and both stay close to the CPU run."""
    from gpu_physics_engine_torch import Engine
    from gpu_physics_engine_torch.ops import radix_sort as rs
    base = dict(max_particles=3000, initial_particles=3000,
                world_width=96.0, world_height=48.0, sort_interval_steps=5)
    rng = np.random.default_rng(3)
    pos = np.stack([rng.uniform(0.5, 95.5, 3000),
                    rng.uniform(0.5, 47.5, 3000)], -1).astype(np.float32)
    rad = np.full(3000, 0.5, np.float32)
    runs = {}
    for dev, impl in (("cuda", "radix"), ("cuda", "lax"), ("cpu", "lax")):
        e = Engine.from_arrays(SimConfig(**base, sort_impl=impl), pos, rad,
                               device=dev)
        n0 = rs.LAUNCHES["radix_rank_hist"]
        e.press_mouse((48.0, 24.0))
        e.run(12)
        runs[dev, impl] = (e.state, rs.LAUNCHES["radix_rank_hist"] - n0)
    (a, na), (b, nb), (c, _) = (runs["cuda", "radix"], runs["cuda", "lax"],
                                runs["cpu", "lax"])
    assert na == 4 * 12 + 4 * 2 and nb == 0  # 4 passes per sort
    for f in ("x", "y", "px", "py", "overflow_count", "steps_since_sort"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.overflow_count) == int(c.overflow_count)
    for f in ("x", "y", "px", "py"):
        np.testing.assert_allclose(getattr(a, f).cpu().numpy(),
                                   getattr(c, f).numpy(), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the device compositor (render/device.py)
# ---------------------------------------------------------------------------

def _render_state(S, dev, n=6000, seed=4):
    """A jittered, moving scene over a 192 x 96 world at cap 8 on ``dev``
    (the same numpy scene on every device)."""
    cfg = SimConfig(max_particles=n, initial_particles=n, world_width=192.0,
                    world_height=96.0, pipeline="tiled", tile_cap=8,
                    render_supersample=S)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.6, [191.4, 95.4], (n, 2)).astype(np.float32)
    prev = (pos + rng.normal(0, 0.12, pos.shape)).astype(np.float32)
    rad = rng.uniform(0.3, 0.5, n).astype(np.float32)
    return cfg, tt.init_tiles(cfg, pos, rad, previous_positions=prev,
                              device=dev)


def _within_one(a, b):
    d = (a.cpu().to(torch.int32) - b.cpu().to(torch.int32)).abs()
    assert int(d.max()) <= 1, f"{int((d > 1).sum())} pixels differ by more " \
                              f"than 1"


@pytest.mark.parametrize("S", [1, 2])
def test_render_core_on_card_matches_cpu(S):
    """render_core and render_parity_core on the card within one u8 step of
    the CPU's on the same state (auto-fit and a zoomed, off-centre rect);
    the parity frame also within one of the full-space frame."""
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.render import device
    cfg, st = _render_state(S, "cuda")
    _, cpu = _render_state(S, "cpu")
    for rect in (device.autofit_rect(cfg, 320, 180), (40.3, 20.7, 90.1, 48.2)):
        planes = [getattr(st, f) for f in FIELDS]
        got = device.render_core(*planes, rect, cfg, 320, 180)
        assert got.is_cuda and got.dtype == torch.uint8
        _within_one(got, device.render_core(
            *[getattr(cpu, f) for f in FIELDS], rect, cfg, 320, 180))
        par = device.render_parity_core(gp.to_parity_state(st, cfg), rect,
                                        cfg, 320, 180)
        _within_one(par, got)
        _within_one(par, device.render_parity_core(
            gp.to_parity_state(cpu, cfg), rect, cfg, 320, 180))
        assert int(got.max()) > 0


@pytest.mark.parametrize("layout", ["jacobi", "par"])
def test_render_run_on_card_matches_run(layout):
    """render_run on the card leaves the state bit-equal to run() over two
    windows, and the render entry points keep the state on the card."""
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    if layout == "jacobi":
        cfg = SimConfig(max_particles=6000, initial_particles=6000,
                        world_width=192.0, world_height=96.0,
                        pipeline="tiled", tile_cap=8,
                        tiled_relocate_interval=2, sort_interval_steps=16)
    else:
        cfg = gs_config(6000, world_width=120.0, world_height=60.0,
                        gs_layout="par", sort_interval_steps=16)
    a, b = (TiledEngine(cfg, seed=2, chunk=8, device="cuda")
            for _ in range(2))
    for _ in range(2):
        a.run(16)
        assert b.render_run(16, width=320, height=180) > 0
    for f in FIELDS + ("num_active", "overflow_count"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    img = b.step_render_frame(width=320, height=180)
    a.step()
    np.testing.assert_array_equal(img, a.render_frame(width=320, height=180))
    assert isinstance(img, np.ndarray) and img.shape == (180, 320, 3)
    assert all(getattr(b.state, f).is_cuda for f in FIELDS)


def _spawn_engines(seed=3):
    """The same scene with three bursts in the overlay, on the CPU and on
    the card (the bursts drawn once, on the CPU engine's generator)."""
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.ops import bigs
    cfg = SimConfig(max_particles=6000, initial_particles=6000,
                    world_width=192.0, world_height=96.0, pipeline="tiled",
                    tile_cap=8, tile_multiplier=3.3,
                    tiled_uniform_radius=True, tiled_relocate_interval=2,
                    sort_interval_steps=16)
    cpu = TiledEngine(cfg, seed=seed, chunk=8, device="cpu")
    for p in ((48.0, 48.0), (96.0, 60.0), (144.0, 40.0)):
        cpu.spawn_at(p, count=60, verbose=False)
    card = TiledEngine(cpu.config, chunk=8, initial_state=tt.from_numpy(
        tt.to_numpy(cpu.state), device="cuda"))
    card.big = bigs.from_numpy(bigs.to_numpy(cpu.big), device="cuda")
    return cpu, card


def test_couple_bigs_on_card_equals_cpu():
    """The overlay's coupling pass sums in one fixed order on every device:
    the card equals the CPU bit for bit, and itself on repeat."""
    from gpu_physics_engine_torch.ops import bigs
    cpu, card = _spawn_engines()
    want = bigs.couple_bigs(cpu.state, cpu.big, cpu.config)
    got = bigs.couple_bigs(card.state, card.big, card.config)
    again = bigs.couple_bigs(card.state, card.big, card.config)
    for w, g, a in zip(want, got, again):
        for f in ("x", "y"):
            assert torch.equal(getattr(g, f).cpu(), getattr(w, f)), f
            assert torch.equal(getattr(g, f), getattr(a, f)), f


def test_spawn_engine_on_card_matches_cpu_engine():
    """The hybrid step on the card (K1's general form, K2) against the same
    engine on the CPU over a relocating and an off step: pids exact,
    positions close (the plain sweep's rsqrt rounds apart on the CPU, and
    the scene amplifies that past 1e-4 within 12 steps); the frame with
    the overlay within one u8."""
    cpu, card = _spawn_engines()
    assert not card.config.tiled_uniform_radius
    for e in (cpu, card):
        e.press_mouse((96.0, 48.0))
        e.run(2)
    a, b = cpu._export(), card._export()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[0], np.arange(6180))
    np.testing.assert_allclose(a[1], b[1], atol=1e-4, rtol=0)
    d = np.abs(cpu.render_frame(width=320, height=180).astype(int)
               - card.render_frame(width=320, height=180).astype(int))
    assert d.max() <= 1


# ---------------------------------------------------------------------------
# solver="fast", the band drain and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack", [True, False], ids=["bf16", "f32"])
def test_fast_engine_on_card_equals_cpu(pack):
    """The sort + shift Jacobi engine sorts stably and folds in one order:
    the card equals the CPU bit for bit over 8 steps (a resort at 5, the
    radix sort's kernels on the card)."""
    from gpu_physics_engine_torch import Engine
    base = dict(max_particles=3000, initial_particles=3000,
                world_width=96.0, world_height=32.0, sort_interval_steps=5,
                solver="fast", sort_impl="radix", fast_pack_bf16=pack)
    rng = np.random.default_rng(6)
    pos = rng.uniform(0.5, [95.5, 31.5], (3000, 2)).astype(np.float32)
    rad = np.full(3000, 0.5, np.float32)
    states = []
    for dev in ("cuda", "cpu"):
        e = Engine.from_arrays(SimConfig(**base), pos, rad, device=dev)
        e.press_mouse((48.0, 16.0))
        e.run(8)
        states.append(e.state)
    for f in ("x", "y", "px", "py", "overflow_count", "steps_since_sort"):
        assert torch.equal(getattr(states[0], f).cpu(),
                           getattr(states[1], f)), f


def test_rebuild_band_on_card_equals_cpu():
    cfg, st = _scene(cap=4, jitter=3.0)
    _, TY, _ = tt.tile_geometry(cfg)
    cpu = st.replace(**{f: getattr(st, f).cpu() for f in FIELDS})
    for r0 in (0, TY // 2, TY - 8):
        got = tt.rebuild_band(st, cfg, r0, rows=8)
        want = tt.rebuild_band(cpu, cfg, r0, rows=8)
        for f in FIELDS:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    np.testing.assert_array_equal(tt.stale_per_row(st, cfg).cpu().numpy(),
                                  tt.stale_per_row(cpu, cfg).numpy())


def test_tiled_checkpoint_loads_on_card_as_on_cpu(tmp_path):
    cpu, card = _spawn_engines()
    path = str(tmp_path / "spawn.npz")
    card.save_checkpoint(path)
    a = type(card).from_checkpoint(path, device="cuda")
    b = type(card).from_checkpoint(path, device="cpu")
    for u, v, w in zip(a._export(), b._export(), card._export()):
        np.testing.assert_array_equal(u, v)
        np.testing.assert_array_equal(u, w)
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f).cpu(), getattr(b.state, f)), f
    a.run(4)
    assert a.num_particles() == card.num_particles()
