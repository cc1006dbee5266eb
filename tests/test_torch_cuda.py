"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only, so it also runs where jax is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repository's conftest imports jax).  Without a CUDA device every test here
skips.  K1 and K3 equal their plain versions bit for bit at every cap
the engine can reach, in box and circle worlds, on grids smaller than one
shared-memory region and not a multiple of it (past cap 64 the packed
kernel, to cap 520); K2 and K2-par bit for bit at caps 2-520 in every
matching mode (past cap 64 the warp kernel; at cap 4,096 on device
scratch) and on a ragged grid, K5 and K5-par (the rank's window) bit for
bit up to cap 520 and K 128 (past cap 64 or K 16 the packed rank, also
with its windows streamed), on a ragged grid, at both parity origins,
K6 (colors 1..c for each c, with and without the Verlet tail) bit for bit
on the flat and the parity layouts, up to cap 520 and K 128 (past cap 64
or K 16 the ranked-slot solve), on a grid smaller than one window and
one several windows wide; the par engine equals the flat engine.  colors_mega bit for bit and
equal to the par route's K6-par launch; relocate_mega and K4 (K2's
window) bit for bit, relocate_mega equal to K2-par, also at caps 32, 64
and past and on a ragged grid.  Only a cap below 1, or slots past the
int32 index, are refused.
The radix sort's digit histogram and its onesweep
pass (rank, look-back, store) bit for bit on all four passes, from 1 key
to about the 1M scene's pair count, the look-back prefixes too, the sort
equal to torch.sort(stable=True) and on repeat, and the array Engine's
radix run on the card equal to its lax run bit for bit.  The
device compositor's frames on the card (full space and parity space)
within one u8 of the CPU's, and render_run equal to run() there.  The
big-particle overlay's coupling pass on the card equals the CPU's bit for
bit, and the spawn engine's hybrid step on the card follows the CPU's.
The fast solver's engine (both packings), ``rebuild_band`` and
``stale_per_row`` on the card equal the CPU's bit for bit, and a tiled
checkpoint with an overlay loads on the card as on the CPU.  The apps
layer: ``tile_stats`` (the tile map) on the card equals the CPU's bit for
bit, ``Viewer.render_engine`` on the card is within one u8 of the CPU's,
and the headless CLI runs a small world with ``--device cuda``.  The slab
mesh: K2 at every slab's row offset and K1 and K3 on halo-extended slabs
bit for bit, and the sharded engine on the card following the CPU's.
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
    pile = n // 2 if cap <= 64 else 8 * cap
    if cap > 64:
        n += pile
        cfg = cfg.replace(max_particles=n, initial_particles=n)
    rng = np.random.default_rng(cap)
    pos = rng.uniform(0.6, 63.4, (n, 2)).astype(np.float32)
    if cap > 32:  # a pile: its tiles fill every slot, past slot 32
        pos[:pile] = np.clip([32.0, 32.0] + rng.normal(
            0, 1.0, (pile, 2)), 0.6, 63.4)
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


@pytest.mark.parametrize("match, hysteresis, cap, shape", [
    (m, h, c, sh) for sh in ("square", "ragged")
    for c in (4, 8, 32, 48, 64, 65, 128, 256, 257, 312, 520)
    for h in (0.0, -1.0) for m in ("flip", "flip2", "greedy")])
def test_k2_cuda_matches_plain(match, hysteresis, cap, shape):
    """K2 on its shared-memory window: bit-equal to the plain version and
    on repeat, nothing lost, up to cap 32 (the 32-bit masks' largest
    window), at caps 48 and 64 (64-bit masks) and 65-520 (the warp kernel
    on a region chosen by cap), on piles whose tiles fill every slot, on a
    64 x 64 world and on a grid whose TY and TX are no multiples of the
    region ("ragged": 21 x 39 at cap 6)."""
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
    per unit area, less at small caps (the tiles must hold the scene); past
    cap 32 also a pile of 4 x cap particles, whose tiles fill every
    slot (8 x cap past cap 64)."""
    n = int(width * height * min(0.6, 0.12 * cap))
    # past cap 32 a pile whose tiles fill every slot
    pile = 0 if cap <= 32 else 4 * cap if cap <= 64 else 8 * cap
    n += pile
    cfg = SimConfig(max_particles=n, initial_particles=n, world_width=width,
                    world_height=height, pipeline="tiled", tile_cap=cap,
                    tiled_uniform_radius=uniform, world_shape=world,
                    gravity=(0.0, -9.8))
    rng = np.random.default_rng(cap)
    pos = np.stack([rng.uniform(0.6, width - 0.6, n),
                    rng.uniform(0.6, height - 0.6, n)], -1).astype(np.float32)
    if pile:
        pos[:pile] = np.clip([width / 2, height / 2] + rng.normal(
            0, 1.0, (pile, 2)), 0.6, [width - 0.6, height - 0.6])
    rad = (np.full(n, 0.5, np.float32) if uniform
           else rng.uniform(0.3, 0.5, n).astype(np.float32))
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    st = tt.init_tiles(cfg, pos, rad, previous_positions=prev, device="cuda")
    if pile:
        assert int((st.pid >= 0).sum(0).max()) == cap
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


@pytest.mark.parametrize("cap", [2, 6, 9, 10, 16, 32, 48, 64, 65, 128, 256,
                                 257, 312, 520])
@pytest.mark.parametrize("shape", ["small", "ragged", "wide"])
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("world", ["box", "circle"])
def test_k1_k3_window_matches_plain(cap, shape, uniform, world):
    """K1 and K3 on the shared-memory window: bit-equal to the plain
    versions and on repeat at caps from 2 to 520 (past the tuned rows:
    the watchdog grows cap; past 32 the 64-bit masks on a 4 x 16 region,
    past 64 the packed kernel, which keeps no mask),
    on a grid smaller than one 8 x 32 region ("small"), one whose TY and
    TX are no multiples of it ("ragged") and one several regions wide
    ("wide")."""
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
    past K; past cap 32 so tight that its tiles fill every slot), stored
    up to a third of a tile off home as after the pull relocate."""
    from gpu_physics_engine_torch.core.tuned import gs_config
    cfg = gs_config(1500, world_width=width, world_height=30.0,
                    tile_cap=cap, max_occupancy=K)
    rng = np.random.default_rng(seed)
    hi = [width - 0.6, 29.4]
    spread = 2.0 if cap <= 32 else 0.6
    pos = np.concatenate([rng.uniform(0.6, hi, (1000, 2)),
                          np.clip([width / 2, 15.0]
                                  + rng.normal(0, spread, (500, 2)), 0.6,
                                  hi)]).astype(np.float32)
    rad = rng.uniform(0.3, 0.5, 1500).astype(np.float32)
    st = tt.init_tiles(cfg, pos, rad, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    occ = st.pid >= 0
    d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 0.7
    return cfg, st.replace(x=torch.where(occ, st.x + d, st.x),
                           y=torch.where(occ, st.y - d, st.y))


def _crowd_cell(st, cfg):
    """``st`` with every particle of the first block of 3 x 3 full tiles
    (row by row) moved into the middle tile's box, on a 9 x 9 grid of
    0.05 tile steps: that tile's cell has 9 x cap members."""
    t = tt.tile_geometry(cfg)[0]
    full = (st.pid >= 0).all(0).float()[None, None]
    block = torch.nn.functional.conv2d(full, torch.ones(1, 1, 3, 3,
                                                        device=full.device))
    hits = (block[0, 0] == 9).nonzero()
    assert len(hits), "the jam fills no block of 3 x 3 tiles"
    ty, tx = (int(v) + 1 for v in hits[0])
    cap = st.dims[0]
    k = torch.arange(9 * cap, device=st.x.device, dtype=torch.float32)
    ox = ((k % 9) - 4) * 0.05 * t
    oy = ((k // 9 % 9) - 4) * 0.05 * t
    x, y = st.x.clone(), st.y.clone()
    for j, (dy, dx) in enumerate((a, b) for a in (-1, 0, 1)
                                 for b in (-1, 0, 1)):
        s = slice(j * cap, (j + 1) * cap)
        x[:, ty + dy, tx + dx] = (tx - 0.5) * t + ox[s]
        y[:, ty + dy, tx + dx] = (ty - 0.5) * t + oy[s]
    return st.replace(x=x, y=y)


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


@pytest.mark.parametrize("cap, K", [(2, 3), (4, 8), (32, 16), (48, 16),
                                    (64, 16), (65, 16), (128, 32), (256, 64),
                                    (16, 17), (16, 32), (8, 64), (32, 64),
                                    (257, 16), (312, 8), (520, 8), (16, 80),
                                    (16, 128)])
@pytest.mark.parametrize("width", [40.0, 150.0])
@pytest.mark.parametrize("uniform", [False, True])
def test_rank_window_matches_plain(cap, K, width, uniform):
    """K5 and K5-par on the rank's shared-memory window: the tables
    bit-equal to the plain versions and on repeat, up to cap 32 with K 16
    (the 32-bit masks' largest window) and at caps 48 and 64 (64-bit
    masks on a 4 x 32 region); past cap 64 or K 16 the packed kernel
    (caps 65-520, K 17-128, K 80 and 128 on a crowded cell; its launches
    counted as gs_rank_pack), on a ragged grid (width 40)
    and one several
    regions wide (TX 39 and 139: no multiple of the 64-column region), with
    and without a radius plane; K5-par at origins 0 and -1, in one launch
    over all parities and in one per parity."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    cfg, st = _gs_scene(cap, K, seed=cap + K, width=width)
    if K > 4 * cap:  # the jam alone fills no cell past K there
        st = _crowd_cell(st, cfg)
    cfg = cfg.replace(tiled_uniform_radius=uniform)
    if uniform:
        st = st.replace(radius=torch.where(st.pid >= 0, 0.5, 0.0))
    n0, p0 = gk.LAUNCHES["gs_rank"], gk.LAUNCHES["gs_rank_pack"]
    a, b, c = gk.rank(st, cfg), gk.rank_plain(st, cfg), gk.rank(st, cfg)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["gs_rank"] == n0 + 2
    assert gk.LAUNCHES["gs_rank_pack"] == p0 + (
        0 if gk.windowed(cap, K) else 2)
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


def _window_cases(cfg, st, layout, prm, colors=(0, 1, 2, 3, 4)):
    """(label, kernel, plain) of K6's window on ``st``: colors 1..c for
    each c of ``colors``, and with a uniform radius the Verlet tail alone
    and after each c; flat (layout None, through ``window_cuda``) or parity
    at that origin.  Each call returns (x, y, px, py) from clones of px,
    py."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    uniform = cfg.tiled_uniform_radius
    if layout is None:
        src, _, rrad, count = gk.rank(st, cfg)
        x, y, px, py, pid = st.x, st.y, st.px, st.py, st.pid
        geo, grid = None, tuple(st.dims[1:]) + (0, 0, 0, 0)
    else:
        ps = gp.to_parity_state(st, cfg, layout)
        src, _, rrad, count = gp.rank_par(ps, cfg)
        x, y, px, py, pid, geo = ps.x, ps.y, ps.px, ps.py, ps.pid, ps.geo
        grid = gp._geo_args(geo) + (1,)
    cases = []
    for c1 in colors:
        for tail in ((False, True) if uniform else (False,)):
            if c1 == 0 and not tail:
                continue

            def kern(c1=c1, tail=tail):
                q, r = px.clone(), py.clone()
                t = (q, r, pid, prm) if tail else None
                out = gk.window_cuda(
                    "window", x, y, src, rrad, cfg, grid, c1, t,
                    gp._verlet_consts(cfg) if tail else None, count=count)
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
                                           (6, 8, 150.0), (32, 16, 40.0),
                                           (48, 16, 150.0), (64, 16, 40.0),
                                           (65, 16, 40.0), (128, 32, 150.0),
                                           (256, 64, 40.0), (16, 32, 40.0),
                                           (8, 64, 150.0), (257, 8, 40.0),
                                           (312, 16, 150.0), (520, 8, 40.0),
                                           (16, 80, 40.0)])
@pytest.mark.parametrize("layout", [None, 0, -1])
def test_colors_window_matches_plain(cap, K, width, layout):
    """K6's window kernel: colors 1..c for each c, with and without the
    Verlet tail, bit-equal to the plain passes and on repeat, on a grid
    smaller than one window (width 20 and 40: TX 21 and 39), one several
    regions wide (150: TX 139), at cap 32 with K 16 and past it (caps 48
    and 64: the fifth region class), general and uniform radius, flat and
    parity (origins 0 and -1); past cap 64 or K 16 (caps 65-520, K 32-80)
    the ranked-slot solve with the rank's count table; its shared-memory
    bytes equal the Python mirror, and its route the library's."""
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
        # past K 16 the plain sweep's K^2/2 pairs are slow: colors 1 and
        # 1..4 (and the tail alone and after them); past K 64 1..4
        colors = (0, 1, 2, 3, 4) if K <= 16 else (0, 1, 4) if K <= 64 \
            else (4,)
        for label, kern, plain in _window_cases(c, s, layout, prm, colors):
            a, b, again = kern(), plain(), kern()
            torch.cuda.synchronize()
            for u, v, w in zip(a, b, again):
                assert torch.equal(u, v), (uniform, label)
                assert torch.equal(u, w), (uniform, label)
    for colors in range(5):
        assert _cuda.library().gpe_gs_colors_window_bytes(cap, colors) \
            == gk.colors_window_bytes(cap, colors)
    assert _cuda.library().gpe_gs_route(cap, K) == (
        0 if gk.windowed(cap, K) else 3)


def test_colors_past_k64_match_plain():
    """K6 at K 128 (the solve without a window) on a crowded cell of 144
    members, flat, uniform radius: the four colors and the Verlet tail
    bit-equal to the plain passes and on repeat."""
    cfg, st = _gs_scene(16, 128, seed=7)
    st = _crowd_cell(st, cfg).replace(px=st.x - 0.01, py=st.y + 0.02)
    cfg = cfg.replace(tiled_uniform_radius=True)
    st = st.replace(radius=torch.where(st.pid >= 0, 0.5, 0.0))
    prm = StepParams.make(0.02, mouse=(20.0, 15.0), pressed=True
                          ).as_tensor("cuda")
    for label, kern, plain in _window_cases(cfg, st, None, prm, (4,)):
        a, b, again = kern(), plain(), kern()
        torch.cuda.synchronize()
        for u, v, w in zip(a, b, again):
            assert torch.equal(u, v), label
            assert torch.equal(u, w), label


@pytest.mark.parametrize("cap, K", [(128, 8), (312, 16), (16, 80)])
def test_packed_rank_streamed_matches_plain(cap, K):
    """K5 and K5-par (origins 0 and -1, one launch and one per parity)
    through the packed kernel with buffers of 8 and 256 occupants, so that
    nearly every window, or those around the jam, streams from device
    memory: bit-equal to the plain versions."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.utils.kernel_study import rank_pack_cuda
    cfg, st = _gs_scene(cap, K, seed=cap + K)
    if K > 4 * cap:
        st = _crowd_cell(st, cfg)
    want = gk.rank_plain(st, cfg)
    for entries in (8, 256):
        for u, v in zip(rank_pack_cuda(st, cfg, entries), want):
            assert torch.equal(u, v), entries
        for origin in (0, -1):
            ps = gp.to_parity_state(st, cfg, origin)
            pwant = gp.rank_par_plain(ps, cfg)
            for p0, n in ((0, 4), (2, 1)):
                got = rank_pack_cuda(ps, cfg, entries, p0=p0, np=n)
                torch.cuda.synchronize()
                if n == 4:
                    for u, v in zip(got, pwant):
                        assert torch.equal(u, v), (entries, origin)
                else:  # parity 2's cells alone
                    assert torch.equal(got[0][2], pwant[0][2])
                    assert torch.equal(got[3][2], pwant[3][2])


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


@pytest.mark.parametrize("cap, K, uniform", [(4, 8, True), (2, 3, False),
                                             (65, 32, True),
                                             (256, 64, False),
                                             (312, 8, True)])
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
        xk, yk = gp.colors_par(ps.x, ps.y, ta[0], ta[2], cfg, ps.geo, c1,
                               count=ta[3])
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
                                tail=(*k, ps.pid, prm), count=ta[3])
            want = gp.colors_par_plain(ps.x, ps.y, tb[0], tb[2], cfg,
                                       ps.geo, c1, tail=(*p, ps.pid, prm))
            for u, v in zip(tuple(got) + tuple(k), tuple(want) + tuple(p)):
                assert torch.equal(u, v), c1


@pytest.mark.parametrize("cap, shape, match", [
    (c, sh, m) for c, sh in ((2, "square"), (32, "square"), (6, "ragged"),
                             (64, "square"), (65, "square"), (128, "square"),
                             (256, "square"), (257, "square"),
                             (312, "ragged"), (520, "square"))
    for m in ("flip", "flip2", "greedy")])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("origin", [0, -1])
def test_relocate_par_window_matches_plain(cap, shape, match, fused, origin):
    """K2-par on its shared-memory window: bit-equal to its plain version
    and on repeat, none lost, at cap 2, cap 32 and cap 64 (64-bit masks),
    at caps 65, 128 and 256 (the warp kernel) and on the ragged 21 x 39
    grid, in one launch over all parities and in one
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


@pytest.mark.parametrize("par", [False, True])
def test_relocate_on_device_scratch_matches_plain(par):
    """At cap 4,096 no region of the warp relocate fits a block, so its
    arrays go to device scratch, sized by the library
    (``gpe_relocate_scratch_bytes``) for the layout's grid: K2 and K4 on
    the flat layout, K2-par (one launch and one per parity) and
    relocate_mega on the parity layout at both origins, on the ragged
    grid whose pile fills a tile: bit-equal to the plain versions and on
    repeat, none lost."""
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import _cuda
    cap = 4096
    cfg, st = _window_scene(cap, False, "box", 80.0, 33.0, 3)
    assert tk.k2_window_bytes(cap, par) == 0  # no region fits a block
    g = torch.Generator(device="cuda").manual_seed(9)
    d = (torch.rand(st.x.shape, generator=g, device="cuda") - 0.5) * 1.4
    st = st.replace(y=torch.where(st.pid >= 0, st.y + d, st.y))
    n_live = int((st.pid >= 0).sum())
    if not par:
        assert _cuda.library().gpe_relocate_scratch_bytes(
            cap, *st.dims[1:], 0) > 0
        runs = [(tk.relocate_pull_cuda, tk.relocate_pull_plain, st,
                 cfg.replace(tiled_match=m)) for m in ("flip", "greedy")]
        runs.append((tk.relocate_one_cuda, tk.relocate_one_plain, st, cfg))
        fields = FIELDS + ("overflow_count",)
    else:
        runs = []
        for origin in (0, -1):
            ps = gp.to_parity_state(st, cfg, origin)
            assert _cuda.library().gpe_relocate_scratch_bytes(
                cap, *ps.x.shape[2:], 1) > 0
            runs += [(gp.relocate_par_cuda, gp.relocate_par_plain, ps,
                      cfg.replace(gs_par_fused=f)) for f in (True, False)]
            runs.append((gm.relocate_mega_cuda, gp.relocate_par_plain, ps,
                         cfg))
        fields = ("x", "y", "px", "py", "pid", "radius", "overflow_count")
    for kern, plain, s0, c in runs:
        a, da = kern(s0, c)
        b, db = plain(s0, c)
        a2, da2 = kern(s0, c)
        torch.cuda.synchronize()
        for f in fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (kern, f)
            assert torch.equal(getattr(a, f), getattr(a2, f)), (kern, f)
        assert torch.equal(da, db) and torch.equal(da, da2)
        assert int((a.pid >= 0).sum()) == n_live
        assert not torch.equal(a.pid, s0.pid)  # particles moved


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


@pytest.mark.parametrize("cap, K, uniform", [(4, 8, True), (2, 3, False),
                                             (128, 32, True), (312, 8, True),
                                             (16, 80, True)])
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
    src, _, rrad, count = gp.rank_par(ps, cfg)
    prm = StepParams.make(0.02, mouse=(20.0, 15.0), pressed=True
                          ).as_tensor("cuda")
    for tail in ((None, prm) if uniform else (None,)):
        runs = [ps.replace(**{f: getattr(ps, f).clone()
                              for f in ("x", "y", "px", "py")})
                for _ in range(3)]
        n0 = gm.LAUNCHES["gs_colors_mega"]
        runs[0] = gm.colors_mega(runs[0], src, rrad, cfg, tail, count)
        assert gm.LAUNCHES["gs_colors_mega"] == n0 + 1
        gm.colors_mega_plain(runs[1], src, rrad, cfg, tail)
        seq = runs[2]
        x, y = gp.colors_par_cuda(
            seq.x, seq.y, src, rrad, cfg, seq.geo,
            tail=None if tail is None else (seq.px, seq.py, ps.pid, tail),
            count=count)
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
    (True, 6, "ragged"), (True, 64, "square"), (True, 128, "square"),
    (False, 256, "square"), (False, 312, "square"), (True, 520, "ragged")])
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


def _radix_passes_match_plain(keys):
    """The histogram, then each pass on the keys the earlier passes leave
    (int64 in on pass 0, out on pass 3), bit-equal to the plain versions
    and on repeat, the look-back array == lookback_plain, every word
    flagged inclusive; returns the last pass's output."""
    from gpu_physics_engine_torch.ops import radix_sort as rs
    vals = torch.arange(keys.shape[0], dtype=torch.int32, device="cuda")
    hist = rs.digit_hist_cuda(keys)
    assert torch.equal(hist, rs.digit_hist_plain(keys))
    assert torch.equal(hist, rs.digit_hist_cuda(keys))
    bits = keys
    for p in range(4):
        od = torch.int64 if p == 3 else torch.int32
        got = rs.onesweep_pass_cuda(bits, vals, 8 * p, hist, od)
        again = rs.onesweep_pass_cuda(bits, vals, 8 * p, hist, od)
        want = rs.onesweep_pass_plain(bits, vals, 8 * p,
                                      rs.digit_bases(hist[p]), out_dtype=od)
        torch.cuda.synchronize()
        for u, v, w in zip(got, want, again):
            assert torch.equal(u, v) and torch.equal(u, w)
        counts = rs.rank_hist_plain(rs.as_i32_bits(bits), 8 * p, rs.TILE)[1]
        look = got[2]
        assert torch.equal((look & 0xFFFFFFFF).to(torch.int32),
                           rs.lookback_plain(counts))
        assert bool(((look >> 32) == 4 * p + 2).all())
        bits, vals = got[:2]
    return bits, vals


@pytest.mark.parametrize("seed", [12, 13, 14, 15])
def test_onesweep_cuda_matches_plain(seed):
    """radix_digit_hist and radix_onesweep on the 25,006-key ramp (7
    tiles, the last ragged): every pass bit-equal to its plain version."""
    from gpu_physics_engine_torch.ops import radix_sort as rs
    keys = _radix_keys(seed=seed).cuda()
    n0 = dict(rs.LAUNCHES)
    bits, _ = _radix_passes_match_plain(keys)
    assert rs.LAUNCHES["radix_digit_hist"] == n0["radix_digit_hist"] + 2
    assert rs.LAUNCHES["radix_onesweep"] == n0["radix_onesweep"] + 8
    assert torch.equal(bits, torch.sort(keys)[0])


@pytest.mark.parametrize("n", [1, 4095, 4097, 1075 * 4096 + 3])
def test_radix_kernels_match_plain_at_sizes(n):
    """Both kernels bit-equal to their plain versions at ragged sizes
    around a tile and at about the 1M scene's pair count, on keys with
    duplicates and 0xFFFFFFFF sentinels; the last pass sorted."""
    from gpu_physics_engine_torch.ops import radix_sort as rs
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2 ** 32, n, dtype=np.int64)
    keys[rng.random(n) < 0.3] = 7
    keys[rng.random(n) < 0.1] = 0xFFFFFFFF
    keys = torch.from_numpy(keys).cuda()
    bits, _ = _radix_passes_match_plain(keys)
    assert bool((bits[1:] >= bits[:-1]).all())
    with pytest.raises(ValueError, match="payload"):
        rs.onesweep_pass_cuda(keys, keys, 0, rs.digit_hist_cuda(keys))


def test_onesweep_pass_on_card_matches_cpu():
    """A pass on the card equals the plain pass on the CPU, each from the
    CPU's histogram; an int64 payload is refused, not converted."""
    from gpu_physics_engine_torch.ops import radix_sort as rs
    keys = _radix_keys()
    vals = torch.arange(keys.shape[0], dtype=torch.int32)
    hist = rs.digit_hist_plain(keys)
    ck, cv = keys.cuda(), vals.cuda()
    for shift in (0, 8, 16, 24):
        want = rs.onesweep_pass_plain(keys, vals, shift,
                                      rs.digit_bases(hist[shift // 8]))
        got = rs.onesweep_pass_cuda(ck, cv, shift, hist.cuda())
        torch.cuda.synchronize()
        for u, v in zip(got, want):
            assert torch.equal(u.cpu(), v)
    with pytest.raises(ValueError, match="payload"):
        rs.onesweep_pass_cuda(ck, cv.to(torch.int64), 0, hist.cuda())


def test_radix_sort_on_card_matches_torch_sort():
    """The sort equals torch.sort(stable=True), and 20 repeats of it are
    identical (the look-back decides nothing by timing)."""
    from gpu_physics_engine_torch.ops import radix_sort as rs
    g = torch.Generator(device="cuda").manual_seed(3)
    for keys in (_radix_keys().cuda(),
                 torch.randint(0, 2 ** 32, (2 ** 22,), generator=g,
                               device="cuda", dtype=torch.int64),
                 torch.full((100_003,), 0xFFFFFFFF, device="cuda")):
        vals = torch.arange(len(keys), dtype=torch.int32, device="cuda")
        sk, sv = rs.radix_sort_pairs(keys, vals)
        wk, wi = torch.sort(keys, stable=True)
        torch.cuda.synchronize()
        assert torch.equal(sk, wk) and torch.equal(sv, wi.to(torch.int32))
        for _ in range(20):
            ak, av = rs.radix_sort_pairs(keys, vals)
            assert torch.equal(ak, sk) and torch.equal(av, sv)


def test_array_engine_radix_equals_lax_on_card():
    """The array Engine on the card: the radix run (the histogram and the
    onesweep pass) equals the lax run bit for bit, and both stay close to
    the CPU run."""
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
        n0 = dict(rs.LAUNCHES)
        e.press_mouse((48.0, 24.0))
        e.run(12)
        runs[dev, impl] = (e.state, {k: rs.LAUNCHES[k] - n0[k]
                                     for k in n0})
    (a, na), (b, nb), (c, _) = (runs["cuda", "radix"], runs["cuda", "lax"],
                                runs["cpu", "lax"])
    # a sort a step and the resorts at steps 5 and 10: 4 passes a sort
    assert na == {"radix_digit_hist": 14, "radix_onesweep": 56}
    assert not any(nb.values())
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


def _apps_scene():
    """1,500 particles in a 96 x 48 world with some velocity, storage
    jittered up to 0.6 of a tile: the config, the state on the card and
    the same tensors on the CPU."""
    n = 1500
    cfg = SimConfig(max_particles=n, initial_particles=n, world_width=96.0,
                    world_height=48.0, pipeline="tiled", tile_cap=6)
    rng = np.random.default_rng(17)
    pos = np.stack([rng.uniform(0.6, 95.4, n),
                    rng.uniform(0.6, 47.4, n)], -1).astype(np.float32)
    prev = (pos + rng.normal(0, 0.1, pos.shape)).astype(np.float32)
    cpu = tt.init_tiles(cfg, pos, np.full(n, 0.5, np.float32),
                        previous_positions=prev)
    live = cpu.pid >= 0
    g = torch.Generator().manual_seed(17)
    d = (torch.rand(cpu.x.shape, generator=g) - 0.5) * 1.2 * \
        tt.tile_geometry(cfg)[0]
    cpu = cpu.replace(x=torch.where(live, cpu.x + d, cpu.x))
    card = tt.TileState(**{f: getattr(cpu, f).cuda() for f in FIELDS + (
        "num_active", "overflow_count")})
    return cfg, card, cpu


def test_tile_stats_on_card_equals_cpu():
    from gpu_physics_engine_torch.render import tilemap
    _, card, cpu = _apps_scene()
    count, mean_v = tilemap.tile_stats(card)
    want_count, want_v = tilemap.tile_stats(cpu)
    assert torch.equal(count.cpu(), want_count)
    assert torch.equal(mean_v.cpu(), want_v)
    assert float(want_v.max()) > 0
    np.testing.assert_array_equal(tilemap.render_tilemap(card),
                                  tilemap.render_tilemap(cpu))


def test_viewer_render_engine_on_card_within_one_u8_of_cpu():
    from gpu_physics_engine_torch.core.tiled_engine import TiledEngine
    from gpu_physics_engine_torch.render.viewer import Viewer
    cfg, card, cpu = _apps_scene()
    frames = []
    for st in (card, cpu):
        v = Viewer((cfg.world_width, cfg.world_height), (321, 160))
        v.toggle_grid()
        v.camera.set_mouse_position((200.0, 50.0))
        v.camera.zoom_camera(2.0)
        v.camera.update(1 / 60)
        frames.append(v.render_engine(TiledEngine(cfg, initial_state=st),
                                      preview_scale=2))
    d = np.abs(frames[0] - frames[1]) * 255.0
    assert frames[0].shape == (160, 321, 3) and d.max() <= 1.0 + 1e-4
    assert frames[0].max() > 0.3


def test_headless_cli_runs_on_card(tmp_path):
    from gpu_physics_engine_torch.app import headless
    out = str(tmp_path / "frames")
    s = headless.main(["--device", "cuda", "--particles", "3000",
                       "--world", "96", "48", "--steps", "12",
                       "--pipeline", "tiled", "--set", "tile_cap=6",
                       "--spawn", "2", "48", "24", "--attract", "4", "48",
                       "24", "--release", "9", "--render-every", "6",
                       "--tilemap", "--out", out,
                       "--chrometrace", str(tmp_path / "trace.json"),
                       "--summary-json"])
    assert s["particles"] == 3100 and s["finite"]
    import os
    assert sorted(os.listdir(out)) == ["frame_000000.png",
                                       "frame_000006.png"]


# ---------------------------------------------------------------------------
# the slab mesh: K2 at slab row offsets, K1 and K3 on halo-extended slabs,
# the sharded engine card against CPU
# ---------------------------------------------------------------------------

def _slabs(cfg, st, n=4):
    from gpu_physics_engine_torch.parallel import mesh as tmesh
    mesh = tmesh.make_mesh(n, device="cuda")
    return mesh, tmesh.shard_tiles(st, mesh)


@pytest.mark.parametrize("match", ["flip", "flip2", "greedy"])
@pytest.mark.parametrize("hysteresis", [0.0, -1.0])
def test_k2_cuda_matches_plain_at_slab_row_offsets(match, hysteresis):
    """K2 on each slab of a 4-slab cut (8 of 32 rows each, row0 = 0, 8,
    16, 24, global_rows 32), the particles jittered by up to 1.2 units in
    x and y: bit-equal to the plain version and on repeat; a mover across
    the slab edge stays in its slab."""
    cfg, st = _scene(match=match, hysteresis=hysteresis, cap=4, jitter=1.2)
    g = torch.Generator(device="cuda").manual_seed(9)
    d = (torch.rand(st.y.shape, generator=g, device="cuda") - 0.5) * 2.4
    st = st.replace(y=torch.where(st.pid >= 0, st.y + d, st.y))
    _, slabs = _slabs(cfg, st)
    TY = st.dims[1]
    for i, s in enumerate(slabs):
        row0 = i * s.dims[1]
        a, da = tk.relocate_pull_cuda(s, cfg, row0=row0, global_rows=TY)
        b, db = tk.relocate_pull_plain(s, cfg, row0=row0, global_rows=TY)
        c, dc = tk.relocate_pull_cuda(s, cfg, row0=row0, global_rows=TY)
        torch.cuda.synchronize()
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (i, f)
            assert torch.equal(getattr(a, f), getattr(c, f)), (i, f)
        assert torch.equal(da, db) and torch.equal(da, dc)
        assert torch.equal(torch.sort(a.pid[a.pid >= 0]).values,
                           torch.sort(s.pid[s.pid >= 0]).values)


@pytest.mark.parametrize("uniform", [False, True])
def test_k1_k3_cuda_match_plain_on_halo_extended_slabs(uniform):
    """K1 and K3 on each extended slab [cap, 8 + 2, TX] of a 4-slab cut:
    the halo rows hold the neighbours' live particles (pid 0 as
    occupancy), bit-equal to the plain versions and on repeat."""
    from gpu_physics_engine_torch.parallel.tiled_shard import extended_slabs
    cfg, st = _scene(uniform=uniform, jitter=0.0, gravity=(0.0, -9.8))
    mesh, slabs = _slabs(cfg, st)
    prm = StepParams.make(0.02, mouse=(30.0, 20.0), pressed=True).as_tensor(
        "cuda")
    for fused in (True, False):
        for i, ext in enumerate(extended_slabs(mesh, slabs, fused)):
            assert ext.dims[1] == slabs[i].dims[1] + 2
            if 0 < i < 3:
                assert bool((ext.pid[:, 0] == 0).any())  # live halo rows
            if fused:
                a = tk.collide_integrate_cuda(ext, prm, cfg)
                b = tk.collide_integrate_plain(ext, prm, cfg)
                c = tk.collide_integrate_cuda(ext, prm, cfg)
                names = ("x", "y", "px", "py")
            else:
                a = tk.collide_cuda(ext, cfg)
                b = tk.collide_plain(ext, cfg)
                c = tk.collide_cuda(ext, cfg)
                names = ("x", "y")
            torch.cuda.synchronize()
            for f in names:
                assert torch.equal(getattr(a, f), getattr(b, f)), (i, f)
                assert torch.equal(getattr(a, f), getattr(c, f)), (i, f)


def test_sharded_engine_on_card_matches_cpu_engine():
    """The sharded engine on 4 slabs of the card (K1 on the extended
    slabs, the crossers shipped, K2 at the slab row offsets) against the
    same engine on the CPU over an off-step and a relocating step with
    the mouse pressed: pids exact, positions close (the plain sweep's
    rsqrt rounds apart on the CPU, and the mouse amplifies that within
    tens of steps); then 38 more steps on the card through the claim
    sweep at 20: every pid kept, finite; K1 launched 4 times a step."""
    from gpu_physics_engine_torch.parallel import mesh as tmesh
    from gpu_physics_engine_torch.parallel.tiled_shard import (
        ShardedTiledEngine)
    cfg = SimConfig(max_particles=3000, initial_particles=3000,
                    world_width=96.0, world_height=64.0, pipeline="tiled",
                    tile_cap=6, tiled_relocate_interval=2,
                    sort_interval_steps=20, tiled_uniform_radius=True,
                    migration_capacity=8, gravity=(0.0, -40.0))
    rng = np.random.default_rng(21)
    pos = rng.uniform(0.6, [95.4, 63.4], (3000, 2)).astype(np.float32)
    prev = (pos + rng.normal(0, 0.3, pos.shape)).astype(np.float32)
    arr = (pos, np.full(3000, 0.5, np.float32), None, prev)
    engines = [ShardedTiledEngine(cfg, mesh=tmesh.make_mesh(4, device=d),
                                  initial_arrays=arr)
               for d in ("cuda", "cpu")]
    n0 = tk.LAUNCHES["collide_integrate"]
    for e in engines:
        e.press_mouse((48.0, 30.0))
        e.run(2)
    a, b = engines[0]._export(), engines[1]._export()
    np.testing.assert_array_equal(a[0], np.arange(3000))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], atol=1e-4, rtol=0)
    card = engines[0]
    card.run(38)
    assert tk.LAUNCHES["collide_integrate"] == n0 + 4 * 40
    pid, p, _, _ = card._export()
    np.testing.assert_array_equal(pid, np.arange(3000))
    assert np.isfinite(p).all() and card.num_particles() == 3000


def test_kernels_refuse_caps_past_64():
    """No kernel has a largest cap or K: a cap-257 state on the card is
    taken by K1, K3, K2, K4 and K5, each bit-equal to its plain version,
    and K 65 by K5 and K6; a state whose slots pass the int32 index is
    refused before any launch, naming the limit.  (The name dates from the
    64-slot limit, which refused them.)"""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    cfg, st = _window_scene(257, False, "box", 12.0, 5.0, 0)
    prm = StepParams.make(0.02).as_tensor("cuda")
    for kern, plain, fields in (
            (lambda: tk.collide_integrate_cuda(st, prm, cfg),
             lambda: tk.collide_integrate_plain(st, prm, cfg),
             ("x", "y", "px", "py")),
            (lambda: tk.collide_cuda(st, cfg), lambda: tk.collide_plain(
                st, cfg), ("x", "y")),
            (lambda: tk.relocate_pull_cuda(st, cfg)[0],
             lambda: tk.relocate_pull_plain(st, cfg)[0], FIELDS),
            (lambda: tk.relocate_one_cuda(st, cfg)[0],
             lambda: tk.relocate_one_plain(st, cfg)[0], FIELDS)):
        a, b = kern(), plain()
        for f in fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for u, v in zip(gk.rank_cuda(st, cfg), gk.rank_plain(st, cfg)):
        assert torch.equal(u, v)
    gcfg, gst = _gs_scene(4, 65, seed=3)
    a, b = gk.rank_cuda(gst, gcfg), gk.rank_plain(gst, gcfg)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    x, y = gk.colors_cuda(gst.x, gst.y, a[0], a[2], gcfg, 1, count=a[3])
    xp, yp = gk.colors_plain(gst.x, gst.y, b[0], b[2], gcfg, 1)
    assert torch.equal(x, xp) and torch.equal(y, yp)
    huge = st.replace(**{f: getattr(st, f)[:1].expand(2 ** 31 // 64 + 1, 8,
                                                       8) for f in FIELDS})
    with pytest.raises(ValueError, match="2\\^31"):
        tk.collide_integrate_cuda(huge, prm, cfg)
