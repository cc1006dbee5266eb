"""K6's window (csrc/gs_kernels.cuh ``gs_colors_window_kernel``) on the CPU,
where no CUDA kernel runs.

  * The bytes of a block, through the Python mirror
    ``gpu_physics_engine_torch.ops.gs_kernels.colors_window_bytes``, fit the
    card's 232,448 at every cap up to 256 and every number of colors up
    to four (one geometry serves both layouts; chip_smoke.py holds the mirror
    equal to the launcher's own number on the card); past cap 64 or K 16
    the solve (``gs_colors_ranked_kernel``) stages no window and takes none.
  * A model of the kernel's algorithm in torch equals the plain color
    passes (``color_plain_`` / ``color_par_plain_``, then ``verlet_plain_``)
    bit for bit on a jammed scene with its storage off home: blocks over
    the kernel's grid (flat, or the parity layout at origin 0 and -1), each
    staging its region and a halo of two tiles per color (tiles outside
    the grid poisoned with NaN, and a read outside the window fails), then
    for the k-th color the cells at least 2k + 1 tiles inside the window's
    inner edges, each swept with the plain version's f32 operations, and
    the region written (with the Verlet step where asked): every tile by
    exactly one block.  Regions of 4 x 6 tiles make many blocks.
  * The same model with a halo two tiles smaller differs from the plain
    passes on that scene: the halo is needed.
  * Past cap 64 or K 16 (``gs_colors_ranked_kernel``): a model of the
    ranked-slot solve (x, y copied to the outputs, then a color at a time
    a cell at a time in place on its ranked slots, its rank count from the
    count table, up to a register depth in registers and past it read and
    written pair by pair, then the Verlet step over every slot) equals the
    plain passes.

The CUDA kernel is held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from gpu_physics_engine_torch import StepParams
from gpu_physics_engine_torch.core.tuned import gs_config
from gpu_physics_engine_torch.ops import gs_kernels as gk
from gpu_physics_engine_torch.ops import gs_parity as gp
from gpu_physics_engine_torch.ops import gs_tiled as gt
from gpu_physics_engine_torch.ops import tiled as tt

SMEM = 232_448  # dynamic shared memory of a block on an H100
REGION = (4, 6)  # a few tiles, so that the scene spans many blocks


def test_colors_window_fits_a_block_at_every_cap():
    for cap in range(1, 4097):
        for colors in range(5):
            assert gk.colors_window_bytes(cap, colors) <= SMEM, (cap, colors)
    assert gk.colors_window_bytes(65) == gk.colors_window_bytes(4, 4, 17) == 0
    # at each class's largest cap, a whole solve: (rows + 16) x (columns +
    # 16) tiles of cap slots of x and y
    assert [gk.colors_window_bytes(c) for c in (4, 8, 16, 32, 64)] == [
        98_304, 147_456, 147_456, 196_608, 225_280]
    assert gk.colors_window_bytes(6) == 110_592  # the 4M-GS cap
    # the widest class (caps 33-64, K up to 16) is the last with a window
    assert gk.colors_window_bytes(gk.WIDE_CAP, 4, gk.REG_K) == 225_280
    assert gk.colors_window_bytes(gk.WIDE_CAP + 1, 0, 1) == 0
    assert gk.colors_window_bytes(4, 0) == 32 * 48 * 4 * 8  # the region


def _scene(uniform):
    """600 particles on a 24 x 16 world, half of them in a jammed cluster
    (cells past K = 4), stored up to 0.35 tile off home: cap 4."""
    cfg = gs_config(600, world_width=24.0, world_height=16.0, tile_cap=4,
                    max_occupancy=4, tiled_uniform_radius=uniform)
    rng = np.random.default_rng(11)
    pos = np.concatenate([
        rng.uniform(0.6, [23.4, 15.4], (300, 2)),
        np.clip([12.0, 8.0] + rng.normal(0.0, 1.8, (300, 2)), 0.6,
                [23.4, 15.4])]).astype(np.float32)
    rad = (np.full(600, cfg.initial_radius, np.float32) if uniform
           else rng.uniform(0.3, 0.5, 600).astype(np.float32))
    prev = (pos - rng.uniform(-0.02, 0.02, pos.shape)).astype(np.float32)
    st = tt.init_tiles(cfg, pos, rad, previous_positions=prev)
    t = tt.tile_geometry(cfg)[0]
    occ = st.pid >= 0
    d = torch.from_numpy(rng.uniform(-0.35, 0.35, (2,) + tuple(st.dims))
                         .astype(np.float32)) * t
    return cfg, st.replace(x=torch.where(occ, st.x + d[0], st.x),
                           y=torch.where(occ, st.y + d[1], st.y))


def _window_model(x, y, src, rrad, cfg, c1, origin=None, halo=None,
                  tail=None, c0=1, region=REGION):
    """The window kernel's algorithm on full-space planes x, y [cap, TY,
    TX] with full-space tables src, rrad [K, TY, TX]: colors 1..c1, then
    with ``tail`` = (px, py, pid, prm) the Verlet step of the region's
    occupied slots (px, py in place).  origin None: the flat grid of
    REGION-sized blocks; else the parity layout's grid at that origin.
    ``halo``: tiles staged on every side (the kernel's: 2 * c1).  Returns
    the new (x, y).  ``c0``: the launch's first color; the k-th color of
    the launch, c0 + k, at inset 2k + 1."""
    cap, TY, TX = x.shape
    RY, RX = region
    nc = max(c1 - c0 + 1, 0)
    H = 2 * nc if halo is None else halo
    o = origin or 0
    if origin is None:
        nby, nbx = -(-TY // RY), -(-TX // RX)
    else:
        nby = -(-((TY - o + 1) // 2) // (RY // 2))
        nbx = -(-((TX - o + 1) // 2) // (RX // 2))
    nan = float("nan")
    ox, oy = torch.full_like(x, nan), torch.full_like(y, nan)
    written = torch.zeros((TY, TX), dtype=torch.int32)
    WY, WX = RY + 2 * H, RX + 2 * H
    for by in range(nby):
        for bx in range(nbx):
            ty0, tx0 = RY * by + o, RX * bx + o
            wy0, wx0 = ty0 - H, tx0 - H
            # 1. stage: the window's in-grid tiles, NaN elsewhere
            win = [torch.full((cap, WY, WX), nan) for _ in range(2)]
            gy0, gy1 = max(wy0, 0), min(wy0 + WY, TY)
            gx0, gx1 = max(wx0, 0), min(wx0 + WX, TX)
            for w, plane in zip(win, (x, y)):
                w[:, gy0 - wy0:gy1 - wy0, gx0 - wx0:gx1 - wx0] = \
                    plane[:, gy0:gy1, gx0:gx1]
            # 2. the k-th color: cells at least 2k + 1 inside inner edges
            for k in range(nc):
                m = 2 * k + 1
                ylo = wy0 + m if wy0 > 0 else 0
                yhi = wy0 + WY - m if wy0 + WY < TY else TY
                xlo = wx0 + m if wx0 > 0 else 0
                xhi = wx0 + WX - m if wx0 + WX < TX else TX
                cy0, cx0 = gt.color_origin(c0 + k)
                ty = torch.arange(ylo + (cy0 - ylo) % 2, yhi, 2)
                tx = torch.arange(xlo + (cx0 - xlo) % 2, xhi, 2)
                if not (len(ty) and len(tx)):
                    continue
                ty, tx = (a.reshape(-1) for a in torch.meshgrid(
                    ty, tx, indexing="ij"))
                codes = src[:, ty, tx]
                valid = codes >= 0
                code = torch.where(valid, codes, 0)
                j, s = code // cap, code % cap
                wy = ty + j // 3 - 1 - wy0
                wx = tx + j % 3 - 1 - wx0
                inside = (wy >= 0) & (wy < WY) & (wx >= 0) & (wx < WX)
                assert inside[valid].all()  # reads nothing outside
                idx = (s * WY + wy.clamp(0, WY - 1)) * WX \
                    + wx.clamp(0, WX - 1)
                lx, ly = gt.ordered_sweep(
                    list(gt.gather(win[0], idx, valid)),
                    list(gt.gather(win[1], idx, valid)),
                    list(rrad[:, ty, tx]), list(valid), cfg.stiffness)
                dst = idx[valid]
                win[0].view(-1)[dst] = torch.stack(lx)[valid]
                win[1].view(-1)[dst] = torch.stack(ly)[valid]
            # 3. write the region (the Verlet step first)
            ry0, ry1 = max(ty0, 0), min(ty0 + RY, TY)
            rx0, rx1 = max(tx0, 0), min(tx0 + RX, TX)
            if ry1 <= ry0 or rx1 <= rx0:
                continue
            sl = (slice(None), slice(ry0, ry1), slice(rx0, rx1))
            vals = [w[:, ry0 - wy0:ry1 - wy0, rx0 - wx0:rx1 - wx0]
                    for w in win]
            if tail is not None:
                px, py, pid, prm = tail
                gp.verlet_plain_(vals[0], vals[1], px[sl], py[sl], pid[sl],
                                 prm, cfg)
            ox[sl], oy[sl] = vals
            written[ry0:ry1, rx0:rx1] += 1
    assert (written == 1).all()  # every tile by exactly one block
    return ox, oy


def _inputs(layout, uniform, with_count=False):
    """(config, state, full-space src, rrad, parity geometry or None, prm)
    of the jammed scene, the tables from the layout's plain rank (the
    parity rank masks border cells); ``with_count``: the full-space count
    table too, last."""
    cfg, st = _scene(uniform)
    prm = StepParams.make(cfg.dt, mouse=(12.0, 8.0), pressed=True
                          ).as_tensor("cpu")
    if layout is None:
        src, _, rrad, count = gt.rank_plain(st, cfg)
        geo = None
    else:
        ps = gp.to_parity_state(st, cfg, layout)
        src, _, rrad, count = gp.rank_par_plain(ps, cfg)
        geo = ps.geo
        src, rrad = gp.from_parity(src, geo), gp.from_parity(rrad, geo)
        count = gp.from_parity(count[:, None], geo)[0]
    assert int((count - cfg.max_occupancy).clamp(min=0).sum()) > 0
    if with_count:
        return cfg, st, src, rrad, geo, prm, count
    return cfg, st, src, rrad, geo, prm


def _plain(cfg, st, src, rrad, geo, c1, tail):
    """The plain passes: colors 1..c1 and the Verlet step, in full space
    (px, py of ``tail`` in place)."""
    if geo is None:
        x, y = gt.colors_plain(st.x, st.y, src, rrad, cfg, c1)
        if tail is not None:
            gp.verlet_plain_(x, y, *tail, cfg)
        return x, y
    to = lambda a, fill: gp.to_parity(a, geo, fill)  # noqa: E731
    ptail = None if tail is None else (
        to(tail[0], 0.0), to(tail[1], 0.0), to(tail[2], -1), tail[3])
    x, y = gp.colors_par_plain(to(st.x, 0.0), to(st.y, 0.0), to(src, -1),
                               to(rrad, 0.0), cfg, geo, c1, ptail)
    if tail is not None:
        tail[0].copy_(gp.from_parity(ptail[0], geo))
        tail[1].copy_(gp.from_parity(ptail[1], geo))
    return gp.from_parity(x, geo), gp.from_parity(y, geo)


@pytest.mark.parametrize("layout, uniform, c1, tail", [
    (None, False, 4, False), (None, True, 4, True), (None, True, 2, False),
    (0, True, 4, True), (-1, True, 4, True), (0, False, 3, False)])
def test_window_model_matches_plain_colors(layout, uniform, c1, tail):
    cfg, st, src, rrad, geo, prm = _inputs(layout, uniform)
    tails = [None, None]
    if tail:
        tails = [(st.px.clone(), st.py.clone(), st.pid, prm)
                 for _ in range(2)]
    got = _window_model(st.x, st.y, src, rrad, cfg, c1, layout,
                        tail=tails[0])
    want = _plain(cfg, st, src, rrad, geo, c1, tails[1])
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    if tail:
        for u, v in zip(tails[0][:2], tails[1][:2]):
            assert torch.equal(u, v)
    assert int((got[0] != st.x).sum()) > 0


@pytest.mark.parametrize("layout", [None, 0])
def test_window_model_needs_its_halo(layout):
    """Two tiles less halo than two per color, and the region's edges come
    out wrong after the fourth color."""
    cfg, st, src, rrad, geo, _ = _inputs(layout, uniform=True)
    want = _plain(cfg, st, src, rrad, geo, 4, None)
    got = _window_model(st.x, st.y, src, rrad, cfg, 4, layout, halo=6)
    assert not torch.equal(got[0], want[0])
    ok = _window_model(st.x, st.y, src, rrad, cfg, 4, layout, halo=8)
    assert torch.equal(ok[0], want[0])


def _ranked_model(x, y, src, rrad, count, cfg, c1, tail=None, regs=8):
    """The ranked-slot solve on full-space planes x, y [cap, TY, TX] and
    tables src, rrad [K, TY, TX], count [TY, TX]: x, y copied to the
    outputs, then for each color 1..c1 each cell of the color in place on
    the outputs: n = min(count, K) ranks (the valid prefix of src), done
    at n < 2; up to ``regs`` ranks read into registers, swept, written
    back; past it rank p held while ranks p + 1 .. n - 1 are read, swept
    and written one pair at a time.  Then with ``tail`` = (px, py, pid,
    prm) the Verlet step of every slot.  Returns the new (x, y)."""
    cap, TY, TX = x.shape
    K = src.shape[0]
    ox, oy = x.clone().reshape(-1), y.clone().reshape(-1)
    stiff = np.float32(cfg.stiffness)

    def pair(p, b):
        dxa, dya, dxb, dyb, hit = gt.pair_correction(
            *p, *b, torch.tensor(stiff))
        if bool(hit):
            p = (p[0] + dxa, p[1] + dya, p[2])
            b = (b[0] - dxb, b[1] - dyb, b[2])
        return p, b

    for c in range(1, c1 + 1):
        cy0, cx0 = gt.color_origin(c)
        for ty in range(cy0, TY, 2):
            for tx in range(cx0, TX, 2):
                n = min(int(count[ty, tx]), K)
                assert (src[:n, ty, tx] >= 0).all()  # the count's prefix
                assert n == K or int(src[n, ty, tx]) < 0
                if n < 2:
                    continue
                codes = src[:n, ty, tx].long()
                j, s = codes // cap, codes % cap
                g = (s * TY + ty + j // 3 - 1) * TX + tx + j % 3 - 1
                if n <= regs:
                    v = [(ox[g[q]], oy[g[q]], rrad[q, ty, tx])
                         for q in range(n)]
                    for p in range(n - 1):
                        for b in range(p + 1, n):
                            v[p], v[b] = pair(v[p], v[b])
                    for q in range(n):
                        ox[g[q]], oy[g[q]] = v[q][0], v[q][1]
                    continue
                for p in range(n - 1):
                    vp = (ox[g[p]], oy[g[p]], rrad[p, ty, tx])
                    for b in range(p + 1, n):
                        vb = (ox[g[b]], oy[g[b]], rrad[b, ty, tx])
                        vp, vb = pair(vp, vb)
                        ox[g[b]], oy[g[b]] = vb[0], vb[1]
                    ox[g[p]], oy[g[p]] = vp[0], vp[1]
    ox, oy = ox.reshape(x.shape), oy.reshape(y.shape)
    if tail is not None:
        gp.verlet_plain_(ox, oy, *tail, cfg)
    return ox, oy


@pytest.mark.parametrize("layout, uniform, tail, regs", [
    (None, False, False, 8), (0, True, True, 8), (-1, True, True, 2)])
def test_one_color_launches_match_plain_colors(layout, uniform, tail, regs):
    """Past cap 64 or K 16 a solve is the copy, a launch a color on the
    ranked slots in place (each cell's rank count from the count table;
    ``regs`` 2: every cell of three ranks or more through the pair-by-pair
    path) and the Verlet step: the same x, y as the plain passes."""
    cfg, st, src, rrad, geo, prm, count = _inputs(layout, uniform, True)
    tails = [None, None]
    if tail:
        tails = [(st.px.clone(), st.py.clone(), st.pid, prm)
                 for _ in range(2)]
    x, y = _ranked_model(st.x, st.y, src, rrad, count, cfg, 4, tails[0],
                         regs)
    want = _plain(cfg, st, src, rrad, geo, 4, tails[1])
    assert torch.equal(x, want[0]) and torch.equal(y, want[1])
    if tail:
        for u, v in zip(tails[0][:2], tails[1][:2]):
            assert torch.equal(u, v)
    assert int((x != st.x).sum()) > 0
    assert int(count.clamp(max=cfg.max_occupancy).max()) > regs or regs > 2
