"""K5's shared-memory window (csrc/gs_kernels.cuh ``gs_rank_kernel``) on the
CPU, where no CUDA kernel runs.

  * The bytes of a block, through the Python mirror
    ``gpu_physics_engine_torch.ops.gs_kernels.rank_window_bytes``, fit the
    card's 232,448 at every cap up to 4,096 and K up to 256 (past cap 256
    or K 64 the list kernel's fixed member lists), with and without a
    radius plane
    (one geometry serves both layouts; chip_smoke.py holds the mirror equal
    to the launches' own numbers on the card).
  * A model of the kernel's walk in numpy equals the plain rank bit for
    bit on a jammed scene with its storage off home: blocks over the
    kernel's grid, each staging its region and a one-tile ring (masks of
    the occupied slots, nothing outside the grid), then per region cell of
    the launch's parities the 9 window tiles in the order j and in each
    only the occupied slots, with the kernel's f32 clip-and-distance test
    (every operation rounded on its own) and its insertion into a
    KMAX-deep list.  On the parity layout the border cells are masked,
    and every cell is written by exactly one block of one launch, in one
    launch over all parities and in one per parity.

The CUDA kernel is held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from gpu_physics_engine_torch.core.tuned import gs_config
from gpu_physics_engine_torch.ops import gs_kernels as gk
from gpu_physics_engine_torch.ops import gs_parity as gp
from gpu_physics_engine_torch.ops import tiled as tt

SMEM = 232_448  # dynamic shared memory of a block on an H100
BIG = int(gp.BIGPID)  # the rank's fill pid


@pytest.mark.parametrize("uniform", [False, True])
def test_rank_window_fits_a_block_at_every_cap(uniform):
    for cap in range(1, 4097):
        assert gk.rank_window_bytes(cap, uniform) <= SMEM, cap
    assert gk.rank_window_bytes(32, uniform) == (
        153_648 if uniform else 204_336)
    # past cap 32 the region is 4 x 32 tiles, the masks 64-bit words
    assert gk.rank_window_bytes(64, uniform) == (
        158_304 if uniform else 210_528)
    # past cap 64 (or K 16) the selection kernel: 2 x 8 tiles, four-word
    # masks and nine member masks per region cell
    assert gk.rank_window_bytes(gk.SPAN_CAP, uniform, gk.SPAN_K) == (
        128_768 if uniform else 169_728)
    # past cap 256 or K 64 the list kernel: 8 warps' lists of 512 members
    # (pid, source code, radius), whatever the cap and K
    assert gk.rank_window_bytes(257, uniform) == 8 * 512 * 12
    assert gk.rank_window_bytes(4, uniform, 65) == 8 * 512 * 12
    for K in range(1, 257):
        for cap in range(1, 4097, 97):
            assert gk.rank_window_bytes(cap, uniform, K) <= SMEM, (cap, K)
    # a slot costs 12 bytes (pid, x, y), 16 with a radius plane, per
    # window tile (the region and a one-tile ring)
    rows, cols = gk.rank_region(8)
    assert (gk.rank_window_bytes(9, uniform)
            - gk.rank_window_bytes(8, uniform)) == (12 if uniform else 16) * (
                (rows + 2) * (cols + 2))


def _scene(uniform):
    """1,500 particles on a 64 x 24 world, a third of them in a jammed
    cluster (cells past K), stored up to 0.35 tile off home: cap 4, K 8,
    a grid no multiple of the region's 64 columns."""
    cfg = gs_config(1500, world_width=64.0, world_height=24.0, tile_cap=4,
                    max_occupancy=8, tiled_uniform_radius=uniform)
    rng = np.random.default_rng(5)
    pos = np.concatenate([
        rng.uniform(0.6, [63.4, 23.4], (1000, 2)),
        np.clip([32.0, 12.0] + rng.normal(0.0, 2.0, (500, 2)), 0.6,
                [63.4, 23.4])]).astype(np.float32)
    rad = (np.full(1500, cfg.initial_radius, np.float32) if uniform
           else rng.uniform(0.3, 0.5, 1500).astype(np.float32))
    st = tt.init_tiles(cfg, pos, rad)
    t = tt.tile_geometry(cfg)[0]
    occ = st.pid >= 0
    d = torch.from_numpy(rng.uniform(-0.35, 0.35, (2,) + tuple(st.dims))
                         .astype(np.float32)) * t
    return cfg, st.replace(x=torch.where(occ, st.x + d[0], st.x),
                           y=torch.where(occ, st.y + d[1], st.y))


def _launch(x, y, rad, pid, K, t, r0, origin, parities, out, written):
    """One launch of the kernel's walk over its grid, on full-space numpy
    planes [cap, TY, TX]; origin None: the flat layout (every cell, no
    mask), else the parity layout with that origin, ranking ``parities``
    (p = 2 * row parity + column parity of the cell's full index - origin)
    and masking border cells.  Writes ``out`` and counts ``written``."""
    cap, TY, TX = pid.shape
    par = origin is not None
    RY, RX = gk.rank_region(cap)
    o = origin or 0
    if par:
        DY, DX = (TY - o + 1) // 2, (TX - o + 1) // 2
        grid = (-(-DY // (RY // 2)), -(-DX // (RX // 2)))
    else:
        grid = (-(-TY // RY), -(-TX // RX))
    KMAX = 8 if K <= 8 else 16
    f = np.float32
    for by in range(grid[0]):
        for bx in range(grid[1]):
            ty0, tx0 = RY * by + o, RX * bx + o
            # 1. stage: a mask of the occupied slots per window tile
            mask = {}
            for wy in range(RY + 2):
                for wx in range(RX + 2):
                    ty, tx = ty0 - 1 + wy, tx0 - 1 + wx
                    m = 0
                    if 0 <= ty < TY and 0 <= tx < TX:
                        for k in range(cap):
                            m |= int(pid[k, ty, tx] >= 0) << k
                    mask[wy, wx] = m
            # 2. rank a region cell of the launch's parities
            for ry in range(RY):
                for rx in range(RX):
                    ty, tx = ty0 + ry, tx0 + rx
                    if par and 2 * (ry & 1) + (rx & 1) not in parities:
                        continue
                    if not (0 <= ty < TY and 0 <= tx < TX):
                        continue  # a pad cell (the fill) or past the grid
                    live = not par or (1 <= ty <= TY - 2
                                       and 1 <= tx <= TX - 2)
                    lox = f(tx - 1) * f(t)
                    loy = f(ty - 1) * f(t)
                    hix, hiy = lox + f(t), loy + f(t)
                    kp, kc, kr = [BIG] * KMAX, [-1] * KMAX, [f(0)] * KMAX
                    members = 0
                    for j in range(9 if live else 0):
                        wy, wx = ry + 1 + j // 3 - 1, rx + 1 + j % 3 - 1
                        m = mask[wy, wx]
                        while m:
                            s = (m & -m).bit_length() - 1
                            m &= m - 1
                            cy, cx = ty + j // 3 - 1, tx + j % 3 - 1
                            px = min(max(x[s, cy, cx], lox), hix)
                            py = min(max(y[s, cy, cx], loy), hiy)
                            ddx, ddy = x[s, cy, cx] - px, y[s, cy, cx] - py
                            d2 = ddx * ddx + ddy * ddy
                            r = f(r0) if rad is None else rad[s, cy, cx]
                            if not d2 < r * r:
                                continue
                            members += 1
                            cp, cc, cr = int(pid[s, cy, cx]), j * cap + s, r
                            for q in range(KMAX):
                                if cp < kp[q]:
                                    kp[q], cp = cp, kp[q]
                                    kc[q], cc = cc, kc[q]
                                    kr[q], cr = cr, kr[q]
                    src, rpid, rrad, count = out
                    src[:, ty, tx] = kc[:K]
                    rpid[:, ty, tx] = kp[:K]
                    rrad[:, ty, tx] = kr[:K]
                    count[ty, tx] = members
                    written[ty, tx] += 1


def _model(st, cfg, origin=None, fused=True):
    """The kernel's tables in full space: one launch (flat, or all four
    parities) or one per parity."""
    cap, TY, TX = st.dims
    K = cfg.max_occupancy
    out = (np.zeros((K, TY, TX), np.int32), np.zeros((K, TY, TX), np.int32),
           np.zeros((K, TY, TX), np.float32), np.zeros((TY, TX), np.int32))
    written = np.zeros((TY, TX), np.int32)
    rad = None if cfg.tiled_uniform_radius else st.radius.numpy()
    groups = [(0, 1, 2, 3)] if fused else [(p,) for p in range(4)]
    for parities in groups:
        _launch(st.x.numpy(), st.y.numpy(), rad, st.pid.numpy(), K,
                tt.tile_geometry(cfg)[0], cfg.initial_radius, origin,
                parities, out, written)
    assert (written == 1).all()  # every cell by one block of one launch
    return [torch.from_numpy(a) for a in out]


@pytest.mark.parametrize("uniform", [False, True])
def test_window_walk_model_matches_flat_rank(uniform):
    cfg, st = _scene(uniform)
    got = _model(st, cfg)
    want = gk.rank_plain(st, cfg)
    for name, u, v in zip(("src", "rpid", "rrad", "count"), got, want):
        assert torch.equal(u, v), name
    assert int((want[3] - cfg.max_occupancy).clamp(min=0).sum()) > 0


@pytest.mark.parametrize("origin, fused", [(0, True), (0, False),
                                           (-1, True), (-1, False)])
def test_window_walk_model_matches_parity_rank(origin, fused):
    cfg, st = _scene(uniform=True)
    got = _model(st, cfg, origin, fused)
    ps = gp.to_parity_state(st, cfg, origin)
    want = gp.rank_par_plain(ps, cfg)
    geo = ps.geo
    want = [gp.from_parity(a, geo) for a in want[:3]] + [
        gp.from_parity(want[3][:, None], geo)[0]]
    for name, u, v in zip(("src", "rpid", "rrad", "count"), got, want):
        assert torch.equal(u, v), name
