"""K5's shared-memory window (csrc/gs_kernels.cuh ``gs_rank_kernel``) on the
CPU, where no CUDA kernel runs.

  * The bytes of a block, through the Python mirror
    ``gpu_physics_engine_torch.ops.gs_kernels.rank_window_bytes``, fit the
    card's 232,448 at every cap up to 4,096 and K up to 256 (past cap 64
    or K 16 no window: the packed kernel's plan is the library's own), with
    and without a radius plane
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
  * A model of the packed kernel (``gs_rank_pack_kernel``, past cap 64 or
    K 16) equals the plain rank bit for bit on the same scene: blocks of
    6 x 30 tiles and their one-tile ring, each window's occupants counted
    and packed per tile in slot order, or, past the buffer, the window
    streamed; per region cell the members of its 9 tiles and their ranks
    in ascending pid order, the fill past them; flat, and on the parity
    layout at both origins in one launch and in one per parity.

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
    # past cap 64 or K 16 the packed kernel: no window, whatever the cap
    # and K (its plan: gpe_gs_rank_pack_bytes)
    assert gk.rank_window_bytes(gk.WIDE_CAP, uniform, gk.REG_K) > 0
    assert gk.rank_window_bytes(gk.WIDE_CAP + 1, uniform) == 0
    assert gk.rank_window_bytes(4, uniform, gk.REG_K + 1) == 0
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


PACK_REGION = (6, 30)  # csrc/gs_simple.cuh kGsPackRY, kGsPackRX


def _pack_launch(x, y, rad, pid, K, t, r0, origin, parities, entries, out,
                 written):
    """One launch of the packed kernel's algorithm over its grid, on
    full-space numpy planes [cap, TY, TX] (origin None: flat, else the
    parity layout at that origin ranking ``parities`` and masking border
    cells), a buffer of ``entries`` occupants.  Writes ``out``, counts
    ``written`` and returns the blocks that streamed."""
    cap, TY, TX = pid.shape
    par = origin is not None
    RY, RX = PACK_REGION
    o = origin or 0
    if par:
        DY, DX = (TY - o + 1) // 2, (TX - o + 1) // 2
        grid = (-(-DY // (RY // 2)), -(-DX // (RX // 2)))
    else:
        grid = (-(-TY // RY), -(-TX // RX))
    f = np.float32
    streamed = 0
    for by in range(grid[0]):
        for bx in range(grid[1]):
            ty0, tx0 = RY * by + o, RX * bx + o
            # 1, 2. count and pack each window tile's occupants, by slot
            packed, total = {}, 0
            for wy in range(RY + 2):
                for wx in range(RX + 2):
                    ty, tx = ty0 - 1 + wy, tx0 - 1 + wx
                    occ = []
                    if 0 <= ty < TY and 0 <= tx < TX:
                        occ = [k for k in range(cap) if pid[k, ty, tx] >= 0]
                    packed[wy, wx] = occ
                    total += len(occ)
            stream = total > entries
            streamed += stream
            # 3, 4. rank a region cell of the launch's parities, the fill
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
                    members = []  # (pid, source code, radius)
                    for j in range(9 if live else 0):
                        cy, cx = ty + j // 3 - 1, tx + j % 3 - 1
                        if stream:  # every slot from device memory
                            slots = [k for k in range(cap)
                                     if 0 <= cy < TY and 0 <= cx < TX
                                     and pid[k, cy, cx] >= 0]
                        else:
                            slots = packed[ry + 1 + j // 3 - 1,
                                           rx + 1 + j % 3 - 1]
                        for s in slots:
                            px = min(max(x[s, cy, cx], lox), hix)
                            py = min(max(y[s, cy, cx], loy), hiy)
                            ddx, ddy = x[s, cy, cx] - px, y[s, cy, cx] - py
                            d2 = ddx * ddx + ddy * ddy
                            r = f(r0) if rad is None else rad[s, cy, cx]
                            if d2 < r * r:
                                members.append((int(pid[s, cy, cx]),
                                                j * cap + s, r))
                    # the rounds: each the smallest pid not yet taken
                    ranks = sorted(members)[:K]
                    ranks += [(BIG, -1, f(0))] * (K - len(ranks))
                    src, rpid, rrad, count = out
                    rpid[:, ty, tx], src[:, ty, tx], rrad[:, ty, tx] = zip(
                        *ranks)
                    count[ty, tx] = len(members)
                    written[ty, tx] += 1
    return streamed


def _pack_model(st, cfg, origin, fused, entries):
    """The packed kernel's tables in full space, and the blocks that
    streamed."""
    cap, TY, TX = st.dims
    K = cfg.max_occupancy
    out = (np.zeros((K, TY, TX), np.int32), np.zeros((K, TY, TX), np.int32),
           np.zeros((K, TY, TX), np.float32), np.zeros((TY, TX), np.int32))
    written = np.zeros((TY, TX), np.int32)
    rad = None if cfg.tiled_uniform_radius else st.radius.numpy()
    groups = [(0, 1, 2, 3)] if fused else [(p,) for p in range(4)]
    streamed = 0
    for parities in groups:
        streamed += _pack_launch(
            st.x.numpy(), st.y.numpy(), rad, st.pid.numpy(), K,
            tt.tile_geometry(cfg)[0], cfg.initial_radius, origin, parities,
            entries, out, written)
    assert (written == 1).all()  # every cell by one block of one launch
    return [torch.from_numpy(a) for a in out], streamed


@pytest.mark.parametrize("origin, fused, uniform", [
    (None, True, False), (None, True, True), (0, True, True),
    (-1, False, True)])
def test_packed_rank_model_matches_plain_rank(origin, fused, uniform):
    """Buffers of 12 occupants: the scene's windows both pack and
    stream."""
    cfg, st = _scene(uniform)
    got, streamed = _pack_model(st, cfg, origin, fused, entries=12)
    if origin is None:
        want = gk.rank_plain(st, cfg)
    else:
        ps = gp.to_parity_state(st, cfg, origin)
        want = gp.rank_par_plain(ps, cfg)
        want = [gp.from_parity(a, ps.geo) for a in want[:3]] + [
            gp.from_parity(want[3][:, None], ps.geo)[0]]
    for name, u, v in zip(("src", "rpid", "rrad", "count"), got, want):
        assert torch.equal(u, v), name
    blocks = -(-st.dims[1] // PACK_REGION[0]) * -(-st.dims[2]
                                                 // PACK_REGION[1])
    assert 0 < streamed < blocks * (1 if fused else 4)
