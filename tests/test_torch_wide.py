"""The port's limits past the card's old ones, on the CPU, where no CUDA
kernel runs: K past 16 against the JAX package, and the kernels' shared
memory at every cap and K the card takes.

  * ``gs_kernels.check_card_k``: every K from 1 passes on a CUDA device,
    65 included; 0, and a K whose tables pass the int32 index, raise
    naming the limit (TiledEngine calls it for a GS config); on the CPU
    every K passes.
  * The Python mirrors of the kernels' shared memory
    (``tiled_kernels.k1_smem_bytes``, ``k2_window_bytes``,
    ``gs_kernels.rank_window_bytes``, ``colors_window_bytes``), which past
    cap 64 (K1, the relocate window; the GS kernels, and past K 16 too)
    follow the kernels that keep no mask, stay within a block's
    232,448 bytes at every cap 1-4,096 and K 1-256 (chip_smoke.py holds
    them equal to the launches' own numbers on the card).
  * The GS routes: which kernels (``gs_kernels.rank_kernel``,
    ``color_kernel``) take each (cap, K) either side of cap 64 and 256 and
    of K 16 and 64 (chip_smoke.py holds them equal to the library's
    ``gpe_gs_route`` on the card).
  * ``gs_kernels.rank_plain`` at K 20 (past the register list's 16) equals
    the JAX package's ``_select_occupants`` exactly, and one solve through
    ``rank_plain`` and ``colors_plain`` at K 20 equals the JAX package's
    jnp ``gs_solve`` bit for bit, on a jammed scene at cap 4 whose cells
    hold more than 20 members.

The CUDA kernels past K 16 and cap 64 are held to these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).  The JAX
functions run op by op (no jit): compiled whole at K 20, the solve's
unrolled 190 pairs a color took past 15 minutes on this CPU; op by op each
primitive is exact, as under jit with the package's no-contract guard.
"""

import functools

import numpy as np
import pytest
import torch

from gpu_physics_engine_tpu.ops.gs_tiled import (_memberships,
                                                 _select_occupants)
from gpu_physics_engine_tpu.ops.gs_tiled import gs_solve as j_gs_solve
from gpu_physics_engine_torch.ops import gs_kernels as gk
from gpu_physics_engine_torch.ops import gs_tiled as gt
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk
from test_torch_gs import gs_cfgs, gs_scene
from test_torch_tiled import assert_same, both_states

SMEM = 232_448  # dynamic shared memory of a block on an H100
K = 20


@pytest.mark.parametrize("k, taken", [(1, True), (16, True), (17, True),
                                      (64, True), (65, True), (0, False)])
def test_card_takes_k_up_to_64(k, taken):
    """The card takes every K from 1, 65 included (the name dates from the
    64-rank limit); it refuses 0, and a K whose tables pass the int32
    index."""
    if taken:
        gk.check_card_k(k, torch.device("cuda"))
        gk.check_card_k(k, "cuda:0", 960 * 2773)  # the 1M-GS grid
    else:
        with pytest.raises(ValueError, match=f"max_occupancy {k} outside 1 "
                                             "<= K"):
            gk.check_card_k(k, "cuda:0")
    gk.check_card_k(k, torch.device("cpu"))  # the plain versions: any K
    cells = 960 * 2773
    with pytest.raises(ValueError, match="2\\^31"):
        gk.check_card_k(2 ** 31 // cells + 1, "cuda", cells)


@pytest.mark.parametrize("mirror", ["k1", "k2", "rank", "colors"])
def test_kernel_windows_fit_a_block_at_every_cap_and_k(mirror):
    ks = (1, 8, 16, 17, 64, 65, 80, 128, 256)
    for cap in range(1, 4097):
        if mirror == "k1":
            got = [tk.k1_smem_bytes(cap, u) for u in (False, True)]
        elif mirror == "k2":
            got = [tk.k2_window_bytes(cap, p) for p in (False, True)]
        elif mirror == "rank":
            got = [gk.rank_window_bytes(cap, u, k) for u in (False, True)
                   for k in (range(1, 257) if cap % 97 == 1 else ks)]
        else:
            got = [gk.colors_window_bytes(cap, c, k) for c in range(5)
                   for k in ks]
        assert max(got) <= SMEM, (mirror, cap)
    # past these the kernels that keep no mask: K1 and the relocate window
    # past cap 64, the GS kernels past cap 64 or K 16 (no window at all)
    assert (tk.WIDE_CAP, gk.REG_K) == (64, 16)
    assert gk.rank_window_bytes(65, False) == gk.colors_window_bytes(65) == 0


@pytest.mark.parametrize("cap, K, windowed", [
    (1, 1, True), (32, 8, True), (64, 16, True), (33, 9, True),
    (65, 8, False), (64, 17, False), (128, 8, False), (256, 16, False),
    (257, 8, False), (312, 8, False), (16, 32, False), (16, 64, False),
    (16, 65, False), (4, 128, False), (520, 80, False)])
def test_gs_routes_by_cap_and_k(cap, K, windowed):
    """Up to cap 64 and K 16 the window kernels take K5 and K6; past either
    the packed rank and the ranked-slot solve, whatever the cap and K (no
    class past cap 256 or K 64 any more), and neither stages a window."""
    assert gk.windowed(cap, K) is windowed
    assert gk.rank_kernel(cap, K) == ("gs_rank_kernel" if windowed
                                      else "gs_rank_pack_kernel")
    assert gk.color_kernel(cap, K) == ("gs_colors_window_kernel" if windowed
                                       else "gs_colors_ranked_kernel")
    assert (gk.rank_window_bytes(cap, True, K) > 0) is windowed
    assert (gk.colors_window_bytes(cap, 4, K) > 0) is windowed


@pytest.mark.parametrize("cap, K", [(65, 8), (64, 17), (312, 8),
                                    (16, 80)])
def test_ranked_solve_needs_the_count_table(cap, K):
    """Past cap 64 or K 16 the solve takes each cell's rank count from
    K5's count table alone: a launch without it is refused before the
    library is loaded."""
    cfg = gs_cfgs(8, cap=cap, K=K)[1]
    x = torch.zeros((cap, 8, 8))
    src = torch.full((K, 8, 8), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="count table"):
        gk.window_cuda("gs color", x, x, src, None, cfg,
                       (8, 8, 0, 0, 0, 0), 4)


@functools.lru_cache(maxsize=None)
def _jammed():
    """The jammed scene at cap 4, K 20 in both packages."""
    jcfg, tcfg = gs_cfgs(180, cap=4, K=K)  # cells of up to 20 members
    pos, rad = gs_scene("jammed", 180, seed=2)
    return jcfg, tcfg, both_states(jcfg, tcfg, pos, rad)


def test_rank_plain_at_k20_matches_select_occupants():
    jcfg, tcfg, (a, b) = _jammed()
    t, TY, TX = tt.tile_geometry(tcfg)
    ox, oy, orad, opid, over = _select_occupants(a, _memberships(a, t), K)
    src, rpid, rrad, count = gk.rank_plain(b, tcfg)
    assert src.shape == (K, TY, TX)
    assert int(count.max()) > 16  # ranks past the register list's depth
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
    assert int(torch.clamp(count - K, min=0).sum()) == int(over)


def test_solve_plain_at_k20_bitmatches_jax():
    jcfg, tcfg, (a, b) = _jammed()
    want = j_gs_solve(a, jcfg)
    got = gt.solve_frame(b, tcfg, gk.rank_plain, gk.colors_plain)[0]
    assert_same(want, got)  # x, y bit-equal; overflow_count exact
    assert int((got.x != b.x).sum()) > 0
