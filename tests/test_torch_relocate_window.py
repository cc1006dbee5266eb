"""The shared memory of K2's window (csrc/tiled_kernels.cuh
``relocate_window_kernel`` up to cap 64, ``relocate_warp_kernel`` past
it), through its Python mirror in
``gpu_physics_engine_torch.ops.tiled_kernels``: the bytes of a block fit
the card's 232,448 at every cap 1-4,096 (past the smallest warp region's
fit, device scratch and no shared memory), on both layouts.
chip_smoke.py holds the mirror equal to the launches' own numbers on the
card; the kernel's coverage of ragged grids is held there and in the
card-only tests of tests/test_torch_cuda.py (bit-equal outputs on grids
that are no multiple of a region)."""

import pytest

from gpu_physics_engine_torch.ops import tiled_kernels as tk


@pytest.mark.parametrize("par", [False, True])
def test_window_fits_a_block_at_every_cap(par):
    for cap in range(1, 4097):
        assert tk.k2_window_bytes(cap, par) <= 232_448, cap
    assert tk.k2_window_bytes(32, par) == 85_312
    # past cap 32 the masks are 64-bit words
    assert tk.k2_window_bytes(64, par) == 168_576
    # past cap 64 the warp kernel's byte a slot, 32-bit words per 32
    # slots and int source codes on a region chosen by cap: 4 x 16 tiles
    # to the two-blocks-an-SM budget, smaller past it, scratch past 2 x 2
    assert tk.k2_warp_region(140) == (4, 16, True)
    assert tk.k2_window_bytes(140, par) == tk.k2_warp_bytes(140, 4, 16) \
        == 4 * 160 * 6 + 4 * 140 * 65 + 4 * 64 + 160 * 164
    assert tk.k2_warp_region(312)[:2] == (2, 16)
    assert tk.k2_warp_region(1000)[:2] == (2, 4)
    assert tk.k2_warp_region(2000) == (2, 2, True)
    assert tk.k2_warp_region(4096) == (4, 16, False)
    assert tk.k2_window_bytes(4096, par) == 0
    # the bytes grow with cap: two bytes a region tile per slot
    rows, cols = tk.K2_REGION[par]
    tiles = rows * cols * (4 if par else 1)
    assert (tk.k2_window_bytes(9, par)
            - tk.k2_window_bytes(8, par)) == 2 * tiles
