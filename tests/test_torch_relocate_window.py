"""The shared memory of K2's window (csrc/tiled_kernels.cuh
``relocate_window_kernel``), through its Python mirror in
``gpu_physics_engine_torch.ops.tiled_kernels``: the bytes of a block fit
the card's 232,448 at every cap the watchdog can reach (1-256), on both
layouts.
chip_smoke.py holds the mirror equal to the launches' own numbers on the
card; the kernel's coverage of ragged grids is held there and in the
card-only tests of tests/test_torch_cuda.py (bit-equal outputs on grids
that are no multiple of a region)."""

import pytest

from gpu_physics_engine_torch.ops import tiled_kernels as tk


@pytest.mark.parametrize("par", [False, True])
def test_window_fits_a_block_at_every_cap(par):
    for cap in range(1, tk.MAX_CAP + 1):
        assert tk.k2_window_bytes(cap, par) <= 232_448, cap
    assert tk.k2_window_bytes(32, par) == 85_312
    # past cap 32 the masks are 64-bit words
    assert tk.k2_window_bytes(64, par) == 168_576
    # past cap 64 four-word masks on a 4 x 16 region (2 x 8 per parity)
    assert tk.k2_window_bytes(tk.MAX_CAP, par) == 106_752
    # the bytes grow with cap: two bytes a region tile per slot
    rows, cols = tk.K2_REGION[par][0]
    tiles = rows * cols * (4 if par else 1)
    assert (tk.k2_window_bytes(9, par)
            - tk.k2_window_bytes(8, par)) == 2 * tiles
