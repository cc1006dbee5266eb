"""K2's plain version (gpu_physics_engine_torch/ops/tiled_kernels.py) against
the JAX package's ``relocate_pallas`` in interpret mode, over every slot
matching mode and both hysteresis settings: all six fields and
overflow_count exact.  (Split from test_torch_kernels.py so the two files
run on separate test workers.)  Cap 3: the interpret-mode kernels compile
in about 60% of their cap-4 time, and the scenes still defer."""

import numpy as np
import pytest

from gpu_physics_engine_tpu.ops import tiled as jt
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk
from test_torch_kernels import j_relocate, tall
from test_torch_tiled import assert_same, both_states, scene, teleport


@pytest.mark.parametrize("match", ["flip", "flip2", "greedy"])
@pytest.mark.parametrize("hysteresis", [0.0, -1.0])
def test_k2_plain_matches_pallas(match, hysteresis):
    jcfg, tcfg = tall(tiled_match=match, tiled_hysteresis=hysteresis,
                      tile_cap=3)
    pos, rad, _ = scene(420, 23, w=16.0, h=60.0)
    a, b = both_states(jcfg, tcfg, pos, rad)
    t = jt.tile_geometry(jcfg)[0]
    a, b = teleport(a, b, np.random.default_rng(23), 0.9 * t)
    ja = j_relocate(a, jcfg)
    tb = tk.relocate_pull(b, tcfg)
    assert_same(ja, tb)
    assert int(tb.overflow_count) > 0  # the scene exercises deferral
    assert int((tb.pid >= 0).sum()) == 420
    assert tk.LAUNCHES["relocate_pull"] == 0


def test_k2_auto_match_resolves_like_jax():
    jcfg, tcfg = tall(tile_cap=3)
    cap, TY, TX = 3, *tt.tile_geometry(tcfg)[1:]
    assert tk.resolve_match(tcfg, cap, TY, TX) == "greedy"
    assert tk.resolve_match(tcfg, 9, TY, TX) == "flip2"
    assert tk.resolve_match(tcfg, 4, 1000, 1000) == "flip2"
    pos, rad, _ = scene(300, 24, w=16.0, h=60.0)
    a, b = both_states(jcfg, tcfg, pos, rad)
    a, b = teleport(a, b, np.random.default_rng(24), 1.0)
    assert_same(j_relocate(a, jcfg), tk.relocate_pull(b, tcfg))
