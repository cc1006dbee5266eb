"""The fused Gauss-Seidel route (gpu_physics_engine_torch/ops/gs_mega.py):
where the parity pipeline takes it, and what its wrappers refuse.

``gs_colors_mega`` / ``gs_relocate_mega`` send the par layout's solve and
relocate to ``gs_mega.colors_mega`` / ``relocate_mega`` under a uniform
radius, as the JAX package's gates do (gs_parity.py:447, :695); without a
uniform radius, and in the flat, mx and dec layouts, the flags change
nothing.  The fused route's results against the JAX package's parity step
are in tests/test_torch_gs_parity.py, its kernels against their plain
versions on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from gpu_physics_engine_torch import StepParams as TParams
from gpu_physics_engine_torch.ops import gs_mega as gm
from gpu_physics_engine_torch.ops import gs_parity as gp
from gpu_physics_engine_torch.ops import tiled as tt
from gpu_physics_engine_torch.ops import tiled_kernels as tk
from test_torch_gs_parity import assert_states_equal, dense_cfgs, dense_scene

MEGA = dict(gs_colors_mega=True, gs_relocate_mega=True)


def _state(**kw):
    _, tcfg = dense_cfgs(gs_layout="par", gs_fuse_integrate=True, **kw)
    pos, rad = dense_scene()
    prev = pos + np.float32(0.05)
    st = tt.init_tiles(tcfg, pos, rad, previous_positions=prev)
    return tcfg, st, TParams.make(tcfg.dt, mouse=(8.0, 4.0), pressed=True)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


def _refuse(monkeypatch, module, *names):
    for name in names:
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} was called")
        monkeypatch.setattr(module, name, refuse)


def test_mega_flags_take_the_fused_route(monkeypatch):
    """Uniform radius, par layout: per step one ``relocate_mega`` and, per
    substep, one ``colors_mega`` with the Verlet tail; no K6-par launch, no
    K2-par.  The result equals the flags-off step."""
    cfg, st, p = _state(tiled_uniform_radius=True, substeps=2)
    want = tt.tiled_step_fn(st, p, cfg)
    calls = []
    _spy(monkeypatch, gm, "colors_mega", calls)
    _spy(monkeypatch, gm, "relocate_mega", calls)
    _refuse(monkeypatch, gp, "colors_par", "relocate_par_cuda")
    got = tt.tiled_step_fn(st, p, cfg.replace(**MEGA))
    assert calls == ["relocate_mega", "colors_mega", "colors_mega"]
    assert_states_equal(want, got)


def test_mega_flags_need_a_uniform_radius(monkeypatch):
    """Without a uniform radius K6-par (one launch a solve) and K2-par run,
    as the JAX gates (``r0 is not None``, ``tiled_uniform_radius``)
    decide."""
    cfg, st, p = _state(tiled_uniform_radius=False)
    want = tt.tiled_step_fn(st, p, cfg)
    calls = []
    _spy(monkeypatch, gp, "colors_par", calls)
    _spy(monkeypatch, gp, "relocate_par_plain", calls)
    _refuse(monkeypatch, gm, "colors_mega", "relocate_mega")
    got = tt.tiled_step_fn(st, p, cfg.replace(**MEGA))
    assert calls == ["relocate_par_plain", "colors_par"]
    assert_states_equal(want, got)


@pytest.mark.parametrize("layout", ["flat", "mx", "dec"])
def test_mega_flags_change_nothing_off_the_par_layout(monkeypatch, layout):
    cfg, st, p = _state(tiled_uniform_radius=True)
    cfg = cfg.replace(gs_layout=layout)
    want = tt.tiled_step_fn(st, p, cfg)
    _refuse(monkeypatch, gm, "colors_mega", "relocate_mega")
    assert_states_equal(want, tt.tiled_step_fn(st, p, cfg.replace(**MEGA)))


def _parity_inputs(device):
    cfg, st, _ = _state(tiled_uniform_radius=True)
    ps = gp.to_parity_state(st, cfg)
    src, _, rrad, _ = gp.rank_par(ps, cfg)
    prm = TParams.make(cfg.dt).as_tensor("cpu")
    move = lambda a: a.to(device)  # noqa: E731
    ps = ps.replace(**{f: move(getattr(ps, f)) for f in
                       ("x", "y", "px", "py", "pid")})
    return cfg, st, ps, move(src), move(rrad), move(prm)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("kernel", ["colors_mega", "relocate_mega",
                                    "relocate_one"])
def test_fused_wrappers_refuse_non_cuda_tensors(kernel, device):
    """The ``*_cuda`` wrappers launch only on CUDA tensors: CPU and meta
    tensors raise before any build or launch, and nothing is counted."""
    cfg, st, ps, src, rrad, prm = _parity_inputs(device)
    before = dict(gm.LAUNCHES, **tk.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        if kernel == "colors_mega":
            gm.colors_mega_cuda(ps, src, rrad, cfg, prm)
        elif kernel == "relocate_mega":
            gm.relocate_mega_cuda(ps, cfg)
        else:
            tk.relocate_one_cuda(tt.TileState(**{
                f: getattr(st, f).to(device)
                for f in tt.FIELDS + ("num_active", "overflow_count")}), cfg)
    assert dict(gm.LAUNCHES, **tk.LAUNCHES) == before
    if device == "meta":
        with pytest.raises(RuntimeError):
            gm.relocate_mega(ps, cfg)
