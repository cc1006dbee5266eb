"""Time K1, K2 and K5 against variants of their input, and the radix
sort's pieces against torch.sort, on the card.

    python -m gpu_physics_engine_torch.utils.kernel_study [--k1] [--k2]
        [--k5] [--other-lib PATH] [--radix]

prints the card's name and power limit, then one JSON line per study
(isolated launches, CUDA events around 20 calls after a warm-up, ms per
call):

* ``--k1``: K1 (``collide_integrate_cuda``) and K3 on the tuned engine's
  initial scene at ``--particles`` (default 4,194,304), and K1 on two
  variants of it that tell load traffic from pair arithmetic: "no pairs"
  (the uniform radius shrunk to 1e-3, so every candidate is loaded and
  tested but none passes the distance test) and "empty" (every pid -1:
  no candidate at all).  Whether K1 and K3 equal their plain versions
  bit for bit, and their largest difference, go into the line too.
* ``--k2``: K2 (``relocate_pull_cuda``) on the tuned engine's scene at
  ``--particles`` and K2-par (``relocate_par_cuda``) on the 1M-GS par
  scene (``gs_config(1_048_576)``), each on four states: "in_step" (the
  engine's own state after 64 steps), "jitter" (every live particle
  displaced by up to 0.6 tile), "no_movers" (the initial scene as
  ``init_tiles`` stores it: the particles at home, bar the few a full
  tile put in a neighbour) and "empty" (every pid -1).  Per state the
  ms of a call (CUDA events, twice), the device ms of each kernel it
  launches (a torch.profiler window over 10 calls: the plan and the apply
  apart where there are two launches), the particles deferred, and
  whether the kernel equals its plain version bit for bit (on the
  jittered state).  K4 (``relocate_one_cuda``) beside K2 and relocate_mega
  (``gs_mega.relocate_mega_cuda``) beside K2-par on the same four states:
  the same window kernel with K4's step rule, and over all four parities.
* ``--k5``: K5 (``gs_kernels.rank_cuda``) on the 1M-GS flat engine's
  scene and K5-par (``gs_parity.rank_par_cuda``, one launch over all
  parities) on the par engine's, each on three states: "initial" (the
  seeded scene, as ``chip_smoke.py`` times it), "in_step" (the engine's
  state after 64 steps, as the step finds it) and "empty" (every pid -1:
  the pid plane staged and the fill written, no candidate); per state the
  ms of a call, the device ms from the profiler, the bound (the pid plane
  and the occupants' x, y, radius read, the tables and the count written,
  at 3.35 TB/s) and whether the kernel equals its plain version bit for
  bit.
* ``--other-lib PATH`` (another build of the kernel library, such as an
  earlier commit's ``_build/*.so``): with ``--k2`` and ``--k5`` every
  kernel above is also timed through that build in one process on the
  same inputs, in turns (this build, the other, the other, this): their
  entry points are the same in both, so a difference is the kernels'.
* ``--radix``: the array Engine's 1M scene (the README's example) and its
  4,403,200 pair keys: ``torch.sort(stable=True)`` of the keys with the
  payload gathered, the hand ``radix_sort_pairs``, and its pieces (one
  pass each of K12, ``radix_offsets`` and ``radix_scatter``, and the
  int64 <-> int32 conversions), then the device time of each kernel of
  the hand sort from a torch.profiler window over 10 sorts (isolated
  pieces are paced by the host where a launch is shorter than its
  enqueue); the hand sort is checked equal to torch.sort first.

Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from gpu_physics_engine_torch.utils.profiling import cuda_ms


def k1_study(particles: int) -> dict:
    import torch
    from gpu_physics_engine_torch import StepParams, make_tuned_engine
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    e = make_tuned_engine(particles, device="cuda")
    cfg, st = e.config, e.state
    prm = StepParams.make(cfg.dt).as_tensor("cuda")
    out = {"study": "k1", "particles": particles, "dims": list(st.dims)}
    for name, kern, plain, fields in (
            ("collide_integrate",
             lambda: tk.collide_integrate_cuda(st, prm, cfg),
             lambda: tk.collide_integrate_plain(st, prm, cfg),
             ("x", "y", "px", "py")),
            ("collide", lambda: tk.collide_cuda(st, cfg),
             lambda: tk.collide_plain(st, cfg), ("x", "y"))):
        a, b = kern(), plain()
        out[f"{name}_bit_equal"] = all(
            torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
        out[f"{name}_max_abs_err"] = max(
            float((getattr(a, f) - getattr(b, f)).abs().max())
            for f in fields)
    no_pairs = cfg.replace(initial_radius=1e-3)
    empty = st.replace(pid=torch.full_like(st.pid, -1))
    for name, fn in (
            ("k1", lambda: tk.collide_integrate_cuda(st, prm, cfg)),
            ("k1_no_pairs",
             lambda: tk.collide_integrate_cuda(st, prm, no_pairs)),
            ("k1_empty", lambda: tk.collide_integrate_cuda(empty, prm, cfg)),
            ("k3", lambda: tk.collide_cuda(st, cfg))):
        out[name] = [cuda_ms(fn), cuda_ms(fn)]
    return out


def _jittered(state, scale, seed):
    """``state`` with live x/y displaced by up to +-scale (on the card)."""
    import torch
    g = torch.Generator(device=state.device).manual_seed(seed)
    occ = state.pid >= 0
    d = [(torch.rand(state.x.shape, generator=g, device=state.device) - 0.5)
         * 2 * scale for _ in range(2)]
    return state.replace(x=torch.where(occ, state.x + d[0], state.x),
                         y=torch.where(occ, state.y + d[1], state.y))


def _k2_states(engine, steps: int) -> dict:
    """The four states of ``--k2`` in full space, from ``engine``."""
    import torch
    from gpu_physics_engine_torch.ops import tiled
    start = engine.state
    t = tiled.tile_geometry(engine.config)[0]
    states = {"jitter": _jittered(start, 0.6 * t, seed=1),
              "no_movers": start,
              "empty": start.replace(pid=torch.full_like(start.pid, -1))}
    engine.run(steps)
    states["in_step"] = engine.state
    return states


def _relocate_rows(fn, check) -> dict:
    out = {"ms": [cuda_ms(fn), cuda_ms(fn)],
           "device_ms": kernel_device_ms(fn, 10),
           "deferred": int(fn()[1].sum())}
    if check is not None:
        out["bit_equal"] = check()
    return out


def _other_library(path: str):
    """Another build of the kernel library, its entry points typed as this
    tree's (those it has)."""
    import ctypes
    from gpu_physics_engine_torch.ops import _cuda
    lib = ctypes.CDLL(path)
    for name, argtypes in _cuda._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _through(lib, fn):
    """``fn`` with the kernel wrappers bound to ``lib`` while it runs."""
    from gpu_physics_engine_torch.ops import _cuda

    def call():
        own = _cuda.library
        _cuda.library = lambda: lib
        try:
            return fn()
        finally:
            _cuda.library = own
    return call


def _turns(rows, fn, other) -> dict:
    """``rows(fn)``; with ``other`` also through the other build, in turns:
    {"this": [row, row], "other": [row, row]}."""
    if other is None:
        return rows(fn)
    theirs = _through(other, fn)
    a, b, c, d = (rows(f) for f in (fn, theirs, theirs, fn))
    return {"this": [a, d], "other": [b, c]}


def _same(a, b, fields) -> bool:
    import torch
    return all(torch.equal(getattr(a[0], f), getattr(b[0], f))
               for f in fields) and torch.equal(a[1], b[1])


def k2_study(particles: int, other=None) -> dict:
    import torch
    from gpu_physics_engine_torch import TiledEngine, make_tuned_engine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    out = {"study": "k2", "particles": particles}
    e = make_tuned_engine(particles, device="cuda")
    cfg = e.config
    out["k2_dims"] = list(e.state.dims)
    fields = ("x", "y", "px", "py", "radius", "pid")
    for name, st in _k2_states(e, 64).items():
        for tag, kern, plain in (
                ("k2", tk.relocate_pull_cuda, tk.relocate_pull_plain),
                ("k4", tk.relocate_one_cuda, tk.relocate_one_plain)):
            check = None
            if name == "jitter":
                check = lambda: _same(  # noqa: E731
                    kern(st, cfg), plain(st, cfg), fields)
            out[f"{tag}_{name}"] = _turns(
                lambda f: _relocate_rows(f, check),
                lambda: kern(st, cfg), other)
    del e, st
    torch.cuda.empty_cache()
    e = TiledEngine(gs_config(1_048_576, gs_layout="par"), seed=0, chunk=64,
                    device="cuda")
    cfg = e.config
    fields = ("x", "y", "px", "py", "pid")
    for name, st in _k2_states(e, 64).items():
        ps = gp.to_parity_state(st, cfg)
        out["k2_par_dims"] = list(ps.x.shape)
        for tag, kern in (("k2_par", gp.relocate_par_cuda),
                          ("mega", gm.relocate_mega_cuda)):
            check = None
            if name == "jitter":
                check = lambda: _same(  # noqa: E731
                    kern(ps, cfg), gp.relocate_par_plain(ps, cfg), fields)
            out[f"{tag}_{name}"] = _turns(
                lambda f: _relocate_rows(f, check),
                lambda: kern(ps, cfg), other)
    return out


def _rank_bound_ms(pid, occupied: int, K: int, radius: bool) -> float:
    """K5's bound: the pid plane and the occupants' x, y (radius) read,
    three K-deep tables and the count written, at 3.35 TB/s."""
    cells = pid.numel() // pid.shape[-3]
    nbytes = (pid.numel() * 4 + occupied * (12 if radius else 8)
              + (3 * K + 1) * cells * 4)
    return nbytes / 3.35e12 * 1e3


def k5_study(other=None) -> dict:
    import torch
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    out = {"study": "k5", "particles": 1_048_576}
    for layout in ("flat", "par"):
        e = TiledEngine(gs_config(1_048_576, gs_layout=layout), seed=0,
                        chunk=64, device="cuda")
        cfg, K = e.config, e.config.max_occupancy
        states = {"initial": e.state,
                  "empty": e.state.replace(pid=torch.full_like(e.state.pid,
                                                               -1))}
        e.run(64)
        states["in_step"] = e.state
        for name, st in states.items():
            occupied = int((st.pid >= 0).sum())
            if layout == "flat":
                tag, arg = "k5", st
                kern = lambda a: gk.rank_cuda(a, cfg)  # noqa: E731
                plain = lambda a: gk.rank_plain(a, cfg)  # noqa: E731
                bound = _rank_bound_ms(st.pid, occupied, K, True)
                out["k5_dims"] = list(st.dims)
            else:
                tag, arg = "k5_par", gp.to_parity_state(st, cfg)
                kern = lambda a: gp.rank_par_cuda(a, cfg)  # noqa: E731
                plain = lambda a: gp.rank_par_plain(a, cfg)  # noqa: E731
                bound = _rank_bound_ms(arg.pid, occupied, K,
                                       arg.radius is not None)
                out["k5_par_dims"] = list(arg.x.shape)

            def rows(fn):
                return {"ms": [cuda_ms(fn), cuda_ms(fn)],
                        "device_ms": kernel_device_ms(fn, 10)}
            out[f"{tag}_{name}"] = _turns(rows, lambda: kern(arg), other)
            out[f"{tag}_{name}_bound_ms"] = bound
            out[f"{tag}_{name}_bit_equal"] = all(
                torch.equal(u, v) for u, v in zip(kern(arg), plain(arg)))
        del e, states, st, arg
        torch.cuda.empty_cache()
    return out


def radix_study() -> dict:
    import torch
    from gpu_physics_engine_torch import Engine, SimConfig
    from gpu_physics_engine_torch.core import stepper
    from gpu_physics_engine_torch.ops import grid
    from gpu_physics_engine_torch.ops import radix_sort as rs
    e = Engine(SimConfig(max_particles=1_100_000, initial_particles=1_000_000,
                         sort_impl="radix"), seed=0, device="cuda")
    st = e.state
    cand = grid.build_candidates(st.x, st.y, st.radius, st.active_mask(),
                                 stepper.cell_size(e.config, st))
    keys, obj = grid.build_cell_ids(cand)
    n = keys.shape[0]

    def lib_sort():
        sk, idx = torch.sort(keys, stable=True)
        return sk, obj[idx]

    sk, sv = rs.radix_sort_pairs(keys, obj)
    wk, wv = lib_sort()
    if not (torch.equal(sk, wk) and torch.equal(sv, wv)):
        raise AssertionError("radix sort != torch.sort(stable=True)")
    bits = rs.as_i32_bits(keys)  # n is a BLOCK multiple here: no padding
    rank, hist = rs.rank_hist_cuda(bits, 0)
    offset = rs.digit_offsets_cuda(hist)
    out = {"study": "radix", "keys": n, "blocks": n // rs.BLOCK}
    for name, fn in (
            ("torch_sort", lib_sort),
            ("radix_sort_pairs", lambda: rs.radix_sort_pairs(keys, obj)),
            ("rank_hist", lambda: rs.rank_hist_cuda(bits, 0)),
            ("radix_offsets", lambda: rs.digit_offsets_cuda(hist)),
            ("radix_scatter", lambda: rs.scatter_cuda(bits, obj, rank, hist,
                                                      offset, 0)),
            ("as_i32_bits", lambda: rs.as_i32_bits(keys)),
            ("from_i32_bits", lambda: rs.from_i32_bits(bits))):
        out[name] = [cuda_ms(fn), cuda_ms(fn)]
    out["in_sort_device_ms"] = kernel_device_ms(lambda: rs.radix_sort_pairs(
        keys, obj), 10)
    return out


def kernel_device_ms(fn, reps: int) -> dict:
    """Device ms per call of ``fn`` for each kernel it launches (a
    torch.profiler window over ``reps`` calls, CUDA activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gpu_physics_engine_torch.utils.profiling import _device_us
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            rows[evt.key.split("(")[0][:60]] = us / 1e3 / reps
    rows["total"] = sum(rows.values())
    return rows


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--k5", action="store_true")
    ap.add_argument("--other-lib", default=None,
                    help="with --k2 and --k5: time the kernels through "
                         "this build of the kernel library too, in turns")
    ap.add_argument("--radix", action="store_true")
    ap.add_argument("--particles", type=int, default=4_194_304)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.k1:
        print(json.dumps(k1_study(args.particles)), flush=True)
    other = _other_library(args.other_lib) if args.other_lib else None
    if args.k2:
        print(json.dumps(k2_study(args.particles, other)), flush=True)
    if args.k5:
        print(json.dumps(k5_study(other)), flush=True)
    if args.radix:
        print(json.dumps(radix_study()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
