"""Time K1, K2, K5 and K6 against variants of their input or of their
build, and the radix sort (its kernels, the parent's) against torch.sort,
on the card.

    python -m gpu_physics_engine_torch.utils.kernel_study [--k1] [--k2]
        [--k5] [--other-lib PATH] [--k6 [--parent DIR]] [--gs-wide]
        [--gs-dense] [--radix]

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
  earlier commit's ``_build/*.so``): with ``--k1``, ``--k2`` and ``--k5``
  every kernel above is also timed through that build in one process on
  the same inputs, in turns (this build, the other, the other, this):
  their entry points are the same in both, so a difference is the
  kernels'.
* ``--k6``: K6's color window (``gs_colors_window_kernel``) on the 1M-GS
  and 4M-GS scenes, one solve through each route: "flat" (``colors_cuda``
  on K5's tables), "par" (``colors_par_cuda`` with the Verlet tail, no
  radius table) and "mega" (``colors_mega_cuda``), on the seeded scene
  ("initial") and on the engines' states after 64 steps ("in_step"); also
  the window with no color and no tail ("write_only": the stage and the
  copy of every slot) and, on par, its four colors and its tail alone.
  Beside it, in turns (in order, then in reverse), the builds of
  ``K6_VARIANTS`` (this tree's sources with its tunables overridden by
  ``-D``: block size, launch bounds, regions) and, with ``--parent DIR``
  (a checkout of the parent commit, e.g. an unpacked ``git archive`` in a
  git-ignored directory), the parent's kernels built from DIR: its four
  per-color K6 launches (and the Verlet tail on par), its cooperative
  colors_mega, and its per-color K6 with the K source codes loaded as one
  batch ("parent_batched").  Per row the ms of a call (CUDA events, twice)
  and the device ms per kernel from the profiler; each build's registers
  and spills from ptxas.
* ``--k5 --k6 --gs-wide`` (either or both): instead of the 1M-GS scenes,
  the GS engine's wide cells (``GS_WIDE``: GS-cap128, GS-K32 and
  GS-cap312, chip_smoke.py's states): K5 and K5-par (``--k5``), and K6
  flat, K6-par with the tail and colors_mega, each with the rank's count
  table (``--k6``); per row the ms of a call, with ``--other-lib PATH``
  (the parent's build) through that build too in turns, whether it
  equals this build's result bit for bit, and this build's device ms per
  kernel; the bounds (the ranked work alone, and with the planes the
  out-of-place solve writes); and the engines' ms/step in the flat, par
  and mega layouts, in turns, with the device ms per kernel a step.  A
  parent from before the ranked-slot solve is called with its scratch
  planes (``_ScratchColors``).
* ``--k5 --gs-dense``: the packed rank's two ways for a window of more
  than 256 occupants (``GS_DENSE``: caps 128 at K 8 and 32, particles
  spread at 1.5, 3 and 6 a tile, flat and parity): a warp a cell on the
  occupants packed in shared memory (the default buffer) against a warp
  a cell streamed from device memory (a buffer of 256 occupants); per
  state the windows' occupants (how many take each way), the ms of a call
  each, in turns, and whether the two are bit-equal.
* ``--radix``: the array Engine's 1M scene (the README's example) and its
  4,403,200 pair keys: ``torch.sort(stable=True)`` of the keys with the
  payload gathered and the hand ``radix_sort_pairs`` (one
  ``radix_digit_hist_kernel`` and four ``radix_onesweep_kernel``
  launches), in turns, each checked equal to torch.sort first; with
  ``--other-lib PATH`` (the parent commit's build, e.g. from an unpacked
  ``git archive`` under ``.archive_check/``) also the parent's sort, its
  three kernels a pass called through that build (``parent_radix_sort``);
  then the device time of each kernel of each sort from a torch.profiler
  window over 10 sorts (the hand sort's passes apart: pass 0 reads int64
  keys, pass 3 writes them).

* ``--wide``: the wide-cap states the engine paths reach (4M-retile, cap
  140; 1M-spawn-ready, cap 144; 1M-retile, cap 52; 1M-cap36; 1M-r5-cap312,
  cap 312; each after its spawn and 8 steps; GS-cap128's parity state):
  K1 on each, this build's default and its packed kernel under the plans
  of ``K1_PLANS`` (region, shared bytes), in turns (in order,
  then in reverse), and K2 (K2-par and relocate_mega on GS-cap128) on
  each jittered by 0.3 tile; with ``--other-lib PATH`` (the parent's
  build) every kernel of this build also through that one, in turns;
  each of this build's kernels bit-equal to its plain version first.
* ``--steps``: ms/step of the 4M engine (``make_tuned_engine``) and the
  1M-GS engine in the par layout, 64-step ``run()`` windows (CUDA events)
  after 16 warm-up steps; with ``--other-lib PATH`` through that build
  too, in turns (this, the other, the other, this, twice).
* ``--ptxas [DIR]``: the registers, stack frame and spills ptxas reports
  for this tree's K1, relocate and GS kernels (and, with DIR, another
  checkout's: e.g. the parent's four-word instantiations).  Needs no card.
* ``--sass DIR`` (a checkout of another commit, e.g. an unpacked ``git
  archive`` of the parent in a git-ignored directory): this tree's kernel
  library and one built from DIR's ``gpu_physics_engine_torch/csrc``,
  their SASS (``cuobjdump -sass``, each line's tokens) compared function
  by function: every kernel instantiation both builds hold is listed as
  identical or not, and those only one holds are counted.  Needs no
  card, only nvcc.

Without a CUDA device it exits non-zero (``--sass`` alone excepted).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

from gpu_physics_engine_torch.utils.profiling import cuda_ms


def k1_study(particles: int, other=None) -> dict:
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
        out[name] = _turns(lambda f: [cuda_ms(f), cuda_ms(f)], fn, other)
    return out


def jittered(state, scale, seed):
    """``state`` with live x/y displaced by up to +-scale, drawn from a
    generator on the state's device seeded with ``seed`` (chip_smoke.py
    and the studies here take their in-step stand-ins from it)."""
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
    states = {"jitter": jittered(start, 0.6 * t, seed=1),
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
    tree's (those it has).  A build from before the ranked-slot solve
    (no ``gpe_gs_route``) takes K6's scratch planes instead of the count
    table: ``_ScratchColors`` calls it with this tree's arguments."""
    import ctypes
    from gpu_physics_engine_torch.ops import _cuda
    lib = ctypes.CDLL(path)
    old = not hasattr(lib, "gpe_gs_route")
    for name, argtypes in _cuda._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    if old:
        lib.gpe_gs_colors_window.argtypes = [ctypes.c_void_p] * 12 + [
            ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
        return _ScratchColors(lib)
    return lib


class _ScratchColors:
    """A library whose ``gpe_gs_colors_window`` takes two scratch planes
    (sx, sy: its one-color launches at caps 65-256) where this tree's
    takes the count table: the call with this tree's arguments allocates
    them, as that tree's wrapper did, and drops the count."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def gpe_gs_colors_window(self, x, y, px, py, pid, src, rrad, count, prm,
                             ox, oy, cap, TY, TX, DY, DX, origin, par, K,
                             c1, r0, stiffness, integ, consts, stream):
        import torch
        sx = sy = None
        if 64 < cap <= 256 and K <= 64 and c1 > 1:
            n = 4 * cap * DY * DX if par else cap * TY * TX
            sx, sy = (torch.empty(n, dtype=torch.float32, device="cuda")
                      for _ in range(2))
        ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
        return self._lib.gpe_gs_colors_window(
            x, y, px, py, pid, src, rrad, prm, ox, oy, ptr(sx), ptr(sy),
            cap, TY, TX, DY, DX, origin, par, K, c1, r0, stiffness, integ,
            consts, stream)


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


def _equal(a, b, fields) -> bool:
    """Two states' ``fields`` bit-equal."""
    import torch
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


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


# --k5/--k6 --gs-wide: the GS engine's wide cells, chip_smoke.py's
# _gs_wide states: tag -> (cap, K)
GS_WIDE = {"GS-cap128": (128, 8), "GS-K32": (16, 32), "GS-cap312": (312, 8)}


def _gs_wide_config(cap: int, K: int, layout: str = "flat"):
    """The GS config at ``cap`` and ``K`` on 262,144 particles over 1524 x
    524 (the 1M-GS density) in ``layout`` ("mega": par with both fused
    kernels), as chip_smoke.py's _gs_wide sets it."""
    from gpu_physics_engine_torch.core.tuned import gs_config
    kw = dict(world_width=1524.0, world_height=524.0, tile_cap=cap,
              max_occupancy=K)
    if layout == "mega":
        return gs_config(262_144, gs_layout="par", gs_colors_mega=True,
                         gs_relocate_mega=True, **kw)
    return gs_config(262_144, gs_layout=layout, **kw)


def _gs_wide_state(cap: int, K: int):
    """(config, state): the flat GS engine at ``cap`` and ``K`` one flat
    frame from the seeded scene, as chip_smoke.py's _gs_wide starts its
    paths."""
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.ops import tiled
    cfg = _gs_wide_config(cap, K)
    seed = TiledEngine(cfg, seed=0, chunk=64, device="cuda")
    return cfg, tiled.tiled_step_fn(seed.state, seed.params(), cfg)


def _gs_wide_steps(cap: int, K: int, start, libs: dict) -> dict:
    """Per layout (flat, par, mega) the engine from ``start`` after 8
    steps: ms/step over 16-step windows (CUDA events) through this build
    and each of ``libs``, in turns (in order, then in reverse), and this
    build's device ms per kernel a step (the profiler, 8 steps)."""
    import torch
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.ops import tiled
    out = {}
    for layout in ("flat", "par", "mega"):
        e = TiledEngine(_gs_wide_config(cap, K, layout), chunk=64,
                        initial_state=start.replace(
                            **{f: getattr(start, f).clone()
                               for f in tiled.FIELDS}))
        e.run(8)
        fns = {"this": lambda: e.run(16)}
        fns.update({k: _through(lib, fns["this"]) for k, lib in libs.items()})
        order = list(fns)
        ms = {k: [] for k in fns}
        for k in order + order[::-1]:
            ms[k].append(cuda_ms(fns[k], reps=1, warmup=0) / 16)
        out[layout] = {"ms_per_step": ms,
                       "device_ms_per_step": kernel_device_ms(
                           lambda: e.run(1), 8)}
        del e
        torch.cuda.empty_cache()
    return out


def _gs_wide_bounds(cfg, st, ps, count, pcount, src) -> dict:
    """Least ms at 3.35 TB/s of the wide cells' GS functions: the ranks
    (the pid plane and the occupants' x, y, radius read, the tables and the
    count written) and the solves two ways: the ranked work alone (each
    valid rank's code, and radius where a table is read; the named slots'
    x, y read and written; on par and mega the tail's pid plane and the
    occupants' px, py read and written too) and with the planes the
    out-of-place contract writes (every slot's x, y read and ox, oy
    written)."""
    import torch
    from gpu_physics_engine_torch.ops import gs_tiled as gt
    K = cfg.max_occupancy
    cap, TY, TX = st.dims
    occ = int((st.pid >= 0).sum())
    slots = float(st.pid.numel())
    ranks = float(torch.clamp(count, max=K).sum())
    pranks = float(torch.clamp(pcount, max=K).sum())
    ty = torch.arange(TY, device=src.device).view(1, TY, 1)
    tx = torch.arange(TX, device=src.device).view(1, 1, TX)
    idx, valid = gt.source_index(src, cap, TY, TX, ty, tx)
    named = float(torch.unique(idx[valid]).numel())
    pslots = float(ps.pid.numel())
    ms = lambda b: b / 3.35e12 * 1e3  # noqa: E731
    tail = 4 * pslots + 16 * occ
    return {
        "rank": _rank_bound_ms(st.pid, occ, K, True),
        "rank_par": _rank_bound_ms(ps.pid, occ, K, ps.radius is not None),
        "color": {"ranked": ms(8 * ranks + 16 * named),
                  "contract": ms(16 * slots + 8 * ranks)},
        "color_par": {"ranked": ms(4 * pranks + 16 * named + tail),
                      "contract": ms(16 * pslots + 4 * pranks + tail)},
        "occupied": occ, "ranks": ranks, "named_slots": named}


def gs_wide_study(others: dict, rank: bool = True, colors: bool = True
                  ) -> dict:
    """K5 and K5-par (``rank``) and K6 flat, K6-par with the tail and
    colors_mega (``colors``, each with the rank's count table as the main
    path passes it) on the GS_WIDE states: the ms of a call (CUDA events)
    through this build and each of ``others`` ({name: library}, e.g. the
    parent's build as "other"), in turns (in order, then in reverse);
    whether each build's result equals this one's bit for bit (from fresh
    copies of the tail's px, py); the device ms per kernel of this build
    (the profiler); the bounds (``_gs_wide_bounds``); and the engines'
    steps in the three layouts (``_gs_wide_steps``)."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    libs = dict(others)
    out = {"study": "gs_wide", "builds": ["this"] + list(libs)}
    for tag, (cap, K) in GS_WIDE.items():
        cfg, st = _gs_wide_state(cap, K)
        ps = gp.to_parity_state(st, cfg)
        src, _, rrad, count = gk.rank_cuda(st, cfg)
        psrc, _, prrad, pcount = gp.rank_par_cuda(ps, cfg)
        prm = StepParams.make(cfg.dt, mouse=(0.5 * cfg.world_width,
                                             0.5 * cfg.world_height),
                              pressed=True).as_tensor("cuda")
        calls = {}  # name -> a factory of calls on fresh px, py
        if rank:
            calls["rank"] = lambda: lambda: gk.rank_cuda(st, cfg)
            calls["rank_par"] = lambda: lambda: gp.rank_par_cuda(ps, cfg)
        if colors:
            calls["color"] = lambda: lambda: gk.colors_cuda(
                st.x, st.y, src, rrad, cfg, count=count)

            def par():
                t = (ps.px.clone(), ps.py.clone(), ps.pid, prm)
                return lambda: gp.colors_par_cuda(
                    ps.x, ps.y, psrc, prrad, cfg, ps.geo, 4, t,
                    uniform=ps.radius is None, count=pcount) + t[:2]

            def mega():
                m = ps.replace(px=ps.px.clone(), py=ps.py.clone())
                return lambda: gm.colors_mega_cuda(m, psrc, prrad, cfg, prm,
                                                   pcount)
            calls["color_par"], calls["colors_mega"] = par, mega
        rows = {}
        for name, make in calls.items():
            fns = {"this": make()}
            for lname, lib in libs.items():
                fns[lname] = _through(lib, make())
            order = list(fns)
            ms = {k: [] for k in fns}
            for k in order + order[::-1]:
                ms[k].append(cuda_ms(fns[k]))
            ref = [t.clone() for t in _result_tensors(make()())]
            equal = {k: all(torch.equal(u, v) for u, v in zip(
                ref, _result_tensors(_through(libs[k], make())())))
                for k in fns if k != "this"}
            rows[name] = {"ms": ms, "equal_to_this": equal,
                          "device_ms": kernel_device_ms(fns["this"], 10)}
        steps = _gs_wide_steps(cap, K, st, libs)
        out[tag] = {"cap": cap, "K": K, "dims": list(st.dims),
                    "par_dims": list(ps.x.shape), "rows": rows,
                    "steps": steps,
                    "rank_kernel": gk.rank_kernel(cap, K),
                    "color_kernel": gk.color_kernel(cap, K),
                    "bounds_ms": _gs_wide_bounds(cfg, st, ps, count, pcount,
                                                 src)}
        del st, ps, src, rrad, count, psrc, prrad, pcount, calls
        torch.cuda.empty_cache()
    return out


# --k5 --gs-dense: the packed rank past 256 occupants a window, packed
# or streamed; tag -> (cap, K), and the particles a tile
GS_DENSE = {"cap128-K8": (128, 8), "cap128-K32": (128, 32)}
GS_DENSE_FILL = (1.5, 3.0, 6.0)
GS_PACK_THREAD_MAX = 256  # csrc/gs_simple.cuh kGsPackThreadMax


def _gs_dense_state(cap: int, K: int, fill: float, seed: int):
    """(config, state): GS_WIDE's config at ``cap`` and ``K`` (the
    [480, 1388] grid) holding ``fill`` x TY x TX particles at seeded
    uniform positions, so that a packed-rank window (8 x 32 tiles) holds
    about 256 x ``fill`` occupants."""
    import numpy as np
    from gpu_physics_engine_torch.ops import tiled
    cfg = _gs_wide_config(cap, K)
    _, TY, TX = tiled.tile_geometry(cfg)
    n = int(fill * TY * TX)
    cfg = cfg.replace(max_particles=n, initial_particles=n)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.6, [cfg.world_width - 0.6, cfg.world_height - 0.6],
                      (n, 2)).astype(np.float32)
    rad = np.full(n, cfg.initial_radius, np.float32)
    return cfg, tiled.init_tiles(cfg, pos, rad, device="cuda")


def _window_occupants(st):
    """The occupants of each packed-rank block's window on the flat
    layout: its 6 x 30 region and the one-tile ring."""
    import torch
    occ = (st.pid >= 0).sum(0).float()[None, None]
    _, TY, TX = st.dims
    by, bx = -(-TY // 6), -(-TX // 30)
    occ = torch.nn.functional.pad(occ, (1, 30 * bx + 1 - TX,
                                        1, 6 * by + 1 - TY))
    return torch.nn.functional.avg_pool2d(occ, (8, 32), (6, 30)
                                          ).flatten() * 256


def gs_dense_study() -> dict:
    """The packed rank's windows of more than 256 occupants ranked a warp
    a cell on the packed occupants (the default buffer of 2,048) or
    streamed from device memory (``rank_pack_cuda`` with a buffer of
    GS_PACK_THREAD_MAX), on the GS_DENSE states, flat and parity (all
    four parities): how many windows take each way, the ms of a call
    (CUDA events) each in turns (in order, then in reverse), and whether
    the two results are bit-equal."""
    import torch
    from gpu_physics_engine_torch.ops import gs_parity as gp
    out = {"study": "gs_dense"}
    for tag, (cap, K) in GS_DENSE.items():
        for i, fill in enumerate(GS_DENSE_FILL):
            cfg, st = _gs_dense_state(cap, K, fill, seed=i)
            w = _window_occupants(st)
            row = {"dims": list(st.dims), "occupied": int((st.pid >= 0).sum()),
                   "windows": {
                       "thread": int((w <= GS_PACK_THREAD_MAX).sum()),
                       "packed_warp": int(((w > GS_PACK_THREAD_MAX)
                                           & (w <= 2048)).sum()),
                       "streamed": int((w > 2048).sum())},
                   "max_window": int(w.max())}
            ps = gp.to_parity_state(st, cfg)
            for layout, s in (("flat", st), ("par", ps)):
                fns = {"packed": lambda s=s: rank_pack_cuda(s, cfg, 0),
                       "streamed": lambda s=s: rank_pack_cuda(
                           s, cfg, GS_PACK_THREAD_MAX)}
                order = list(fns)
                ms = {k: [] for k in fns}
                for k in order + order[::-1]:
                    ms[k].append(cuda_ms(fns[k]))
                equal = all(torch.equal(u, v) for u, v in zip(
                    fns["packed"](), fns["streamed"]()))
                row[layout] = {"ms": ms, "equal": equal}
            out[f"{tag}-fill{fill}"] = row
            del st, ps
            torch.cuda.empty_cache()
    return out


def _result_tensors(r) -> list:
    """The tensors of a wrapper's result (a tuple, or a state's fields)."""
    import torch
    if isinstance(r, torch.Tensor):
        return [r]
    if isinstance(r, (tuple, list)):
        return [t for v in r for t in _result_tensors(v)]
    return [getattr(r, f) for f in ("x", "y", "px", "py")]


# --k6: the color window against the parent's kernels and its variants

# builds of this tree's sources with the window's tunables overridden
# (csrc/gs_kernels.cuh GPE_GSW_THREADS, GPE_GSW_MINB: the launch bounds'
# blocks an SM, and GPE_GSW_RY<c>/RX<c>: the region of the class c of caps
# <= 4, 8, 16, 32)
K6_VARIANTS = {
    "threads256": ("GPE_GSW_THREADS=256",),
    "minblocks1": ("GPE_GSW_MINB=1",),
    "regions_16x64_8x64": ("GPE_GSW_RY0=16", "GPE_GSW_RX0=64",
                           "GPE_GSW_RY1=8", "GPE_GSW_RX1=64"),
    "regions_24x48_24x32": ("GPE_GSW_RY0=24", "GPE_GSW_RY1=24"),
}

# the parent's per-color K6 loads rank q only once rank q - 1 proved valid
# (csrc/gs_kernels.cuh gs_color_cell); the "batched" build loads the K
# codes as one batch, then the valid ranks' slots
_CHAIN = """    if (q < K && q == nv) {
      const int tq = lay.at(q, K, ty, tx);
      const int code = src[tq];
      if (code >= 0) {
        const int j = code / cap;
        const int s = code - j * cap;
        const int at = lay.at(s, cap, ty + j / 3 - 1, tx + j % 3 - 1);
        slot[q] = at;
        lx[q] = x[at];
        ly[q] = y[at];
        lr[q] = rrad[tq];
        nv = q + 1;
      }
    }
  }
"""
_BATCHED = """    code[q] = q < K ? src[lay.at(q, K, ty, tx)] : -1;
  }
#pragma unroll
  for (int q = 0; q < KMAX; ++q)
    if (q == nv && code[q] >= 0) nv = q + 1;
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    if (q < nv) {
      const int j = code[q] / cap;
      const int s = code[q] - j * cap;
      const int at = lay.at(s, cap, ty + j / 3 - 1, tx + j % 3 - 1);
      slot[q] = at;
      lx[q] = x[at];
      ly[q] = y[at];
      lr[q] = rrad[lay.at(q, K, ty, tx)];
    }
  }
"""

# the parent's entry points (this tree has the window's instead)
_PARENT_SIGNATURES = {
    "gpe_gs_color": ["p"] * 4 + ["i"] * 5 + ["f", "p"],
    "gpe_gs_color_par": ["p"] * 4 + ["i"] * 8 + ["f", "p"],
    "gpe_gs_verlet": ["p"] * 6 + ["i", "p", "p"],
    "gpe_gs_colors_mega": ["p"] * 8 + ["i"] * 7 + ["f", "i", "p", "p"],
}


def _build_from(csrc: str, out_dir: str, patch: bool,
                want_log: bool = False) -> str:
    """Build the kernel library from another tree's ``csrc`` into
    ``out_dir`` (with ``patch``: the parent's K6 with batched loads).
    Returns the library's path (``want_log``: nvcc's output)."""
    import os
    import shutil
    from pathlib import Path
    from gpu_physics_engine_torch.ops import _cuda
    os.makedirs(out_dir, exist_ok=True)
    src = Path(out_dir) / "csrc"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(csrc, src)
    if patch:
        f = src / "gs_kernels.cuh"
        text = f.read_text()
        if _CHAIN not in text:
            raise RuntimeError("the parent's gs_color_cell chain not found")
        text = text.replace(_CHAIN, _BATCHED).replace(
            "  int slot[KMAX];\n  float lx[KMAX], ly[KMAX], lr[KMAX];",
            "  int slot[KMAX], code[KMAX];\n"
            "  float lx[KMAX], ly[KMAX], lr[KMAX];")
        f.write_text(text)
    nvcc = _cuda._nvcc()
    cus = sorted(src.glob("*.cu"))
    objs = [os.path.join(out_dir, c.stem + ".o") for c in cus]
    log = _cuda._run_all([nvcc, *_cuda.NVCC_FLAGS, "-c", str(c), "-o", o]
                         for c, o in zip(cus, objs))
    so = os.path.join(out_dir, "lib.so")
    _cuda._run_all([[nvcc, *_cuda.ARCH, "-shared", "-o", so, *objs]])
    return log if want_log else so


def _window_ptxas(log: str) -> dict:
    """{kernel instance: "N registers ...; S bytes stack frame ..."} of the
    window kernels in an nvcc -Xptxas -v log."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"gs_colors_window_kernelILi(\d+)ELi(\d)ENS_\d+"
                          r"(Flat|Par)Layout", line)
            name = f"K{m.group(1)}-class{m.group(2)}-{m.group(3)}" if m \
                else None
        elif name and "Used" in line:
            out[name] = line.split(":", 1)[1].strip() + "; " + out.get(
                name, "")
        elif name and "spill" in line:
            out[name] = out.get(name, "") + line.strip()
    return out


PTXAS_KERNELS = ("collide_integrate", "relocate_window", "relocate_warp",
                 "gs_rank", "gs_color", "gs_verlet")


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: "registers, shared, ...; stack frame, spill
    stores, spill loads"} of every kernel of PTXAS_KERNELS in an nvcc
    -Xptxas -v log."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1)
                                     for k in PTXAS_KERNELS) else None
        elif name and ("Used" in line or "spill" in line):
            out[name] = (out.get(name, "") + " "
                         + line.split(":", 2)[-1].strip()).strip()
    return out


def ptxas_study(other_tree=None) -> dict:
    """This build's ptxas report (and ``other_tree``'s, built apart)."""
    import os
    from gpu_physics_engine_torch.ops import _cuda
    so = _cuda.library_path()
    if so.exists():
        so.unlink()  # rebuilt, so that the log holds ptxas's report
    out = {"study": "ptxas", "this": ptxas_report(_cuda.build()["log"])}
    if other_tree:
        log = _build_from(os.path.join(other_tree, "gpu_physics_engine_torch",
                                       "csrc"),
                          os.path.join(_cuda.BUILD_DIR, "ptxas_other"),
                          patch=False, want_log=True)
        out["other"] = ptxas_report(log)
    return out


def collide_integrate_pack_cuda(state, prm, config, plan):
    """K1 through the packed kernel (csrc/tiled_kernels.cuh
    collide_integrate_pack_kernel) at any cap under ``plan`` = (rows,
    columns, shared bytes): the studies' variants, and the stream's
    checks (a plan whose buffer holds too few occupants).  Not a launch
    of the engine's: LAUNCHES is not counted."""
    import torch
    from gpu_physics_engine_torch.ops import _cuda, tiled_kernels as tk
    tk._check_cuda_state(state, "collide_integrate_pack")
    cap, TY, TX = state.dims
    outs = [torch.empty_like(state.x) for _ in range(4)]
    consts = tk._k1_consts(config)
    with torch.cuda.device(state.device):
        rc = _cuda.library().gpe_collide_integrate_pack(
            *tk._ptrs(*(getattr(state, f) for f in tk.FIELDS), prm, *outs),
            cap, TY, TX, int(config.tiled_uniform_radius),
            int(config.world_shape == "circle"), consts.ctypes.data,
            tk._stream(state.device), *plan)
    _cuda.check(rc, "collide_integrate_pack")
    return state.replace(x=outs[0], y=outs[1], px=outs[2], py=outs[3])


def rank_pack_cuda(state, config, entries: int, p0: int = 0, np: int = 4):
    """K5 (``state`` a TileState) or K5-par (a ParityState, parities p0 ..
    p0 + np - 1) through the packed kernel (csrc/gs_simple.cuh
    gs_rank_pack_kernel) at any cap and K with a buffer of ``entries``
    occupants (0: the default plan's): the studies, and the checks that
    make windows stream (a buffer too small for them).  Returns (src,
    rpid, rrad, count) as the wrappers do; not a launch of the engine's:
    LAUNCHES is not counted."""
    import torch
    from gpu_physics_engine_torch.ops import _cuda, tiled_kernels as tk
    from gpu_physics_engine_torch.ops.integrate import f32
    from gpu_physics_engine_torch.ops.tiled import tile_geometry
    K, dev = config.max_occupancy, state.x.device
    par = hasattr(state, "geo")
    if par:
        g = state.geo
        cap, dims = state.cap, (g.TY, g.TX, g.DY, g.DX, g.origin)
        tables = (4, K, g.DY, g.DX)
    else:
        cap, TY, TX = state.dims
        dims, tables = (TY, TX, 0, 0, 0), (K, TY, TX)
    src = torch.empty(tables, dtype=torch.int32, device=dev)
    rpid = torch.empty_like(src)
    rrad = torch.empty(tables, dtype=torch.float32, device=dev)
    count = torch.empty((tables[0],) + tables[2:] if par else tables[1:],
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.library().gpe_gs_rank_pack(
            state.x.data_ptr(), state.y.data_ptr(), tk._ptr(state.radius),
            *tk._ptrs(state.pid, src, rpid, rrad, count), cap, *dims,
            int(par), p0, np, K, f32(tile_geometry(config)[0]),
            f32(config.initial_radius), int(entries), tk._stream(dev))
    _cuda.check(rc, "gs_rank_pack")
    return src, rpid, rrad, count


def relocate_pull_warp_cuda(state, config):
    """K2 through the warp kernel (csrc/tiled_kernels.cuh
    relocate_warp_kernel) at any cap: the studies' comparison with the
    mask kernel at caps up to 64.  Returns (state, defer); LAUNCHES is not
    counted."""
    import torch
    from gpu_physics_engine_torch.ops import _cuda, tiled_kernels as tk
    from gpu_physics_engine_torch.ops.integrate import f32
    tk._check_cuda_state(state, "relocate_pull_warp")
    cap, TY, TX = state.dims
    match, t, delta, gTY = tk._k2_args(state, config, None)
    outs = [torch.empty_like(state.x) for _ in range(5)]
    opid = torch.empty_like(state.pid)
    defer = torch.empty((TY, TX), dtype=torch.int32, device=state.device)
    scratch = tk.k2_scratch(cap, TY, TX, False, state.device)
    with torch.cuda.device(state.device):
        rc = _cuda.library().gpe_relocate_pull_warp(
            *tk._ptrs(*(getattr(state, f) for f in tk.FIELDS), *outs, opid,
                      defer), cap, TY, TX, 0, gTY, TX,
            tk._MATCH_CODE[match], f32(t), f32(delta),
            tk._stream(state.device), tk._ptr(scratch))
    _cuda.check(rc, "relocate_pull_warp")
    return tk._relocated(state, outs, opid, defer), defer


# the packed K1's plans timed by --wide: (rows, columns, shared bytes)
K1_PLANS = ((2, 8, 49_152), (4, 8, 65_536), (2, 16, 65_536),
            (4, 8, 98_304), (2, 16, 98_304), (4, 16, 98_304))

def _wide_states() -> dict:
    """name -> (config, state) of the wide-cap engine paths: each engine
    after its spawn (or as built) and 8 steps."""
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    centre = (1524.0, 524.0)
    out = {}
    for name, n, kw, pre, spawn in (
            ("4M-retile", 4_194_304, dict(tiled_spawn="retile"), 0, True),
            ("1M-spawn-ready", 1_048_576,
             dict(tile_max_radius=3.0, tile_cap=0), 0, True),
            ("1M-retile", 1_048_576, dict(tiled_spawn="retile"), 64, True),
            ("1M-cap36", 1_048_576, dict(tile_max_radius=1.0, tile_cap=0),
             0, False),
            ("1M-r5-cap312", 1_048_576,
             dict(tile_max_radius=5.0, tile_cap=0), 0, True)):
        e = make_tuned_engine(n, device="cuda", **kw)
        e.run(pre)
        if spawn:
            e.spawn_at(centre, verbose=False)
        e.run(8)
        out[name] = (e.config, e.state)
        del e
        torch.cuda.empty_cache()
    return out


def _gs_cap128():
    """GS-cap128's parity state: 262,144 particles on 1524 x 524 at cap
    128, K 8, one flat frame from the seeded scene, then the par layout
    jittered by 0.3 tile (chip_smoke.py's K2-par time row)."""
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_parity as gp, tiled
    cfg = gs_config(262_144, world_width=1524.0, world_height=524.0,
                    tile_cap=128, max_occupancy=8)
    seed = TiledEngine(cfg, seed=0, chunk=64, device="cuda")
    st = tiled.tiled_step_fn(seed.state, seed.params(), cfg)
    return cfg, gp.to_parity_state(jittered(
        st, 0.3 * tiled.tile_geometry(cfg)[0], seed=2), cfg)


def step_study(other=None) -> dict:
    """ms/step of the 4M and 1M-GS par engines, this build and ``other``
    in turns."""
    import torch
    from gpu_physics_engine_torch import TiledEngine, make_tuned_engine
    from gpu_physics_engine_torch.core.tuned import gs_config
    out = {"study": "steps"}
    for name, make in (
            ("4M", lambda: make_tuned_engine(4_194_304, device="cuda")),
            ("1M-GS-par", lambda: TiledEngine(
                gs_config(1_048_576, gs_layout="par"), seed=0, chunk=64,
                device="cuda"))):
        e = make()
        e.run(16)

        def window(e=e):
            return cuda_ms(lambda: e.run(64), reps=1, warmup=0) / 64
        order = [("this", window)]
        if other is not None:
            order.append(("other", _through(other, window)))
        turns = order + order[::-1]
        out[name] = {k: [] for k, _ in order}
        for k, fn in turns + turns:
            out[name][k].append(fn())
        del e
        torch.cuda.empty_cache()
    return out


def wide_study(other=None) -> dict:
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    out = {"study": "wide"}
    for name, (cfg, st) in _wide_states().items():
        # the parent's kernels refuse caps past 256: this build alone there
        theirs = other if st.dims[0] <= 256 else None
        prm = StepParams.make(cfg.dt).as_tensor("cuda", 1.0 / cfg.substeps)
        moved = jittered(st, 0.3 * tiled.tile_geometry(cfg)[0], seed=2)
        a, b = tk.collide_integrate_cuda(st, prm, cfg), \
            tk.collide_integrate_plain(st, prm, cfg)
        k2, k2p = tk.relocate_pull_cuda(moved, cfg), \
            tk.relocate_pull_plain(moved, cfg)
        row = {"dims": list(st.dims), "match": tk.resolve_match(
                   cfg, *st.dims),
               "k1_bit_equal": _equal(a, b, ("x", "y", "px", "py")),
               "k2_bit_equal": _same(k2, k2p, tiled.FIELDS),
               "k1": _turns(lambda f: [cuda_ms(f), cuda_ms(f)],
                            lambda: tk.collide_integrate_cuda(st, prm, cfg),
                            theirs),
               "k2": _turns(lambda f: [cuda_ms(f), cuda_ms(f)],
                            lambda: tk.relocate_pull_cuda(moved, cfg),
                            theirs)}
        plans = {}
        for plan in K1_PLANS + K1_PLANS[::-1]:
            def fn(plan=plan):
                return collide_integrate_pack_cuda(st, prm, cfg, plan)
            if plan not in plans:
                c = fn()
                plans[plan] = {"bit_equal": _equal(c, b, ("x", "y", "px",
                                                           "py")), "ms": []}
            plans[plan]["ms"].append(cuda_ms(fn))
        row["k1_plans"] = {"x".join(map(str, p)): v for p, v in plans.items()}
        if st.dims[0] <= tk.WIDE_CAP:  # the warp kernel beside the masks
            w = relocate_pull_warp_cuda(moved, cfg)
            fns = (lambda: tk.relocate_pull_cuda(moved, cfg),
                   lambda: relocate_pull_warp_cuda(moved, cfg))
            ms = [[], []]
            for i in (0, 1, 1, 0):
                ms[i].append(cuda_ms(fns[i]))
            row["k2_mask_vs_warp"] = {"warp_bit_equal": _same(w, k2p,
                                                              tiled.FIELDS),
                                      "mask_ms": ms[0], "warp_ms": ms[1]}
        out[name] = row
        print(json.dumps({name: row}), flush=True)
        del a, b, k2, k2p
        torch.cuda.empty_cache()
    cfg, ps = _gs_cap128()
    a, b = gp.relocate_par_cuda(ps, cfg), gp.relocate_par_plain(ps, cfg)
    m = gm.relocate_mega_cuda(ps, cfg)
    f = ("x", "y", "px", "py", "pid", "overflow_count")
    out["GS-cap128"] = {
        "dims": list(ps.x.shape),
        "bit_equal": _same(a, b, f) and _same(m, b, f),
        "k2_par": _turns(lambda f: [cuda_ms(f), cuda_ms(f)],
                         lambda: gp.relocate_par_cuda(ps, cfg), other),
        "relocate_mega": _turns(lambda f: [cuda_ms(f), cuda_ms(f)],
                                lambda: gm.relocate_mega_cuda(ps, cfg),
                                other)}
    print(json.dumps({"GS-cap128": out["GS-cap128"]}), flush=True)
    return out


def _parent_library(path: str):
    import ctypes
    lib = ctypes.CDLL(path)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    for name, sig in _PARENT_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[k] for k in sig]
        fn.restype = ctypes.c_int
    return lib


def _parent_calls(lib, route: str, a: dict):
    """The parent's kernels for a solve of ``route`` on the inputs ``a``
    (in place on clones of x, y, px, py): "flat" four K6 launches, "par"
    four K6-par launches and the Verlet tail, "mega" the cooperative
    kernel."""
    import torch
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops.integrate import f32
    cfg = a["cfg"]
    K, stiff = cfg.max_occupancy, f32(cfg.stiffness)
    x, y, px, py = (a[k].clone() for k in ("x", "y", "px", "py"))
    consts = gp._verlet_consts(cfg)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: t.data_ptr()  # noqa: E731

    def check(rc):
        if rc:
            raise RuntimeError(f"parent {route}: CUDA error {rc}")
    if route == "flat":
        cap, TY, TX = x.shape

        def run():
            for c in (1, 2, 3, 4):
                check(lib.gpe_gs_color(ptr(x), ptr(y), ptr(a["src"]),
                                       ptr(a["rrad"]), cap, TY, TX, K, c,
                                       stiff, stream))
        return run
    geo = a["geo"]
    cap = int(x.shape[1])
    geo_args = gp._geo_args(geo)
    if route == "par":
        def run():
            for c in (1, 2, 3, 4):
                check(lib.gpe_gs_color_par(ptr(x), ptr(y), ptr(a["src"]),
                                           ptr(a["rrad"]), cap, *geo_args,
                                           K, c, stiff, stream))
            check(lib.gpe_gs_verlet(ptr(x), ptr(y), ptr(px), ptr(py),
                                    ptr(a["pid"]), ptr(a["prm"]), x.numel(),
                                    consts.ctypes.data, stream))
        return run

    def run():
        check(lib.gpe_gs_colors_mega(
            ptr(x), ptr(y), ptr(px), ptr(py), ptr(a["pid"]), ptr(a["src"]),
            ptr(a["rrad"]), ptr(a["prm"]), cap, *geo_args, K, stiff, 1,
            consts.ctypes.data, stream))
    return run


def _window_calls(route: str, a: dict, colors: int = 4, tail: bool = True):
    """This tree's window for a solve of ``route`` (the wrappers: flat
    ``colors_cuda``, par ``colors_par_cuda`` with the tail unless ``tail``
    is False and no radius table, mega ``colors_mega_cuda``); ``colors``
    0 with no tail: the stage and the full-plane write alone."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    cfg = a["cfg"]
    px, py = a["px"].clone(), a["py"].clone()
    if route == "flat":
        return lambda: gk.colors_cuda(a["x"], a["y"], a["src"], a["rrad"],
                                      cfg, colors)
    if route == "par":
        t = (px, py, a["pid"], a["prm"]) if tail else None
        return lambda: gp.colors_par_cuda(a["x"], a["y"], a["src"],
                                          a["rrad"], cfg, a["geo"], colors,
                                          t, uniform=True)
    ps = a["ps"].replace(px=px, py=py)
    return lambda: gm.colors_mega_cuda(ps, a["src"], a["rrad"], cfg,
                                       a["prm"])


def _k6_inputs(n: int, steps: int) -> dict:
    """{(route, state): inputs} at the GS scene of n particles: "flat"
    full-space planes and K5's tables, "par" and "mega" the parity state
    and K5-par's tables, on the seeded scene ("initial") and on the
    engines' states after ``steps`` steps ("in_step")."""
    from gpu_physics_engine_torch import StepParams, TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    out = {}
    for layout in ("flat", "par"):
        e = TiledEngine(gs_config(n, gs_layout=layout), seed=0, chunk=64,
                        device="cuda")
        cfg = e.config
        prm = StepParams.make(cfg.dt, mouse=(0.5 * cfg.world_width,
                                             0.5 * cfg.world_height),
                              pressed=True).as_tensor("cuda")
        for state in ("initial", "in_step"):
            if state == "in_step":
                e.run(steps)
            st = e.state
            if layout == "flat":
                src, _, rrad, _ = gk.rank_cuda(st, cfg)
                out["flat", state] = dict(cfg=cfg, x=st.x, y=st.y, px=st.px,
                                          py=st.py, pid=st.pid, src=src,
                                          rrad=rrad, prm=prm)
                continue
            ps = gp.to_parity_state(st, cfg)
            src, _, rrad, _ = gp.rank_par_cuda(ps, cfg)
            for route in ("par", "mega"):
                out[route, state] = dict(cfg=cfg, x=ps.x, y=ps.y, px=ps.px,
                                         py=ps.py, pid=ps.pid, src=src,
                                         rrad=rrad, prm=prm, geo=ps.geo,
                                         ps=ps)
        del e
    return out


def k6_study(parent=None) -> dict:
    """K6's window (flat, par with the tail, mega) at each GS scene on the
    initial and the in-step state: the ms of a call (CUDA events, twice)
    and the device ms per kernel from the profiler, through this build,
    the K6_VARIANTS builds and, with ``parent`` (a checkout of the parent
    commit), the parent's per-color and cooperative kernels and its
    per-color kernel with batched loads; all in turns (in order, then in
    reverse).  Also the window with no color ("write_only": the stage and
    the full-plane write) and, on par, its colors and its tail alone."""
    import tempfile
    import threading
    import torch
    from gpu_physics_engine_torch.ops import _cuda
    builds, errors = {}, []

    def build(name, fn):
        try:
            builds[name] = fn()
        except Exception as exc:  # reported below, the study stops
            errors.append(f"{name}: {exc}")
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=str(_cuda.BUILD_DIR), prefix="k6_")
    jobs = []
    jobs += [(name, lambda d=d: _cuda.build(d))
             for name, d in K6_VARIANTS.items()]
    if parent:
        csrc = f"{parent}/gpu_physics_engine_torch/csrc"
        jobs += [(name, lambda d=f"{work}/{name}", p=p:
                  _build_from(csrc, d, p))
                 for name, p in (("parent", False), ("parent_batched", True))]
    threads = [threading.Thread(target=build, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    libs = {name: (_parent_library(b) if name.startswith("parent")
                   else _other_library(b["path"]))
            for name, b in builds.items()}
    out = {"study": "k6",
           "variants": {k: list(v) for k, v in K6_VARIANTS.items()}}
    # registers and spills of each build's window kernels (ptxas -v)
    out["ptxas"] = {name: _window_ptxas(b["log"])
                    for name, b in builds.items() if isinstance(b, dict)}
    for n in (1_048_576, 4_194_304):
        inputs = _k6_inputs(n, 64)
        for (route, state), a in inputs.items():
            fns = {"window": _window_calls(route, a)}
            if route != "mega":
                fns["write_only"] = _window_calls(route, a, 0, False)
            if route == "par":
                fns["colors_only"] = _window_calls(route, a, 4, False)
                fns["tail_only"] = _window_calls(route, a, 0, True)
            for name, lib in libs.items():
                if name.startswith("parent"):
                    if name == "parent" or route != "mega":
                        fns[name] = _parent_calls(lib, route, a)
                else:
                    fns[name] = _through(lib, fns["window"])
            rows = {k: [] for k in fns}
            order = list(fns)
            for name in order + order[::-1]:
                rows[name].append(cuda_ms(fns[name]))
            dev = {name: kernel_device_ms(fn, 10) for name, fn in fns.items()}
            out[f"{n}_{route}_{state}"] = {
                "dims": list(a["x"].shape),
                "ms": rows, "device_ms": dev}
            torch.cuda.synchronize()
        del inputs
        torch.cuda.empty_cache()
    return out


# The parent commit's radix pass (three kernels a pass: the rank and
# histogram of 1024-key blocks, the digit offsets, the scatter), called
# through an earlier build of the library given with --other-lib, so that
# --radix can time it in turns with this tree's sort in one process.
PARENT_RADIX = {"gpe_radix_rank_hist": 3 * [ctypes.c_void_p]
                + 2 * [ctypes.c_int] + [ctypes.c_void_p],
                "gpe_radix_offsets": 3 * [ctypes.c_void_p]
                + [ctypes.c_int, ctypes.c_void_p],
                "gpe_radix_scatter": 7 * [ctypes.c_void_p]
                + 2 * [ctypes.c_int] + [ctypes.c_void_p]}


def parent_radix_sort(lib):
    """The parent's ``radix_sort_pairs`` on the card through ``lib``'s
    entry points: keys to int32 bits padded to 1024-key blocks with
    0xFFFFFFFF, 4 passes of 3 launches, back to int64."""
    import torch
    for name, argtypes in PARENT_RADIX.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int

    def sort(keys, payload):
        n, block = keys.shape[0], 1024
        bits = keys.to(torch.int32)
        pad = -n % block
        if pad:
            bits = torch.cat([bits, bits.new_full((pad,), -1)])
            payload = torch.cat([payload, payload.new_zeros(pad)])
        nb = bits.shape[0] // block
        rank = torch.empty_like(bits)
        hist = torch.empty((nb, 256), dtype=torch.int32, device=keys.device)
        offset = torch.empty_like(hist)
        part = torch.empty((-(-nb // 32), 256), dtype=torch.int32,
                           device=keys.device)
        bufs = [(torch.empty_like(bits), torch.empty_like(payload))
                for _ in range(2)]
        s = torch.cuda.current_stream().cuda_stream
        for p in range(4):
            ok, ov = bufs[p % 2]
            rcs = (lib.gpe_radix_rank_hist(bits.data_ptr(), rank.data_ptr(),
                                           hist.data_ptr(), nb, 8 * p, s),
                   lib.gpe_radix_offsets(hist.data_ptr(), part.data_ptr(),
                                         offset.data_ptr(), nb, s),
                   lib.gpe_radix_scatter(
                       bits.data_ptr(), payload.data_ptr(), rank.data_ptr(),
                       hist.data_ptr(), offset.data_ptr(), ok.data_ptr(),
                       ov.data_ptr(), nb, 8 * p, s))
            if any(rcs):
                raise RuntimeError(f"parent radix pass {p}: CUDA errors {rcs}")
            bits, payload = ok, ov
        return bits[:n].to(torch.int64) & 0xFFFFFFFF, payload[:n]
    return sort


def radix_study(other=None) -> dict:
    """The hand sort, its kernels and ``torch.sort`` on the 1M scene's pair
    keys; with ``other`` (the parent's build) the parent's sort too, in
    turns (torch.sort, this, parent, parent, this, torch.sort)."""
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

    def hand_sort():
        return rs.radix_sort_pairs(keys, obj)

    sorts = {"torch_sort": lib_sort, "radix_sort_pairs": hand_sort}
    if other is not None:
        parent = parent_radix_sort(other)
        sorts["parent_sort"] = lambda: parent(keys, obj)
    want = lib_sort()
    for name, fn in sorts.items():
        got = fn()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"{name} != torch.sort(stable=True)")
    out = {"study": "radix", "keys": n, "tiles": rs.num_tiles(n)}
    order = list(sorts)
    rows = {name: [] for name in order}
    for name in order + order[::-1]:
        rows[name].append(cuda_ms(sorts[name]))
    out["sorts_ms"] = rows
    for name, fn in sorts.items():
        out[f"{name}_device_ms"] = kernel_device_ms(fn, 10)
    return out


def _sass_functions(lib: str) -> dict:
    """{mangled kernel name: its SASS text} of a built library."""
    import os
    import re
    from gpu_physics_engine_torch.ops import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = "\n".join(body)
            name, body = m.group(1), []
        elif name and line.strip() and not line.lstrip().startswith(
                ("....", ".section", "Fatbin", "code for", "arch =",
                 "host =", "compile_size", "=====")):
            # cuobjdump pads its columns to the widest instruction of the
            # whole dump: compare the tokens, not the padding
            body.append(" ".join(line.split()))
    if name:
        out[name] = "\n".join(body)
    return out


def sass_study(other_tree: str) -> dict:
    """This tree's kernels against ``other_tree``'s, SASS for SASS (the
    first lines that differ, where they do)."""
    import os
    from gpu_physics_engine_torch.ops import _cuda
    mine = _sass_functions(_cuda.build()["path"])
    out_dir = os.path.join(_cuda.BUILD_DIR, "sass_other")
    theirs = _sass_functions(_build_from(
        os.path.join(other_tree, "gpu_physics_engine_torch", "csrc"),
        out_dir, patch=False))
    both = sorted(set(mine) & set(theirs))
    same = [f for f in both if mine[f] == theirs[f]]
    diffs = {}
    for f in both:
        if mine[f] != theirs[f]:
            a, b = theirs[f].splitlines(), mine[f].splitlines()
            i = next((i for i, (u, v) in enumerate(zip(a, b)) if u != v),
                     min(len(a), len(b)))
            diffs[f] = {"lines": len(b), "other_lines": len(a),
                        "first_difference": i, "other": a[i:i + 8],
                        "this": b[i:i + 8]}
    return {"study": "sass", "common": len(both), "identical": len(same),
            "differ": diffs,
            "only_this": len(set(mine) - set(theirs)),
            "only_other": sorted(set(theirs) - set(mine)),
            "identical_names": same}


def kernel_device_ms(fn, reps: int, counts: dict | None = None,
                     pad_s: float | None = None) -> dict:
    """Device ms per call of ``fn`` for each kernel it launches (a
    torch.profiler window over ``reps`` calls, CUDA activity only:
    ``profiling.kernel_window``, ``pad_s`` its default where None).
    ``counts``, where given, gets each kernel's number of records."""
    import torch
    from gpu_physics_engine_torch.utils.profiling import (PAD_S, _device_us,
                                                          kernel_window)
    fn()
    torch.cuda.synchronize()
    with kernel_window(PAD_S if pad_s is None else pad_s) as prof:
        for _ in range(reps):
            fn()
    rows = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0:
            name = evt.key.split("(")[0][:60]
            rows[name] = us / 1e3 / reps
            if counts is not None:
                counts[name] = evt.count
    rows["total"] = sum(rows.values())
    return rows


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--k5", action="store_true")
    ap.add_argument("--other-lib", default=None,
                    help="with --k1, --k2 and --k5: time the kernels "
                         "through "
                         "this build of the kernel library too, in turns; "
                         "with --radix: the parent commit's build, whose "
                         "three-kernel sort is timed in turns")
    ap.add_argument("--k6", action="store_true")
    ap.add_argument("--parent", default=None,
                    help="with --k6: a checkout of the parent commit, whose "
                         "kernels (and its K6 with batched loads) are built "
                         "and timed in turns")
    ap.add_argument("--radix", action="store_true")
    ap.add_argument("--particles", type=int, default=4_194_304)
    ap.add_argument("--sass", default=None,
                    help="another checkout whose kernels' SASS is compared "
                         "with this tree's, function by function")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--gs-wide", action="store_true",
                    help="with --k5 and/or --k6: the rank and/or the solve "
                         "on the GS-cap128, GS-K32 and GS-cap312 states "
                         "instead, beside --other-lib's build, in turns")
    ap.add_argument("--gs-dense", action="store_true",
                    help="with --k5: the packed rank's windows past 256 "
                         "occupants, packed or streamed, in turns")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--ptxas", nargs="?", const="", default=None,
                    help="ptxas's registers and spills of this tree's "
                         "kernels (and of another checkout's)")
    args = ap.parse_args(argv)
    if args.ptxas is not None:
        print(json.dumps(ptxas_study(args.ptxas or None)), flush=True)
    if args.sass:
        print(json.dumps(sass_study(args.sass)), flush=True)
    if (args.sass or args.ptxas is not None) and not (
            args.k1 or args.k2 or args.k5 or args.k6 or args.radix
            or args.wide or args.steps):
        return 0
    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    other = _other_library(args.other_lib) if args.other_lib else None
    if args.k1:
        print(json.dumps(k1_study(args.particles, other)), flush=True)
    if args.k2:
        print(json.dumps(k2_study(args.particles, other)), flush=True)
    if args.gs_wide:
        print(json.dumps(gs_wide_study({} if other is None else {
            "other": other}, args.k5, args.k6)), flush=True)
    if args.gs_dense and args.k5:
        print(json.dumps(gs_dense_study()), flush=True)
    elif args.k5 and not args.gs_wide:
        print(json.dumps(k5_study(other)), flush=True)
    if args.k6 and not args.gs_wide:
        print(json.dumps(k6_study(args.parent)), flush=True)
    if args.radix:
        print(json.dumps(radix_study(other)), flush=True)
    if args.wide:
        print(json.dumps(wide_study(other)), flush=True)
    if args.steps:
        print(json.dumps(step_study(other)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
