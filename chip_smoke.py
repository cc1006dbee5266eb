#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpu_physics_engine_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the script exits
non-zero with no result line:

  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build: the CUDA kernels from csrc/ (one nvcc per source, in parallel,
     sm_90a), with the time;
  3. kernel vs plain on the card, every kernel run twice (bit-equal), at
     a small shape and at the shape and config of every path below that
     launches it: K1 (fused collide + integrate) and K3 (collide) for the
     uniform and the general radius at the 4M [8, 640, 1850] and 256k
     [9, 176, 506] shapes, within 1e-5 with pid equal; K2 (pull relocate)
     there for flip / flip2 / greedy, hysteresis on and off, and at the
     GS shapes [4, 960, 2773] and [6, 960, 2773] with the GS config,
     bit-equal; K5 (GS rank) and K6 (GS color solve) on a small
     mixed-radius scene with a jammed cluster (clamp overflow) and at both
     GS shapes: rank tables, x, y and overflow_count bit-equal; the
     parity-space kernels there too, on a small uniform scene as well, at
     the parity shapes [4, 4, 480, 1387] and [4, 6, 480, 1387]: K5-par
     (one launch for all parities and one per parity), K6-par for every
     color on the par, mx and dec layouts, K2-par (both launch modes, the
     config's match) and K6-par's Verlet tail, all bit-equal; the mx and
     dec solves bit-equal to the flat solve;
  4. the Jacobi main path at 4,194,304 particles (make_tuned_engine, 150
     steps free then 150 with the mouse pressed, crossing the sweep at step
     240) and the rebuild-sweep path at 256,000 (250 steps): launch counts,
     conservation, bounds, ms/step and quality;
  5. the Gauss-Seidel path (tiled_solver="gs", the bench's GS config) at
     1,048,576 particles for 300 steps (150 free, 150 with the mouse at
     the world centre) and at 4,194,304 (cap 6) for 100 steps, each in the
     flat layout (K5 once, K6 four times and K2 once per step) and in the
     parity layout "par" (K5-par once, K6-par four times, K2-par once and
     the Verlet tail once per step; no flat K5/K6/K2), the same checks,
     and the two layouts' final states bit-equal; then 32 steps at 1M in
     the "mx" and "dec" layouts (K5, K6-par, K2), bit-equal to flat;
  6. the unfused path (tiled_fuse_integrate=False) at 4,194,304 for 64
     steps: K3 on every step;
  7. kernel times at the main paths' shapes against their plain versions,
     with each kernel's bound on this card.

Then a line {"kernels": [...]} and, last, the result line
{"ok": true, "device": {...}}.  Without a CUDA device (or without the
package beside this script) it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): device memory bytes/s and f32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (CUDA
    events around the whole batch, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def reset_launches() -> None:
    from gpu_physics_engine_torch.ops import (gs_kernels, gs_parity,
                                              tiled_kernels)
    tiled_kernels.reset_launches()
    gs_kernels.reset_launches()
    gs_parity.reset_launches()


def launches() -> dict:
    from gpu_physics_engine_torch.ops import (gs_kernels, gs_parity,
                                              tiled_kernels)
    return {**tiled_kernels.LAUNCHES, **gs_kernels.LAUNCHES,
            **gs_parity.LAUNCHES}


def phase_environment() -> str:
    import torch
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = "not found"
    if CUDA_HOME:
        out = subprocess.run([f"{CUDA_HOME}/bin/nvcc", "--version"],
                             capture_output=True, text=True)
        nvcc = out.stdout.strip().splitlines()[-1] if out.stdout else nvcc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc: {nvcc}")
    log(smi.splitlines()[0])
    return smi.splitlines()[0]


def phase_build() -> None:
    from gpu_physics_engine_torch.ops import _cuda
    info = _cuda.build()
    _cuda.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log(f"[build] {info['path'].split('/')[-1]} in {info['seconds']:.1f} s")
    for ln in ptxas:
        log(f"[build] {ln}")


def _jittered(state, scale, seed):
    """``state`` with live x/y displaced by up to +-scale (on the card)."""
    import torch
    g = torch.Generator(device=state.device).manual_seed(seed)
    occ = state.pid >= 0
    dx = (torch.rand(state.x.shape, generator=g, device=state.device)
          - 0.5) * 2 * scale
    dy = (torch.rand(state.x.shape, generator=g, device=state.device)
          - 0.5) * 2 * scale
    return state.replace(x=torch.where(occ, state.x + dx, state.x),
                         y=torch.where(occ, state.y + dy, state.y))


def _small_state(cap, uniform=True):
    import numpy as np
    from gpu_physics_engine_torch import SimConfig
    from gpu_physics_engine_torch.ops import tiled
    cfg = SimConfig(max_particles=3000, initial_particles=3000,
                    world_width=96.0, world_height=60.0, pipeline="tiled",
                    tile_cap=cap, tiled_uniform_radius=uniform)
    rng = np.random.default_rng(cap)
    pos = np.stack([rng.uniform(0.6, 95.4, 3000),
                    rng.uniform(0.6, 59.4, 3000)], -1).astype(np.float32)
    rad = (np.full(3000, 0.5, np.float32) if uniform
           else rng.uniform(0.3, 0.5, 3000).astype(np.float32))
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    return cfg, tiled.init_tiles(cfg, pos, rad, previous_positions=prev,
                                 device="cuda")


def _max_err(a, b, fields) -> float:
    return max(float((getattr(a, f) - getattr(b, f)).abs().max())
               for f in fields)


def _same(a, b, fields) -> bool:
    import torch
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


def check_relocate(label, cfg, st, modes, errs: dict) -> None:
    """K2 (pull relocate) against its plain version on ``st`` with every
    live particle jittered by up to 0.6 tile, for each (match, hysteresis)
    of ``modes``: bit-equal, bit-equal on repeat, no pid lost."""
    import torch
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    moved = _jittered(st, 0.6 * tiled.tile_geometry(cfg)[0], seed=1)
    for match, hyst in modes:
        c = cfg.replace(tiled_match=match, tiled_hysteresis=hyst)
        a, da = tk.relocate_pull_cuda(moved, c)
        a2, da2 = tk.relocate_pull_cuda(moved, c)
        b, db = tk.relocate_pull_plain(moved, c)
        torch.cuda.synchronize()
        eq = _same(a, b, tiled.FIELDS) and torch.equal(da, db)
        errs["relocate_pull"] = max(
            errs.get("relocate_pull", 0.0),
            _max_err(a, b, ("x", "y", "px", "py", "radius")))
        rep = _same(a, a2, tiled.FIELDS) and torch.equal(da, da2)
        if not (eq and rep):
            raise AssertionError(f"K2 {label} {match} hyst={hyst}: "
                                 f"bit-equal {eq}, repeat {rep}")
        n_live = int((a.pid >= 0).sum())
        if n_live != int((moved.pid >= 0).sum()):
            raise AssertionError(f"K2 {label} {match}: lost pids")
        log(f"[k2] {label} {list(st.dims)} {match} "
            f"hysteresis={c.hysteresis_delta:.3g}: bit-equal, "
            f"repeat bit-equal, deferred {int(da.sum())} of {n_live}")


def phase_jacobi_kernels(scenes, errs: dict) -> None:
    """K1, K3 and K2 against their plain versions on the card, at a small
    shape and at each Jacobi path's ``scenes`` [(label, config, state)]."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    small_cfg, small_uniform = _small_state(4, uniform=True)
    _, small_mixed = _small_state(4, uniform=False)
    # (label, config, state for the uniform variant, for the general one);
    # the general variant reads the radius plane (mixed radii when small)
    shapes = [("small", small_cfg, small_uniform, small_mixed)] + [
        (label, cfg, st, st) for label, cfg, st in scenes]
    for label, cfg, st, st_general in shapes:
        prm = StepParams.make(cfg.dt, mouse=(0.5 * cfg.world_width,
                                             0.5 * cfg.world_height),
                              pressed=True).as_tensor("cuda")
        for uniform, s in ((True, st), (False, st_general)):
            c = cfg.replace(tiled_uniform_radius=uniform)
            runs = (("k1", "collide_integrate", ("x", "y", "px", "py"),
                     lambda: tk.collide_integrate_cuda(s, prm, c),
                     lambda: tk.collide_integrate_plain(s, prm, c)),
                    ("k3", "collide", ("x", "y"),
                     lambda: tk.collide_cuda(s, c),
                     lambda: tk.collide_plain(s, c)))
            for tag, name, fields, kern, plain in runs:
                a, a2, b = kern(), kern(), plain()
                torch.cuda.synchronize()
                err = _max_err(a, b, fields)
                same = _same(a, a2, fields)
                if not (err <= 1e-5 and same and torch.equal(a.pid, b.pid)):
                    raise AssertionError(f"{tag} {label} uniform={uniform}: "
                                         f"max err {err}, repeat {same}")
                errs[name] = max(errs.get(name, 0.0), err)
                log(f"[{tag}] {label} {list(s.dims)} uniform={uniform}: "
                    f"max_abs_err {err:.3g}, repeat bit-equal")
        # K2: every matching mode, hysteresis off and auto
        check_relocate(label, cfg, st, [(m, h) for m in ("flip", "flip2",
                                                         "greedy")
                                        for h in (0.0, -1.0)], errs)


def _gs_small_state():
    """A small GS scene: mixed radii over the world plus a jammed cluster
    whose cells hold more than K occupants (the clamp and the overflow)."""
    import numpy as np
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import tiled
    cfg = gs_config(4000, world_width=96.0, world_height=60.0, tile_cap=4,
                    tiled_uniform_radius=False)
    rng = np.random.default_rng(7)
    spread = np.stack([rng.uniform(0.6, 95.4, 3000),
                       rng.uniform(0.6, 59.4, 3000)], -1)
    jam = np.array([30.0, 30.0]) + rng.normal(0.0, 2.5, (1000, 2))
    pos = np.concatenate([spread, jam]).astype(np.float32)
    rad = rng.uniform(0.3, 0.5, 4000).astype(np.float32)
    return cfg, tiled.init_tiles(cfg, pos, rad, device="cuda")


def phase_gs_kernels(scenes, errs: dict) -> None:
    """K5 and K6 against their plain versions: the rank tables, and x, y
    and overflow_count after the four colors, bit-equal; twice each.  At a
    small scene and at each GS path's ``scenes`` [(label, config, state)],
    where K2 is also held to its plain version with the path's config."""
    import torch
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import tiled
    small_cfg, small = _gs_small_state()
    runs = [("small", small_cfg, small)] + list(scenes)
    for i, (label, cfg, st) in enumerate(runs):
        # storage off home, as in a run
        st = _jittered(st, 0.3 * tiled.tile_geometry(cfg)[0], seed=4 + i)
        ka, ta = gk.solve_frame(st, cfg, gk.rank_cuda, gk.color_cuda_)
        ka2, ta2 = gk.solve_frame(st, cfg, gk.rank_cuda, gk.color_cuda_)
        pb, tb = gk.solve_frame(st, cfg, gk.rank_plain, gk.color_plain_)
        torch.cuda.synchronize()
        names = ("src", "rpid", "rrad", "count")
        rank_eq = [n for n, u, v in zip(names, ta, tb)
                   if not torch.equal(u, v)]
        rank_rep = all(torch.equal(u, v) for u, v in zip(ta, ta2))
        fields = ("x", "y", "overflow_count")
        eq, rep = _same(ka, pb, fields), _same(ka, ka2, fields)
        if rank_eq or not (rank_rep and eq and rep):
            raise AssertionError(
                f"K5/K6 {label}: rank tables differing {rank_eq}, rank "
                f"repeat {rank_rep}, frame bit-equal {eq}, repeat {rep}, "
                f"max err {_max_err(ka, pb, ('x', 'y'))}")
        errs["gs_rank"] = max(errs.get("gs_rank", 0.0),
                              float((ta[2] - tb[2]).abs().max()))
        errs["gs_color"] = max(errs.get("gs_color", 0.0),
                               _max_err(ka, pb, ("x", "y")))
        frame = int(ka.overflow_count) - int(st.overflow_count)
        moved = int((ka.x != st.x).sum())
        log(f"[k5/k6] {label} {list(st.dims)} K={cfg.max_occupancy}: rank "
            f"tables, x, y, overflow bit-equal and repeat bit-equal; "
            f"clamp overflow {frame} this frame, max count "
            f"{int(ta[3].max())}, {moved} slots moved")
        if label != "small":
            check_relocate(label, cfg, st, [(cfg.tiled_match,
                                             cfg.tiled_hysteresis)], errs)


def _equal_or_raise(what, got, want, again=None) -> None:
    """Tensors (or tuples of them) bit-equal, and ``again`` (a repeat of the
    kernel) bit-equal to ``got``."""
    import torch
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    if again is not None and not isinstance(again, tuple):
        again = (again,)
    torch.cuda.synchronize()
    bad = [i for i, (u, v) in enumerate(zip(got, want))
           if not torch.equal(u, v)]
    if bad:
        err = max(float((got[i].double() - want[i].double()).abs().max())
                  for i in bad)
        raise AssertionError(f"{what}: outputs {bad} differ from the plain "
                             f"version (max err {err})")
    if again is not None and not all(torch.equal(u, v)
                                     for u, v in zip(got, again)):
        raise AssertionError(f"{what}: not bit-equal on repeat")


def _colors_lockstep(what, x, y, src, rrad, cfg, geo, errs, key) -> int:
    """K6-par against its plain version, color after color, from the same
    x, y; returns the number of slots the four colors moved."""
    from gpu_physics_engine_torch.ops import gs_parity as gp
    xk, yk, xp, yp = x.clone(), y.clone(), x.clone(), y.clone()
    for color in (1, 2, 3, 4):
        gp.color_par_cuda_(xk, yk, src, rrad, cfg, geo, color)
        gp.color_par_plain_(xp, yp, src, rrad, cfg, geo, color)
        _equal_or_raise(f"{what} color {color}", (xk, yk), (xp, yp))
    errs[key] = max(errs.get(key, 0.0), float((xk - xp).abs().max()))
    return int((xk != x).sum())


def phase_par_kernels(scenes, errs: dict) -> None:
    """The parity-space kernels against their plain versions, bit-equal and
    bit-equal on repeat: K5-par in both launch modes, K6-par for every
    color on the par layout (tables from K5-par) and on the mx and dec
    layouts (K5's tables relayouted), K2-par in both launch modes with the
    config's match and hysteresis, and the Verlet tail under the mouse;
    the mx and dec solves against the flat solve.  On a small mixed-radius
    scene (radius planes carried), a small uniform one and each GS path's
    ``scenes`` [(label, config, state)]."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    mixed_cfg, mixed = _gs_small_state()
    ucfg = gs_config(4000, world_width=96.0, world_height=60.0, tile_cap=4)
    uni = mixed.replace(radius=torch.where(
        mixed.pid >= 0, torch.full_like(mixed.x, ucfg.initial_radius),
        torch.zeros_like(mixed.x)))
    runs = [("small", mixed_cfg, mixed), ("small-uniform", ucfg, uni)]
    for i, (label, cfg, st) in enumerate(runs + list(scenes)):
        t = tiled.tile_geometry(cfg)[0]
        st = _jittered(st, 0.3 * t, seed=20 + i)  # storage off home
        ps = gp.to_parity_state(st, cfg)
        dims = list(ps.x.shape)
        for fused in (True, False):
            c = cfg.replace(gs_par_fused=fused)
            ta, ta2 = gp.rank_par_cuda(ps, c), gp.rank_par_cuda(ps, c)
            _equal_or_raise(f"K5-par {label} fused={fused}", ta,
                            gp.rank_par_plain(ps, c), ta2)
        src, _, rrad, count = ta
        errs["gs_rank_par"] = 0.0
        moved = _colors_lockstep(f"K6-par {label}", ps.x, ps.y, src, rrad,
                                 cfg, ps.geo, errs, "gs_color_par")
        fsrc, _, frrad, _ = gk.rank_cuda(st, cfg)
        for name, origin in (("mx", 0), ("dec", -1)):
            geo = gp.ParityGeometry(*st.dims[1:], origin)
            _colors_lockstep(
                f"K6-{name} {label}", gp.to_parity(st.x, geo, 0.0),
                gp.to_parity(st.y, geo, 0.0), gp.to_parity(fsrc, geo, -1),
                gp.to_parity(frrad, geo, 0.0), cfg, geo, errs,
                f"gs_color_par[{name}]")
            c = cfg.replace(gs_layout=name)
            got, want = gp.gs_solve_layout(st, c), gk.gs_solve_flat(st, c)
            _equal_or_raise(f"{name} solve {label} vs flat",
                            (got.x, got.y, got.overflow_count),
                            (want.x, want.y, want.overflow_count))
        far = gp.to_parity_state(_jittered(st, 0.6 * t, seed=40 + i), cfg)
        for fused in (True, False):
            c = cfg.replace(gs_par_fused=fused)
            a, da = gp.relocate_par_cuda(far, c)
            a2, _ = gp.relocate_par_cuda(far, c)
            b, db = gp.relocate_par_plain(far, c)
            fields = ("x", "y", "px", "py", "pid", "overflow_count") + (
                () if far.radius is None else ("radius",))
            _equal_or_raise(f"K2-par {label} fused={fused}",
                            tuple(getattr(a, f) for f in fields) + (da,),
                            tuple(getattr(b, f) for f in fields) + (db,),
                            tuple(getattr(a2, f) for f in fields))
            errs["relocate_par"] = 0.0
        verlet = ""
        if cfg.tiled_uniform_radius:
            prm = StepParams.make(cfg.dt, mouse=(0.5 * cfg.world_width,
                                                 0.5 * cfg.world_height),
                                  pressed=True).as_tensor("cuda")
            ka = [a.clone() for a in (ps.x, ps.y, ps.px, ps.py)]
            kb = [a.clone() for a in ka]
            pa = [a.clone() for a in ka]
            gp.verlet_cuda_(*ka, ps.pid, prm, cfg)
            gp.verlet_cuda_(*kb, ps.pid, prm, cfg)
            gp.verlet_plain_(*pa, ps.pid, prm, cfg)
            _equal_or_raise(f"Verlet tail {label}", tuple(ka), tuple(pa),
                            tuple(kb))
            errs["gs_verlet"] = max(errs.get("gs_verlet", 0.0), max(
                float((u - v).abs().max()) for u, v in zip(ka, pa)))
            verlet = ", Verlet tail"
        log(f"[par] {label} {dims} match {tk.resolve_match(cfg, *st.dims)}: "
            f"K5-par (fused and per parity), K6-par (par, mx, dec), K2-par "
            f"(fused and per parity, deferred {int(da.sum())}){verlet} "
            f"bit-equal and repeat bit-equal; mx and dec solves == flat; "
            f"clamp overflow "
            f"{int((count - cfg.max_occupancy).clamp(min=0).sum())}, "
            f"{moved} slots moved")


def _check_engine(e, n, label) -> dict:
    import numpy as np
    from gpu_physics_engine_torch.ops import tiled
    pid, pos, _, rad = tiled.export_particles(e.state)
    if not np.array_equal(pid, np.arange(n)):
        raise AssertionError(f"{label}: pid set is not arange({n}) "
                             f"({len(pid)} live)")
    cfg = e.config
    if not np.isfinite(pos).all():
        raise AssertionError(f"{label}: non-finite positions")
    inside = ((pos[:, 0] >= rad - 1e-4)
              & (pos[:, 0] <= cfg.world_width - rad + 1e-4)
              & (pos[:, 1] >= rad - 1e-4)
              & (pos[:, 1] <= cfg.world_height - rad + 1e-4))
    if not inside.all():
        raise AssertionError(f"{label}: {int((~inside).sum())} particles "
                             "outside [r, W-r] x [r, H-r]")
    speed = np.linalg.norm(e.velocities(), axis=1)
    return {"stale_pct": float(tiled.stale_pair_fraction(e.state, cfg))
            * 100.0, "speed_mean": float(speed.mean()),
            "speed_p99": float(np.percentile(speed, 99)),
            "tile": tiled.tile_geometry(cfg)[0]}


def phase_engine(make, n, windows, label, expect) -> dict:
    """Drive the engine ``make()`` builds on the card through ``windows`` =
    [(steps, mouse or None)]; the launch counts are zeroed just before the
    windows and must equal ``expect`` just after; then conservation,
    bounds, ms/step and quality."""
    import torch
    from gpu_physics_engine_torch.core.tuned import QUALITY_EXPECTATION
    t0 = time.perf_counter()
    e = make()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = e.config
    if e.num_particles() != n:
        raise AssertionError(f"{label}: init placed {e.num_particles()}")
    win_ms, win_of = [], []
    reset_launches()
    for steps, mouse in windows:
        if mouse is not None:
            e.press_mouse(mouse)
        of0 = int(e.state.overflow_count)
        win_ms.append(cuda_ms(lambda: e.run(steps), reps=1, warmup=0)
                      / steps)
        win_of.append((int(e.state.overflow_count) - of0) / steps)
    torch.cuda.synchronize()
    got = launches()
    for name, want in expect.items():
        if got[name] != want:
            raise AssertionError(f"{label}: launches {got}, expected "
                                 f"{expect}")
    steps_total = sum(s for s, _ in windows)
    q = _check_engine(e, n, label)
    # 32 more steps as they come after the windows (mouse still held)
    steady = cuda_ms(lambda: e.run(32), reps=1, warmup=0) / 32
    log(f"[{label}] solver {cfg.tiled_solver} geometry cap {cfg.tile_cap} "
        f"x {list(e.state.dims[1:])} match {cfg.tiled_match} interval "
        f"{cfg.tiled_relocate_interval} sweep {cfg.tiled_sweep} every "
        f"{cfg.sort_interval_steps}; init {init_s:.1f} s")
    log(f"[{label}] launches {got} over {steps_total} steps; all {n} pids "
        f"present, finite, inside the world")
    log(f"[{label}] ms/step (CUDA events) windows "
        f"{[round(w, 4) for w in win_ms]} (sweeps included), next 32 "
        f"steps {steady:.4f}")
    if cfg.tiled_solver == "gs":
        log(f"[{label}] stale {q['stale_pct']:.4f}%  overflow per frame "
            f"(clamp + deferrals) windows {[round(o, 1) for o in win_of]}"
            f"  watchdog events {e.watchdog_events}; speed mean "
            f"{q['speed_mean']:.3f} p99 {q['speed_p99']:.3f} per step "
            f"(tile edge {q['tile']:.3f})")
    else:
        dpp = sum(o * s for o, (s, _) in zip(win_of, windows)) \
            / steps_total / n * 100.0
        log(f"[{label}] stale {q['stale_pct']:.4f}%  deferred {dpp:.4f}%"
            f"/step (population {dpp * cfg.tiled_relocate_interval:.4f}%)"
            f"  watchdog events {e.watchdog_events}  expectation (deferred "
            f"population %, stale %) <= {QUALITY_EXPECTATION.get(n)}; speed"
            f" mean {q['speed_mean']:.3f} p99 {q['speed_p99']:.3f} per step"
            f" (tile edge {q['tile']:.3f})")
    return {"launches": got, "steady_ms": steady, "win_ms": win_ms,
            "engine": e}


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for each kernel's work
# ---------------------------------------------------------------------------

def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tile_counts(state):
    """(occupants per tile, occupants in each tile's 3x3 neighbourhood)."""
    import torch
    n = (state.pid >= 0).sum(0, dtype=torch.int32).float()[None, None]
    box = torch.nn.functional.conv2d(n, torch.ones(1, 1, 3, 3,
                                                   device=n.device),
                                     padding=1)
    return n[0, 0], box[0, 0]


def bounds(cfg, state, gs_cfg, gs_state) -> dict:
    """Per kernel (least ms, "bytes" or "operations"): each input read once,
    each output written once; operations counted from this run's data
    (5 flops per candidate pair's distance test, 25 per Verlet step, 9 per
    membership test, 8 per GS pair).  The parity kernels at the 1M-GS
    scene's parity shape: the same counts, no radius plane (uniform)."""
    import torch
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    cap, TY, TX = state.dims
    S = cap * TY * TX * 4.0  # bytes of one plane
    n, box = _tile_counts(state)
    occ = float(n.sum())
    pairs = float((n * box).sum()) - occ  # occupied (slot, candidate) pairs
    rplanes = 0 if cfg.tiled_uniform_radius else 1
    out = {
        "collide_integrate": _bound((5 + rplanes + 4) * S + 16,
                                    5 * pairs + 25 * occ),
        "collide": _bound((3 + rplanes + 2) * S, 5 * pairs),
        "relocate_pull": _bound(12 * S + TY * TX * 4.0, 10 * occ),
    }
    K = gs_cfg.max_occupancy
    gcap, GY, GX = gs_state.dims
    gocc = float((gs_state.pid >= 0).sum())
    _, _, _, count = gk.rank_cuda(gs_state, gs_cfg)
    m = torch.clamp(count, max=K).double()
    out["gs_rank"] = _bound(4 * gcap * GY * GX * 4.0 + (3 * K + 1) * GY * GX
                            * 4.0, 9 * 9 * gocc)
    # per launch (a quarter of the frame): each valid rank's code and
    # radius read, its x, y read and written; its pairs' sweep
    out["gs_color"] = _bound(24 * float(m.sum()) / 4,
                             8 * float((m * (m - 1) / 2).sum()) / 4)
    ps = gp.to_parity_state(gs_state, gs_cfg)
    P = float(ps.x.numel()) * 4.0  # bytes of one parity-space field
    cells = float(ps.pid[:, 0].numel())
    _, _, _, pcount = gp.rank_par_cuda(ps, gs_cfg)
    pm = torch.clamp(pcount, max=K).double()
    out["gs_rank_par"] = _bound(3 * P + (3 * K + 1) * cells * 4.0,
                                9 * 9 * gocc)
    out["gs_color_par"] = _bound(24 * float(pm.sum()) / 4,
                                 8 * float((pm * (pm - 1) / 2).sum()) / 4)
    out["gs_color_par[mx]"] = out["gs_color_par[dec]"] = out["gs_color"]
    out["relocate_par"] = _bound(10 * P + cells * 4.0, 10 * gocc)
    # in place: the pid plane is read, and x, y, px, py of occupied slots
    # are read and written; empty slots keep their values
    out["gs_verlet"] = _bound(P + 32 * gocc, 25 * gocc)
    return out


def _par_runs(gs_cfg, gs_state) -> dict:
    """The parity kernels' timing runs at the 1M-GS scene's parity shape:
    name -> (kernel, plain, launches per call).  The colors run on the par
    layout (K5-par's tables) and on the mx and dec layouts (K5's tables
    relayouted); the relocate on a jittered copy; the Verlet tail with
    the mouse pressed."""
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import tiled
    cfg = gs_cfg
    ps = gp.to_parity_state(gs_state, cfg)
    far = gp.to_parity_state(_jittered(
        gs_state, 0.3 * tiled.tile_geometry(cfg)[0], seed=2), cfg)
    src, _, rrad, _ = gp.rank_par_cuda(ps, cfg)
    fsrc, _, frrad, _ = gk.rank_cuda(gs_state, cfg)
    prm = StepParams.make(cfg.dt, mouse=(0.5 * cfg.world_width,
                                         0.5 * cfg.world_height),
                          pressed=True).as_tensor("cuda")
    v = [a.clone() for a in (ps.x, ps.y, ps.px, ps.py)]

    def colors(fn, geo, tables):
        x, y = gp.to_parity(gs_state.x, geo, 0.0), gp.to_parity(
            gs_state.y, geo, 0.0)
        return lambda: [fn(x, y, *tables, cfg, geo, c) for c in (1, 2, 3, 4)]

    runs = {
        "gs_rank_par": (lambda: gp.rank_par_cuda(ps, cfg),
                        lambda: gp.rank_par_plain(ps, cfg), 1),
        "gs_color_par": (colors(gp.color_par_cuda_, ps.geo, (src, rrad)),
                         colors(gp.color_par_plain_, ps.geo, (src, rrad)), 4),
        "relocate_par": (lambda: gp.relocate_par_cuda(far, cfg),
                         lambda: gp.relocate_par_plain(far, cfg), 1),
        "gs_verlet": (lambda: gp.verlet_cuda_(*v, ps.pid, prm, cfg),
                      lambda: gp.verlet_plain_(*v, ps.pid, prm, cfg), 1),
    }
    for name, origin in (("mx", 0), ("dec", -1)):
        geo = gp.ParityGeometry(*gs_state.dims[1:], origin)
        tables = (gp.to_parity(fsrc, geo, -1), gp.to_parity(frrad, geo, 0.0))
        runs[f"gs_color_par[{name}]"] = (
            colors(gp.color_par_cuda_, geo, tables),
            colors(gp.color_par_plain_, geo, tables), 4)
    return runs, list(ps.x.shape)


def phase_times(cfg, state, gs_cfg, gs_state) -> dict:
    """Every kernel against its plain version at the main paths' shapes:
    K1, K2, K3 at the 4M shape, K5 and K6 (one color launch) at the
    1M-GS shape, the parity kernels at its parity shape, on the engines'
    initial scenes (after a mouse drag most particles are members of no
    cell, and K6 would have little to do).  Turns: plain, kernel, kernel,
    plain."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    prm = StepParams.make(cfg.dt).as_tensor("cuda")
    moved = _jittered(state, 0.3 * tiled.tile_geometry(cfg)[0], seed=2)
    src, _, rrad, _ = gk.rank_cuda(gs_state, gs_cfg)
    gx, gy = gs_state.x.clone(), gs_state.y.clone()

    def colors(fn):
        for c in (1, 2, 3, 4):
            fn(gx, gy, src, rrad, gs_cfg, c)

    runs = {  # name: (kernel, plain, launches per call)
        "collide_integrate": (lambda: tk.collide_integrate_cuda(state, prm,
                                                                cfg),
                              lambda: tk.collide_integrate_plain(state, prm,
                                                                 cfg), 1),
        "relocate_pull": (lambda: tk.relocate_pull_cuda(moved, cfg),
                          lambda: tk.relocate_pull_plain(moved, cfg), 1),
        "collide": (lambda: tk.collide_cuda(state, cfg),
                    lambda: tk.collide_plain(state, cfg), 1),
        "gs_rank": (lambda: gk.rank_cuda(gs_state, gs_cfg),
                    lambda: gk.rank_plain(gs_state, gs_cfg), 1),
        "gs_color": (lambda: colors(gk.color_cuda_),
                     lambda: colors(gk.color_plain_), 4),
    }
    shapes = {name: list(state.dims) for name in runs}
    shapes.update(gs_rank=list(gs_state.dims), gs_color=list(gs_state.dims))
    par, par_shape = _par_runs(gs_cfg, gs_state)
    runs.update(par)
    shapes.update({name: par_shape for name in par})
    out = {}
    for name, (kern, plain, per) in runs.items():
        p1 = cuda_ms(plain, reps=2) / per
        k1 = cuda_ms(kern, reps=20) / per
        k2 = cuda_ms(kern, reps=20) / per
        p2 = cuda_ms(plain, reps=2) / per
        out[name] = (min(k1, k2), min(p1, p2))
        log(f"[time] {name} {shapes[name]}: kernel {k1:.4f} / {k2:.4f} ms, "
            f"plain {p1:.3f} / {p2:.3f} ms per launch")
    torch.cuda.synchronize()
    return out


def cross_check(label, flat, other, what) -> None:
    """Two engines driven through the same steps from the same seed: the
    full-space states bit-equal (x, y, px, py, pid, overflow_count) and the
    same watchdog events."""
    import torch
    fields = ("x", "y", "px", "py", "pid", "overflow_count")
    diff = [f for f in fields if not torch.equal(getattr(flat.state, f),
                                                 getattr(other.state, f))]
    if diff or flat.watchdog_events != other.watchdog_events:
        errs = {f: float((getattr(flat.state, f).double()
                          - getattr(other.state, f).double()).abs().max())
                for f in diff}
        raise AssertionError(f"{label}: the {what} engine differs from the "
                             f"flat engine in {diff} (max err {errs}), "
                             f"watchdog {other.watchdog_events} vs "
                             f"{flat.watchdog_events}")
    log(f"[xcheck] {label}: {what} == flat bit for bit ({', '.join(fields)})"
        f" after {flat._steps_done} steps")


KERNELS = (  # name, launch counter, source, the TPU kernel it replaces,
    # the driven path whose launches it reports
    ("collide_integrate", "collide_integrate", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "4M"),
    ("relocate_pull", "relocate_pull", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:945", "4M"),
    ("collide", "collide", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:455", "4M-unfused"),
    ("gs_rank", "gs_rank", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:467", "1M-GS"),
    ("gs_color", "gs_color", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:543", "1M-GS"),
    ("gs_rank_par", "gs_rank_par", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:275", "1M-GS-par"),
    ("gs_color_par", "gs_color_par", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:433", "1M-GS-par"),
    ("gs_verlet", "gs_verlet", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:353", "1M-GS-par"),
    ("relocate_par", "relocate_par", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:689", "1M-GS-par"),
    ("gs_color_par[mx]", "gs_color_par", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:1045", "1M-GS-mx"),
    ("gs_color_par[dec]", "gs_color_par", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:783", "1M-GS-dec"),
)

FLAT_GS = ("gs_rank", "gs_color", "relocate_pull")
PAR_GS = ("gs_rank_par", "gs_color_par", "relocate_par", "gs_verlet")


def _gs_expect(steps: int, layout: str) -> dict:
    """Launch counts of ``steps`` GS steps in ``layout``."""
    per = {"flat": dict(gs_rank=1, gs_color=4, relocate_pull=1),
           "par": dict(gs_rank_par=1, gs_color_par=4, relocate_par=1,
                       gs_verlet=1),
           "mx": dict(gs_rank=1, gs_color_par=4, relocate_pull=1)}
    per["dec"] = per["mx"]
    want = {k: 0 for k in FLAT_GS + PAR_GS + ("collide_integrate",)}
    want.update({k: v * steps for k, v in per[layout].items()})
    return want


def _gs_start(n: int):
    """The seeded GS scene at n after one flat frame, and how many
    memberships the seeded scene has in border cells before that frame.

    The seeded scene is uniform over [0, W) x [0, H), so some particles
    lie closer than r to a wall; until the first Verlet step clamps them
    into [r, W - r], their circles reach into the border cells.  The flat
    rank counts such memberships; the parity rank keeps border cells
    empty, as the JAX package's _rank_kernel_par does.  After that frame
    the two layouts run the same function, so the layouts are compared
    from there."""
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_kernels as gk, tiled
    cfg = gs_config(n, gs_layout="flat")
    e = TiledEngine(cfg, seed=0, chunk=64, device="cuda")
    count = gk.rank_cuda(e.state, cfg)[3]
    border = int(count.sum()) - int(count[1:-1, 1:-1].sum())
    return tiled.tiled_step_fn(e.state, e.params(), cfg), border


def phase_gs_paths(paths: dict) -> None:
    """The GS engine at 1M (150 free steps, 150 under the drag) and 4M cap
    6 (100 steps), in the flat and the par layout from the same start
    (``_gs_start``), each pair held bit-equal; then 32 steps at 1M in the
    mx and dec layouts from the seeded scene, held to a flat engine over
    the same steps.  Prints the par/flat ms/step."""
    import torch
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    drag = (1524.0, 524.0)
    for label, n, windows in (("1M-GS", 1_048_576, [(150, None),
                                                    (150, drag)]),
                              ("4M-GS", 4_194_304, [(100, None)])):
        steps = sum(s for s, _ in windows)
        start, border = _gs_start(n)
        log(f"[{label}] start: the seeded scene after one flat frame (its "
            f"{border} border-cell memberships are where flat and par "
            f"differ: the par rank masks border cells)")
        runs = {}
        for layout in ("flat", "par"):
            tag = label if layout == "flat" else f"{label}-{layout}"
            runs[layout] = phase_engine(
                lambda: TiledEngine(
                    gs_config(n, gs_layout=layout), chunk=64,
                    initial_state=start.replace(
                        **{f: getattr(start, f).clone()
                           for f in ("x", "y", "px", "py", "radius", "pid",
                                     "num_active", "overflow_count")})),
                n, windows, tag, _gs_expect(steps, layout))
            paths[tag] = runs[layout]["launches"]
        cross_check(label, runs["flat"]["engine"], runs["par"]["engine"],
                    "par")
        f, p = runs["flat"]["win_ms"], runs["par"]["win_ms"]
        log(f"[layout] {label} ms/step per window: par "
            f"{[round(w, 4) for w in p]} vs flat {[round(w, 4) for w in f]}"
            f"; next 32 steps par {runs['par']['steady_ms']:.4f} vs flat "
            f"{runs['flat']['steady_ms']:.4f}")
        del runs, start
        torch.cuda.empty_cache()
    runs = {}
    for layout in ("flat", "mx", "dec"):
        tag = "1M-GS-32" if layout == "flat" else f"1M-GS-{layout}"
        runs[layout] = phase_engine(
            lambda: TiledEngine(gs_config(1_048_576, gs_layout=layout),
                                seed=0, chunk=64, device="cuda"),
            1_048_576, [(32, None)], tag, _gs_expect(32, layout))
        paths[tag] = runs[layout]["launches"]
    for layout in ("mx", "dec"):
        cross_check("1M-GS", runs["flat"]["engine"], runs[layout]["engine"],
                    layout)
    del runs
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import gpu_physics_engine_torch  # noqa: F401  (fails outside the repo)
    from gpu_physics_engine_torch import TiledEngine, make_tuned_engine
    from gpu_physics_engine_torch.core.tuned import gs_config

    smi = phase_environment()
    phase_build()

    errs: dict = {}
    jacobi = []
    for label, n in (("4M", 4_194_304), ("256k", 256_000)):
        e = make_tuned_engine(n, device="cuda")
        moving = _jittered(e.state, 0.05, seed=3)  # some velocity
        jacobi.append((label, e.config,
                       e.state.replace(px=moving.x, py=moving.y)))
        del e
    phase_jacobi_kernels(jacobi, errs)
    big_cfg, big_state = jacobi[0][1:]
    del jacobi

    gs = []
    for label, n in (("1M-GS", 1_048_576), ("4M-GS", 4_194_304)):
        e = TiledEngine(gs_config(n), seed=0, chunk=64, device="cuda")
        gs.append((label, e.config, e.state))
        del e
    phase_gs_kernels(gs, errs)
    phase_par_kernels(gs, errs)
    gs_cfg, gs_state = gs[0][1:]
    del gs
    torch.cuda.empty_cache()

    paths = {}
    run = phase_engine(lambda: make_tuned_engine(4_194_304, device="cuda"),
                       4_194_304, [(150, None), (150, (1524.0, 524.0))],
                       "4M", {"collide_integrate": 300, "relocate_pull": 150})
    paths["4M"] = run["launches"]
    del run
    torch.cuda.empty_cache()
    phase_engine(lambda: make_tuned_engine(256_000, device="cuda"), 256_000,
                 [(250, None)], "256k",
                 {"collide_integrate": 250, "relocate_pull": 125})

    phase_gs_paths(paths)
    run = phase_engine(
        lambda: make_tuned_engine(4_194_304, device="cuda",
                                  tiled_fuse_integrate=False),
        4_194_304, [(64, None)], "4M-unfused",
        {"collide": 64, "relocate_pull": 32, "collide_integrate": 0})
    paths["4M-unfused"] = run["launches"]
    del run
    torch.cuda.empty_cache()

    times = phase_times(big_cfg, big_state, gs_cfg, gs_state)
    bound = bounds(big_cfg, big_state, gs_cfg, gs_state)
    kernels = []
    for name, counter, source, replaces, path in KERNELS:
        n = paths[path][counter]
        if n <= 0:
            raise AssertionError(f"{name}: not launched on the {path} path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"gpu_physics_engine_torch/{source}",
            "replaces": replaces, "launches": n,
            "max_abs_err": errs[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": bound[name][0],
            "bound_by": bound[name][1], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
