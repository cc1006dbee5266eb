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
     GS shapes: rank tables, x, y and overflow_count bit-equal;
  4. the Jacobi main path at 4,194,304 particles (make_tuned_engine, 150
     steps free then 150 with the mouse pressed, crossing the sweep at step
     240) and the rebuild-sweep path at 256,000 (250 steps): launch counts,
     conservation, bounds, ms/step and quality;
  5. the Gauss-Seidel path (tiled_solver="gs", the bench's GS config) at
     1,048,576 particles for 300 steps (150 free, 150 with the mouse at
     the world centre) and at 4,194,304 (cap 6) for 100 steps: K5 once,
     K6 four times and K2 once per step, the same checks;
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
    from gpu_physics_engine_torch.ops import gs_kernels, tiled_kernels
    tiled_kernels.reset_launches()
    gs_kernels.reset_launches()


def launches() -> dict:
    from gpu_physics_engine_torch.ops import gs_kernels, tiled_kernels
    return {**tiled_kernels.LAUNCHES, **gs_kernels.LAUNCHES}


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
    if e.num_particles() != n or int(e.state.overflow_count) != 0:
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
    membership test, 8 per GS pair)."""
    import torch
    from gpu_physics_engine_torch.ops import gs_kernels as gk
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
    _, _, _, count = gk.rank_cuda(gs_state, gs_cfg)
    m = torch.clamp(count, max=K).double()
    out["gs_rank"] = _bound(4 * gcap * GY * GX * 4.0 + (3 * K + 1) * GY * GX
                            * 4.0, 9 * 9 * float((gs_state.pid >= 0).sum()))
    # per launch (a quarter of the frame): each valid rank's code and
    # radius read, its x, y read and written; its pairs' sweep
    out["gs_color"] = _bound(24 * float(m.sum()) / 4,
                             8 * float((m * (m - 1) / 2).sum()) / 4)
    return out


def phase_times(cfg, state, gs_cfg, gs_state) -> dict:
    """Every kernel against its plain version at the main paths' shapes:
    K1, K2, K3 at the 4M shape, K5 and K6 (one color launch) at the
    1M-GS shape, on the engines' initial scenes (after a mouse drag most
    particles are members of no cell, and K6 would have little to do).
    Turns: plain, kernel, kernel, plain."""
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
    out = {}
    for name, (kern, plain, per) in runs.items():
        p1 = cuda_ms(plain, reps=2) / per
        k1 = cuda_ms(kern, reps=20) / per
        k2 = cuda_ms(kern, reps=20) / per
        p2 = cuda_ms(plain, reps=2) / per
        out[name] = (min(k1, k2), min(p1, p2))
        shape = list((gs_state if name.startswith("gs") else state).dims)
        log(f"[time] {name} {shape}: kernel {k1:.4f} / {k2:.4f} ms, plain "
            f"{p1:.3f} / {p2:.3f} ms per launch")
    torch.cuda.synchronize()
    return out


KERNELS = (  # name, source, the TPU kernel it replaces, its main path
    ("collide_integrate", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "4M"),
    ("relocate_pull", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:945", "4M"),
    ("collide", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:455", "4M-unfused"),
    ("gs_rank", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:467", "1M-GS"),
    ("gs_color", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:543", "1M-GS"),
)


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

    run = phase_engine(
        lambda: TiledEngine(gs_config(1_048_576), seed=0, chunk=64,
                            device="cuda"),
        1_048_576, [(150, None), (150, (1524.0, 524.0))], "1M-GS",
        {"gs_rank": 300, "gs_color": 1200, "relocate_pull": 300,
         "collide_integrate": 0})
    paths["1M-GS"] = run["launches"]
    del run
    torch.cuda.empty_cache()
    phase_engine(
        lambda: TiledEngine(gs_config(4_194_304), seed=0, chunk=64,
                            device="cuda"),
        4_194_304, [(100, None)], "4M-GS",
        {"gs_rank": 100, "gs_color": 400, "relocate_pull": 100})
    torch.cuda.empty_cache()
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
    for name, source, replaces, path in KERNELS:
        n = paths[path][name]
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
