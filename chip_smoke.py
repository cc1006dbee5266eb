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
     uniform and the general radius at small shapes (box and circle
     worlds, and a [6, 21, 39] grid that is no multiple of K1's 8 x 32
     region) and at the 4M [8, 640, 1850], 1M [6, 480, 1388] and 256k
     [9, 176, 506] shapes, bit-equal; K2 (pull relocate, one launch on a
     shared-memory window; its window bytes == the Python mirror
     at every cap) there, on the ragged grid and on a small scene at cap 32
     (K2-par too), for flip / flip2 / greedy, hysteresis on and off, and
     at the GS shapes [4, 960, 2773] and [6, 960, 2773],
     bit-equal; K5 (GS rank) and K6 (GS color solve, one launch of the
     color window a solve) on a small mixed-radius scene with a jammed
     cluster (clamp overflow) and at both GS shapes: rank tables, x, y and
     overflow_count bit-equal; K6's window alone with colors 1..c for
     c = 1..4 and, under a uniform radius, with the Verlet tail (alone and
     after each c), bit-equal and on repeat, there and below; K5 and
     K5-par (the rank's shared-memory window; its bytes == the Python
     mirror at every cap) and K6 and K6-par (the color window; its bytes
     == the mirror at every cap and number of colors) also on a 40 x 30
     world's ragged grid and at cap 32 with K 16, with and without a
     radius plane, at origins 0 and -1, and K6 on a 20 x 12 world's grid
     smaller than one window; the parity-space kernels there too, on a
     small uniform scene as well, at the parity shapes [4, 4, 480, 1387]
     and [4, 6, 480, 1387]: K5-par (origins 0 and -1, one launch for all
     parities and one per parity), K6-par's window on the par layout at
     both origins and on the mx and dec layouts, K2-par (both launch
     modes, origins 0 and -1, every matching mode), all bit-equal; the mx
     and dec solves bit-equal to the flat solve; the fused kernels there
     too: colors_mega (with and without the tail) == its plain version ==
     K6-par's launch, relocate_mega (K2's window over all four
     parities) == K2-par, also on the ragged grid and at cap 32 in every
     matching mode at origins 0 and -1, and K4 (K2's window with K4's step
     rule) == its plain version at the 4M shape, a small mixed-radius one,
     the ragged grid and cap 32, and == K2 under flip with delta 0 away from
     particles within an ulp of a tile edge (the rules part there);
     before these, the tile division: ``tiled._tile_of`` on the card ==
     numpy's f32 floor(x / t) on the 4M scene and on every tile-edge probe
     (with the count the reciprocal forms would misplace), and one claim
     relocate of the jittered 4M state on the card == the CPU's;
  4. the Jacobi main path at 4,194,304 particles (make_tuned_engine, 150
     steps free then 150 with the mouse pressed, crossing the sweep at step
     240), at 1,048,576 (128 steps) and the rebuild-sweep path at 256,000
     (250 steps): launch counts, conservation, bounds, ms/step and
     quality; then K2 against its plain version on each engine's own
     final state, in every matching mode;
  4b. spawns and the big-particle overlay on the 4M engine: three
     ``spawn_at`` bursts of 100 (every radius 1-3 to the overlay, which
     grows 128 -> 512 slots; the tile edge kept, tiled_uniform_radius
     off), then the 4M windows with the hybrid step (K1's general-radius
     form 300 times, K2 150; the merged pids arange(n + 300), finite,
     inside the world), ms/step beside the 4M run's; on its final state
     K1's general form bit-equal to its plain version at [8, 640, 1850]
     and on repeat, ``couple_bigs`` card == CPU bit for bit and on
     repeat, ``render_frame`` with the overlay within one u8 of the CPU's,
     and a jammed 3 x 3 block's far-spill insert card == CPU;
  5. the Gauss-Seidel path (tiled_solver="gs", the bench's GS config) at
     1,048,576 particles for 300 steps (150 free, 150 with the mouse at
     the world centre) and at 4,194,304 (cap 6) for 100 steps, each in the
     flat layout (K5, K6 and K2 once per step), in the parity layout
     "par" (K5-par, K6-par with the Verlet tail fused and K2-par once per
     step; no flat K5/K6/K2) and in "par" with
     gs_colors_mega and gs_relocate_mega ("mega": K5-par, colors_mega and
     relocate_mega once per step; no K6-par, K2-par or tail launch), the
     same checks, and the three final states bit-equal, K2 and K2-par
     held to their plain versions on the flat and par engines' final
     states; then 32 steps at
     1M in the "mx" and "dec" layouts (K5, K6-par, K2), bit-equal to flat;
     then K4's path, the probe's 4M frame loop with K4 as the relocate
     (32 steps), beside the same loop with K2;
  5b. the device compositor (render/device.py, plain PyTorch: no kernel
     of its own): ``render_core`` on the card within one u8 of the CPU's
     on the initial 4M scene (S = 1, the auto-fit and a zoomed,
     off-centre rect) and a jittered 256k scene (S = 2); then the frame
     loop, ``render_run`` (a step and a 1280 x 720 frame) at 4M, 1M and
     1M-GS par, 64 frames after 64 of warm-up, beside ``run()`` over the
     same steps on a twin engine (the same launch counts, the states bit
     for bit after), with frame ms, ms/step and ``render_throughput_ms``
     (the frames as ``render_run`` draws them, from parity space under
     "par"); ``step_render_frame`` == ``step()`` + ``render_frame()`` at 1M
     over 3 frames; at 1M-GS par the parity frame within one u8 of the
     full-space frame, and its time beside ``from_parity_state`` +
     ``render_core``'s;
  6. the array Engine (pipeline "sorted", the 4-color Gauss-Seidel solve,
     the Morton resort every 240 steps) at the README's 1,000,000
     particles in 1,100,800 slots, sort_impl="radix": first the radix
     sort's three kernels, K12 (the rank/histogram pass), radix_offsets
     (the digit-offset scan) and radix_scatter, against their plain
     versions, twice, bit-equal, for all 4 passes of a sort, on a
     25,006-key reverse ramp with duplicates and sentinels, on the scene's
     4,403,200 pair keys and on its 1,100,800 resort codes, each whole
     radix sort equal to torch.sort(stable=True); the scene's candidate
     cells on the card equal to the CPU's; then 256 steps (128 free, 128
     with the mouse at the world centre, crossing the resort at step 240)
     with 4 x 256 + 4 launches of each radix kernel, the same run with
     sort_impl="lax" (no radix launch, final state bit-equal), and 64
     steps each of pipeline "bucket" and solver "jacobi";
  6b. the engine options that raised before (phase_options): the fast
     solver (solver="fast", the sort + shift Jacobi) on the 1M array
     Engine with fast_pack_bf16 on and off, the windows of the radix
     engine (256 steps, the resort at step 240 launching K12 and the radix
     pass 4 times), and card == CPU bit for bit for both packings on a
     10,000-particle scene over 8 steps; the 4M-GS engine (the card's par
     layout: K5-par, K6-par's window, K2-par) with tiled_sweep="bands"
     for 1,232 steps (5 periodic sweeps, at least 10 band drains) beside
     the claim sweep from the same start, with the stale % after each
     sweep and the band drains' ms, then ``rebuild_band`` on the card ==
     the CPU's at three row starts of its final state; the hybrid sweep
     (make_tuned_engine(512_000), claim sweep, tiled_rebuild_every=4) for
     1,000 steps, the 4th sweep the rebuild; the 4M-spawn engine's
     checkpoint (saved after its windows in phase 4b, 300 bigs) loaded on
     the card equal to the saved engine and to a CPU load bit for bit,
     then 64 steps with the seconds of each;
  7. the unfused path (tiled_fuse_integrate=False) at 4,194,304 for 64
     steps: K3 on every step;
  8. kernel times at the main paths' shapes against their plain versions,
     with each kernel's bound on this card (and, for K12, the time of
     torch.sort(stable=True) of the same pairs beside the whole hand radix
     sort's).

Then a line {"kernels": [...]} and, last, the result line
{"ok": true, "device": {...}}.  Without a CUDA device (or without the
package beside this script) it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from gpu_physics_engine_torch.utils.profiling import cuda_ms

# H100 SXM data-sheet peaks (dense): device memory bytes/s and f32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def _counted():
    from gpu_physics_engine_torch.ops import (gs_kernels, gs_mega, gs_parity,
                                              radix_sort, tiled_kernels)
    return (tiled_kernels, gs_kernels, gs_parity, gs_mega, radix_sort)


def reset_launches() -> None:
    for m in _counted():
        m.reset_launches()


def launches() -> dict:
    out = {}
    for m in _counted():
        out.update(m.LAUNCHES)
    return out


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


def check_window_formula() -> None:
    """The shared-memory bytes of K2's, K5's and K6's windows, as the
    launches take them from csrc/, equal the Python mirrors
    (``tiled_kernels.k2_window_bytes``, ``gs_kernels.rank_window_bytes``,
    ``gs_kernels.colors_window_bytes``) at every cap 1-32 (K2 on both
    layouts; K5, whose geometry is one for both, with and without a radius
    plane; K6, one geometry too, for 0-4 colors a launch)."""
    from gpu_physics_engine_torch.ops import _cuda, gs_kernels as gk
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    lib = _cuda.library()
    most = {}
    for par in (False, True):
        for cap in range(1, tk.MAX_CAP + 1):
            pairs = [("K2", tk.k2_window_bytes(cap, par),
                      lib.gpe_relocate_window_bytes(cap, int(par)))]
            pairs += [("K5", gk.rank_window_bytes(cap, uniform),
                       lib.gpe_gs_rank_window_bytes(cap, int(uniform)))
                      for uniform in (False, True)]
            pairs += [("K6", gk.colors_window_bytes(cap, colors),
                       lib.gpe_gs_colors_window_bytes(cap, colors))
                      for colors in range(5)]
            for what, want, got in pairs:
                if got != want:
                    raise AssertionError(
                        f"{what} window at cap {cap} par={par}: launch "
                        f"{got} B, mirror {want} B")
                most[what, par] = max(most.get((what, par), 0), want)
    log(f"[window] bytes of the launches == the Python mirrors at caps "
        f"1-{tk.MAX_CAP}: K2 most {most['K2', False]} B flat, "
        f"{most['K2', True]} B parity; K5 most {most['K5', False]} B; K6 "
        f"most {most['K6', False]} B")


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


def _clone(state):
    """A TileState with every tensor copied."""
    return state.replace(**{f: getattr(state, f).clone() for f in (
        "x", "y", "px", "py", "radius", "pid", "num_active",
        "overflow_count")})


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


MODES = [(m, h) for m in ("flip", "flip2", "greedy") for h in (0.0, -1.0)]


def check_relocate(label, cfg, st, modes, errs: dict, jitter=0.6) -> None:
    """K2 (pull relocate) against its plain version on ``st`` with every
    live particle jittered by up to ``jitter`` tile (0: ``st`` as it is),
    for each (match, hysteresis) of ``modes``: bit-equal, bit-equal on
    repeat, no pid lost."""
    import torch
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    moved = (_jittered(st, jitter * tiled.tile_geometry(cfg)[0], seed=1)
             if jitter else st)
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
            f"repeat bit-equal, deferred {int(da.sum())} of {n_live}, "
            f"{int((a.pid != moved.pid).sum())} pid slots changed")


def check_relocate_par(label, cfg, st, modes, errs: dict, jitter=0.6,
                       seed=40) -> None:
    """K2-par against its plain version on ``st`` (full space) with every
    live particle jittered by up to ``jitter`` tile (0: as it is), at
    origin 0 and -1, in one launch over all parities and in one per
    parity (gs_par_fused=False), for each (match, hysteresis) of
    ``modes``: bit-equal, bit-equal on repeat, no pid lost."""
    from gpu_physics_engine_torch.ops import gs_parity as gp, tiled
    moved = (_jittered(st, jitter * tiled.tile_geometry(cfg)[0], seed=seed)
             if jitter else st)
    n_live = int((moved.pid >= 0).sum())
    for match, hyst in modes:
        c0 = cfg.replace(tiled_match=match, tiled_hysteresis=hyst)
        for origin in (0, -1):
            far = gp.to_parity_state(moved, c0, origin)
            b, db = gp.relocate_par_plain(far, c0)
            fields = ("x", "y", "px", "py", "pid", "overflow_count") + (
                () if far.radius is None else ("radius",))
            for fused in (True, False):
                c = c0.replace(gs_par_fused=fused)
                a, da = gp.relocate_par_cuda(far, c)
                a2, da2 = gp.relocate_par_cuda(far, c)
                _equal_or_raise(
                    f"K2-par {label} {match} hysteresis={hyst} origin="
                    f"{origin} fused={fused}",
                    tuple(getattr(a, f) for f in fields) + (da,),
                    tuple(getattr(b, f) for f in fields) + (db,),
                    tuple(getattr(a2, f) for f in fields) + (da2,))
                if int((a.pid >= 0).sum()) != n_live:
                    raise AssertionError(f"K2-par {label} {match}: lost pids")
        log(f"[k2-par] {label} {list(far.x.shape)} {match} hysteresis="
            f"{c0.hysteresis_delta:.3g}: origins 0 and -1, one launch and "
            f"one per parity, bit-equal and repeat bit-equal, deferred "
            f"{int(da.sum())} of {n_live}")
    errs["relocate_par"] = 0.0


def _ragged_state(cap, uniform):
    """A small scene whose grid is no multiple of K1's 8 x 32 region nor
    K2's: TX 39, and TY 21 (three of the empty rows above the world
    dropped; one stays as the ring)."""
    import numpy as np
    from gpu_physics_engine_torch import SimConfig
    from gpu_physics_engine_torch.ops import tiled
    cfg = SimConfig(max_particles=1500, initial_particles=1500,
                    world_width=80.0, world_height=33.0, pipeline="tiled",
                    tile_cap=cap, tiled_uniform_radius=uniform)
    rng = np.random.default_rng(11)
    pos = np.stack([rng.uniform(0.6, 79.4, 1500),
                    rng.uniform(0.6, 32.4, 1500)], -1).astype(np.float32)
    rad = (np.full(1500, 0.5, np.float32) if uniform
           else rng.uniform(0.3, 0.5, 1500).astype(np.float32))
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    st = tiled.init_tiles(cfg, pos, rad, previous_positions=prev,
                          device="cuda")
    ty = st.dims[1] - 3
    if bool((st.pid[:, ty - 1:] >= 0).any()):
        raise AssertionError("ragged scene: particles in the rows cut")
    return cfg, st.replace(**{f: getattr(st, f)[:, :ty].contiguous()
                              for f in tiled.FIELDS})


def phase_jacobi_kernels(scenes, errs: dict) -> None:
    """K1, K3 and K2 against their plain versions on the card, at small
    shapes (box and circle worlds, a grid no multiple of K1's or K2's
    region) and at each Jacobi path's ``scenes`` [(label, config, state)]:
    K1 and K3 bit-equal and bit-equal on repeat, uniform and general
    radius; K2 in every matching mode, and at cap 32; K2-par on the ragged
    grid and at cap 32."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    small_cfg, small_uniform = _small_state(4, uniform=True)
    _, small_mixed = _small_state(4, uniform=False)
    ragged_cfg, ragged_uniform = _ragged_state(6, uniform=True)
    _, ragged_mixed = _ragged_state(6, uniform=False)
    # (label, config, state for the uniform variant, for the general one);
    # the general variant reads the radius plane (mixed radii when small)
    shapes = [("small", small_cfg, small_uniform, small_mixed),
              ("small-circle", small_cfg.replace(world_shape="circle"),
               small_uniform, small_mixed),
              ("ragged", ragged_cfg, ragged_uniform, ragged_mixed)] + [
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
                same, rep = _same(a, b, fields), _same(a, a2, fields)
                if not (same and rep and torch.equal(a.pid, b.pid)):
                    raise AssertionError(
                        f"{tag} {label} uniform={uniform}: bit-equal "
                        f"{same} (max err {err}), repeat {rep}")
                errs[name] = max(errs.get(name, 0.0), err)
                moved = int((a.x != s.x).sum())
                log(f"[{tag}] {label} {list(s.dims)} uniform={uniform}: "
                    f"bit-equal and repeat bit-equal ({moved} slots moved)")
        # K2: every matching mode, hysteresis off and auto
        if label != "small-circle":
            check_relocate(label, cfg, st, MODES, errs)
    # K2 at cap 32: the largest window; K2-par there and on the ragged grid
    cap32_cfg, cap32 = _small_state(32, uniform=False)
    check_relocate("small-cap32", cap32_cfg, cap32, MODES, errs)
    for label, cfg, st in (("ragged", ragged_cfg, ragged_mixed),
                           ("small-cap32", cap32_cfg, cap32)):
        check_relocate_par(label, cfg.replace(tiled_uniform_radius=False),
                           st, MODES, errs)


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


def _gs_ragged_state(cap, K, uniform, n=1500, world=(40.0, 30.0)):
    """A small GS scene on a 40 x 30 world: TX 39 is no multiple of K5's
    32-wide flat region nor its parity sub-grids' 20 columns of one of
    32, nor of K6's regions, and at origin -1 DY 17 no multiple of two
    rows (TY itself is padded to a multiple of 8 by the tile geometry, as
    in the JAX package); a 20 x 12 world's [cap, 16, 21] grid is smaller
    than one K6 window; mixed radii (or uniform) with a jammed cluster."""
    import numpy as np
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import tiled
    w, h = world
    cfg = gs_config(n, world_width=w, world_height=h, tile_cap=cap,
                    max_occupancy=K, tiled_uniform_radius=uniform)
    rng = np.random.default_rng(cap)
    spread = rng.uniform(0.6, [w - 0.6, h - 0.6], (n - n // 3, 2))
    jam = np.clip([w / 2, h / 2] + rng.normal(0.0, 2.0, (n // 3, 2)), 0.6,
                  [w - 0.6, h - 0.6])
    pos = np.concatenate([spread, jam]).astype(np.float32)
    rad = (np.full(n, cfg.initial_radius, np.float32) if uniform
           else rng.uniform(0.3, 0.5, n).astype(np.float32))
    return cfg, tiled.init_tiles(cfg, pos, rad, device="cuda")


def _prm(cfg):
    """A substep's Verlet parameters with the mouse pressed at the world's
    centre (on the card), where the config allows the fused tail (uniform
    radius, box world), else None."""
    from gpu_physics_engine_torch import StepParams
    if not (cfg.tiled_uniform_radius and cfg.world_shape == "box"):
        return None
    return StepParams.make(cfg.dt, mouse=(0.5 * cfg.world_width,
                                          0.5 * cfg.world_height),
                           pressed=True).as_tensor("cuda")


def _tails(cfg) -> str:
    return ", with and without the tail" if _prm(cfg) is not None else ""


def check_window(label, cfg, st, errs: dict) -> None:
    """K6's window on ``st`` with its own rank's tables, flat and on the
    parity layout at origins 0 and -1 (no radius table read where the
    parity state drops the radius plane, as the par route does):
    ``_colors_lockstep`` on each."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    src, _, rrad, _ = gk.rank_cuda(st, cfg)
    _colors_lockstep(f"K6 {label}", (st.x, st.y, st.px, st.py, st.pid),
                     (src, rrad), cfg, None, errs, "gs_color", _prm(cfg))
    shapes = []
    for origin in (0, -1):
        ps = gp.to_parity_state(st, cfg, origin)
        shapes.append(list(ps.x.shape))
        psrc, _, prrad, _ = gp.rank_par_cuda(ps, cfg)
        _colors_lockstep(f"K6-par {label} origin={origin}",
                         (ps.x, ps.y, ps.px, ps.py, ps.pid), (psrc, prrad),
                         cfg, ps.geo, errs, "gs_color_par", _prm(cfg),
                         uniform=ps.radius is None)
    log(f"[k6] {label} {list(st.dims)} and {shapes} K={cfg.max_occupancy} "
        f"uniform={cfg.tiled_uniform_radius}: K6's window, colors 1..c (c = "
        f"1..4{_tails(cfg)}), flat and parity (origins 0 and -1) bit-equal "
        f"and repeat bit-equal")


def check_rank(label, cfg, st, errs: dict) -> None:
    """K5 (flat) and K5-par at origins 0 and -1, in one launch over all
    parities and one per parity, against their plain versions on ``st``
    (its radius plane dropped in parity space under a uniform radius):
    bit-equal and bit-equal on repeat."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    a, a2 = gk.rank_cuda(st, cfg), gk.rank_cuda(st, cfg)
    _equal_or_raise(f"K5 {label}", a, gk.rank_plain(st, cfg), a2)
    errs.setdefault("gs_rank", 0.0)
    shapes = []
    for origin in (0, -1):
        ps = gp.to_parity_state(st, cfg, origin)
        shapes.append(list(ps.x.shape))
        for fused in (True, False):
            c = cfg.replace(gs_par_fused=fused)
            b, b2 = gp.rank_par_cuda(ps, c), gp.rank_par_cuda(ps, c)
            _equal_or_raise(f"K5-par {label} origin={origin} fused={fused}",
                            b, gp.rank_par_plain(ps, c), b2)
    errs["gs_rank_par"] = 0.0
    log(f"[k5] {label} {list(st.dims)} K={cfg.max_occupancy} uniform="
        f"{cfg.tiled_uniform_radius}: K5 and K5-par at {shapes} (origins 0 "
        f"and -1, one launch and one per parity) bit-equal and repeat "
        f"bit-equal; max count {int(a[3].max())}, clamp overflow "
        f"{int((a[3] - cfg.max_occupancy).clamp(min=0).sum())}")


def phase_gs_kernels(scenes, errs: dict) -> None:
    """K5 and K6 against their plain versions: the rank tables, and x, y
    and overflow_count after the four colors, bit-equal; twice each.  At a
    small scene and at each GS path's ``scenes`` [(label, config, state)],
    where K2 is also held to its plain version in every matching mode."""
    import torch
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import tiled
    small_cfg, small = _gs_small_state()
    runs = [("small", small_cfg, small)] + list(scenes)
    for i, (label, cfg, st) in enumerate(runs):
        # storage off home, as in a run
        st = _jittered(st, 0.3 * tiled.tile_geometry(cfg)[0], seed=4 + i)
        ka, ta = gk.solve_frame(st, cfg, gk.rank_cuda, gk.colors_cuda)
        ka2, ta2 = gk.solve_frame(st, cfg, gk.rank_cuda, gk.colors_cuda)
        pb, tb = gk.solve_frame(st, cfg, gk.rank_plain, gk.colors_plain)
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
        moved = _colors_lockstep(
            f"K6 {label}", (st.x, st.y, st.px, st.py, st.pid),
            (ta[0], ta[2]), cfg, None, errs, "gs_color", _prm(cfg))
        log(f"[k5/k6] {label} {list(st.dims)} K={cfg.max_occupancy}: rank "
            f"tables, x, y, overflow bit-equal and repeat bit-equal; K6's "
            f"window colors 1..c (c = 1..4{_tails(cfg)}) too; clamp "
            f"overflow {frame} this frame, max count {int(ta[3].max())}, "
            f"{moved} slots moved")
        if label != "small":
            check_relocate(label, cfg, st, MODES, errs)
    # K5's and K6's windows where they are largest (cap 32, K 16), on a
    # ragged grid and on one smaller than a K6 window, with and without a
    # radius plane
    for uniform in (False, True):
        for label, cap, K, n, world in (("ragged", 4, 8, 1500, (40.0, 30.0)),
                                        ("tiny", 4, 8, 200, (20.0, 12.0)),
                                        ("cap32-K16", 32, 16, 3000,
                                         (40.0, 30.0))):
            cfg, st = _gs_ragged_state(cap, K, uniform, n, world)
            st = _jittered(st, 0.3 * tiled.tile_geometry(cfg)[0], seed=cap)
            if label != "tiny":
                check_rank(label, cfg, st, errs)
            check_window(label, cfg, st, errs)


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


def _colors_lockstep(what, fields, tables, cfg, geo, errs, key, prm=None,
                     uniform=False) -> int:
    """K6's window against the plain passes from the same inputs: colors
    1..c for c = 1..4 and, with ``prm`` (uniform radius, box world), the
    Verlet tail alone and after each c; bit-equal and bit-equal on repeat.
    ``fields`` = (x, y, px, py, pid) and ``tables`` = (src, rrad) in the
    layout of ``geo`` (None: flat); ``uniform``: the kernel reads no radius
    table, as on the par route.  Returns the number of slots the four
    colors moved."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    x, y, px, py, pid = fields
    src, rrad = tables
    grid = (tuple(x.shape[1:]) + (0, 0, 0, 0) if geo is None
            else gp._geo_args(geo) + (1,))
    moved, tails = 0, (False, True) if prm is not None else (False,)
    for c1 in range(5):
        for tail in tails:
            if c1 == 0 and not tail:
                continue
            runs = []
            for _ in range(3):
                q, r = px.clone(), py.clone()
                runs.append((q, r, (q, r, pid, prm) if tail else None))
            got = [gk.window_cuda(what, x, y, src, None if uniform else rrad,
                                  cfg, grid, c1, t,
                                  gp._verlet_consts(cfg) if tail else None,
                                  cfg.initial_radius) + (q, r)
                   for q, r, t in runs[:2]]
            q, r, t = runs[2]
            if geo is None:
                a, b = gk.colors_plain(x, y, src, rrad, cfg, c1)
                if tail:
                    gp.verlet_plain_(a, b, q, r, pid, prm, cfg)
            else:
                a, b = gp.colors_par_plain(x, y, src, rrad, cfg, geo, c1, t)
            _equal_or_raise(f"{what} colors 1..{c1} tail={tail}", got[0],
                            (a, b, q, r), got[1])
            if c1 == 4 and not tail:
                moved = int((got[0][0] != x).sum())
    errs[key] = 0.0
    return moved


def phase_par_kernels(scenes, errs: dict) -> None:
    """The parity-space kernels against their plain versions, bit-equal and
    bit-equal on repeat: K5-par in both launch modes, K6-par's window
    (colors 1..c for each c, and under a uniform radius the Verlet tail,
    mouse pressed, alone and after each c) on the par layout (tables from
    K5-par, no radius table read where the state drops the radius plane)
    and on the mx and dec layouts (K5's tables relayouted), K2-par in both
    launch modes at both origins in every matching mode; the mx and dec
    solves against the flat solve.  On a small mixed-radius
    scene (radius planes carried), a small uniform one and each GS path's
    ``scenes`` [(label, config, state)]."""
    import torch
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
        prm = _prm(cfg)
        for origin in (-1, 0):
            ps = gp.to_parity_state(st, cfg, origin)
            for fused in (True, False):
                c = cfg.replace(gs_par_fused=fused)
                ta, ta2 = gp.rank_par_cuda(ps, c), gp.rank_par_cuda(ps, c)
                _equal_or_raise(f"K5-par {label} origin={origin} "
                                f"fused={fused}", ta,
                                gp.rank_par_plain(ps, c), ta2)
            src, _, rrad, count = ta
            moved = _colors_lockstep(
                f"K6-par {label} origin={origin}",
                (ps.x, ps.y, ps.px, ps.py, ps.pid), (src, rrad), cfg,
                ps.geo, errs, "gs_color_par", prm, uniform=ps.radius is None)
        dims = list(ps.x.shape)
        errs["gs_rank_par"] = 0.0
        if prm is not None:  # the par route's tail is this launch's
            errs["gs_verlet"] = 0.0
        fsrc, _, frrad, _ = gk.rank_cuda(st, cfg)
        for name, origin in (("mx", 0), ("dec", -1)):
            geo = gp.ParityGeometry(*st.dims[1:], origin)
            to = lambda a, fill: gp.to_parity(a, geo, fill)  # noqa: E731
            _colors_lockstep(
                f"K6-{name} {label}", (to(st.x, 0.0), to(st.y, 0.0),
                                       to(st.px, 0.0), to(st.py, 0.0),
                                       to(st.pid, -1)),
                (to(fsrc, -1), to(frrad, 0.0)), cfg, geo, errs,
                f"gs_color_par[{name}]")
            c = cfg.replace(gs_layout=name)
            got, want = gp.gs_solve_layout(st, c), gk.gs_solve_flat(st, c)
            _equal_or_raise(f"{name} solve {label} vs flat",
                            (got.x, got.y, got.overflow_count),
                            (want.x, want.y, want.overflow_count))
        check_relocate_par(label, cfg, st, MODES, errs, seed=40 + i)
        log(f"[par] {label} {dims} match {tk.resolve_match(cfg, *st.dims)}: "
            f"K5-par (origins 0 and -1, fused and per parity), K6-par's "
            f"window (par at origins 0 and -1, mx, dec; colors 1..c for c = "
            f"1..4{_tails(cfg)}), "
            f"K2-par (above) bit-equal and repeat bit-equal; mx and dec "
            f"solves == flat; clamp overflow "
            f"{int((count - cfg.max_occupancy).clamp(min=0).sum())}, "
            f"{moved} slots moved")


def phase_tile_division(cfg, state) -> None:
    """``tiled._tile_of`` on the card against numpy's f32 floor(x / t) + 1:
    on the 4M scene's positions and on the edge probes k * t and their two
    f32 neighbours for every k across the world.  Prints how many of them
    the reciprocal forms would have put in another tile: numpy's
    floor(x * f32(1 / t)) and the card's division by the Python float
    (which PyTorch computes as a product by the reciprocal).  Then one
    claim relocate of the jittered scene on the card against the CPU's."""
    import numpy as np
    import torch
    from gpu_physics_engine_torch.ops import tiled
    from gpu_physics_engine_torch.ops.integrate import f32
    t, TY, TX = tiled.tile_geometry(cfg)
    t32 = np.float32(t)
    occ = state.pid >= 0
    k = np.arange(TX + 2, dtype=np.float32)
    p = k * t32
    probes = np.concatenate([p, np.nextafter(p, np.float32(np.inf)),
                             np.nextafter(p, np.float32(-np.inf))])
    probes = probes[probes >= 0]
    for label, x in (("4M scene x", state.x[occ]), ("4M scene y",
                                                     state.y[occ]),
                     ("edge probes", torch.from_numpy(probes).cuda())):
        hx = x.cpu().numpy()
        want = (np.floor(hx / t32) + 1).astype(np.int32)
        got = tiled._tile_of(x, x, t)[1].cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"_tile_of on the card != f32 division on "
                                 f"{label}: {int((got != want).sum())} of "
                                 f"{len(want)}")
        recip = int(((np.floor(hx * (np.float32(1) / t32)) + 1)
                     .astype(np.int32) != want).sum())
        byfloat = int(((torch.floor(x / f32(t)).to(torch.int32) + 1)
                       .cpu().numpy() != want).sum())
        log(f"[tile] {label}: _tile_of on the card == numpy f32 "
            f"floor(x / t) + 1 on all {len(want)}; floor(x * (1/t)) would "
            f"put {recip} elsewhere, the card's x / float(t) {byfloat}")
    moved = _jittered(state, 0.6 * t, seed=11)
    card = tiled.relocate(moved, cfg)
    cpu = tiled.relocate(moved.replace(**{
        f: getattr(moved, f).cpu() for f in tiled.FIELDS + (
            "num_active", "overflow_count")}), cfg)
    fields = tiled.FIELDS + ("overflow_count",)
    diff = [f for f in fields
            if not torch.equal(getattr(card, f).cpu(), getattr(cpu, f))]
    if diff:
        raise AssertionError(f"claim relocate of the jittered 4M state: "
                             f"card != CPU in {diff}")
    log(f"[tile] claim relocate of the jittered 4M state {list(state.dims)}:"
        f" card == CPU bit for bit ({', '.join(fields)}; overflow "
        f"{int(card.overflow_count) - int(moved.overflow_count)})")


def _rule_mismatch(state, cfg):
    """Occupied slots whose one-hop step differs between K4's rule (the
    home tile by division) and K2's (products, delta 0), and a mask of the
    tiles such a particle can touch (Chebyshev distance 2: its tile, its
    target, and the target's other claimants)."""
    import torch
    from gpu_physics_engine_torch.ops import tiled
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    t, TY, TX = tiled.tile_geometry(cfg)
    TY = state.dims[1]
    sty = torch.arange(TY, device="cuda").view(1, TY, 1)
    stx = torch.arange(TX, device="cuda").view(1, 1, TX)
    a = tiled.step_offsets(state.x, state.y, sty, stx, t=t, delta=0.0,
                           gTY=TY, gTX=TX)
    b = tk.home_offsets(state.x, state.y, sty, stx, t=t, gTY=TY, gTX=TX)
    bad = ((a[0] != b[0]) | (a[1] != b[1])) & (state.pid >= 0)
    near = torch.nn.functional.max_pool2d(
        bad.any(0).float()[None, None], 5, stride=1, padding=2)[0, 0] > 0
    return int(bad.sum()), near


def check_relocate_one(label, cfg, st, errs: dict) -> None:
    """K4 against its plain version (twice, bit-equal) and against K2 under
    flip with delta 0, on ``st`` jittered by up to 0.6 tile.  Where a
    particle lies within an ulp of a tile edge the two rules part; then
    K4 must equal K2 on every tile out of reach of those particles."""
    import torch
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    moved = _jittered(st, 0.6 * tiled.tile_geometry(cfg)[0], seed=7)
    c = cfg.replace(tiled_match="greedy", tiled_hysteresis=-1.0)
    a, da = tk.relocate_one_cuda(moved, c)
    a2, da2 = tk.relocate_one_cuda(moved, c)
    b, db = tk.relocate_one_plain(moved, c)
    fields = tiled.FIELDS + ("overflow_count",)
    _equal_or_raise(f"K4 {label}",
                    tuple(getattr(a, f) for f in fields) + (da,),
                    tuple(getattr(b, f) for f in fields) + (db,),
                    tuple(getattr(a2, f) for f in fields) + (da2,))
    errs["relocate_one"] = 0.0
    k2, dk2 = tk.relocate_pull_cuda(moved, cfg.replace(tiled_match="flip",
                                                       tiled_hysteresis=0.0))
    n_rule, near = _rule_mismatch(moved, cfg)
    if n_rule == 0:
        _equal_or_raise(f"K4 {label} vs K2 flip",
                        tuple(getattr(a, f) for f in fields) + (da,),
                        tuple(getattr(k2, f) for f in fields) + (dk2,))
        vs_k2 = "== K2 (flip, delta 0) bit for bit"
    else:
        far = ~near
        same = all(torch.equal(getattr(a, f)[:, far], getattr(k2, f)[:, far])
                   for f in tiled.FIELDS) and torch.equal(da[far], dk2[far])
        if not same:
            raise AssertionError(f"K4 {label}: differs from K2 (flip) away "
                                 f"from the {n_rule} edge particles")
        ndiff = int((a.pid != k2.pid).sum())
        vs_k2 = (f"== K2 (flip, delta 0) on every tile out of reach of the "
                 f"{n_rule} particles within an ulp of a tile edge (K4 "
                 f"divides, K2 multiplies); {ndiff} pid slots differ near "
                 f"them")
    log(f"[k4] {label} {list(st.dims)}: bit-equal to the plain version and "
        f"on repeat (config greedy, hysteresis auto: ignored), deferred "
        f"{int(da.sum())}; {vs_k2}")


def check_relocate_mega(label, cfg, st, modes, errs: dict,
                        seed=70) -> str:
    """relocate_mega against its plain version and K2-par (one launch over
    all parities) on ``st`` (full space) jittered by up to 0.6 tile, at
    origins 0 and -1, for each (match, hysteresis) of ``modes``:
    bit-equal and bit-equal on repeat.  Returns a summary for the log."""
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import tiled
    moved = _jittered(st, 0.6 * tiled.tile_geometry(cfg)[0], seed=seed)
    deferred = []
    for match, hyst in modes:
        c = cfg.replace(tiled_match=match, tiled_hysteresis=hyst,
                        gs_par_fused=True)
        for origin in (0, -1):
            far = gp.to_parity_state(moved, c, origin)
            a, da = gm.relocate_mega_cuda(far, c)
            a2, da2 = gm.relocate_mega_cuda(far, c)
            fields = ("x", "y", "px", "py", "pid", "overflow_count") + (
                () if far.radius is None else ("radius",))
            for ref, (b, db) in (("plain", gp.relocate_par_plain(far, c)),
                                 ("K2-par", gp.relocate_par_cuda(far, c))):
                _equal_or_raise(
                    f"relocate_mega {label} {match} hysteresis={hyst} "
                    f"origin={origin} vs {ref}",
                    tuple(getattr(a, f) for f in fields) + (da,),
                    tuple(getattr(b, f) for f in fields) + (db,),
                    tuple(getattr(a2, f) for f in fields) + (da2,))
            deferred.append(int(da.sum()))
    errs["relocate_mega"] = 0.0
    return (f"relocate_mega == plain == K2-par ({len(modes)} mode(s), "
            f"origins 0 and -1, deferred {deferred})")


def phase_fused_kernels(gs_scenes, cfg4m, st4m, errs: dict) -> None:
    """The fused kernels against their plain versions and the sequential
    kernels they fuse, bit-equal and on repeat: colors_mega with and
    without the Verlet tail (== K6-par's launch on the par route),
    relocate_mega (== K2-par) at a small uniform scene and the GS paths'
    parity shapes, and in every matching mode on the ragged grid and at
    cap 32; K4 at the 4M shape, at a small mixed-radius one, on the
    ragged grid and at cap 32."""
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import tiled
    import torch
    small_cfg, small = _gs_small_state()
    ucfg = gs_config(4000, world_width=96.0, world_height=60.0, tile_cap=4)
    uni = small.replace(radius=torch.where(
        small.pid >= 0, torch.full_like(small.x, ucfg.initial_radius),
        torch.zeros_like(small.x)))
    for i, (label, cfg, st) in enumerate([("small-uniform", ucfg, uni)]
                                         + list(gs_scenes)):
        t = tiled.tile_geometry(cfg)[0]
        ps = gp.to_parity_state(_jittered(st, 0.3 * t, seed=60 + i), cfg)
        src, _, rrad, _ = gp.rank_par_cuda(ps, cfg)
        prm = StepParams.make(cfg.dt, mouse=(0.5 * cfg.world_width,
                                             0.5 * cfg.world_height),
                              pressed=True).as_tensor("cuda")
        for tail in (prm, None):
            runs = [ps.replace(**{f: getattr(ps, f).clone()
                                  for f in ("px", "py")})
                    for _ in range(4)]
            runs[0] = gm.colors_mega_cuda(runs[0], src, rrad, cfg, tail)
            runs[1] = gm.colors_mega_cuda(runs[1], src, rrad, cfg, tail)
            runs[2] = runs[2].replace(x=ps.x.clone(), y=ps.y.clone())
            gm.colors_mega_plain(runs[2], src, rrad, cfg, tail)
            seq = runs[3]
            x, y = gp.colors_par_cuda(
                seq.x, seq.y, src, rrad, cfg, seq.geo,
                tail=None if tail is None else (seq.px, seq.py, seq.pid,
                                                tail),
                uniform=True)
            seq = seq.replace(x=x, y=y)
            got = lambda r: tuple(getattr(r, f)  # noqa: E731
                                  for f in ("x", "y", "px", "py"))
            what = f"colors_mega {label} tail={tail is not None}"
            _equal_or_raise(what, got(runs[0]), got(runs[2]), got(runs[1]))
            _equal_or_raise(f"{what} vs K6-par's launch", got(runs[0]),
                            got(seq))
        errs["gs_colors_mega"] = 0.0
        mega = check_relocate_mega(
            label, cfg, st, [(cfg.tiled_match, cfg.tiled_hysteresis)], errs,
            seed=70 + i)
        log(f"[mega] {label} {list(ps.x.shape)}: colors_mega (with and "
            f"without the tail) == plain == K6-par's launch, {mega} "
            f"(match {gp.resolve_match(cfg, cfg.tile_cap, *st.dims[1:])}), "
            f"bit for bit and on repeat")
    ragged_cfg, ragged = _ragged_state(6, uniform=True)
    cap32_cfg, cap32 = _small_state(32, uniform=False)
    for label, c, s in (("ragged", ragged_cfg, ragged),
                        ("small-cap32", cap32_cfg, cap32)):
        log(f"[mega] {label} {list(s.dims)}: "
            f"{check_relocate_mega(label, c, s, MODES, errs)}, bit for bit "
            f"and on repeat")
    mixed_cfg, mixed = _small_state(4, uniform=False)
    for label, c, s in (("small-mixed", mixed_cfg, mixed),
                        ("ragged", ragged_cfg, ragged),
                        ("small-cap32", cap32_cfg, cap32),
                        ("4M", cfg4m, st4m)):
        check_relocate_one(label, c, s, errs)


def _check_engine(e, n, label) -> dict:
    """Conservation over the tiles and any overlay: the merged pids are
    arange(n), every position finite and inside [r, W - r] x [r, H - r]."""
    import numpy as np
    from gpu_physics_engine_torch.ops import tiled
    pid, pos, _, rad = e._export()
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
# the array Engine (sorted pairs, 4-color Gauss-Seidel, Morton resort)
# ---------------------------------------------------------------------------

ARRAY_N = 1_000_000
CENTRE = (1524.0, 524.0)


def _array_cfg(**kw):
    """The README's first example: 1,000,000 particles in 1,100,800 slots,
    world 3048 x 1048, radius 0.5 (cell 1.1, grid 2773 x 955)."""
    from gpu_physics_engine_torch import SimConfig
    return SimConfig(max_particles=1_100_000, initial_particles=ARRAY_N,
                     **kw)


def _ramp_keys(n=25_006, seed=12):
    """The reference's 25,006-key reverse ramp, with duplicates and
    0xFFFFFFFF sentinels: u32 values in int64 on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    keys = np.arange(n - 1, -1, -1, dtype=np.int64) * 40_503
    keys[rng.random(n) < 0.3] = 7
    keys[rng.random(n) < 0.1] = 0xFFFFFFFF
    return torch.from_numpy(keys & 0xFFFFFFFF).cuda()


def _pair_keys(state, cfg):
    """(candidates, cell_ids) of ``state``: the slice's sort input."""
    from gpu_physics_engine_torch.core import stepper
    from gpu_physics_engine_torch.ops import grid
    cand = grid.build_candidates(state.x, state.y, state.radius,
                                 state.active_mask(),
                                 stepper.cell_size(cfg, state))
    return cand, grid.build_cell_ids(cand)[0]


def check_radix(label, keys) -> "torch.Tensor":
    """K12, radix_offsets and radix_scatter against their plain versions
    on each of the 4 passes' real inputs (the keys after the earlier
    passes), twice, bit-equal; the whole radix sort equal to
    torch.sort(stable=True).  Returns the padded int32 key bits of the
    first pass."""
    import torch
    from gpu_physics_engine_torch.ops import radix_sort as rs
    n = keys.shape[0]
    bits = rs.as_i32_bits(torch.cat([keys, keys.new_full(
        (-n % rs.BLOCK,), 0xFFFFFFFF)]))
    first = bits
    vals = torch.arange(bits.shape[0], dtype=torch.int32, device="cuda")
    for p in range(4):
        shift = 8 * p
        got, again = rs.rank_hist_cuda(bits, shift), rs.rank_hist_cuda(
            bits, shift)
        _equal_or_raise(f"K12 {label} pass {p}", got,
                        rs.rank_hist_plain(bits, shift), again)
        rank, hist = got
        off = rs.digit_offsets_cuda(hist)
        _equal_or_raise(f"radix_offsets {label} pass {p}", off,
                        rs.digit_offsets_plain(hist),
                        rs.digit_offsets_cuda(hist))
        out = rs.scatter_cuda(bits, vals, rank, hist, off, shift)
        _equal_or_raise(f"radix_scatter {label} pass {p}", out,
                        rs.scatter_plain(bits, vals, rank, off, shift),
                        rs.scatter_cuda(bits, vals, rank, hist, off, shift))
        bits, vals = out
    sk, sv = rs.radix_sort_pairs(
        keys, torch.arange(n, dtype=torch.int32, device="cuda"))
    wk, wi = torch.sort(keys, stable=True)
    _equal_or_raise(f"radix sort {label} vs torch.sort", (sk, sv),
                    (wk, wi.to(torch.int32)))
    log(f"[radix] {label} {bits.shape[0]} keys ({bits.shape[0] // rs.BLOCK}"
        f" blocks): K12, radix_offsets and radix_scatter bit-equal to their "
        f"plain versions and on repeat on all 4 passes; the radix sort == "
        f"torch.sort(stable=True)")
    return first


def phase_array_kernels(errs: dict):
    """K12 at a small shape and at both shapes the 1M engine gives it: the
    scene's pair keys (each substep) and its home-cell codes over the
    whole capacity, the inactive tail UNUSED (the Morton resort); and the
    scene's candidate cells on the card against the CPU's.  Returns the
    first pass's key bits at the pair keys' shape."""
    from gpu_physics_engine_torch import Engine
    from gpu_physics_engine_torch.core import stepper
    from gpu_physics_engine_torch.ops import resort
    check_radix("ramp", _ramp_keys())
    cfg = _array_cfg(sort_impl="radix")
    e = Engine(cfg, seed=0, device="cuda")
    _, keys = _pair_keys(e.state, cfg)
    big = check_radix("1M pairs", keys)
    st = e.state
    check_radix("1M resort codes", resort.home_cell_codes(
        st.x, st.y, st.active_mask(), stepper.cell_size(cfg, st)))
    for name in RADIX:
        errs[name] = 0.0
    check_candidates("1M scene", e.state, cfg)
    return big


def check_candidates(label, state, cfg) -> None:
    """The candidate cells (Morton codes, coords, valid) of ``state`` on
    the card equal the CPU's: the grid build divides by the cell size
    held as a tensor, so the card's division is IEEE as the CPU's."""
    import torch
    cand, _ = _pair_keys(state, cfg)
    cpu = state.replace(**{f: getattr(state, f).cpu() for f in (
        "x", "y", "radius", "num_active", "max_radius")})
    ccand, _ = _pair_keys(cpu, cfg)
    same = [torch.equal(getattr(cand, f).cpu(), getattr(ccand, f))
            for f in ("cells", "coords", "valid")]
    if not all(same):
        raise AssertionError(f"{label} candidate cells: card != CPU "
                             f"({same})")
    log(f"[grid] {label}: candidate cells, coords and valid on the card == "
        f"the CPU's ({int(cand.valid.sum())} candidates)")


def phase_array_engine(make, windows, label, expect) -> dict:
    """Drive the array Engine ``make()`` builds through ``windows`` =
    [(steps, mouse or None)]: launch counts zeroed just before and equal
    to ``expect`` just after; all particles live, finite, inside the
    world; ms/step and overflow per frame per window."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    e = make()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
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
    bad = {k: (got[k], v) for k, v in expect.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{label}: launches (got, expected) {bad}")
    cfg = e.config
    pos, rad = e.positions(), e.radii()
    if e.num_particles() != cfg.initial_particles:
        raise AssertionError(f"{label}: {e.num_particles()} live")
    if not np.isfinite(pos).all():
        raise AssertionError(f"{label}: non-finite positions")
    inside = ((pos[:, 0] >= rad - 1e-4)
              & (pos[:, 0] <= cfg.world_width - rad + 1e-4)
              & (pos[:, 1] >= rad - 1e-4)
              & (pos[:, 1] <= cfg.world_height - rad + 1e-4))
    if not inside.all():
        raise AssertionError(f"{label}: {int((~inside).sum())} particles "
                             "outside [r, W-r] x [r, H-r]")
    steps_total = sum(s for s, _ in windows)
    log(f"[{label}] pipeline {cfg.pipeline} solver {cfg.solver} sort "
        f"{cfg.sort_impl} K {cfg.max_occupancy} capacity {cfg.capacity} "
        f"grid {list(cfg.grid_dims)}; init {init_s:.1f} s")
    log(f"[{label}] launches {got} over {steps_total} steps; all "
        f"{e.num_particles()} live, finite, inside the world")
    log(f"[{label}] ms/step (CUDA events) windows "
        f"{[round(w, 3) for w in win_ms]}; overflow per frame windows "
        f"{[round(o, 1) for o in win_of]}")
    return {"launches": got, "win_ms": win_ms, "engine": e}


RADIX = ("radix_rank_hist", "radix_offsets", "radix_scatter")
ARRAY_STATE = ("x", "y", "px", "py", "radius", "num_active",
               "steps_since_sort", "max_radius", "overflow_count")


def phase_array_paths(paths: dict) -> None:
    """The radix engine at 1M for 256 steps (128 free, 128 under the drag,
    the resort at step 240), the lax engine through the same steps from the
    same seed (bit-equal, no K12 launch), then 64 steps each of the bucket
    pipeline and the Jacobi solver."""
    import torch
    from gpu_physics_engine_torch import Engine
    windows = [(128, None), (128, CENTRE)]
    runs = {}
    for impl, count in (("radix", 4 * 256 + 4), ("lax", 0)):
        label = f"1M-array-{impl}"
        runs[impl] = phase_array_engine(
            lambda: Engine(_array_cfg(sort_impl=impl), seed=0,
                           device="cuda"),
            windows, label, dict.fromkeys(RADIX, count))
        paths[label] = runs[impl]["launches"]
    a, b = runs["radix"]["engine"].state, runs["lax"]["engine"].state
    diff = [f for f in ARRAY_STATE
            if not torch.equal(getattr(a, f), getattr(b, f))]
    if diff:
        raise AssertionError(f"1M array: radix != lax in {diff}")
    log(f"[xcheck] 1M array: radix == lax bit for bit "
        f"({', '.join(ARRAY_STATE)}) after 256 steps")
    check_candidates("1M after 256 steps", a, runs["radix"]["engine"].config)
    del runs, a, b
    torch.cuda.empty_cache()
    for label, kw in (("1M-array-bucket", dict(pipeline="bucket")),
                      ("1M-array-jacobi", dict(solver="jacobi"))):
        run = phase_array_engine(
            lambda: Engine(_array_cfg(sort_impl="radix", **kw), seed=0,
                           device="cuda"),
            [(64, None)], label, dict.fromkeys(RADIX, 0))
        paths[label] = run["launches"]
        del run
        torch.cuda.empty_cache()


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


def _k1_bound(cfg, state):
    """K1's least time on ``state``: x, y, px, py, pid (and the radius
    plane under a general radius) read, x, y, px, py written; 5 flops a
    candidate pair's distance test and 25 a Verlet step."""
    cap, TY, TX = state.dims
    S = cap * TY * TX * 4.0  # bytes of one plane
    n, box = _tile_counts(state)
    occ = float(n.sum())
    pairs = float((n * box).sum()) - occ  # occupied (slot, candidate) pairs
    rplanes = 0 if cfg.tiled_uniform_radius else 1
    return _bound((5 + rplanes + 4) * S + 16, 5 * pairs + 25 * occ)


def bounds(cfg, state, gs_cfg, gs_state, radix_bits) -> dict:
    """Per kernel (least ms, "bytes" or "operations"): each input read once,
    each output written once; operations counted from this run's data
    (5 flops per candidate pair's distance test, 25 per Verlet step, 9 per
    membership test, 8 per GS pair).  The parity kernels at the 1M-GS
    scene's parity shape: the same counts, no radius plane (uniform).  The
    GS colors per solve: K6 and K6-mx/dec the four colors, K6-par and
    colors_mega the four colors and the Verlet tail."""
    import torch
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import gs_tiled as gt
    cap, TY, TX = state.dims
    S = cap * TY * TX * 4.0  # bytes of one plane
    n, box = _tile_counts(state)
    occ = float(n.sum())
    pairs = float((n * box).sum()) - occ  # occupied (slot, candidate) pairs
    rplanes = 0 if cfg.tiled_uniform_radius else 1
    out = {
        "collide_integrate": _k1_bound(cfg, state),
        "collide": _bound((3 + rplanes + 2) * S, 5 * pairs),
        # the pid plane read, x, y, px, py, radius of occupied slots read
        # (an empty slot moves nothing), six planes and defer written
        "relocate_pull": _bound(7 * S + 20 * occ + TY * TX * 4.0, 10 * occ),
    }
    K = gs_cfg.max_occupancy
    gcap, GY, GX = gs_state.dims
    gocc = float((gs_state.pid >= 0).sum())
    _, _, _, count = gk.rank_cuda(gs_state, gs_cfg)
    m = torch.clamp(count, max=K).double()
    # the pid plane and the occupants' x, y, radius read (an empty slot is
    # no candidate), three K-deep tables and the count written
    out["gs_rank"] = _bound(gcap * GY * GX * 4.0 + 12 * gocc
                            + (3 * K + 1) * GY * GX * 4.0, 9 * 9 * gocc)
    # per solve (four colors): each valid rank's code and radius read, the
    # x, y of the slots the ranks name read once and written once; the
    # pairs' sweep.  (The window also copies every empty slot into its new
    # planes; the function needs no such bytes.)
    src = gk.rank_cuda(gs_state, gs_cfg)[0]
    ty = torch.arange(GY, device=src.device).view(1, GY, 1)
    tx = torch.arange(GX, device=src.device).view(1, 1, GX)
    idx, valid = gt.source_index(src, gcap, GY, GX, ty, tx)
    members = float(torch.unique(idx[valid]).numel())
    ranks, pairs = float(m.sum()), float((m * (m - 1) / 2).sum())
    out["gs_color"] = _bound(8 * ranks + 16 * members, 8 * pairs)
    ps = gp.to_parity_state(gs_state, gs_cfg)
    P = float(ps.x.numel()) * 4.0  # bytes of one parity-space field
    cells = float(ps.pid[:, 0].numel())
    _, _, _, pcount = gp.rank_par_cuda(ps, gs_cfg)
    pm = torch.clamp(pcount, max=K).double()
    nr = 0 if ps.radius is None else 1  # no radius plane when uniform
    out["gs_rank_par"] = _bound(P + 4 * (2 + nr) * gocc
                                + (3 * K + 1) * cells * 4.0, 9 * 9 * gocc)
    # the par route's solve: four colors and the tail; no radius table
    # (every valid rank has radius r0), each valid rank's code read, the
    # pid plane read, x, y, px, py of the occupied slots read and written
    pranks = float(pm.sum())
    ppairs = float((pm * (pm - 1) / 2).sum())
    out["gs_color_par"] = _bound(4 * pranks + P + 32 * gocc,
                                 8 * ppairs + 25 * gocc)
    out["gs_color_par[mx]"] = out["gs_color_par[dec]"] = out["gs_color"]
    # as K2: pid read, the occupied slots' fields read, the fields and pid
    # written (no radius plane under uniform radius), and the defer cells
    nf = 4 + (ps.radius is not None)
    out["relocate_par"] = _bound((nf + 2) * P + 4 * nf * gocc + cells * 4.0,
                                 10 * gocc)
    # the tail alone: the pid plane is read, and x, y, px, py of occupied
    # slots are read and written; empty slots keep their values
    out["gs_verlet"] = _bound(P + 32 * gocc, 25 * gocc)
    # the fused kernels compute the same functions: colors_mega the par
    # route's solve, relocate_mega K2-par's, K4 K2's (at 4M)
    out["gs_colors_mega"] = out["gs_color_par"]
    out["relocate_mega"] = out["relocate_par"]
    out["relocate_one"] = out["relocate_pull"]
    # K12: each key read once, each rank written once, one 256-bin
    # histogram per 1024-key block; a handful of integer operations a key
    nkeys = float(radix_bits.shape[0])
    hist_bytes = nkeys / 1024 * 256 * 4
    out["radix_rank_hist"] = _bound(8 * nkeys + hist_bytes, 0.0)
    # the offsets read the histogram and write the offsets; the scatter
    # reads key, payload and rank and one offset row a block (1 KiB) and
    # writes key and payload (the kernel also reads the block's histogram
    # row to stage in digit order; the function does not need it)
    out["radix_offsets"] = _bound(2 * hist_bytes, 0.0)
    out["radix_scatter"] = _bound(20 * nkeys + hist_bytes, 0.0)
    return out


def _par_runs(gs_cfg, gs_state) -> dict:
    """The parity kernels' timing runs at the 1M-GS scene's parity shape:
    name -> (kernel, plain, launches per call).  K6-par's window runs a
    solve on the par layout (K5-par's tables, the Verlet tail fused, mouse
    pressed) and on the mx and dec layouts (K5's tables relayouted); the
    tail's row is the window with no color; the relocate on a jittered
    copy."""
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_mega as gm
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
    tail = (ps.px.clone(), ps.py.clone(), ps.pid, prm)

    def colors(fn, geo, tables, c1=4, tail=None, **kw):
        x, y = gp.to_parity(gs_state.x, geo, 0.0), gp.to_parity(
            gs_state.y, geo, 0.0)
        return lambda: fn(x, y, *tables, cfg, geo, c1, tail, **kw)

    m = ps.replace(**{f: getattr(ps, f).clone()
                      for f in ("x", "y", "px", "py")})
    par = (src, rrad)
    runs = {
        "gs_rank_par": (lambda: gp.rank_par_cuda(ps, cfg),
                        lambda: gp.rank_par_plain(ps, cfg), 1),
        "gs_colors_mega": (
            lambda: gm.colors_mega_cuda(m, src, rrad, cfg, prm),
            lambda: gm.colors_mega_plain(m, src, rrad, cfg, prm), 1),
        "relocate_mega": (lambda: gm.relocate_mega_cuda(far, cfg),
                          lambda: gm.relocate_mega_plain(far, cfg), 1),
        # the par route's solve: four colors and the tail, no radius table
        "gs_color_par": (
            colors(gp.colors_par_cuda, ps.geo, par, tail=tail, uniform=True),
            colors(gp.colors_par_plain, ps.geo, par, tail=tail), 1),
        "relocate_par": (lambda: gp.relocate_par_cuda(far, cfg),
                         lambda: gp.relocate_par_plain(far, cfg), 1),
        # the window with no color: the tail alone
        "gs_verlet": (
            colors(gp.colors_par_cuda, ps.geo, par, 0, tail, uniform=True),
            colors(gp.colors_par_plain, ps.geo, par, 0, tail), 1),
    }
    for name, origin in (("mx", 0), ("dec", -1)):
        geo = gp.ParityGeometry(*gs_state.dims[1:], origin)
        tables = (gp.to_parity(fsrc, geo, -1), gp.to_parity(frrad, geo, 0.0))
        runs[f"gs_color_par[{name}]"] = (
            colors(gp.colors_par_cuda, geo, tables),
            colors(gp.colors_par_plain, geo, tables), 1)
    return runs, list(ps.x.shape)


def phase_times(cfg, state, gs_cfg, gs_state, radix_bits):
    """Every kernel against its plain version at the main paths' shapes:
    K1, K2, K3 at the 4M shape, K5 and K6 (one launch: a solve's four
    colors) at the 1M-GS shape, the parity kernels at its parity shape, on
    the engines' initial scenes (after a mouse drag most particles are
    members of no cell, and K6 would have little to do), K12 (one pass) at
    the 1M array scene's 4,403,200 pair keys.  Turns: plain, kernel,
    kernel, plain.  Returns ({name: (kernel ms, plain ms)}, {name: library ms}):
    for K12 the library call is torch.sort(stable=True) of the same pairs,
    which does the whole sort that K12's four passes serve."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    prm = StepParams.make(cfg.dt).as_tensor("cuda")
    moved = _jittered(state, 0.3 * tiled.tile_geometry(cfg)[0], seed=2)
    src, _, rrad, _ = gk.rank_cuda(gs_state, gs_cfg)

    def colors(fn):
        return lambda: fn(gs_state.x, gs_state.y, src, rrad, gs_cfg)

    runs = {  # name: (kernel, plain, launches per call)
        "collide_integrate": (lambda: tk.collide_integrate_cuda(state, prm,
                                                                cfg),
                              lambda: tk.collide_integrate_plain(state, prm,
                                                                 cfg), 1),
        "relocate_pull": (lambda: tk.relocate_pull_cuda(moved, cfg),
                          lambda: tk.relocate_pull_plain(moved, cfg), 1),
        "relocate_one": (lambda: tk.relocate_one_cuda(moved, cfg),
                         lambda: tk.relocate_one_plain(moved, cfg), 1),
        "collide": (lambda: tk.collide_cuda(state, cfg),
                    lambda: tk.collide_plain(state, cfg), 1),
        "gs_rank": (lambda: gk.rank_cuda(gs_state, gs_cfg),
                    lambda: gk.rank_plain(gs_state, gs_cfg), 1),
        "gs_color": (colors(gk.colors_cuda), colors(gk.colors_plain), 1),
    }
    shapes = {name: list(state.dims) for name in runs}
    shapes.update(gs_rank=list(gs_state.dims), gs_color=list(gs_state.dims))
    par, par_shape = _par_runs(gs_cfg, gs_state)
    runs.update(par)
    shapes.update({name: par_shape for name in par})
    from gpu_physics_engine_torch.ops import radix_sort as rs
    obj = torch.arange(radix_bits.shape[0], dtype=torch.int32,
                       device="cuda")
    rank, hist = rs.rank_hist_cuda(radix_bits, 0)
    off = rs.digit_offsets_cuda(hist)
    runs["radix_rank_hist"] = (lambda: rs.rank_hist_cuda(radix_bits, 0),
                               lambda: rs.rank_hist_plain(radix_bits, 0), 1)
    runs["radix_offsets"] = (lambda: rs.digit_offsets_cuda(hist),
                             lambda: rs.digit_offsets_plain(hist), 1)
    runs["radix_scatter"] = (
        lambda: rs.scatter_cuda(radix_bits, obj, rank, hist, off, 0),
        lambda: rs.scatter_plain(radix_bits, obj, rank, off, 0), 1)
    for name in RADIX:
        shapes[name] = list(radix_bits.shape)
    out = {}
    for name, (kern, plain, per) in runs.items():
        p1 = cuda_ms(plain, reps=2) / per
        k1 = cuda_ms(kern, reps=20) / per
        k2 = cuda_ms(kern, reps=20) / per
        p2 = cuda_ms(plain, reps=2) / per
        out[name] = (min(k1, k2), min(p1, p2))
        log(f"[time] {name} {shapes[name]}: kernel {k1:.4f} / {k2:.4f} ms, "
            f"plain {p1:.3f} / {p2:.3f} ms per launch")
    # the sort the radix kernels serve: torch.sort of the pairs against the
    # hand radix sort (4 passes of K12, radix_offsets and radix_scatter)
    keys = rs.from_i32_bits(radix_bits)

    def lib_sort():
        sk, idx = torch.sort(keys, stable=True)
        return sk, obj[idx]
    lib = [cuda_ms(lib_sort, reps=10), None, None, cuda_ms(lib_sort, reps=10)]
    lib[1] = cuda_ms(lambda: rs.radix_sort_pairs(keys, obj), reps=10)
    lib[2] = cuda_ms(lambda: rs.radix_sort_pairs(keys, obj), reps=10)
    log(f"[time] sort of {keys.shape[0]} pairs: torch.sort(stable=True) "
        f"{lib[0]:.4f} / {lib[3]:.4f} ms, the hand radix sort (4 passes of "
        f"K12, radix_offsets, radix_scatter) {lib[1]:.4f} / {lib[2]:.4f} ms")
    torch.cuda.synchronize()
    return out, {"radix_rank_hist": min(lib[0], lib[3])}


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
    # K1's general-radius form: the 4M engine after a big spawn
    ("collide_integrate[general]", "collide_integrate",
     "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "4M-spawn"),
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
    ("radix_rank_hist", "radix_rank_hist", "csrc/radix_kernels.cuh",
     "gpu_physics_engine_tpu/ops/radix_sort.py:80", "1M-array-radix"),
    # the two below replace XLA steps of _one_pass, not a pallas_call
    ("radix_offsets", "radix_offsets", "csrc/radix_kernels.cuh",
     "gpu_physics_engine_tpu/ops/radix_sort.py:111", "1M-array-radix"),
    ("radix_scatter", "radix_scatter", "csrc/radix_kernels.cuh",
     "gpu_physics_engine_tpu/ops/radix_sort.py:114", "1M-array-radix"),
    ("gs_colors_mega", "gs_colors_mega", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:503", "1M-GS-mega"),
    ("relocate_mega", "relocate_mega", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:443", "1M-GS-mega"),
    ("relocate_one", "relocate_one", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:1187", "4M-one"),
)

FLAT_GS = ("gs_rank", "gs_color", "relocate_pull")
PAR_GS = ("gs_rank_par", "gs_color_par", "relocate_par", "gs_verlet")
MEGA_GS = ("gs_colors_mega", "relocate_mega")


def _gs_expect(steps: int, layout: str) -> dict:
    """Launch counts of ``steps`` GS steps (one substep each) in ``layout``
    ("mega": par with gs_colors_mega and gs_relocate_mega)."""
    per = {"flat": dict(gs_rank=1, gs_color=1, relocate_pull=1),
           "par": dict(gs_rank_par=1, gs_color_par=1, relocate_par=1,
                       gs_verlet=1),
           "mega": dict(gs_rank_par=1, gs_colors_mega=1, relocate_mega=1),
           "mx": dict(gs_rank=1, gs_color_par=1, relocate_pull=1)}
    per["dec"] = per["mx"]
    want = {k: 0 for k in FLAT_GS + PAR_GS + MEGA_GS + ("collide_integrate",
                                                       "relocate_one")}
    want.update({k: v * steps for k, v in per[layout].items()})
    return want


def _gs_cfg(n: int, layout: str):
    """The bench's GS config at n in ``layout``; "mega" is the par layout
    with both fused kernels on."""
    from gpu_physics_engine_torch.core.tuned import gs_config
    if layout == "mega":
        return gs_config(n, gs_layout="par", gs_colors_mega=True,
                         gs_relocate_mega=True)
    return gs_config(n, gs_layout=layout)


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


def phase_gs_paths(paths: dict, errs: dict) -> None:
    """The GS engine at 1M (150 free steps, 150 under the drag) and 4M cap
    6 (100 steps), in the flat and the par layout and the par layout with
    the fused kernels ("mega") from the same start (``_gs_start``), each
    held bit-equal to flat, and K2 and K2-par held to their plain versions
    on the flat and par engines' final states; then 32 steps at 1M in the
    mx and dec layouts from the seeded scene, held to a flat engine over
    the same steps.
    Prints the par/flat and mega/par ms/step."""
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
        for layout in ("flat", "par", "mega"):
            tag = label if layout == "flat" else f"{label}-{layout}"
            runs[layout] = phase_engine(
                lambda: TiledEngine(_gs_cfg(n, layout), chunk=64,
                                    initial_state=_clone(start)),
                n, windows, tag, _gs_expect(steps, layout))
            paths[tag] = runs[layout]["launches"]
        for layout in ("par", "mega"):
            cross_check(label, runs["flat"]["engine"],
                        runs[layout]["engine"], layout)
        # K2 and K2-par on the engines' own states after the windows
        flat_e, par_e = runs["flat"]["engine"], runs["par"]["engine"]
        check_relocate(f"{label} in-step", flat_e.config, flat_e.state,
                       [(flat_e.config.tiled_match,
                         flat_e.config.tiled_hysteresis)], errs, jitter=0)
        check_relocate_par(f"{label} in-step", par_e.config, par_e.state,
                           MODES, errs, jitter=0)
        f, p, m = (runs[k]["win_ms"] for k in ("flat", "par", "mega"))
        log(f"[layout] {label} ms/step per window: par "
            f"{[round(w, 4) for w in p]} vs flat {[round(w, 4) for w in f]}"
            f"; next 32 steps par {runs['par']['steady_ms']:.4f} vs flat "
            f"{runs['flat']['steady_ms']:.4f}")
        log(f"[layout] {label} ms/step per window: mega "
            f"{[round(w, 4) for w in m]} vs par {[round(w, 4) for w in p]}; "
            f"next 32 steps mega {runs['mega']['steady_ms']:.4f} vs par "
            f"{runs['par']['steady_ms']:.4f}")
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


def phase_k4_path(paths: dict) -> None:
    """K4's path, the single-kernel relocate in a 4M frame loop as the JAX
    package's probe drives it (scripts/tpu_probe_one.py): the tuned 4M
    engine's first 16 steps, then 32 steps of ``relocate_one`` (every
    ``tiled_relocate_interval``-th step) and K1, counts zeroed just
    before; the same loop with K2 under flip and delta 0 beside it, and
    how far the two loops part (K4 divides where K2 multiplies)."""
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    e = make_tuned_engine(4_194_304, device="cuda")
    e.run(16)
    cfg, start = e.config, e.state
    prm = e.params().as_tensor("cuda", 1.0 / cfg.substeps)
    flip = cfg.replace(tiled_match="flip", tiled_hysteresis=0.0)
    every = max(1, cfg.tiled_relocate_interval)
    ends, ms = {}, {}
    for name, reloc in (("relocate_one", tk.relocate_one),
                        ("relocate_pull", tk.relocate_pull)):
        st = start
        reset_launches()

        def loop():
            nonlocal st
            for i in range(32):
                if i % every == 0:
                    st = reloc(st, flip)
                for _ in range(cfg.substeps):
                    st = tk.collide_integrate(st, prm, cfg)
        ms[name] = cuda_ms(loop, reps=1, warmup=0) / 32
        got = launches()
        want = {"relocate_one": 0, "relocate_pull": 0,
                "collide_integrate": 32 * cfg.substeps}
        want[name] = 32 // every
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            raise AssertionError(f"4M-one ({name}): launches (got, "
                                 f"expected) {bad}")
        if name == "relocate_one":
            paths["4M-one"] = got
        ends[name] = st
    a, b = ends["relocate_one"], ends["relocate_pull"]
    pid, pos, _, _ = tiled.export_particles(a)
    if len(pid) != 4_194_304 or not torch.isfinite(
            torch.from_numpy(pos)).all():
        raise AssertionError("4M-one: particles lost or non-finite")
    differ = int((a.pid != b.pid).sum())
    log(f"[4M-one] K4 + K1 loop, 32 steps: launches {paths['4M-one']}; all "
        f"4194304 pids present, finite; ms/step {ms['relocate_one']:.4f} "
        f"against {ms['relocate_pull']:.4f} with K2 (flip, delta 0); the "
        f"loops' pid planes differ in {differ} slots (edge rule)")
    del e, ends, a, b, start
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# spawns and the big-particle overlay (ops/bigs.py) on the 4M engine
# ---------------------------------------------------------------------------

SPAWN_N = 4_194_304
SPAWN_POINTS = ((1024.0, 524.0), (1524.0, 700.0), (2024.0, 400.0))


def _spawned_4m():
    """The tuned 4M engine after three ``spawn_at`` bursts of spawn_burst
    (100) at ``SPAWN_POINTS``: every radius 1-3 goes to the overlay (the
    tiles are sized for 0.5), which grows 128 -> 256 -> 512 slots; the
    tile geometry stays and tiled_uniform_radius turns off."""
    from gpu_physics_engine_torch import make_tuned_engine
    e = make_tuned_engine(SPAWN_N, device="cuda")
    edge, caps = e.cell_size(), []
    if not e.config.tiled_uniform_radius:
        raise AssertionError("4M-spawn: the tuned engine is not uniform")
    for p in SPAWN_POINTS:
        e.spawn_at(p, verbose=False)
        caps.append(e.big.capacity)
    if (caps != [128, 256, 512] or e.cell_size() != edge
            or e.config.tiled_uniform_radius
            or int(e.big.num_active) != 300):
        raise AssertionError(
            f"4M-spawn: overlay capacities {caps}, cell {e.cell_size()} "
            f"(was {edge}), uniform radius {e.config.tiled_uniform_radius}, "
            f"{int(e.big.num_active)} bigs")
    log(f"[4M-spawn] 3 bursts of {e.config.spawn_burst}: overlay "
        f"{' -> '.join(map(str, caps))} slots, {int(e.big.num_active)} bigs "
        f"(radii {sorted(set(e.big.radius[e.big.pid >= 0].tolist()))}); "
        f"tile edge {edge:.3f} kept; tiled_uniform_radius off")
    return e


def _twin_on_cpu(e):
    """A CPU engine holding a copy of ``e``'s tiles and overlay."""
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.ops import bigs, tiled
    twin = TiledEngine(e.config, initial_state=tiled.from_numpy(
        tiled.to_numpy(e.state)))
    twin.big = bigs.from_numpy(bigs.to_numpy(e.big))
    return twin


def _jam_and_burst(e, rng):
    """A 3 x 3 block of tiles around the first spawn point jammed full
    (each free slot takes a particle whose home it is), then 100 radius-0.5
    entries aimed at its centre tile: (block home (ty, tx), jam arrays,
    burst arrays), each (positions, radii, pids)."""
    import numpy as np
    from gpu_physics_engine_torch.ops import tiled
    cfg = e.config
    t, _, _ = tiled.tile_geometry(cfg)
    cx, cy = SPAWN_POINTS[0]
    hty, htx = int(cy // t) + 1, int(cx // t) + 1
    free = (e.state.pid[:, hty - 1:hty + 2, htx - 1:htx + 2] < 0).sum(0)
    pos = []
    for dy in range(3):
        for dx in range(3):
            ty, tx = hty - 1 + dy, htx - 1 + dx
            k = int(free[dy, dx])
            u = rng.uniform(0.25, 0.75, (k, 2))
            pos.append(np.stack([(tx - 1 + u[:, 0]) * t,
                                 (ty - 1 + u[:, 1]) * t], -1))
    jam = np.concatenate(pos).astype(np.float32)
    u = rng.uniform(0.1, 0.9, (100, 2))
    burst = np.stack([(htx - 1 + u[:, 0]) * t, (hty - 1 + u[:, 1]) * t],
                     -1).astype(np.float32)
    first = e._next_pid
    jam_ids = np.arange(first, first + len(jam), dtype=np.int32)
    ids = np.arange(first + len(jam), first + len(jam) + 100,
                    dtype=np.int32)
    return ((hty, htx), (jam, np.full(len(jam), 0.5, np.float32), jam_ids),
            (burst, np.full(100, 0.5, np.float32), ids))


def phase_spawn(smi: str, paths: dict, errs: dict, plain_ms: float):
    """The spawn path on the production 4M engine.

    ``_spawned_4m``, then 150 steps free and 150 with the mouse pressed
    (crossing the claim sweep at step 240) and 32 more (``phase_engine``:
    launch counts zeroed just before, K1 300 and K2 150, the merged pids
    arange(n + 300), finite, inside the world); ms/step beside the 4M
    engine's without an overlay (``plain_ms``, the same windows).  On the
    engine's own state after them: K1's general-radius form (the first
    engine path that launches it) against its plain version at
    [8, 640, 1850], bit-equal and on repeat, with its time; the overlay's
    coupling pass (``couple_bigs``, plain PyTorch) on the card twice,
    bit-equal, and against the CPU's from the same state, bit-equal (both
    sum in one fixed order); ``render_frame`` with the overlay within one
    u8 of the CPU twin's; last, the tile insert with the far spill:
    a 3 x 3 block jammed, 100 radius-0.5 spawns at its centre through
    ``_spawn_insert``, the card's TileState bit-equal to the CPU twin's.
    Returns (config, state) of the engine after its windows, K1's times
    and the checkpoint saved after the windows (path, export, the bigs'
    export, seconds)."""
    import numpy as np
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import bigs, tiled
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    n = SPAWN_N + 300
    run = phase_engine(_spawned_4m, n, [(150, None), (150, CENTRE)],
                       "4M-spawn", {"collide_integrate": 300,
                                    "relocate_pull": 150})
    paths["4M-spawn"] = run["launches"]
    e = run["engine"]
    cfg, st = e.config, e.state
    # the checkpoint phase_options resumes, saved before anything below
    # changes the state
    ckpt = f"{_scratch_dir()}/spawn4m.npz"
    t0 = time.perf_counter()
    e.save_checkpoint(ckpt)
    saved = (ckpt, e._export(), bigs.export_bigs(e.big),
             time.perf_counter() - t0)
    log(f"[4M-spawn] ({smi}) ms/step with the overlay: windows "
        f"{[round(w, 4) for w in run['win_ms']]}, next 32 steps "
        f"{run['steady_ms']:.4f}; without it (the 4M run, same windows) "
        f"next 32 steps {plain_ms:.4f}; hand-kernel launches a step "
        f"{sum(run['launches'].values()) / 300:.2f}")

    # K1's general form on the engine's own state
    prm = e.params().as_tensor("cuda", 1.0 / cfg.substeps)
    fields = ("x", "y", "px", "py")
    a, a2, b = (tk.collide_integrate_cuda(st, prm, cfg),
                tk.collide_integrate_cuda(st, prm, cfg),
                tk.collide_integrate_plain(st, prm, cfg))
    _equal_or_raise("k1 4M-spawn general", tuple(getattr(a, f) for f in
                                                 fields),
                    tuple(getattr(b, f) for f in fields),
                    tuple(getattr(a2, f) for f in fields))
    errs["collide_integrate[general]"] = _max_err(a, b, fields)
    log(f"[k1] 4M-spawn {list(st.dims)} uniform=False (the engine's state "
        f"after its {e._steps_done} steps): bit-equal and repeat bit-equal "
        f"({int((a.x != st.x).sum())} slots moved)")
    k1 = [cuda_ms(lambda: tk.collide_integrate_plain(st, prm, cfg), reps=2),
          cuda_ms(lambda: tk.collide_integrate_cuda(st, prm, cfg), reps=20),
          cuda_ms(lambda: tk.collide_integrate_cuda(st, prm, cfg), reps=20),
          cuda_ms(lambda: tk.collide_integrate_plain(st, prm, cfg), reps=2)]
    log(f"[time] collide_integrate[general] {list(st.dims)}: kernel "
        f"{k1[1]:.4f} / {k1[2]:.4f} ms, plain {k1[0]:.3f} / {k1[3]:.3f} ms "
        "per launch")
    del a, a2, b

    # the coupling pass: card twice, against the CPU
    twin = _twin_on_cpu(e)
    c1 = bigs.couple_bigs(st, e.big, cfg)
    c2 = bigs.couple_bigs(st, e.big, cfg)
    cc = bigs.couple_bigs(twin.state, twin.big, cfg)
    pairs = [(c1[0].x, c2[0].x, cc[0].x), (c1[0].y, c2[0].y, cc[0].y),
             (c1[1].x, c2[1].x, cc[1].x), (c1[1].y, c2[1].y, cc[1].y)]
    for got, again, want in pairs:
        _equal_or_raise("couple_bigs card vs CPU", got.cpu(), want,
                        again.cpu())
    moved = int((c1[0].x != st.x).sum()) + int((c1[1].x != e.big.x).sum())
    ms_couple = cuda_ms(lambda: bigs.couple_bigs(st, e.big, cfg), reps=10)
    log(f"[4M-spawn] couple_bigs (W {bigs.window_halfwidth(cfg)}, "
        f"{e.big.capacity} slots): card == CPU bit for bit and on repeat "
        f"(x, y of the tiles and the bigs; {moved} values moved); "
        f"{ms_couple:.4f} ms a pass")
    del c1, c2, cc

    # render_frame with the overlay: card against the CPU twin
    got, want = e.render_frame(), twin.render_frame()
    _within_one("4M-spawn", torch.from_numpy(got), torch.from_numpy(want),
                "render_frame with the overlay, card vs CPU")

    # the tile insert with the far spill: card against the CPU twin
    home, jam, burst = _jam_and_burst(e, np.random.default_rng(5))
    for eng in (e, twin):
        eng.state = tiled.insert_particles(eng.state, cfg, *jam)
        eng._spawn_insert(*burst)
    da, db = tiled.to_numpy(e.state), tiled.to_numpy(twin.state)
    bad = [f for f in da if not np.array_equal(da[f], db[f])]
    where = np.argwhere(da["pid"] >= burst[2][0])[:, 1:]
    ring = np.abs(where - np.asarray(home)).max(1)
    rings = {int(k): int(c) for k, c in zip(*np.unique(ring,
                                                       return_counts=True))}
    if bad or len(where) != 100 or ring.max() < 2:
        raise AssertionError(f"4M-spawn insert: card != CPU in {bad}; "
                             f"{len(where)} placed, rings {rings}")
    log(f"[4M-spawn] insert: {len(jam[0])} particles jam the 3 x 3 block "
        f"at tile {home}, then 100 spawns at its centre land at rings "
        f"{rings} "
        "(far spill); card == CPU bit for bit (every TileState field)")
    out = (cfg, st, (min(k1[1], k1[2]), min(k1[0], k1[3])), saved)
    del e, twin, run
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the remaining engine options: solver="fast", the band drain, the hybrid
# sweep, checkpoints
# ---------------------------------------------------------------------------

def _scratch_dir():
    """A fresh directory under the package's git-ignored build directory
    (the 4M checkpoint is too large to bring back)."""
    import tempfile
    from gpu_physics_engine_torch.ops import _cuda
    root = _cuda.BUILD_DIR
    root.mkdir(parents=True, exist_ok=True)
    return tempfile.mkdtemp(prefix="smoke_", dir=root)


def _fast_card_vs_cpu() -> None:
    """The fast solver's engine at 10,000 particles (the 1M scene's
    density: a 304.8 x 104.8 world), 8 steps under the drag with a resort
    at step 5, on the card and on the CPU, both packings: bit-equal."""
    import numpy as np
    import torch
    from gpu_physics_engine_torch import Engine, SimConfig
    rng = np.random.default_rng(12)
    pos = rng.uniform(0.5, [304.3, 104.3], (10_000, 2)).astype(np.float32)
    rad = np.full(10_000, 0.5, np.float32)
    for pack in (True, False):
        cfg = SimConfig(max_particles=10_000, initial_particles=10_000,
                        world_width=304.8, world_height=104.8,
                        solver="fast", sort_impl="radix",
                        sort_interval_steps=5, fast_pack_bf16=pack)
        ends = []
        for dev in ("cuda", "cpu"):
            e = Engine.from_arrays(cfg, pos, rad, device=dev)
            e.press_mouse((152.4, 52.4))
            e.run(8)
            ends.append(e.state)
        bad = [f for f in ARRAY_STATE if not torch.equal(
            getattr(ends[0], f).cpu(), getattr(ends[1], f))]
        if bad:
            raise AssertionError(f"fast 10k (pack {pack}): card != CPU in "
                                 f"{bad}")
        moved = int((ends[1].x[:10_000] != torch.from_numpy(pos[:, 0]))
                    .sum())
        log(f"[fast] 10k, fast_pack_bf16={pack}: card == CPU bit for bit "
            f"after 8 steps (resort at 5; {moved} of 10000 moved; overflow "
            f"{int(ends[1].overflow_count)})")


def _timed_sweeps(e):
    """Wrap ``e``'s periodic sweep and band drains to record, per sweep,
    its ms (host clock, a device sync on both sides) and the stale % just
    after it, and each sweep's band drains' ms.  The records are the
    engine's ``sweep_log`` dict."""
    import torch
    from gpu_physics_engine_torch.ops import tiled
    rec = {"sweep_ms": [], "stale_pct": [], "band_ms": []}
    run_sweep, apply_bands = e._run_sweep, e._apply_bands

    def timed(fn, key, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        rec[key].append((time.perf_counter() - t0) * 1e3)
        return out

    def sweep():
        out = timed(run_sweep, "sweep_ms")
        rec["stale_pct"].append(
            float(tiled.stale_pair_fraction(out, e.config)) * 100.0)
        return out
    e._run_sweep = sweep
    e._apply_bands = lambda state: timed(apply_bands, "band_ms", state)
    e.sweep_log = rec
    return e


def _bands_4m_gs(paths: dict) -> None:
    """4M-GS with tiled_sweep="bands" (the card's par layout) for 1,232
    steps, 5 periodic sweeps with 2 band drains each, beside the claim
    sweep from the same start; then ``rebuild_band`` on the card against
    the CPU's at three row starts of the bands engine's final state."""
    import torch
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import tiled
    n, steps = 4_194_304, 1232
    start = TiledEngine(gs_config(n), seed=0, chunk=64,
                        device="cuda").state
    runs = {}
    for label, sweep in (("4M-GS-bands", "bands"),
                         ("4M-GS-claim", "relocate")):
        runs[sweep] = phase_engine(
            lambda: _timed_sweeps(TiledEngine(
                gs_config(n, tiled_sweep=sweep), chunk=64,
                initial_state=_clone(start))),
            n, [(steps, None)], label, _gs_expect(steps, "par"))
        paths[label] = runs[sweep]["launches"]
        e = runs[sweep]["engine"]
        rec = e.sweep_log
        log(f"[{label}] sweeps {e._sweep_count} (watchdog events "
            f"{e.watchdog_events}); band drains {e.band_rebuilds}; stale % "
            f"after each sweep {[round(v, 4) for v in rec['stale_pct']]}; "
            f"ms a sweep {[round(v, 2) for v in rec['sweep_ms']]}")
    e = runs["bands"]["engine"]
    band_ms = e.sweep_log["band_ms"]
    if e.band_rebuilds < 10 or len(band_ms) < 5:
        raise AssertionError(f"4M-GS-bands: {e.band_rebuilds} band drains "
                             f"in {len(band_ms)} sweeps")
    log(f"[4M-GS-bands] the band drains' ms per sweep "
        f"({e.config.tiled_band_k} bands of {e.config.tiled_band_rows} "
        f"rows, the histogram read included) "
        f"{[round(v, 3) for v in band_ms]}")
    st = e.state
    cpu = tiled.from_numpy(tiled.to_numpy(st))
    TY = st.dims[1]
    rows = e.config.tiled_band_rows
    moved = []
    for r0 in (0, (TY - rows) // 2, TY - rows):
        got = tiled.rebuild_band(st, e.config, r0, rows=rows)
        want = tiled.rebuild_band(cpu, e.config, r0, rows=rows)
        bad = [f for f in tiled.FIELDS
               if not torch.equal(getattr(got, f).cpu(), getattr(want, f))]
        if bad:
            raise AssertionError(f"4M-GS rebuild_band at row {r0}: card != "
                                 f"CPU in {bad}")
        moved.append(int((got.pid != st.pid).sum()))
    log(f"[4M-GS-bands] rebuild_band at rows 0, {(TY - rows) // 2}, "
        f"{TY - rows} of the final state: card == CPU bit for bit (every "
        f"plane; {moved} slots changed)")
    del runs, e, st, cpu, start
    torch.cuda.empty_cache()


def _hybrid_512k(paths: dict) -> None:
    """make_tuned_engine(512_000) with the claim sweep and
    tiled_rebuild_every=4 for 1,000 steps: sweeps 1-3 claims, sweep 4 the
    wholesale rebuild."""
    from gpu_physics_engine_torch import make_tuned_engine
    n = 512_000
    run = phase_engine(
        lambda: make_tuned_engine(n, device="cuda", tiled_sweep="relocate",
                                  tiled_rebuild_every=4),
        n, [(1000, None)], "512k-hybrid", {"collide_integrate": 1000})
    paths["512k-hybrid"] = run["launches"]
    e = run["engine"]
    if run["launches"]["relocate_pull"] <= 0 or e.rebuild_sweeps < 1 or (
            e.watchdog_events == 0
            and e.rebuild_sweeps != e._sweep_count // 4):
        raise AssertionError(
            f"512k-hybrid: sweeps {e._sweep_count}, rebuilds "
            f"{e.rebuild_sweeps}, watchdog events {e.watchdog_events}, "
            f"launches {run['launches']}")
    log(f"[512k-hybrid] _sweep_count {e._sweep_count}, rebuild_sweeps "
        f"{e.rebuild_sweeps}, watchdog_events {e.watchdog_events} (after "
        f"the 1000 steps and 32 more); all {n} pids present")


def _resume_4m_spawn(saved, paths: dict) -> None:
    """The 4M-spawn engine's checkpoint (saved after its windows, 300 bigs
    in the overlay) loaded on the card: its export and bigs equal the
    saved engine's bit for bit, and a CPU load's tiles and overlay equal
    the card's; then 64 steps with every pid kept."""
    import numpy as np
    import torch
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.ops import bigs, tiled
    path, export, big_export, save_s = saved
    t0 = time.perf_counter()
    e = TiledEngine.from_checkpoint(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for got, want, what in ((e._export(), export, "export"),
                            (bigs.export_bigs(e.big), big_export, "bigs")):
        if not all(np.array_equal(u, v) for u, v in zip(got, want)):
            raise AssertionError(f"4M-spawn-resume: the card's {what} != "
                                 "the saved engine's")
    c = TiledEngine.from_checkpoint(path, device="cpu")
    a, b = tiled.to_numpy(e.state), tiled.to_numpy(c.state)
    ab, bb = bigs.to_numpy(e.big), bigs.to_numpy(c.big)
    bad = [f for f in a if not np.array_equal(a[f], b[f])] + [
        f"big.{f}" for f in ab if not np.array_equal(ab[f], bb[f])]
    if bad:
        raise AssertionError(f"4M-spawn-resume: card load != CPU load in "
                             f"{bad}")
    del c
    n = len(export[0])
    reset_launches()
    secs = []
    for _ in range(64):
        t0 = time.perf_counter()
        e.step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    got = launches()
    paths["4M-spawn-resume"] = got
    if got["collide_integrate"] != 64 or got["relocate_pull"] <= 0:
        raise AssertionError(f"4M-spawn-resume: launches {got}")
    _check_engine(e, n, "4M-spawn-resume")
    log(f"[4M-spawn-resume] saved in {save_s:.1f} s, loaded on the card in "
        f"{load_s:.1f} s ({int(e.big.num_active)} bigs, next pid "
        f"{e._next_pid}): export and bigs == the saved engine's, the CPU "
        f"load == the card's (every plane) bit for bit")
    log(f"[4M-spawn-resume] 64 steps (step(), a sync after each), all {n} "
        f"pids present, finite, inside; launches {got}; seconds a step: "
        f"first {secs[0]:.4f}, median {sorted(secs)[32]:.5f}, max "
        f"{max(secs):.4f}, all {[round(v, 5) for v in secs]}")
    del e
    torch.cuda.empty_cache()


def phase_options(paths: dict, saved) -> None:
    """The options that raised before this slice, each on the card at full
    width: the fast solver at 1M (both packings, 256 steps with the resort
    at step 240: K12 and the radix pass), with card == CPU at 10k; the band
    drain at 4M-GS beside the claim sweep; the hybrid sweep at 512k; the
    4M-spawn checkpoint resumed."""
    import shutil
    import torch
    from gpu_physics_engine_torch import Engine
    t0 = time.perf_counter()
    for label, pack in (("1M-array-fast", True),
                        ("1M-array-fast-f32", False)):
        run = phase_array_engine(
            lambda: Engine(_array_cfg(solver="fast", sort_impl="radix",
                                      fast_pack_bf16=pack), seed=0,
                           device="cuda"),
            [(128, None), (128, CENTRE)], label, dict.fromkeys(RADIX, 4))
        paths[label] = run["launches"]
        del run
        torch.cuda.empty_cache()
    _fast_card_vs_cpu()
    _bands_4m_gs(paths)
    _hybrid_512k(paths)
    _resume_4m_spawn(saved, paths)
    shutil.rmtree(saved[0].rsplit("/", 1)[0], ignore_errors=True)
    log(f"[options] phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the device compositor (render/device.py) and the frame loop
# ---------------------------------------------------------------------------

RENDER_FRAMES = 64


def _planes(state):
    from gpu_physics_engine_torch.ops import tiled
    return [getattr(state, f) for f in tiled.FIELDS]


def _within_one(label, got, want, what) -> None:
    """u8 frames within one step on every value, or raise; prints the
    largest difference and how many values differ."""
    import torch
    d = (got.cpu().to(torch.int32) - want.cpu().to(torch.int32)).abs()
    worst, n = int(d.max()), int((d > 0).sum())
    log(f"[render] {label}: {what}: largest difference {worst} u8, {n} of "
        f"{d.numel()} values differ; {int((want > 0).any(-1).sum())} pixels "
        "lit")
    if worst > 1:
        raise AssertionError(f"{label}: {what}: {int((d > 1).sum())} values "
                             f"differ by more than 1 u8 (largest {worst})")


def _render_vs_cpu(label, cfg, state, rect) -> None:
    """render_core on the card against render_core of the same planes
    copied to the CPU (the plain path the CPU tests hold to the JAX
    package), 1280 x 720."""
    from gpu_physics_engine_torch.render import device as rd
    got = rd.render_core(*_planes(state), rect, cfg, 1280, 720)
    want = rd.render_core(*[p.cpu() for p in _planes(state)], rect, cfg,
                          1280, 720)
    rect_s = ", ".join(f"{v:.2f}" for v in rect)
    _within_one(label, got, want, f"card vs CPU, S = "
                f"{cfg.render_supersample}, rect ({rect_s})")


PEAK_TF32 = 495e12  # H100 SXM TF32 tensor-core FLOP/s (dense)


def _render_bound(planes, S: int, width: int, height: int) -> str:
    """The least time of one frame: every input plane ([P, CAP, R, C]: P
    sub-grids) read once and the u8 image written once over the memory
    rate, against the two resample products of each sub-grid and sample
    grid (3 channels) over the TF32 tensor-core rate."""
    nbytes = sum(p.numel() * p.element_size() for p in planes)
    nbytes += height * width * 3
    P, _, R, C = planes[0].shape
    flops = P * S * S * 2 * 3 * (R * C * width + height * R * width)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_TF32 * 1e3
    return (f"bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e9:.3f} GB: "
            f"{t_bytes:.4f} ms; {flops / 1e9:.1f} TF32 GFLOP: {t_ops:.4f})")


def _parity_vs_relayout(label, smi, cfg, ps) -> None:
    """A parity-space state's frame two ways, timed in turns over
    ``RENDER_FRAMES`` frames each (weights built once, before the timing):
    ``render_parity_core``, and ``from_parity_state`` + ``render_core``."""
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.render import device as rd
    parity = rd.frame_drawer(cfg, 1280, 720, "cuda", parity=True)
    full = rd.frame_drawer(cfg, 1280, 720, "cuda")
    ways = {"render_parity_core": lambda: parity(ps),
            "from_parity_state + render_core":
                lambda: full(gp.from_parity_state(ps, cfg))}
    times = {k: [] for k in ways}
    for _ in range(3):
        for k, fn in ways.items():
            times[k].append(cuda_ms(fn, reps=RENDER_FRAMES, warmup=1))
    log(f"[render] {label} ({smi}): a parity-space frame, ms over "
        f"{RENDER_FRAMES} frames in turns: " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)}"
            for k, v in times.items()))


def phase_render(smi: str, paths: dict) -> None:
    """The compositor on the card, then the frame loop.

    Card against CPU: the initial 4M scene (its previous positions
    jittered, so slots differ in color) at S = 1 and the auto-fit and a
    zoomed, off-centre rect, and a jittered 256k scene at S = 2, within one
    u8.  Frames, free (no mouse: a drag trips run()'s watchdog, which
    render_run does not have): at 4M, 1M and 1M-GS par, a warm-up window of
    ``RENDER_FRAMES`` frames of ``render_run`` and one timed between CUDA
    events, beside ``run()`` over the same steps on a twin engine (launch
    counts zeroed just before each timed window and equal after it), and
    ``render_throughput_ms`` of the state ``render_run`` draws from; then
    the two engines' states bit-equal.  At 1M, 3 frames of
    ``step_render_frame`` against ``step()`` + ``render_frame()`` on the
    twin, image and state bit-equal; at 1M-GS par ``render_parity_core`` of
    the final state against ``render_core`` of it in full space, within one
    u8, and the two ways timed."""
    import torch
    from gpu_physics_engine_torch import TiledEngine, make_tuned_engine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_parity as gp, tiled
    from gpu_physics_engine_torch.render import device as rd
    t0 = time.perf_counter()
    e = make_tuned_engine(256_000, device="cuda")
    moving = _jittered(e.state, 0.3, seed=5)
    moving = moving.replace(px=_jittered(moving, 0.1, seed=6).x)
    cfg = e.config.replace(render_supersample=2)
    _render_vs_cpu("256k", cfg, moving, rd.autofit_rect(cfg, 1280, 720))
    del e, moving

    fields = tiled.FIELDS + ("num_active", "overflow_count")
    cases = (
        ("4M", lambda: make_tuned_engine(4_194_304, device="cuda")),
        ("1M", lambda: make_tuned_engine(1_048_576, device="cuda")),
        ("1M-GS-par", lambda: TiledEngine(
            gs_config(1_048_576, gs_layout="par"), seed=0, chunk=64,
            device="cuda")))
    frames = RENDER_FRAMES
    for label, make in cases:
        e = make()
        cfg = e.config
        if label == "4M":
            moving = e.state.replace(
                px=_jittered(e.state, 0.1, seed=7).x,
                py=_jittered(e.state, 0.1, seed=8).y)
            _render_vs_cpu("4M", cfg, moving,
                           rd.autofit_rect(cfg, 1280, 720))
            _render_vs_cpu("4M", cfg, moving, (1100.0, 300.0, 1420.0, 480.0))
            del moving
        twin = TiledEngine(cfg, initial_state=_clone(e.state), chunk=e.CHUNK)
        e.render_run(frames)
        twin.run(frames)
        torch.cuda.synchronize()
        reset_launches()
        frame_ms = cuda_ms(lambda: e.render_run(frames), reps=1,
                           warmup=0) / frames
        got = launches()
        reset_launches()
        step_ms = cuda_ms(lambda: twin.run(frames), reps=1,
                          warmup=0) / frames
        want = launches()
        if got != want or not any(want.values()):
            raise AssertionError(f"{label}: render_run launches {got}, run()"
                                 f" launches {want}")
        paths[f"{label}-render"] = got
        diff = [f for f in fields if not torch.equal(getattr(e.state, f),
                                                     getattr(twin.state, f))]
        if diff:
            raise AssertionError(
                f"{label}: after {e._steps_done} steps render_run's state "
                f"differs from run()'s in {diff} (watchdog events "
                f"{twin.watchdog_events})")
        if e.parity_space:
            ps = gp.to_parity_state(e.state, cfg)
            render_ms = rd.render_throughput_ms(ps, cfg)
            drawn = [ps.x, ps.y, ps.px, ps.py, ps.pid]
        else:
            render_ms = rd.render_throughput_ms(e.state, cfg)
            drawn = [p[None] for p in _planes(e.state)]
        bound = _render_bound(drawn, cfg.render_supersample, 1280, 720)
        busy = {k: v for k, v in got.items() if v}
        log(f"[render] {label} ({smi}): frame (step + render, 1280 x 720) "
            f"{frame_ms:.4f} ms over {frames} frames; run() {step_ms:.4f} "
            f"ms/step on the twin; render_throughput_ms {render_ms:.4f}; "
            f"launches {busy} in both; the frame's render {bound}")
        log(f"[render] {label}: render_run == run() bit for bit after "
            f"{e._steps_done} steps ({', '.join(fields)})")
        if label == "1M":
            for _ in range(3):
                img = e.step_render_frame()
                twin.step()
                if not (img == twin.render_frame()).all():
                    raise AssertionError("1M: step_render_frame differs from "
                                         "step() + render_frame()")
            if not all(torch.equal(getattr(e.state, f),
                                   getattr(twin.state, f)) for f in fields):
                raise AssertionError("1M: step_render_frame's state differs "
                                     "from step()'s")
            log("[render] 1M: step_render_frame == step() + render_frame() "
                "over 3 frames, image and state bit for bit")
        if label == "1M-GS-par":
            ps = gp.to_parity_state(e.state, cfg)
            rect = rd.autofit_rect(cfg, 1280, 720)
            _within_one(label, rd.render_parity_core(ps, rect, cfg, 1280,
                                                     720),
                        rd.render_core(
                            *_planes(gp.from_parity_state(ps, cfg)), rect,
                            cfg, 1280, 720),
                        "parity frame vs full-space frame on the card")
            _parity_vs_relayout(label, smi, cfg, ps)
        del e, twin
        torch.cuda.empty_cache()
    log(f"[render] phase {time.perf_counter() - t0:.1f} s")


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
    check_window_formula()

    errs: dict = {}
    jacobi = []
    for label, n in (("4M", 4_194_304), ("1M", 1_048_576),
                     ("256k", 256_000)):
        e = make_tuned_engine(n, device="cuda")
        moving = _jittered(e.state, 0.05, seed=3)  # some velocity
        jacobi.append((label, e.config,
                       e.state.replace(px=moving.x, py=moving.y)))
        del e
    phase_jacobi_kernels(jacobi, errs)
    big_cfg, big_state = jacobi[0][1:]
    del jacobi
    phase_tile_division(big_cfg, big_state)

    gs = []
    for label, n in (("1M-GS", 1_048_576), ("4M-GS", 4_194_304)):
        e = TiledEngine(gs_config(n), seed=0, chunk=64, device="cuda")
        gs.append((label, e.config, e.state))
        del e
    phase_gs_kernels(gs, errs)
    phase_par_kernels(gs, errs)
    phase_fused_kernels(gs, big_cfg, big_state, errs)
    gs_cfg, gs_state = gs[0][1:]
    del gs
    torch.cuda.empty_cache()

    paths = {}
    run = phase_engine(lambda: make_tuned_engine(4_194_304, device="cuda"),
                       4_194_304, [(150, None), (150, (1524.0, 524.0))],
                       "4M", {"collide_integrate": 300, "relocate_pull": 150})
    paths["4M"] = run["launches"]
    # K2 on the engine's own state after its windows (no jitter)
    check_relocate("4M in-step", run["engine"].config, run["engine"].state,
                   MODES, errs, jitter=0)
    plain_4m_ms = run["steady_ms"]
    del run
    torch.cuda.empty_cache()
    spawn_cfg, spawn_state, spawn_times, saved = phase_spawn(
        smi, paths, errs, plain_4m_ms)
    for label, n, steps, want in (
            ("1M", 1_048_576, 128, {"collide_integrate": 128,
                                    "relocate_pull": 32}),
            ("256k", 256_000, 250, {"collide_integrate": 250,
                                    "relocate_pull": 125})):
        run = phase_engine(lambda: make_tuned_engine(n, device="cuda"), n,
                           [(steps, None)], label, want)
        paths[label] = run["launches"]
        check_relocate(f"{label} in-step", run["engine"].config,
                       run["engine"].state, MODES, errs, jitter=0)
        del run

    phase_gs_paths(paths, errs)
    phase_k4_path(paths)
    phase_render(smi, paths)
    radix_bits = phase_array_kernels(errs)
    phase_array_paths(paths)
    phase_options(paths, saved)
    run = phase_engine(
        lambda: make_tuned_engine(4_194_304, device="cuda",
                                  tiled_fuse_integrate=False),
        4_194_304, [(64, None)], "4M-unfused",
        {"collide": 64, "relocate_pull": 32, "collide_integrate": 0})
    paths["4M-unfused"] = run["launches"]
    del run
    torch.cuda.empty_cache()

    times, library = phase_times(big_cfg, big_state, gs_cfg, gs_state,
                                 radix_bits)
    bound = bounds(big_cfg, big_state, gs_cfg, gs_state, radix_bits)
    times["collide_integrate[general]"] = spawn_times
    bound["collide_integrate[general]"] = _k1_bound(spawn_cfg, spawn_state)
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
            "bound_by": bound[name][1], "library_ms": library.get(name)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
