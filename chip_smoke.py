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
     shared-memory window; its window bytes, and K1's, == the Python
     mirrors at every cap 1-256 and past it to 4,096) there, on the
     ragged grid and on a small scene at cap 32
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
     sort's two kernels, radix_digit_hist (the four digit histograms, once
     a sort) and radix_onesweep (rank, look-back and store, once a pass),
     against their plain versions, twice, bit-equal, for all 4 passes of a
     sort, with each pass's look-back prefixes == ``lookback_plain``, on a
     25,006-key reverse ramp with duplicates and sentinels, on the scene's
     4,403,200 pair keys and on its 1,100,800 resort codes, each whole
     radix sort equal to torch.sort(stable=True); the stress sorts (the
     pairs 50 times, identical; 2^26 random keys; all-equal keys; all
     0xFFFFFFFF; n = 1, 4,095, 4,097 and 4,403,201, each ==
     torch.sort(stable=True)); the scene's candidate
     cells on the card equal to the CPU's; then 256 steps (128 free, 128
     with the mouse at the world centre, crossing the resort at step 240)
     with 257 histogram and 1,028 pass launches, the same run with
     sort_impl="lax" (no radix launch, final state bit-equal), and 64
     steps each of pipeline "bucket" and solver "jacobi";
  6b. the engine options that raised before (phase_options): the fast
     solver (solver="fast", the sort + shift Jacobi) on the 1M array
     Engine with fast_pack_bf16 on and off, the windows of the radix
     engine (256 steps, the resort at step 240 launching the histogram
     once and the radix pass 4 times), and card == CPU bit for bit for
     both packings on a 10,000-particle scene over 8 steps; the 4M-GS engine (the card's par
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
  7b. the apps layer (phase_apps): each of the five scenes (tiny,
     interactive, million, four_million, sixteen_million) through the
     headless CLI, ``headless.main([--scene, name, --device cuda, ...])``,
     at its own step count (four_million with ``--tilemap --render-every
     50`` and a chrome trace; sixteen_million, 16,777,216 particles on one
     card, with ``--render-every 50`` through the Viewer's device path;
     million with ``--render-every 300`` through the host splat), each
     with its summary, ms/step from CUDA events, construction seconds,
     peak device memory and launch counts (four_million K1 400 times at
     substeps=2 and K2 100; sixteen_million K1 and K2 100 each), the
     particle count, the bounds and the PNG frames checked; on the
     four_million and sixteen_million states (their shapes and configs),
     K1 at the scene's dt_scale (0.5 at four_million) and K2 under its
     match and hysteresis on a jittered copy, each bit-equal to its plain
     version, twice; the phase breakdowns (``tiled_phase_breakdown`` of the 4M
     engine: K2, K3, K1; of the 1M-GS engine in the par layout: K5-par and
     the color window; ``phase_breakdown`` of the 1M array Engine with
     sort_impl="radix": the histogram and the radix pass), every phase
     finite and
     positive; the web app on make_tuned_engine(1_048_576) through
     ``make_server(port=0)``: the page, PNG frames, a move, a press and
     release and the key p, then 1,048,676 particles in /stats;
  7c. the slab mesh (parallel/, phase_sharded), every slab on this card:
     K1 (fused) and K3 on slab 1's halo-extended planes [8, 162, 1850]
     and K2 at row0 160, 320 and 480 (global_rows 640) on jittered
     slabs, each bit-equal to its plain version, twice; the 4M row on 4
     slabs (ShardedTiledEngine) beside its TiledEngine twin built from
     the same arrays: step 1 (an off-step on both) bit-equal per pid,
     then 256 steps through the claim sweep at 240 (K1 4 a step, K2 4 a
     relocating step; every pid kept, finite, inside), ms/step and idle
     share beside the twin's, 16 steps under the sync-error mode, a
     64-step mouse drag across a slab edge (nothing lost or doubled) and
     8 unfused steps (K3); a 1,000-particle spawn on a slab edge of a
     1M engine (tile_max_radius 1, the cap from the scene), the uniform
     radius turned off; the multichip CLI at its defaults on 4 slabs;
     ``halo.make_sharded_step`` at 1M for 16 steps with the radix resort
     (nothing dropped); the sharded GS frame at 1M-GS on 4 slabs
     bit-equal to the one-grid plain solve and to K5 + K6;
  7d. tile caps past 32 and K past 16 (phase_wide_caps): the kernels'
     64-bit mask instantiations (caps 33-64), K1's and the relocate
     window's kernels without a mask (past 64: the packed K1, its window
     also streamed; the warp relocate, at cap 4,096 on device scratch), the
     GS kernels past cap 64 or K 16 (the packed rank, also with its
     windows streamed, and the ranked-slot solve): every kernel at caps
     33, 65, 140, 257, 312 and 520 (the GS kernels also at 128 and 256) on
     piles whose tiles fill every slot, bit-equal to its plain version and
     on repeat (K1 and K3, uniform and general radius, on a grid smaller
     than one region, a ragged one and a halo-extended slab; K2 in every
     matching mode, K4, K2-par at origins 0 and -1 and relocate_mega; K5
     and K5-par with K 16, with and without a radius plane; K6 / K6-par
     for colors 1..4, with and without the tail, and colors_mega); K5,
     K5-par and K6 at K 17, 32 and 64 (cap 16) and K 64 at cap 140; at K
     80 and 128 (cap 16, a crowded cell of 144 members) K5, K5-par, K6 and
     K6-par; an engine's cap
     grown from 256 to 257 by ``_maybe_grow_cap``, 8 steps there; the 1M
     engine with tiled_spawn="retile" (64 steps, then a spawn re-tiles it
     past cap 32, then 128 steps: K1's general form every step, K2 every
     4th) and the 1M engine at the cap its scene gives tile_max_radius 1
     (128 steps, K1 uniform; K3's and K4's paths on its scene); the 4M
     engine with tiled_spawn="retile": a spawn on the seeded scene
     re-tiles it to cap 140 [140, 168, 464] (after 64 steps the scene
     gives 108), 128 steps (K1's general form, K2 every 2nd);
     JAX's spawn-ready 1M tiling (tile_max_radius 3: cap 144 [144, 88,
     233]) and the 1M engine tiled for radius 5 (cap 312 [312, 56, 141]),
     a spawn into their tiles, 128 steps; each with its launch counts,
     every pid kept, ms/step, idle share and launches a step (a profiler
     window that holds every K1 launch, else fail), and K1 and K2
     bit-equal on its final state
     (K2 also jittered; at cap 140 K2 on a band of 32 tile rows); the GS
     engine at caps 64, 128 and 312 and at K 32 (cap 16) in the
     flat, par and mega layouts (48 steps each past cap 64 or K 16),
     bit-equal to each other, each kernel timed on its state;
  8. kernel times at the main paths' shapes against their plain versions,
     with each kernel's bound on this card (and, for the radix pass, the
     time of torch.sort(stable=True) of the same pairs beside the whole
     hand radix sort's).

Then a line {"kernels": [...]} and, last, the result line
{"ok": true, "device": {...}}.  Without a CUDA device (or without the
package beside this script) it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from gpu_physics_engine_torch.utils.kernel_study import (jittered,
                                                      kernel_device_ms)
from gpu_physics_engine_torch.utils.profiling import cuda_ms

# H100 SXM data-sheet peaks (dense): device memory bytes/s and f32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
# seconds a profiler window keeps its kernels clear of its ends, one a try
# (utils/profiling.kernel_window)
PADS = (0.5, 2.0, 5.0)
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


FORMULA_CAPS = tuple(range(1, 257)) + (257, 300, 312, 520, 1000, 1913,
                                       2000, 4096)
FORMULA_KS = tuple(range(1, 65)) + (65, 80, 128, 256)


def check_window_formula() -> None:
    """The shared-memory bytes of K1's, K2's, K5's and K6's windows, as the
    launches take them from csrc/, equal the Python mirrors
    (``tiled_kernels.k1_smem_bytes``, ``tiled_kernels.k2_window_bytes``,
    ``gs_kernels.rank_window_bytes``, ``gs_kernels.colors_window_bytes``)
    at every cap 1-256 and at caps past it up to 4,096 (K1 with and
    without a radius plane; K2 on both layouts; K5, whose geometry is one
    for both, with and without a radius plane, at every K 1-64 and at K
    65, 80, 128 and 256; K6, one geometry too, for 0-4 colors a launch),
    and the GS kernels each (cap, K) takes (``gpe_gs_route``) those the
    Python routes name (``gs_kernels.rank_kernel``, ``color_kernel``)."""
    from gpu_physics_engine_torch.ops import _cuda, gs_kernels as gk
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    lib = _cuda.library()
    most = {}
    for par in (False, True):
        for cap in FORMULA_CAPS:
            pairs = [("K2", tk.k2_window_bytes(cap, par),
                      lib.gpe_relocate_window_bytes(cap, int(par)))]
            pairs += [("K5", gk.rank_window_bytes(cap, uniform, K),
                       lib.gpe_gs_rank_window_bytes(cap, int(uniform), K))
                      for uniform in (False, True)
                      for K in FORMULA_KS]
            pairs += [("K1", tk.k1_smem_bytes(cap, uniform),
                       lib.gpe_collide_window_bytes(cap, int(uniform)))
                      for uniform in (False, True)]
            pairs += [("K6", gk.colors_window_bytes(cap, colors),
                       lib.gpe_gs_colors_window_bytes(cap, colors))
                      for colors in range(5)]
            pairs += [("GS route", (gk.rank_kernel(cap, K)
                                    == "gs_rank_pack_kernel")
                       + 2 * (gk.color_kernel(cap, K)
                              == "gs_colors_ranked_kernel"),
                       lib.gpe_gs_route(cap, K)) for K in FORMULA_KS]
            for what, want, got in pairs:
                if got != want:
                    raise AssertionError(
                        f"{what} window at cap {cap} par={par}: launch "
                        f"{got} B, mirror {want} B")
                most[what, par] = max(most.get((what, par), 0), want)
    from gpu_physics_engine_torch.ops import radix_sort as rs
    for ntiles in (0, 1, 1075, 16_384, rs.num_tiles(2 ** 31 - 1)):
        got = lib.gpe_radix_scratch_bytes(ntiles)
        if got != 8 * rs.scratch_words(ntiles):
            raise AssertionError(f"radix scratch at {ntiles} tiles: launch "
                                 f"{got} B, mirror "
                                 f"{8 * rs.scratch_words(ntiles)} B")
    log(f"[window] bytes of the launches == the Python mirrors at caps "
        f"1-256 and {FORMULA_CAPS[256:]} (K5 at K 1-64 and "
        f"{FORMULA_KS[64:]}): K1 most {most['K1', False]} B, K2 most "
        f"{most['K2', False]} B flat, {most['K2', True]} B parity; K5 most "
        f"{most['K5', False]} B; K6 most {most['K6', False]} B; the radix "
        f"sort's scratch; the GS routes (packed rank and ranked solve past "
        f"cap 64 or K 16; their plan {lib.gpe_gs_rank_pack_bytes(0, 0)} B, "
        f"{lib.gpe_gs_rank_pack_bytes(1, 0)} B without a radius plane)")


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
    moved = (jittered(st, jitter * tiled.tile_geometry(cfg)[0], seed=1)
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
    moved = (jittered(st, jitter * tiled.tile_geometry(cfg)[0], seed=seed)
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


def check_k1_k3(label, cfg, st, st_general, errs: dict) -> None:
    """K1 and K3 against their plain versions on ``st`` under a uniform
    radius and on ``st_general`` under the general one (the radius plane
    read), the mouse pressed at the world's centre: bit-equal and
    bit-equal on repeat."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
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


def phase_jacobi_kernels(scenes, errs: dict) -> None:
    """K1, K3 and K2 against their plain versions on the card, at small
    shapes (box and circle worlds, a grid no multiple of K1's or K2's
    region) and at each Jacobi path's ``scenes`` [(label, config, state)]:
    K1 and K3 bit-equal and bit-equal on repeat, uniform and general
    radius; K2 in every matching mode, and at cap 32; K2-par on the ragged
    grid and at cap 32."""
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
        check_k1_k3(label, cfg, st, st_general, errs)
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


def _gs_ragged_state(cap, K, uniform, n=1500, world=(40.0, 30.0),
                     jam_sd=2.0):
    """A small GS scene on a 40 x 30 world: TX 39 is no multiple of K5's
    32-wide flat region nor its parity sub-grids' 20 columns of one of
    32, nor of K6's regions, and at origin -1 DY 17 no multiple of two
    rows (TY itself is padded to a multiple of 8 by the tile geometry, as
    in the JAX package); a 20 x 12 world's [cap, 16, 21] grid is smaller
    than one K6 window; mixed radii (or uniform) with a jammed cluster
    (of deviation ``jam_sd``: 0.6 fills every slot of its tiles at cap
    64)."""
    import numpy as np
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import tiled
    w, h = world
    cfg = gs_config(n, world_width=w, world_height=h, tile_cap=cap,
                    max_occupancy=K, tiled_uniform_radius=uniform)
    rng = np.random.default_rng(cap)
    spread = rng.uniform(0.6, [w - 0.6, h - 0.6], (n - n // 3, 2))
    jam = np.clip([w / 2, h / 2] + rng.normal(0.0, jam_sd, (n // 3, 2)),
                  0.6, [w - 0.6, h - 0.6])
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
    """K6 on ``st`` with its own rank's tables (and count), flat and on the
    parity layout at origins 0 and -1 (no radius table read where the
    parity state drops the radius plane, as the par route does):
    ``_colors_lockstep`` on each; under a uniform radius also colors_mega
    with the tail on each parity state: bit-equal to their plain
    versions."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_mega as gm
    from gpu_physics_engine_torch.ops import gs_parity as gp
    src, _, rrad, count = gk.rank_cuda(st, cfg)
    _colors_lockstep(f"K6 {label}", (st.x, st.y, st.px, st.py, st.pid),
                     (src, rrad, count), cfg, None, errs, "gs_color",
                     _prm(cfg))
    shapes, prm = [], _prm(cfg)
    for origin in (0, -1):
        ps = gp.to_parity_state(st, cfg, origin)
        shapes.append(list(ps.x.shape))
        psrc, _, prrad, pcount = gp.rank_par_cuda(ps, cfg)
        _colors_lockstep(f"K6-par {label} origin={origin}",
                         (ps.x, ps.y, ps.px, ps.py, ps.pid),
                         (psrc, prrad, pcount), cfg, ps.geo, errs,
                         "gs_color_par", prm, uniform=ps.radius is None)
        if prm is not None:
            m = [ps.replace(px=ps.px.clone(), py=ps.py.clone())
                 for _ in range(3)]
            got = [gm.colors_mega_cuda(q, psrc, prrad, cfg, prm, pcount)
                   for q in m[:2]]
            want = m[2].replace(x=ps.x.clone(), y=ps.y.clone())
            gm.colors_mega_plain(want, psrc, prrad, cfg, prm)
            fields = ("x", "y", "px", "py")
            _equal_or_raise(f"colors_mega {label} origin={origin}",
                            tuple(getattr(got[0], f) for f in fields),
                            tuple(getattr(want, f) for f in fields),
                            tuple(getattr(got[1], f) for f in fields))
    log(f"[k6] {label} {list(st.dims)} and {shapes} K={cfg.max_occupancy} "
        f"uniform={cfg.tiled_uniform_radius}: "
        f"{gk.color_kernel(st.dims[0], cfg.max_occupancy)}, colors 1..c (c "
        f"= 1..4{_tails(cfg)}), flat and parity (origins 0 and -1)"
        f"{', colors_mega' if prm is not None else ''} bit-equal and "
        f"repeat bit-equal")


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
        st = jittered(st, 0.3 * tiled.tile_geometry(cfg)[0], seed=4 + i)
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
            (ta[0], ta[2], ta[3]), cfg, None, errs, "gs_color", _prm(cfg))
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
            st = jittered(st, 0.3 * tiled.tile_geometry(cfg)[0], seed=cap)
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
    1..c for c = 1..4 (past K 16, where the plain sweep's K^2/2 pairs are
    slow, c = 1 and 4) and, with ``prm`` (uniform radius, box world), the
    Verlet tail alone and after each c; bit-equal and bit-equal on repeat.
    ``fields`` = (x, y, px, py, pid) and ``tables`` = (src, rrad, count) in
    the layout of ``geo`` (None: flat); ``uniform``: the kernel reads no radius
    table, as on the par route.  Returns the number of slots the four
    colors moved."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    x, y, px, py, pid = fields
    src, rrad, count = tables
    grid = (tuple(x.shape[1:]) + (0, 0, 0, 0) if geo is None
            else gp._geo_args(geo) + (1,))
    moved, tails = 0, (False, True) if prm is not None else (False,)
    for c1 in range(5) if cfg.max_occupancy <= 16 else (0, 1, 4):
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
                                  cfg.initial_radius, count) + (q, r)
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
        st = jittered(st, 0.3 * t, seed=20 + i)  # storage off home
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
                (ps.x, ps.y, ps.px, ps.py, ps.pid), (src, rrad, count), cfg,
                ps.geo, errs, "gs_color_par", prm, uniform=ps.radius is None)
        dims = list(ps.x.shape)
        errs["gs_rank_par"] = 0.0
        if prm is not None:  # the par route's tail is this launch's
            errs["gs_verlet"] = 0.0
        fsrc, _, frrad, fcount = gk.rank_cuda(st, cfg)
        for name, origin in (("mx", 0), ("dec", -1)):
            geo = gp.ParityGeometry(*st.dims[1:], origin)
            to = lambda a, fill: gp.to_parity(a, geo, fill)  # noqa: E731
            _colors_lockstep(
                f"K6-{name} {label}", (to(st.x, 0.0), to(st.y, 0.0),
                                       to(st.px, 0.0), to(st.py, 0.0),
                                       to(st.pid, -1)),
                (to(fsrc, -1), to(frrad, 0.0), to(fcount[None], 0)[:, 0]),
                cfg, geo, errs, f"gs_color_par[{name}]")
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
    moved = jittered(state, 0.6 * t, seed=11)
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
    moved = jittered(st, 0.6 * tiled.tile_geometry(cfg)[0], seed=7)
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
    moved = jittered(st, 0.6 * tiled.tile_geometry(cfg)[0], seed=seed)
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
        ps = gp.to_parity_state(jittered(st, 0.3 * t, seed=60 + i), cfg)
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
    # a sharded engine's state is its list of slabs: the stale share of the
    # slabs stacked on the card
    state = e.gathered("cuda") if hasattr(e, "gathered") else e.state
    return {"stale_pct": float(tiled.stale_pair_fraction(state, cfg))
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


def _sort_vs_torch(label, keys) -> None:
    """The hand radix sort of ``keys`` (u32 values in int64 on the card)
    with the payload arange(n) equal to torch.sort(stable=True)."""
    import torch
    from gpu_physics_engine_torch.ops import radix_sort as rs
    n = keys.shape[0]
    sk, sv = rs.radix_sort_pairs(
        keys, torch.arange(n, dtype=torch.int32, device=keys.device))
    wk, wi = torch.sort(keys, stable=True)
    _equal_or_raise(f"radix sort {label} vs torch.sort", (sk, sv),
                    (wk, wi.to(torch.int32)))


def check_radix(label, keys) -> None:
    """radix_digit_hist and radix_onesweep against their plain versions:
    the histogram of the caller's int64 keys, then each of the 4 passes on
    its real input (the keys after the earlier passes; pass 0 reads int64,
    pass 3 writes int64), twice, bit-equal, and each pass's look-back
    array ending as ``lookback_plain`` of its tiles' counts, every word
    flagged inclusive; the whole radix sort equal to
    torch.sort(stable=True)."""
    import torch
    from gpu_physics_engine_torch.ops import radix_sort as rs
    vals = torch.arange(keys.shape[0], dtype=torch.int32, device="cuda")
    hist = rs.digit_hist_cuda(keys)
    _equal_or_raise(f"radix_digit_hist {label}", hist,
                    rs.digit_hist_plain(keys), rs.digit_hist_cuda(keys))
    bits = keys
    for p in range(4):
        shift = 8 * p
        od = torch.int64 if p == 3 else torch.int32
        got = rs.onesweep_pass_cuda(bits, vals, shift, hist, od)
        again = rs.onesweep_pass_cuda(bits, vals, shift, hist, od)
        _equal_or_raise(f"radix_onesweep {label} pass {p}", got[:2],
                        rs.onesweep_pass_plain(bits, vals, shift,
                                               rs.digit_bases(hist[p]),
                                               out_dtype=od), again[:2])
        counts = rs.rank_hist_plain(rs.as_i32_bits(bits), shift,
                                    rs.TILE)[1]
        look = got[2]
        if not (torch.equal((look & 0xFFFFFFFF).to(torch.int32),
                            rs.lookback_plain(counts))
                and bool(((look >> 32) == 4 * p + 2).all())):
            raise AssertionError(f"radix_onesweep {label} pass {p}: the "
                                 f"look-back array != lookback_plain")
        bits, vals = got[:2]
    _sort_vs_torch(label, keys)
    log(f"[radix] {label} {keys.shape[0]} keys ({rs.num_tiles(keys.shape[0])}"
        f" tiles): radix_digit_hist and radix_onesweep bit-equal to their "
        f"plain versions and on repeat on all 4 passes, the look-back "
        f"prefixes == lookback_plain; the radix sort == "
        f"torch.sort(stable=True)")


def check_radix_stress(pair_keys) -> None:
    """The look-back under load and the ragged edges: the 1M pairs sorted
    50 times (every result identical), 2^26 random u32 keys (16,384
    tiles), all-equal keys, all 0xFFFFFFFF, and n = 1, T - 1, T + 1 and
    4,403,201 (T = 4,096 keys a tile), each == torch.sort(stable=True)."""
    import torch
    from gpu_physics_engine_torch.ops import radix_sort as rs
    t0 = time.perf_counter()
    obj = torch.arange(pair_keys.shape[0], dtype=torch.int32, device="cuda")
    first = rs.radix_sort_pairs(pair_keys, obj)
    for i in range(49):
        _equal_or_raise(f"radix sort of the 1M pairs, repeat {i + 1}",
                        rs.radix_sort_pairs(pair_keys, obj), first)
    _sort_vs_torch("1M pairs", pair_keys)
    g = torch.Generator(device="cuda").manual_seed(14)
    wide = torch.randint(0, 2 ** 32, (2 ** 26,), generator=g,
                         device="cuda", dtype=torch.int64)
    _sort_vs_torch("2^26 random", wide)
    del wide
    T = rs.TILE
    n = pair_keys.shape[0]
    cases = {"all equal": torch.full((n,), 0x01020304, device="cuda"),
             "all 0xFFFFFFFF": torch.full((n,), 0xFFFFFFFF, device="cuda")}
    more = torch.randint(0, 2 ** 32, (n + 1,), generator=g, device="cuda",
                         dtype=torch.int64)
    for m in (1, T - 1, T + 1):
        cases[f"n={m}"] = more[:m]
    cases[f"n={n + 1}"] = torch.cat([pair_keys, more[:1]])
    for label, keys in cases.items():
        _sort_vs_torch(label, keys.contiguous())
    torch.cuda.empty_cache()
    log(f"[radix] stress: the 1M pairs sorted 50 times, identical; 2^26 "
        f"random keys ({rs.num_tiles(2 ** 26)} tiles), "
        f"{', '.join(cases)} == torch.sort(stable=True) "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_array_kernels(errs: dict):
    """The radix kernels at a small shape and at both shapes the 1M engine
    gives them: the scene's pair keys (each substep) and its home-cell
    codes over the whole capacity, the inactive tail UNUSED (the Morton
    resort); the stress sorts; and the scene's candidate cells on the card
    against the CPU's.  Returns the pair keys."""
    from gpu_physics_engine_torch import Engine
    from gpu_physics_engine_torch.core import stepper
    from gpu_physics_engine_torch.ops import resort
    check_radix("ramp", _ramp_keys())
    cfg = _array_cfg(sort_impl="radix")
    e = Engine(cfg, seed=0, device="cuda")
    _, keys = _pair_keys(e.state, cfg)
    check_radix("1M pairs", keys)
    st = e.state
    check_radix("1M resort codes", resort.home_cell_codes(
        st.x, st.y, st.active_mask(), stepper.cell_size(cfg, st)))
    check_radix_stress(keys)
    for name in RADIX:
        errs[name] = 0.0
    check_candidates("1M scene", e.state, cfg)
    return keys


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


RADIX = ("radix_digit_hist", "radix_onesweep")


def _radix_expect(sorts: int) -> dict:
    """The radix launches of ``sorts`` sorts: one histogram, four passes."""
    return {"radix_digit_hist": sorts, "radix_onesweep": 4 * sorts}


ARRAY_STATE = ("x", "y", "px", "py", "radius", "num_active",
               "steps_since_sort", "max_radius", "overflow_count")


def phase_array_paths(paths: dict) -> None:
    """The radix engine at 1M for 256 steps (128 free, 128 under the drag,
    the resort at step 240), the lax engine through the same steps from the
    same seed (bit-equal, no radix launch), then 64 steps each of the bucket
    pipeline and the Jacobi solver."""
    import torch
    from gpu_physics_engine_torch import Engine
    windows = [(128, None), (128, CENTRE)]
    runs = {}
    for impl, sorts in (("radix", 256 + 1), ("lax", 0)):
        label = f"1M-array-{impl}"
        runs[impl] = phase_array_engine(
            lambda: Engine(_array_cfg(sort_impl=impl), seed=0,
                           device="cuda"),
            windows, label, _radix_expect(sorts))
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
            [(64, None)], label, _radix_expect(0))
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


def _k2_bound(state):
    """K2's least time on ``state``: the pid plane read, x, y, px, py,
    radius of the occupied slots read (an empty slot moves nothing), six
    planes and the defer cells written; 10 flops a particle."""
    cap, TY, TX = state.dims
    occ = float((state.pid >= 0).sum())
    return _bound(7 * cap * TY * TX * 4.0 + 20 * occ + TY * TX * 4.0,
                  10 * occ)


def _k3_bound(cfg, state):
    """K3's least time on ``state``: x, y, pid (and the radius plane under
    a general radius) read, x, y written; 5 flops a candidate pair."""
    cap, TY, TX = state.dims
    n, box = _tile_counts(state)
    pairs = float((n * box).sum()) - float(n.sum())
    rplanes = 0 if cfg.tiled_uniform_radius else 1
    return _bound((3 + rplanes + 2) * cap * TY * TX * 4.0, 5 * pairs)


def bounds(cfg, state, gs_cfg, gs_state, radix_keys) -> dict:
    """Per kernel (least ms, "bytes" or "operations"): each input read once,
    each output written once; operations counted from this run's data
    (5 flops per candidate pair's distance test, 25 per Verlet step, 9 per
    membership test, 8 per GS pair).  The GS kernels: ``gs_bounds``."""
    out = {
        "collide_integrate": _k1_bound(cfg, state),
        "collide": _k3_bound(cfg, state),
        "relocate_pull": _k2_bound(state),
        "relocate_one": _k2_bound(state),
    }
    out.update(gs_bounds(gs_cfg, gs_state))
    # the radix sort: the histogram reads each int64 key once and writes
    # [4, 256] i32; the pass as timed (pass 0) reads the int64 key, the
    # payload and its histogram row and writes the u32 key and the payload
    # (the look-back words are the kernel's scratch, not the function's);
    # a handful of integer operations a key
    nkeys = float(radix_keys.shape[0])
    out["radix_digit_hist"] = _bound(8 * nkeys + 4096, 0.0)
    out["radix_onesweep"] = _bound(20 * nkeys + 1024, 0.0)
    return out


def gs_bounds(gs_cfg, gs_state) -> dict:
    """The GS kernels' least times on ``gs_state``, as ``bounds`` counts.
    The parity kernels at the scene's parity shape: the same counts, no
    radius plane (uniform).  The GS colors per solve: K6 and K6-mx/dec the
    four colors, K6-par and colors_mega the four colors and the Verlet
    tail."""
    import torch
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.ops import gs_tiled as gt
    out = {}
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
    # route's solve, relocate_mega K2-par's
    out["gs_colors_mega"] = out["gs_color_par"]
    out["relocate_mega"] = out["relocate_par"]
    return out


def _par_runs(gs_cfg, gs_state) -> dict:
    """The parity kernels' timing runs at the 1M-GS scene's parity shape:
    name -> (kernel, plain, launches per call[, the tensors the calls
    update in place]).  K6-par's window runs a
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
    far = gp.to_parity_state(jittered(
        gs_state, 0.3 * tiled.tile_geometry(cfg)[0], seed=2), cfg)
    src, _, rrad, count = gp.rank_par_cuda(ps, cfg)
    fsrc, _, frrad, fcount = gk.rank_cuda(gs_state, cfg)
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

    def mega_plain():  # as the kernel: new x, y; the tail's px, py in place
        out = m.replace(x=m.x.clone(), y=m.y.clone())
        gm.colors_mega_plain(out, src, rrad, cfg, prm)
        return out

    runs = {
        "gs_rank_par": (lambda: gp.rank_par_cuda(ps, cfg),
                        lambda: gp.rank_par_plain(ps, cfg), 1),
        "gs_colors_mega": (
            lambda: gm.colors_mega_cuda(m, src, rrad, cfg, prm, count),
            mega_plain, 1, (m.px, m.py)),
        "relocate_mega": (lambda: gm.relocate_mega_cuda(far, cfg),
                          lambda: gm.relocate_mega_plain(far, cfg), 1),
        # the par route's solve: four colors and the tail, no radius table
        "gs_color_par": (
            colors(gp.colors_par_cuda, ps.geo, par, tail=tail, uniform=True,
                   count=count),
            colors(gp.colors_par_plain, ps.geo, par, tail=tail), 1,
            tail[:2]),
        "relocate_par": (lambda: gp.relocate_par_cuda(far, cfg),
                         lambda: gp.relocate_par_plain(far, cfg), 1),
        # the window with no color: the tail alone
        "gs_verlet": (
            colors(gp.colors_par_cuda, ps.geo, par, 0, tail, uniform=True,
                   count=count),
            colors(gp.colors_par_plain, ps.geo, par, 0, tail), 1, tail[:2]),
    }
    for name, origin in (("mx", 0), ("dec", -1)):
        geo = gp.ParityGeometry(*gs_state.dims[1:], origin)
        tables = (gp.to_parity(fsrc, geo, -1), gp.to_parity(frrad, geo, 0.0))
        runs[f"gs_color_par[{name}]"] = (
            colors(gp.colors_par_cuda, geo, tables,
                   count=gp.to_parity(fcount[None], geo, 0)[:, 0]),
            colors(gp.colors_par_plain, geo, tables), 1)
    return runs, list(ps.x.shape)


def phase_times(cfg, state, gs_cfg, gs_state, radix_keys):
    """Every kernel against its plain version at the main paths' shapes:
    K1, K2, K3 at the 4M shape, K5 and K6 (one launch: a solve's four
    colors) at the 1M-GS shape, the parity kernels at its parity shape, on
    the engines' initial scenes (after a mouse drag most particles are
    members of no cell, and K6 would have little to do), the radix
    histogram and one radix pass (pass 0: int64 keys in, each call with a
    look-back state of its own) at the 1M array scene's 4,403,200 pair
    keys (their kernels' device time: the calls are host-paced).  Turns:
    plain, kernel, kernel, plain.  Returns ({name: (kernel ms, plain ms)},
    {name: library ms}): for radix_onesweep the library call is
    torch.sort(stable=True) of the same pairs, which does the whole sort
    that the histogram and the four passes serve."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    prm = StepParams.make(cfg.dt).as_tensor("cuda")
    moved = jittered(state, 0.3 * tiled.tile_geometry(cfg)[0], seed=2)
    src, _, rrad, count = gk.rank_cuda(gs_state, gs_cfg)

    def colors(fn):
        return lambda: fn(gs_state.x, gs_state.y, src, rrad, gs_cfg,
                          count=count)

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
    keys = radix_keys
    obj = torch.arange(keys.shape[0], dtype=torch.int32, device="cuda")
    hist = rs.digit_hist_cuda(keys)
    runs["radix_digit_hist"] = (lambda: rs.digit_hist_cuda(keys),
                                lambda: rs.digit_hist_plain(keys), 1)
    runs["radix_onesweep"] = (
        lambda: rs.onesweep_pass_cuda(keys, obj, 0, hist, torch.int32),
        lambda: rs.onesweep_pass_plain(keys, obj, 0, rs.digit_bases(hist[0]),
                                       out_dtype=torch.int32), 1)
    for name in RADIX:
        shapes[name] = list(keys.shape)
    out = {}
    for name, (kern, plain, per, *_) in runs.items():
        p1 = cuda_ms(plain, reps=2) / per
        k1 = cuda_ms(kern, reps=20) / per
        k2 = cuda_ms(kern, reps=20) / per
        p2 = cuda_ms(plain, reps=2) / per
        out[name] = (min(k1, k2), min(p1, p2))
        log(f"[time] {name} {shapes[name]}: kernel {k1:.4f} / {k2:.4f} ms, "
            f"plain {p1:.3f} / {p2:.3f} ms per launch")
    # a radix wrapper's host work (allocation, the zeroed look-back state)
    # outlasts its kernel, so back-to-back calls are paced by the host:
    # the kernel's ms is its device time in a profiler window instead,
    # taken again with a wider pad until the window holds all 10 of its
    # records, at most three times, else fail
    for name in RADIX:
        for pad in PADS:
            n = {}
            dev = kernel_device_ms(runs[name][0], 10, counts=n, pad_s=pad)
            ms = sum(v for k, v in dev.items() if f"{name}_kernel" in k)
            got = sum(v for k, v in n.items() if f"{name}_kernel" in k)
            if got == 10:
                break
        else:
            raise AssertionError(
                f"{name}: three profiler windows (pads {PADS} s) held "
                f"{got} of 10 kernel records: device time not measured")
        log(f"[time] {name} {shapes[name]}: kernel device time {ms:.4f} ms "
            f"a call (10 records, profiler window pad {pad} s; the call "
            f"{out[name][0]:.4f} ms, host-paced)")
        out[name] = (ms, out[name][1])
    # the sort the radix kernels serve: torch.sort of the pairs against the
    # hand radix sort (the histogram and 4 passes)
    def lib_sort():
        sk, idx = torch.sort(keys, stable=True)
        return sk, obj[idx]
    lib = [cuda_ms(lib_sort, reps=10), None, None, cuda_ms(lib_sort, reps=10)]
    lib[1] = cuda_ms(lambda: rs.radix_sort_pairs(keys, obj), reps=10)
    lib[2] = cuda_ms(lambda: rs.radix_sort_pairs(keys, obj), reps=10)
    log(f"[time] sort of {keys.shape[0]} pairs: torch.sort(stable=True) "
        f"{lib[0]:.4f} / {lib[3]:.4f} ms, the hand radix sort (the "
        f"histogram and 4 onesweep passes) {lib[1]:.4f} / {lib[2]:.4f} ms")
    torch.cuda.synchronize()
    return out, {"radix_onesweep": min(lib[0], lib[3])}


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
    # the pass kernel replaces K12 and the XLA steps of _one_pass
    # (:103-127); the histogram the digit-major half of its scan (:111)
    ("radix_onesweep", "radix_onesweep", "csrc/radix_kernels.cuh",
     "gpu_physics_engine_tpu/ops/radix_sort.py:80", "1M-array-radix"),
    ("radix_digit_hist", "radix_digit_hist", "csrc/radix_kernels.cuh",
     "gpu_physics_engine_tpu/ops/radix_sort.py:111", "1M-array-radix"),
    ("gs_colors_mega", "gs_colors_mega", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:503", "1M-GS-mega"),
    ("relocate_mega", "relocate_mega", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:443", "1M-GS-mega"),
    ("relocate_one", "relocate_one", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:1187", "4M-one"),
    # the 4M engine on four slabs: K1 on the halo-extended slabs
    # [8, 162, 1850], K2 at the slab row offsets 160, 320, 480
    ("collide_integrate[slab]", "collide_integrate", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "4M-sharded"),
    ("relocate_pull[row0]", "relocate_pull", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:945", "4M-sharded"),
    # caps 33-64, the kernels' 64-bit mask instantiations: the 1M engine
    # re-tiled by a radius-3 spawn (K1's general form) and the 1M engine at
    # the scene's cap for radius 1 (K1 uniform; K3 and K4 on its scene)
    ("collide_integrate[retile]", "collide_integrate",
     "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "1M-retile"),
    ("relocate_pull[retile]", "relocate_pull", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:945", "1M-retile"),
    ("collide_integrate[cap36]", "collide_integrate",
     "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "1M-cap36"),
    ("relocate_pull[cap36]", "relocate_pull", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:945", "1M-cap36"),
    ("collide[cap36]", "collide", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:455", "1M-cap36-unfused"),
    ("relocate_one[cap36]", "relocate_one", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:1187", "1M-cap36-one"),
    # the GS engine at cap 64 (set by hand) in its three layouts
    ("gs_rank[cap64]", "gs_rank", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:467", "GS-cap64"),
    ("gs_color[cap64]", "gs_color", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:543", "GS-cap64"),
    ("gs_rank_par[cap64]", "gs_rank_par", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:275", "GS-cap64-par"),
    ("gs_color_par[cap64]", "gs_color_par", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:433", "GS-cap64-par"),
    ("relocate_par[cap64]", "relocate_par", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:689", "GS-cap64-par"),
    ("gs_colors_mega[cap64]", "gs_colors_mega", "csrc/gs_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:503", "GS-cap64-mega"),
    ("relocate_mega[cap64]", "relocate_mega", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:443", "GS-cap64-mega"),
    # past cap 64, K1's and the relocate window's kernels without a mask:
    # the 4M engine re-tiled by a radius-3 spawn (cap 140) and JAX's
    # spawn-ready 1M tiling (cap 144), both K1's general form
    ("collide_integrate[cap140]", "collide_integrate",
     "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "4M-retile"),
    ("relocate_pull[cap140]", "relocate_pull", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:945", "4M-retile"),
    ("collide_integrate[cap144]", "collide_integrate",
     "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "1M-spawn-ready"),
    ("relocate_pull[cap144]", "relocate_pull", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:945", "1M-spawn-ready"),
    # the GS engine at cap 128 (set by hand) in its three layouts: the
    # packed rank and the ranked-slot solve
    ("gs_rank_pack[cap128]", "gs_rank_pack", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:467", "GS-cap128"),
    ("gs_color_ranked[cap128]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:543", "GS-cap128"),
    ("gs_rank_pack_par[cap128]", "gs_rank_pack", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:275", "GS-cap128-par"),
    ("gs_color_ranked_par[cap128]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:433", "GS-cap128-par"),
    ("relocate_par[cap128]", "relocate_par", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:689", "GS-cap128-par"),
    ("gs_color_ranked_mega[cap128]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:503", "GS-cap128-mega"),
    ("relocate_mega[cap128]", "relocate_mega", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:443", "GS-cap128-mega"),
    # the tuned 1M engine with tiles for radius-5 particles (cap 312 from
    # the scene), K1's general form after a spawn into its tiles
    ("collide_integrate[cap312]", "collide_integrate",
     "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:524", "1M-r5-cap312"),
    ("relocate_pull[cap312]", "relocate_pull", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/tiled_pallas.py:945", "1M-r5-cap312"),
    # the GS engine at cap 312 (set by hand): the packed rank and the
    # ranked-slot solve
    ("gs_rank_pack[cap312]", "gs_rank_pack", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:467", "GS-cap312"),
    ("gs_color_ranked[cap312]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:543", "GS-cap312"),
    ("gs_rank_pack_par[cap312]", "gs_rank_pack", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:275", "GS-cap312-par"),
    ("gs_color_ranked_par[cap312]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:433", "GS-cap312-par"),
    ("relocate_par[cap312]", "relocate_par", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:689", "GS-cap312-par"),
    ("gs_color_ranked_mega[cap312]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:503", "GS-cap312-mega"),
    ("relocate_mega[cap312]", "relocate_mega", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:443", "GS-cap312-mega"),
    # the GS engine at K 32 (cap 16) (set by hand) in its three layouts:
    # the packed rank and the ranked-slot solve
    ("gs_rank_pack[K32]", "gs_rank_pack", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:467", "GS-K32"),
    ("gs_color_ranked[K32]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_pallas.py:543", "GS-K32"),
    ("gs_rank_pack_par[K32]", "gs_rank_pack", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:275", "GS-K32-par"),
    ("gs_color_ranked_par[K32]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:433", "GS-K32-par"),
    ("relocate_par[K32]", "relocate_par", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_parity.py:689", "GS-K32-par"),
    ("gs_color_ranked_mega[K32]", "gs_color_ranked", "csrc/gs_simple.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:503", "GS-K32-mega"),
    ("relocate_mega[K32]", "relocate_mega", "csrc/tiled_kernels.cuh",
     "gpu_physics_engine_tpu/ops/gs_mega.py:443", "GS-K32-mega"),
)

FLAT_GS = ("gs_rank", "gs_color", "relocate_pull")
PAR_GS = ("gs_rank_par", "gs_color_par", "relocate_par", "gs_verlet")
MEGA_GS = ("gs_colors_mega", "relocate_mega")
# past cap 64 or K 16, beside the wrappers' counts: the packed rank's and
# the ranked-slot solve's launches
RANKED_GS = ("gs_rank_pack", "gs_color_ranked")


def _gs_expect(steps: int, layout: str, ranked: bool = False) -> dict:
    """Launch counts of ``steps`` GS steps (one substep each) in ``layout``
    ("mega": par with gs_colors_mega and gs_relocate_mega); ``ranked``: a
    config past cap 64 or K 16, whose rank and solve take the packed and
    the ranked-slot kernels (else those launch no time)."""
    per = {"flat": dict(gs_rank=1, gs_color=1, relocate_pull=1),
           "par": dict(gs_rank_par=1, gs_color_par=1, relocate_par=1,
                       gs_verlet=1),
           "mega": dict(gs_rank_par=1, gs_colors_mega=1, relocate_mega=1),
           "mx": dict(gs_rank=1, gs_color_par=1, relocate_pull=1)}
    per["dec"] = per["mx"]
    want = {k: 0 for k in FLAT_GS + PAR_GS + MEGA_GS + RANKED_GS
            + ("collide_integrate", "relocate_one")}
    want.update({k: v * steps for k, v in per[layout].items()})
    if ranked:
        want.update({k: steps for k in RANKED_GS})
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
    at step 240: the histogram and the radix pass), with card == CPU at
    10k; the band
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
            [(128, None), (128, CENTRE)], label, _radix_expect(1))
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
    moving = jittered(e.state, 0.3, seed=5)
    moving = moving.replace(px=jittered(moving, 0.1, seed=6).x)
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
                px=jittered(e.state, 0.1, seed=7).x,
                py=jittered(e.state, 0.1, seed=8).y)
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


# ---------------------------------------------------------------------------
# the apps layer: the scenes through the headless CLI, the phase
# breakdowns, the web app
# ---------------------------------------------------------------------------

# scene -> (extra CLI flags, the launch counts its run must give)
APP_SCENES = (
    ("tiny", [], {}),
    ("interactive", [], {}),
    ("million", ["--render-every", "300"], {}),
    ("four_million", ["--tilemap", "--render-every", "50"],
     {"collide_integrate": 400, "relocate_pull": 100}),
    ("sixteen_million", ["--render-every", "50"],
     {"collide_integrate": 100, "relocate_pull": 100}),
)


def _check_particles(e, n, label) -> None:
    """``n`` particles, every position finite and inside [r, W - r] x
    [r, H - r]; on the tiled engine also the pid set arange(n)."""
    import numpy as np
    if hasattr(e, "_export"):
        _check_engine(e, n, label)
        return
    if e.num_particles() != n:
        raise AssertionError(f"{label}: {e.num_particles()} particles, "
                             f"expected {n}")
    pos, rad, cfg = e.positions(), e.radii(), e.config
    inside = (np.isfinite(pos).all(1)
              & (pos[:, 0] >= rad - 1e-4)
              & (pos[:, 0] <= cfg.world_width - rad + 1e-4)
              & (pos[:, 1] >= rad - 1e-4)
              & (pos[:, 1] <= cfg.world_height - rad + 1e-4))
    if not inside.all():
        raise AssertionError(f"{label}: {int((~inside).sum())} particles "
                             "not finite or outside [r, W-r] x [r, H-r]")


def _cli_scene(name, extra, want, out_root, paths: dict):
    """``headless.main`` on the scene with ``--device cuda``: construction
    seconds (from the call to the built engine), ms/step from CUDA events
    around the CLI's step loop (its ``around_run`` hook; the frames drawn
    between steps included, the summary's downloads not), the peak of
    allocated device memory, the launch counts (zeroed just before the
    loop, read just after the run), then the particle count, the bounds
    and the frames; last, ``step()`` alone over up to 50 more steps (CUDA
    events)."""
    import contextlib
    import os
    import torch
    from gpu_physics_engine_torch.app import headless
    from gpu_physics_engine_torch.scenes import get_scene
    scene = get_scene(name)
    out = os.path.join(out_root, name)
    argv = ["--scene", name, "--device", "cuda", "--summary-json",
            "--out", out] + extra
    if name == "four_million":
        argv += ["--chrometrace", os.path.join(out_root, f"{name}.json")]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    built = {}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    @contextlib.contextmanager
    def around_run(e):
        torch.cuda.synchronize()
        built["s"] = time.perf_counter() - t0
        built["engine"] = e
        reset_launches()
        start.record()
        yield
        end.record()

    t0 = time.perf_counter()
    summary = headless.main(argv, around_run=around_run)
    end.synchronize()
    got = launches()
    e = built["engine"]
    n = scene.config.initial_particles + e.config.spawn_burst * sum(
        ev.kind == "spawn" for ev in scene.events)
    peak = torch.cuda.max_memory_allocated()
    ms = start.elapsed_time(end) / scene.steps
    log(f"[apps] {name}: {summary}")
    log(f"[apps] {name}: {type(e).__name__} pipeline "
        f"{e.config.pipeline}, {scene.steps} steps, construction "
        f"{built['s']:.2f} s, {ms:.4f} ms/step (CUDA events over the run, "
        f"frames included), peak allocated {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB held before), launches "
        f"{ {k: v for k, v in got.items() if v} }")
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"{name}: {k} launched {got[k]} times, "
                                 f"expected {v}")
    if summary["particles"] != n or not summary["finite"]:
        raise AssertionError(f"{name}: summary {summary}, expected {n}")
    _check_particles(e, n, f"apps {name}")
    every = int(extra[extra.index("--render-every") + 1]) \
        if "--render-every" in extra else 0
    frames = sorted(os.listdir(out)) if every else []
    if len(frames) != (-(-scene.steps // every) if every else 0):
        raise AssertionError(f"{name}: frames {frames}")
    for f in frames:
        with open(os.path.join(out, f), "rb") as fh:
            if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{name}: {f} is not a PNG")
    if frames:
        log(f"[apps] {name}: {len(frames)} PNG frames written")
    if name == "four_million":
        with open(os.path.join(out_root, f"{name}.json")) as fh:
            trace = json.load(fh)["traceEvents"]
        steps = [ev for ev in trace if ev["name"].startswith("frame ")]
        if len(steps) != scene.steps or not all(
                ev["ph"] == "X" and ev["dur"] >= 0 for ev in trace):
            raise AssertionError(f"{name}: chrome trace {len(trace)} events")
        log(f"[apps] {name}: chrome trace with {len(trace)} events")
    paths[f"{name}-cli"] = got
    more = min(scene.steps, 50)
    alone = cuda_ms(e.step, reps=more, warmup=0)
    log(f"[apps] {name}: step() alone {alone:.4f} ms/step over {more} more "
        f"steps (CUDA events)")
    return e, ms, alone, built["s"], peak


def _tile_stats_probe(e, label) -> None:
    """``tile_stats`` (plain PyTorch, the tile map's device half) on the
    scene's state: device ms (CUDA events, 20 calls), the launches and
    device time of one call (torch.profiler, CUDA activity), and its bound
    (x, y, px, py and pid read once, the two [TY, TX] maps written)."""
    from gpu_physics_engine_torch.render.tilemap import tile_stats
    from gpu_physics_engine_torch.utils.profiling import (_device_us,
                                                          kernel_window)
    ms = cuda_ms(lambda: tile_stats(e.state))
    with kernel_window() as prof:
        tile_stats(e.state)
    rows = [r for r in prof.key_averages() if _device_us(r) > 0]
    cap, TY, TX = e.state.dims
    nbytes = 5 * 4 * cap * TY * TX + 2 * 4 * TY * TX
    log(f"[apps] tile_stats {label} [{cap}, {TY}, {TX}]: {ms:.4f} ms "
        f"(CUDA events), one call {sum(r.count for r in rows)} launches "
        f"{sum(_device_us(r) for r in rows) / 1e3:.4f} device-ms; bound "
        f"{nbytes / PEAK_BYTES * 1e3:.4f} ms (bytes)")


def _scene_kernels(name, e, errs: dict) -> None:
    """K1 and K2 against their plain versions at the scene's own shape and
    config, each bit-equal and bit-equal on repeat: K1 with the scene's
    dt_scale (1 / substeps: 0.5 at four_million) and params on its state
    with velocity added (x, y displaced by up to 0.05 as the previous
    positions), then K2 under the scene's match and hysteresis on its
    state jittered by up to 0.6 tile (``check_relocate``)."""
    import torch
    from gpu_physics_engine_torch.ops import tiled_kernels as tk
    cfg = e.config
    moving = jittered(e.state, 0.05, seed=3)
    st = e.state.replace(px=moving.x, py=moving.y)
    prm = e.params().as_tensor("cuda", 1.0 / cfg.substeps)
    a = tk.collide_integrate_cuda(st, prm, cfg)
    a2 = tk.collide_integrate_cuda(st, prm, cfg)
    b = tk.collide_integrate_plain(st, prm, cfg)
    torch.cuda.synchronize()
    fields = ("x", "y", "px", "py")
    err = _max_err(a, b, fields)
    if not (_same(a, b, fields) and _same(a, a2, fields)):
        raise AssertionError(f"K1 {name} dt_scale {1.0 / cfg.substeps}: "
                             f"max err {err}")
    errs["collide_integrate"] = max(errs.get("collide_integrate", 0.0), err)
    log(f"[k1] {name} {list(st.dims)} substeps {cfg.substeps} "
        f"(dt_scale {1.0 / cfg.substeps}): bit-equal and repeat bit-equal "
        f"({int((a.x != st.x).sum())} slots moved)")
    del a, a2, b, st, moving
    check_relocate(name, cfg, e.state,
                   [(cfg.tiled_match, cfg.tiled_hysteresis)], errs)


def _breakdown(label, fn, engine, expect) -> None:
    """One phase breakdown on ``engine``'s state: every phase printed,
    finite and positive; the kernels in ``expect`` launched."""
    import math
    reset_launches()
    out = fn(engine.config, engine.state, engine.params())
    got = launches()
    for phase, ms in out.items():
        log(f"[breakdown] {label} {phase}: {ms:.4f} ms")
    bad = [p for p, ms in out.items() if not (math.isfinite(ms) and ms > 0)]
    if bad:
        raise AssertionError(f"{label}: phases {bad} not finite and positive")
    missing = [k for k in expect if got[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} not launched ({got})")
    log(f"[breakdown] {label}: launches "
        f"{ {k: v for k, v in got.items() if v} }")


def _web_app(paths: dict) -> None:
    """The web app in-process on make_tuned_engine(1_048_576): the page, at
    least 5 PNG frames, a move, a press and release and the key p (a
    spawn burst of radius 1-3 into the overlay, splatted on the host);
    /stats then shows the frames advanced and 1,048,676 particles.  The
    app's frames/s is read over WEB_FRAMES frames before the spawn and as
    many after, while a client fetches /frame.png back to back as the page
    does (wall clock: the sim thread's step, frame, PNG and count)."""
    import http.client
    import threading
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    from gpu_physics_engine_torch.app.web import WebApp, make_server
    from gpu_physics_engine_torch.render.viewer import Viewer

    def request(port, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request(method, path, body)
        r = conn.getresponse()
        got = r.status, r.read()
        conn.close()
        return got

    def wait(cond, seconds=120.0):
        deadline = time.time() + seconds
        while time.time() < deadline and not cond():
            time.sleep(0.05)
        return cond()

    def rate(label, frames=WEB_FRAMES, seconds=120.0):
        f0, t0, fetched = app.stats()["frame"], time.perf_counter(), 0
        while app.stats()["frame"] < f0 + frames:
            if time.perf_counter() - t0 > seconds:
                got = app.stats()["frame"] - f0
                raise AssertionError(f"web: {label}, {got} frames in "
                                     f"{seconds} s")
            status, png = request(port, "GET", "/frame.png")
            if status != 200 or not png.startswith(b"\x89PNG\r\n\x1a\n"):
                raise AssertionError(f"web: frame {status} {label}")
            fetched += 1
        f, took = app.stats()["frame"] - f0, time.perf_counter() - t0
        log(f"[apps] web {label}: {f} frames in {took:.3f} s, "
            f"{f / took:.3f} frames/s ({fetched} PNGs fetched meanwhile)")
        return f / took

    e = make_tuned_engine(1_048_576, device="cuda")
    cfg = e.config
    app = WebApp(e, Viewer((cfg.world_width, cfg.world_height), (1280, 720)))
    reset_launches()
    app.start()
    srv = make_server(app, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    try:
        status, page = request(port, "GET", "/")
        if status != 200 or b"<canvas" not in page:
            raise AssertionError(f"web: page {status}")
        if not wait(lambda: request(port, "GET", "/frame.png")[0] == 200):
            raise AssertionError("web: no frame within 120 s")
        sizes = []
        for _ in range(5):
            idx = app.stats()["frame"]
            wait(lambda: app.stats()["frame"] > idx)
            status, png = request(port, "GET", "/frame.png")
            if status != 200 or not png.startswith(b"\x89PNG\r\n\x1a\n"):
                raise AssertionError(f"web: frame {status}")
            sizes.append(len(png))
        before = rate("before the spawn")
        for ev in ({"type": "move", "x": 640, "y": 360},
                   {"type": "button", "pressed": True}):
            request(port, "POST", "/event", json.dumps(ev))
        if not wait(lambda: e.mouse_pressed):
            raise AssertionError("web: the press never reached the engine")
        for ev in ({"type": "button", "pressed": False},
                   {"type": "key", "key": "p", "pressed": True}):
            request(port, "POST", "/event", json.dumps(ev))
        n = 1_048_576 + cfg.spawn_burst
        f1 = app.stats()["frame"]
        if not wait(lambda: app.stats()["particles"] == n
                    and app.stats()["frame"] > f1 + 5):
            raise AssertionError(f"web: stats {app.stats()}, expected {n}")
        after = rate("after the spawn")
        stats = json.loads(request(port, "GET", "/stats")[1])
    finally:
        app.stop()
        srv.shutdown()
        srv.server_close()
        app.join(60)
        th.join(60)
    if app._thread.is_alive() or th.is_alive():
        raise AssertionError("web: a thread did not stop")
    torch.cuda.synchronize()
    got = launches()
    for k in ("collide_integrate", "relocate_pull"):
        if got[k] <= 0:
            raise AssertionError(f"web: {k} not launched ({got})")
    log(f"[apps] web: {before:.3f} frames/s before the spawn, {after:.3f} "
        f"after ({WEB_FRAMES} frames each); PNG {min(sizes)}-{max(sizes)} "
        f"B; after "
        f"the spawn {stats} (the app's own fps average); overlay "
        f"{int(e.big.num_active) if e.big is not None else 0} bigs; "
        f"launches {got['collide_integrate']} K1, {got['relocate_pull']} K2")
    paths["1M-web"] = got


WEB_FRAMES = 60  # frames a web frames/s reading is taken over


def phase_apps(smi: str, paths: dict, errs: dict) -> None:
    """The apps phase: the five scenes through the CLI, K1 and K2 on the
    four_million and sixteen_million states (K1 at their dt_scale), the
    three phase breakdowns, the web app."""
    import shutil
    import torch
    from gpu_physics_engine_torch import Engine, TiledEngine
    from gpu_physics_engine_torch import make_tuned_engine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.utils.device import device_info
    from gpu_physics_engine_torch.utils.profiling import (
        phase_breakdown, tiled_phase_breakdown)
    t0 = time.perf_counter()
    log(f"[apps] {device_info()} {smi}")
    out_root = _scratch_dir()
    rows = []
    for name, extra, want in APP_SCENES:
        e, *row = _cli_scene(name, extra, want, out_root, paths)
        rows.append((name, *row))
        if name in ("four_million", "sixteen_million"):
            _scene_kernels(name, e, errs)
            _tile_stats_probe(e, name)
        del e
        torch.cuda.empty_cache()
    shutil.rmtree(out_root, ignore_errors=True)
    for name, ms, alone, build_s, peak in rows:
        log(f"[apps] scene {name}: {ms:.4f} ms/step over the CLI run, "
            f"step() alone {alone:.4f}, construction {build_s:.2f} s, peak "
            f"{peak / 2**30:.3f} GiB ({smi})")

    e = make_tuned_engine(4_194_304, device="cuda")
    e.run(32)
    _breakdown("4M", tiled_phase_breakdown, e,
               ("collide_integrate", "collide", "relocate_pull"))
    del e
    e = TiledEngine(gs_config(1_048_576), device="cuda", chunk=64)
    e.run(16)
    _breakdown("1M-GS par", tiled_phase_breakdown, e,
               ("gs_rank_par", "gs_color_par"))
    del e
    e = Engine(_array_cfg(sort_impl="radix"), device="cuda")
    e.run(4)
    _breakdown("1M-array radix", phase_breakdown, e, RADIX)
    del e
    torch.cuda.empty_cache()
    _web_app(paths)
    torch.cuda.empty_cache()
    log(f"[apps] phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the slab mesh (parallel/): the 4M engine on four slabs of the card
# ---------------------------------------------------------------------------

SLABS = 4


def _tensors(r) -> tuple:
    """The tensors of a wrapper's result: a tensor, a state (its tensor
    fields) or a tuple of these."""
    import dataclasses
    import torch
    if r is None:
        return ()
    if isinstance(r, torch.Tensor):
        return (r,)
    if isinstance(r, (tuple, list)):
        return tuple(t for v in r for t in _tensors(v))
    return tuple(v for f in dataclasses.fields(r)
                 if isinstance(v := getattr(r, f.name), torch.Tensor))


def _held(what, kern, plain, keep=()) -> float:
    """``kern`` twice and ``plain`` once, as they are timed, each from the
    same values of ``keep`` (the tensors the calls update in place:
    restored before each call and after the last); their results and
    ``keep`` bit-equal (``_equal_or_raise``).  Returns the largest
    absolute difference of the kernel's result from the plain one's."""
    saved = [t.clone() for t in keep]

    def restore():
        for t, v in zip(keep, saved):
            t.copy_(v)

    outs = []
    for fn in (kern, kern, plain):
        restore()
        r = fn()
        outs.append(tuple(t.clone() for t in _tensors(r) + tuple(keep)))
    restore()
    got, again, want = outs
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} tensors from the kernel, "
                             f"{len(want)} from the plain version")
    _equal_or_raise(what, got, want, again)
    return max((float((u.double() - v.double()).abs().max())
                for u, v in zip(got, want) if u.numel()), default=0.0)


def _time_pair(name, shape, kern, plain, plain_reps=2, errs=None,
               keep=()) -> tuple:
    """(kernel ms, plain ms) in turns: plain, kernel, kernel, plain
    (``plain_reps`` 1: one plain call a turn, no warm-up).  With ``errs``
    the two are first held bit-equal on these inputs (``_held``, with
    ``keep``) and ``errs[name]`` is the measured error."""
    if errs is not None:
        errs[name] = _held(name, kern, plain, keep)
    light = dict(reps=1, warmup=0) if plain_reps == 1 else dict(reps=2)
    p1 = cuda_ms(plain, **light)
    k1 = cuda_ms(kern, reps=20)
    k2 = cuda_ms(kern, reps=20)
    p2 = cuda_ms(plain, **light)
    log(f"[time] {name} {shape}: kernel {k1:.4f} / {k2:.4f} ms, plain "
        f"{p1:.3f} / {p2:.3f} ms per launch")
    return min(k1, k2), min(p1, p2)


def _slab_kernels(cfg, eng, errs: dict) -> dict:
    """K1 (fused) and K3 on slab 1's halo-extended planes [8, 162, 1850],
    whose halo rows hold slabs 0 and 2's live particles, and K2 at row0 =
    160, 320 and 480 with global_rows 640 under the engine's match and
    hysteresis on each slab jittered by 0.6 tile: each bit-equal to its
    plain version, twice.  Returns {name: (kernel ms, plain ms, bound)}."""
    import torch
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    from gpu_physics_engine_torch.parallel import tiled_shard as ts
    t, TYp, _, rows = ts.sharded_tile_geometry(cfg, SLABS)
    prm = StepParams.make(cfg.dt).as_tensor("cuda", 1.0 / cfg.substeps)
    ext = ts.extended_slabs(eng.mesh, eng.state, fused=True)[1]
    ext3 = ts.extended_slabs(eng.mesh, eng.state, fused=False)[1]
    halo = [int((ext.pid[:, r] == 0).sum()) for r in (0, -1)]
    if min(halo) == 0:
        raise AssertionError(f"slab 1's halo rows hold {halo} particles")
    a = tk.collide_integrate_cuda(ext, prm, cfg)
    a2 = tk.collide_integrate_cuda(ext, prm, cfg)
    b = tk.collide_integrate_plain(ext, prm, cfg)
    c = tk.collide_cuda(ext3, cfg)
    c2 = tk.collide_cuda(ext3, cfg)
    d = tk.collide_plain(ext3, cfg)
    torch.cuda.synchronize()
    k1 = ("x", "y", "px", "py")
    ok = (_same(a, b, k1), _same(a, a2, k1), _same(c, d, ("x", "y")),
          _same(c, c2, ("x", "y")))
    errs["collide_integrate[slab]"] = _max_err(a, b, k1)
    errs["collide"] = max(errs.get("collide", 0.0), _max_err(c, d, ("x", "y")))
    if not all(ok):
        raise AssertionError(f"K1/K3 on the extended slab {list(ext.dims)}: "
                             f"bit-equal, repeat (K1, K1, K3, K3) {ok}")
    log(f"[sharded] K1 and K3 on slab 1's extended planes {list(ext.dims)} "
        f"(halo rows: {halo[0]} and {halo[1]} live particles): bit-equal to "
        "their plain versions, repeat bit-equal")
    moved = {}
    for i in range(1, SLABS):
        row0 = i * rows
        m = jittered(eng.state[i], 0.6 * t, seed=1)
        a, da = tk.relocate_pull_cuda(m, cfg, row0=row0, global_rows=TYp)
        a2, da2 = tk.relocate_pull_cuda(m, cfg, row0=row0, global_rows=TYp)
        b, db = tk.relocate_pull_plain(m, cfg, row0=row0, global_rows=TYp)
        torch.cuda.synchronize()
        eq = _same(a, b, tiled.FIELDS) and torch.equal(da, db)
        rep = _same(a, a2, tiled.FIELDS) and torch.equal(da, da2)
        errs["relocate_pull[row0]"] = max(
            errs.get("relocate_pull[row0]", 0.0),
            _max_err(a, b, ("x", "y", "px", "py", "radius")))
        kept = torch.equal(torch.sort(a.pid[a.pid >= 0]).values,
                           torch.sort(m.pid[m.pid >= 0]).values)
        if not (eq and rep and kept):
            raise AssertionError(f"K2 at row0 {row0}: bit-equal {eq}, "
                                 f"repeat {rep}, pids kept in the slab {kept}")
        # the movers over the slab edge: left in place for the ship phase
        dty, _ = tiled.step_offsets(
            m.x, m.y, tiled._iota(m.dims, 1, "cuda") + row0,
            tiled._iota(m.dims, 2, "cuda"), t=t,
            delta=cfg.hysteresis_delta, gTY=TYp, gTX=m.dims[2])
        edge = int(((m.pid[:, 0] >= 0) & (dty[:, 0] < 0)).sum()
                   + ((m.pid[:, -1] >= 0) & (dty[:, -1] > 0)).sum())
        log(f"[sharded] K2 at row0 {row0} (global_rows {TYp}) on "
            f"{list(m.dims)} {cfg.tiled_match} hysteresis "
            f"{cfg.hysteresis_delta:.3g}: bit-equal, repeat bit-equal, "
            f"deferred {int(da.sum())}, {int((a.pid != m.pid).sum())} pid "
            f"slots changed, {edge} movers over the slab edges kept")
        moved[row0] = m
    m = moved[2 * rows]
    return {
        "collide_integrate[slab]": _time_pair(
            "collide_integrate[slab]", list(ext.dims),
            lambda: tk.collide_integrate_cuda(ext, prm, cfg),
            lambda: tk.collide_integrate_plain(ext, prm, cfg))
        + (_k1_bound(cfg, ext),),
        "relocate_pull[row0]": _time_pair(
            f"relocate_pull[row0 {2 * rows}]", list(m.dims),
            lambda: tk.relocate_pull_cuda(m, cfg, row0=2 * rows,
                                          global_rows=TYp),
            lambda: tk.relocate_pull_plain(m, cfg, row0=2 * rows,
                                           global_rows=TYp))
        + (_k2_bound(m),)}


def _slab_owner(eng):
    """The slab of every pid, by pid."""
    import numpy as np
    owner = np.full(eng.num_particles(), -1, np.int64)
    for i, s in enumerate(eng.state):
        pid = s.pid[s.pid >= 0].long().cpu().numpy()
        owner[pid] = i
    return owner


def _sharded_4m(paths: dict, errs: dict) -> dict:
    """The 4M engine on four slabs beside its TiledEngine twin."""
    import numpy as np
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    from gpu_physics_engine_torch.parallel import mesh as pm
    from gpu_physics_engine_torch.parallel import tiled_shard as ts
    from gpu_physics_engine_torch.utils.profiling import profile_run
    n = 4_194_304
    twin = make_tuned_engine(n, device="cuda")
    cfg = twin.config
    pid, pos, prev, rad = twin._export()
    t0 = time.perf_counter()
    eng = ts.ShardedTiledEngine(cfg, mesh=pm.make_mesh(SLABS, device="cuda"),
                                initial_arrays=(pos, rad, pid, prev))
    torch.cuda.synchronize()
    t, TYp, TX, rows = ts.sharded_tile_geometry(cfg, SLABS)
    log(f"[4M-sharded] {SLABS} slabs of {list(eng.state[0].dims)} on "
        f"{[str(d) for d in eng.mesh.devices]} (grid {TYp} x {TX}, cap "
        f"{cfg.tile_cap}, match {cfg.tiled_match}, interval "
        f"{cfg.tiled_relocate_interval}, sweep every "
        f"{eng._sweep_interval}); built in "
        f"{time.perf_counter() - t0:.1f} s")
    # the sharded engine's relocate counter starts at 0 (as the JAX
    # package's does), so its step 1 is an off-step: K1 on the extended
    # slabs only.  The twin's step 1 is made one too: its relocate-first
    # step would move the few particles where the host tiler's tile
    # (f32 division) and K2's step rule (products) part, within an ulp of
    # a tile edge.
    twin._since_reloc = 0
    twin.step()
    eng.step()
    got, want = eng._export(), twin._export()
    for what, a, b in zip(("pid", "positions", "previous positions"),
                          got[:3], want[:3]):
        if not np.array_equal(a, b):
            raise AssertionError(f"4M-sharded step 1: {what} differ from "
                                 "the TiledEngine twin's")
    log(f"[4M-sharded] step 1: the pids, positions and previous positions "
        f"of all {n} particles bit-equal to the TiledEngine twin's")
    slab_runs = _slab_kernels(cfg, eng, errs)

    steps = 256
    relocating = [0]
    inner = eng._step

    def counted(state, p):
        relocating[0] += 1
        return inner(state, p)

    eng._step = counted
    reset_launches()
    of0 = eng.per_chip_overflow
    ms = cuda_ms(lambda: eng.run(steps), reps=1, warmup=0) / steps
    torch.cuda.synchronize()
    eng._step = inner
    got = launches()
    expect = {"collide_integrate": SLABS * steps,
              "relocate_pull": SLABS * relocating[0], "collide": 0}
    if (any(got[k] != v for k, v in expect.items())
            or not steps // 2 - 8 <= relocating[0] <= steps // 2 + 8):
        raise AssertionError(f"4M-sharded: launches {got}, expected "
                             f"{expect} ({relocating[0]} relocating steps)")
    paths["4M-sharded"] = got
    q = _check_engine(eng, n, "4M-sharded")
    log(f"[4M-sharded] {steps} steps through the claim sweep at step "
        f"{eng._sweep_interval}: K1 {got['collide_integrate'] / steps:.0f} "
        f"a step, K2 {got['relocate_pull']} over {relocating[0]} "
        f"relocating steps ({SLABS} each); all {n} pids present, finite, "
        f"inside the world; stale {q['stale_pct']:.4f}%; deferred per slab "
        f"{(eng.per_chip_overflow - of0).tolist()}; {ms:.4f} ms/step "
        "(CUDA events, the sweep included)")
    twin.run(steps)
    prof = {label: profile_run(e, 32) for label, e in (("sharded", eng),
                                                       ("twin", twin))}
    for label, r in prof.items():
        log(f"[4M-sharded] {label}: {r['device_span_ms'] / 32:.4f} ms/step "
            f"(CUDA events, 32 steps), device busy "
            f"{r['device_busy_ms'] / 32:.4f} ms/step, idle share "
            f"{r['idle_share']:.4f}, {r['device_launches'] / 32:.1f} "
            f"launches a step, hand kernels {r['hand_kernel_ms'] / 32:.4f} "
            "ms/step")
    out = {"ms": {k: r["device_span_ms"] / 32 for k, r in prof.items()},
           "idle": {k: r["idle_share"] for k, r in prof.items()}}
    del twin
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run(16)  # one window of non-sweep steps
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("[4M-sharded] 16 steps (one window) under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")

    # drag the mouse across the slab 0 / 1 edge (y = 159 tiles) for 64 steps
    yb = (rows - 1) * t
    owner0 = _slab_owner(eng)
    of0 = eng.per_chip_overflow
    eng.press_mouse((1524.0, yb - 60.0))
    for k in range(8):
        eng.move_mouse((1524.0, yb - 60.0 + 17.0 * k))
        eng.run(8)
    eng.release_mouse()
    _check_engine(eng, n, "4M-sharded drag")
    changed = int((_slab_owner(eng) != owner0).sum())
    log(f"[4M-sharded] mouse dragged across the slab 0/1 edge (y {yb:.2f}) "
        f"for 64 steps: {changed} particles changed slab, none lost or "
        f"doubled (pids arange({n})); deferred per slab "
        f"{(eng.per_chip_overflow - of0).tolist()}")

    # the unfused route on the slabs: K3 on the extended slabs
    eng.config = eng.config.replace(tiled_fuse_integrate=False)
    eng._build()
    reset_launches()
    eng.run(8)
    torch.cuda.synchronize()
    got = launches()
    if got["collide"] != SLABS * 8 or got["collide_integrate"]:
        raise AssertionError(f"4M-sharded unfused: launches {got}")
    paths["4M-sharded-unfused"] = got
    _check_engine(eng, n, "4M-sharded unfused")
    log(f"[4M-sharded] unfused (K3 + integrate) 8 steps: launches {got}")
    del eng
    torch.cuda.empty_cache()
    out["slab_runs"] = slab_runs
    return out


def _sharded_spawn(paths: dict) -> None:
    """A spawn on a slab edge: tuned_config(1_048_576)'s world and count
    with tile_max_radius 1 and the cap sized from the scene, 4 slabs.  The
    tiles are the reference's cells (edge 2.2 x the radius, as
    TiledEngine's spawn re-tile sizes them): at the row's multiplier 4.4
    the scene's cap would be 36, past the kernels' 32 slots."""
    import numpy as np
    import torch
    from gpu_physics_engine_torch import tuned_config
    from gpu_physics_engine_torch.parallel import mesh as pm
    from gpu_physics_engine_torch.parallel import tiled_shard as ts
    n = 1_048_576
    e = ts.ShardedTiledEngine(
        tuned_config(n, tile_max_radius=1.0, tile_multiplier=2.2,
                     tile_cap=0),
        mesh=pm.make_mesh(SLABS, device="cuda"), seed=0)
    assert e.num_particles() == n and e.config.tiled_uniform_radius
    e.run(16)
    t, _, _, rows = ts.sharded_tile_geometry(e.config, SLABS)
    yb = (2 * rows - 1) * t  # the slab 1 / 2 edge
    step_before = e._step
    of0 = int(e.state[0].overflow_count)
    e.spawn_at((1524.0, yb), count=1000, verbose=False)
    refused = int(e.state[0].overflow_count) - of0
    if e.config.tiled_uniform_radius or e._step is step_before:
        raise AssertionError("spawn: the uniform-radius fallback did not "
                             "rebuild the step")
    if e.num_particles() != n + 1000 - refused:
        raise AssertionError(f"spawn: {e.num_particles()} particles, "
                             f"{refused} refused")
    reset_launches()
    e.run(16)
    torch.cuda.synchronize()
    got = launches()
    pid, pos, _, rad = e._export()
    if (len(np.unique(pid)) != len(pid) or len(pid) != e.num_particles()
            or pid.min() < 0 or pid.max() >= n + 1000
            or not np.isfinite(pos).all()):
        raise AssertionError("spawn: the pid set is not exact")
    paths["1M-sharded-spawn"] = got
    log(f"[1M-sharded-spawn] cap {e.config.tile_cap} (from the scene), "
        f"tile edge {t:.2f}: spawn_at((1524, {yb:.1f})) of 1000 on the "
        f"slab 1/2 edge: {e.num_particles()} particles ({refused} refused), "
        f"radii {sorted(set(rad[pid >= n].tolist()))}, uniform radius off "
        f"and the step rebuilt; 16 more steps, launches {got}")
    del e
    torch.cuda.empty_cache()


def _halo_1m(paths: dict) -> None:
    """parallel/halo.py at 1M on 4 slabs of the reference world."""
    import numpy as np
    import torch
    from gpu_physics_engine_torch import SimConfig, StepParams
    from gpu_physics_engine_torch.parallel import halo
    from gpu_physics_engine_torch.parallel import mesh as pm
    n = 1_048_576
    # the slab-edge band is 2 cells (2.2 units) wide: 2.2 x 1048 x 0.33
    # particles a unit^2 = about 760 a side, 2048 buffer slots; a step
    # moves a particle well under a unit, 1024 migration slots
    cfg = SimConfig(max_particles=n, initial_particles=n, sort_impl="radix",
                    sort_interval_steps=8, halo_capacity=2048,
                    migration_capacity=1024)
    rng = np.random.default_rng(5)
    pos = np.stack([rng.uniform(0.5, cfg.world_width - 0.5, n),
                    rng.uniform(0.5, cfg.world_height - 0.5, n)],
                   -1).astype(np.float32)
    mesh = pm.make_mesh(SLABS, device="cuda")
    slots = 278_528  # n / 4 and 6% room
    st = halo.init_sharded(cfg, mesh, pos, np.full(n, 0.5, np.float32),
                           slots_per_shard=slots)
    step = halo.make_sharded_step(cfg, mesh)
    p = StepParams.make(cfg.dt, mouse=(1524.0, 524.0), pressed=True)
    reset_launches()

    def run():
        nonlocal st
        for _ in range(16):
            st = step(st, p)

    ms = cuda_ms(run, reps=1, warmup=0) / 16
    got = launches()
    alive = int(halo.gather(st, "alive").sum())
    dropped = int(halo.gather(st, "dropped").sum())
    pos2, _ = halo.gather_alive(st)
    if (dropped or alive != n or not np.isfinite(pos2).all()
            or got["radix_digit_hist"] < SLABS
            or got["radix_onesweep"] < 4 * SLABS):
        raise AssertionError(f"halo-1M: alive {alive}, dropped {dropped}, "
                             f"launches {got}")
    paths["halo-1M-4"] = got
    log(f"[halo-1M-4] {SLABS} slabs of {slots} slots, halo_capacity "
        f"{cfg.halo_capacity}, migration_capacity "
        f"{cfg.migration_capacity}: 16 steps, the resort at step 9 through "
        f"the radix sort (radix_digit_hist {got['radix_digit_hist']}, "
        f"radix_onesweep {got['radix_onesweep']}), alive {alive}, dropped "
        f"{dropped}, finite; {ms:.3f} ms/step")
    del st
    torch.cuda.empty_cache()


def _gs_shard_1m() -> None:
    """parallel/gs_shard.py on gs_config(1_048_576) over 4 slabs: one
    frame bit-equal to the single-grid plain solve and to K5 + K6."""
    import torch
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_kernels as gk, gs_tiled
    from gpu_physics_engine_torch.parallel import gs_shard
    from gpu_physics_engine_torch.parallel import mesh as pm
    cfg = gs_config(1_048_576)
    st = TiledEngine(cfg, seed=0, chunk=64, device="cuda").state
    mesh = pm.make_mesh(SLABS, device="cuda")
    plain = gs_tiled.gs_solve(st, cfg)
    kern = gs_tiled.solve_frame(st, cfg, gk.rank_cuda, gk.colors_cuda)[0]
    solve = gs_shard.make_sharded_gs_solve(cfg, mesh)
    t0 = time.perf_counter()
    out = pm.gather_tiles(solve(pm.shard_tiles(st, mesh)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    TY = st.dims[1]
    for label, ref in (("the plain gs_solve", plain), ("K5 + K6", kern)):
        same = all(torch.equal(getattr(out, f)[:, :TY], getattr(ref, f))
                   for f in ("x", "y", "pid"))
        if not same or int(out.overflow_count) != int(ref.overflow_count):
            raise AssertionError(f"gs-shard-1M: differs from {label}")
    moved = int(((out.x[:, :TY] != st.x) & (st.pid >= 0)).sum())
    bill = gs_shard.bytes_per_frame(cfg, SLABS)
    log(f"[gs-shard-1M-GS-4] one frame on {SLABS} slabs of "
        f"{[st.dims[0], TY // SLABS, st.dims[2]]} (+2 ghost rows a side): "
        f"x, y, pid and overflow ({int(out.overflow_count)}) bit-equal to "
        f"the plain gs_solve and to K5 + K6 on the card; {moved} particles "
        f"moved; {secs:.2f} s (plain PyTorch); "
        f"{bill['total_bytes_per_frame']} bytes a slab edge a frame in "
        f"{bill['exchanges_per_frame']} exchanges")
    torch.cuda.empty_cache()


def phase_sharded(paths: dict, errs: dict) -> dict:
    """The slab mesh on one card: the kernels at slab shapes, the 4M
    engine on 4 slabs beside its twin, a spawn on a slab edge, the
    multichip CLI, the halo step and the sharded GS frame."""
    import torch
    from gpu_physics_engine_torch.app import multichip
    t0 = time.perf_counter()
    out = _sharded_4m(paths, errs)
    _sharded_spawn(paths)
    s = multichip.main(["--devices", str(SLABS), "--summary-json"])
    if (s["particles"] != 1_048_576 or not s["finite"]
            or s["devices"] != SLABS):
        raise AssertionError(f"multichip: {s}")
    log(f"[multichip-1M-4] {json.dumps(s)}")
    torch.cuda.empty_cache()
    _halo_1m(paths)
    _gs_shard_1m()
    log(f"[sharded] phase {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# tile caps past 32: the 64-bit mask instantiations (33-64), K1's and the
# relocate window's kernels without a mask (past 64), the GS kernels
# without a window (past cap 256 or K 64)
# ---------------------------------------------------------------------------

WIDE_CAPS = (33, 65, 140, 257, 312, 520)
# the GS rank and solve: the window kernels' widest class, and past it the
# packed rank and the ranked-slot solve either side of caps 128 and 256
GS_CAPS = (33, 65, 128, 140, 256, 257, 312, 520)
SLAB_CAPS = (33, 140, 312)  # K1 and K3 on a halo-extended slab too
DEEP_KS = (80, 128)
RETILE_N = 1_048_576
GS64 = (262_144, (1524.0, 524.0))  # the 1M-GS density on a quarter world


def _pile_state(cap, uniform, world, cut, centre=None):
    """A small scene at ``cap`` on a ``world`` = (width, height) world: 0.6
    particles a unit area spread over it and a pile of 4 x cap (8 x cap
    past cap 64) at ``centre`` (default the world's centre) whose tiles
    fill every slot, past slot 32; ``cut`` of the empty rows above the
    world dropped (one stays as the ring), so TY is no multiple of any
    region.  Mixed radii unless ``uniform``."""
    import numpy as np
    from gpu_physics_engine_torch import SimConfig
    from gpu_physics_engine_torch.ops import tiled
    w, h = world
    spread, pile = int(0.6 * w * h), (4 if cap <= 64 else 8) * cap
    n = spread + pile
    cfg = SimConfig(max_particles=n, initial_particles=n, world_width=w,
                    world_height=h, pipeline="tiled", tile_cap=cap,
                    tiled_uniform_radius=uniform, gravity=(0.0, -9.8))
    rng = np.random.default_rng(cap)
    hi = [w - 0.6, h - 0.6]
    pos = np.concatenate([
        rng.uniform(0.6, hi, (spread, 2)),
        np.clip((centre or (w / 2, h / 2)) + rng.normal(0.0, 1.0, (pile, 2)),
                0.6, hi)]).astype(np.float32)
    rad = (np.full(n, 0.5, np.float32) if uniform
           else rng.uniform(0.3, 0.5, n).astype(np.float32))
    prev = (pos + rng.normal(0, 0.05, pos.shape)).astype(np.float32)
    st = tiled.init_tiles(cfg, pos, rad, previous_positions=prev,
                          device="cuda")
    if int((st.pid >= 0).sum(0).max()) != cap:
        raise AssertionError(f"cap {cap} pile: no tile fills every slot")
    if cut:
        ty = st.dims[1] - cut
        if bool((st.pid[:, ty - 1:] >= 0).any()):
            raise AssertionError("pile scene: particles in the rows cut")
        st = st.replace(**{f: getattr(st, f)[:, :ty].contiguous()
                           for f in tiled.FIELDS})
    return cfg, st


def _slab_wide(cap, errs: dict) -> None:
    """K1 (fused) and K3 at ``cap`` on slab 1's halo-extended planes of a
    two-slab mesh on this card, the pile on the slab edge (full tiles in
    its lower halo row), uniform and general radius: bit-equal and on
    repeat."""
    from gpu_physics_engine_torch.ops import tiled
    from gpu_physics_engine_torch.parallel import tiled_shard as ts
    from gpu_physics_engine_torch.parallel.mesh import make_mesh
    world = (80.0, 33.0)
    base, _ = _pile_state(cap, False, world, 0)
    t, _, _, rows = ts.sharded_tile_geometry(base, 2)
    cfg, st = _pile_state(cap, False, world, 0,
                          centre=(40.0, (rows - 1) * t))
    pid, pos, prev, rad = tiled.export_particles(st)
    mesh = make_mesh(2, device="cuda")
    slabs = ts.init_sharded_tiles(cfg, mesh, pos, rad, pids=pid,
                                  previous_positions=prev)
    ext = ts.extended_slabs(mesh, slabs, fused=True)[1]
    full = int(((ext.pid[:, 0] >= 0).sum(0) == cap).sum())
    if full == 0:
        raise AssertionError(f"cap {cap} slab: no full tile in the halo")
    check_k1_k3(f"cap{cap}-slab", cfg, ext, ext, errs)
    log(f"[caps] cap {cap}: K1 and K3 on slab 1's halo-extended planes "
        f"{list(ext.dims)} ({full} full tiles in its lower halo row) "
        "bit-equal "
        "and repeat bit-equal")


def _crowd_cell(st, cfg):
    """``st`` with every particle of the first block of 3 x 3 full tiles
    (row by row) moved into the middle tile's box, on a 9 x 9 grid of 0.05
    tile steps: that tile's cell has 9 x cap members (past any K the scene
    reaches otherwise)."""
    import torch
    from gpu_physics_engine_torch.ops import tiled
    t = tiled.tile_geometry(cfg)[0]
    full = (st.pid >= 0).all(0).float()[None, None]
    block = torch.nn.functional.conv2d(full, torch.ones(1, 1, 3, 3,
                                                        device=full.device))
    hits = (block[0, 0] == 9).nonzero()
    if not len(hits):
        raise AssertionError("the jam fills no block of 3 x 3 tiles")
    ty, tx = (int(v) + 1 for v in hits[0])
    cap = st.dims[0]
    k = torch.arange(9 * cap, device=st.x.device, dtype=torch.float32)
    ox = ((k % 9) - 4) * 0.05 * t
    oy = ((k // 9 % 9) - 4) * 0.05 * t
    x, y = st.x.clone(), st.y.clone()
    for j, (dy, dx) in enumerate((a, b) for a in (-1, 0, 1)
                                 for b in (-1, 0, 1)):
        sl = slice(j * cap, (j + 1) * cap)
        x[:, ty + dy, tx + dx] = (tx - 0.5) * t + ox[sl]
        y[:, ty + dy, tx + dx] = (ty - 0.5) * t + oy[sl]
    return st.replace(x=x, y=y)


def _rank_streamed(label, cfg, st) -> None:
    """K5 and K5-par (origin 0, all parities) through the packed kernel
    with buffers of 8 and 256 occupants, so that the windows around the
    scene's full tiles (and, at 8, nearly every window) stream: bit-equal
    to the plain versions."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    from gpu_physics_engine_torch.utils.kernel_study import rank_pack_cuda
    ps = gp.to_parity_state(st, cfg, 0)
    want, pwant = gk.rank_plain(st, cfg), gp.rank_par_plain(ps, cfg)
    for entries in (8, 256):
        _equal_or_raise(f"K5 {label} streamed ({entries} entries)",
                        rank_pack_cuda(st, cfg, entries), want)
        _equal_or_raise(f"K5-par {label} streamed ({entries} entries)",
                        rank_pack_cuda(ps, cfg, entries), pwant)
    log(f"[k5] {label}: the packed rank with buffers of 8 and 256 "
        "occupants (windows streamed), flat and parity, bit-equal")


def _deep_colors(label, cfg, st, errs: dict) -> None:
    """Past K 64 (the solve without a window): K6 flat, and K6-par at
    origin 0 (with the Verlet tail under a uniform radius), a whole solve
    each against the plain passes, bit-equal and on repeat (the plain
    sweep's K^2/2 pairs a color are slow: one solve a layout)."""
    from gpu_physics_engine_torch.ops import gs_kernels as gk
    from gpu_physics_engine_torch.ops import gs_parity as gp
    src, _, rrad, count = gk.rank_cuda(st, cfg)
    a, a2 = (gk.colors_cuda(st.x, st.y, src, rrad, cfg, count=count)
             for _ in range(2))
    _equal_or_raise(f"K6 {label}", a, gk.colors_plain(st.x, st.y, src, rrad,
                                                      cfg), a2)
    ps = gp.to_parity_state(st, cfg, 0)
    psrc, _, prrad, pcount = gp.rank_par_cuda(ps, cfg)
    prm = _prm(cfg)
    runs = []
    for _ in range(3):
        q, r = ps.px.clone(), ps.py.clone()
        runs.append((q, r, None if prm is None else (q, r, ps.pid, prm)))
    got = [gp.colors_par_cuda(ps.x, ps.y, psrc, prrad, cfg, ps.geo, 4, t,
                              uniform=ps.radius is None, count=pcount)
           + (q, r) for q, r, t in runs[:2]]
    q, r, t = runs[2]
    want = gp.colors_par_plain(ps.x, ps.y, psrc, prrad, cfg, ps.geo, 4, t)
    _equal_or_raise(f"K6-par {label}", got[0], want + (q, r), got[1])
    errs["gs_color"] = errs["gs_color_par"] = 0.0


def _wide_kernels(errs: dict) -> None:
    """The kernels past cap 32 against their plain versions, bit-equal and
    on repeat, at caps 33 (64-bit masks), 65, 140 (K1 and the relocate
    window without a mask), 257, 312 and 520, on pile scenes whose tiles
    fill every slot: K1 and K3 (uniform and general radius) on a grid
    smaller than one region (12 x 5 world: [cap, 8, 8]) and on a ragged one
    ([cap, 21, 39]), and on a halo-extended slab (caps 33, 140 and 312);
    there K2 in every matching mode with hysteresis on and off (past cap
    256 on the small grid under the config's hysteresis), and K4; on the
    ragged grid K2-par (origins 0 and -1, one launch and one per parity)
    and relocate_mega (== K2-par) in every matching mode; K1 through the
    packed kernel under a plan whose buffer makes the window stream (two
    plans: four and one tiles a block) at caps 140 and 520; K2 and K4 at
    cap 4,096 (their arrays in device scratch: no region fits a block;
    K2-par and relocate_mega there: tests/test_torch_cuda.py).  The GS
    kernels at caps 33 (the window kernels' widest class), 65, 128, 140,
    256, 257, 312 and 520 (the packed rank and the ranked-slot solve): K5
    and K5-par (K 16, with and without a radius plane), K6 flat and K6-par
    at origins 0 and -1 (colors 1..c, with and without the tail) and
    colors_mega, on a 40 x 30 GS scene whose cluster fills the slots of
    its tiles, and the packed rank with its windows streamed.  Then K past
    16: K5, K5-par and K6 at K 17 (with and without a radius plane), 32 and
    64 at cap 16, and at K 64 at cap 140 (uniform radius); and at K 80 and
    128 at cap 16 on a crowded cell (9 x cap members): K5 and K5-par, K6
    flat and K6-par."""
    from gpu_physics_engine_torch import StepParams
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    from gpu_physics_engine_torch.utils.kernel_study import (
        collide_integrate_pack_cuda)
    matches = [(m, -1.0) for m in ("flip", "flip2", "greedy")]
    for cap in WIDE_CAPS:
        t0 = time.perf_counter()
        for shape, world, cut in (("small", (12.0, 5.0), 0),
                                  ("ragged", (80.0, 33.0), 3)):
            label = f"cap{cap}-{shape}"
            cfg, st_u = _pile_state(cap, True, world, cut)
            _, st_g = _pile_state(cap, False, world, cut)
            check_k1_k3(label, cfg, st_u, st_g, errs)
            gcfg = cfg.replace(tiled_uniform_radius=False)
            # past cap 256 the small grid under the config's hysteresis
            # only (the ragged grid takes both)
            check_relocate(label, gcfg, st_g, matches if cap > 256 and
                           shape == "small" else MODES, errs)
            check_relocate_one(label, gcfg, st_g, errs)
            if shape == "ragged":
                check_relocate_par(label, gcfg, st_g, matches, errs)
                log(f"[mega] {label}: "
                    + check_relocate_mega(label, cfg, st_u, matches, errs))
            if shape == "ragged" and cap in (140, 520):
                prm = StepParams.make(0.02, mouse=(30.0, 20.0), pressed=True
                                      ).as_tensor("cuda")
                want = tk.collide_integrate_plain(st_g, prm, gcfg)
                fields = ("x", "y", "px", "py")
                for plan in ((4, 8, 12 * 256 + 1024 + 24 * 40),
                             (1, 1, 12 * 256 + 512 + 24 * 3)):
                    got = [collide_integrate_pack_cuda(st_g, prm, gcfg, plan)
                           for _ in range(2)]
                    _equal_or_raise(
                        f"K1 {label} streaming plan {plan}",
                        tuple(getattr(got[0], f) for f in fields),
                        tuple(getattr(want, f) for f in fields),
                        tuple(getattr(got[1], f) for f in fields))
                log(f"[caps] {label}: K1's packed kernel with the window "
                    f"streamed (plans of 40 and 3 occupants) bit-equal and "
                    f"repeat bit-equal")
        if cap in SLAB_CAPS:
            _slab_wide(cap, errs)
        log(f"[caps] cap {cap}: K1-K4, {time.perf_counter() - t0:.1f} s")
    for cap in GS_CAPS:
        t0 = time.perf_counter()
        for uniform in (False, True):
            gcfg, gst = _gs_ragged_state(cap, 16, uniform, 3000,
                                         (40.0, 30.0), jam_sd=0.6)
            if int((gst.pid >= 0).sum(0).max()) < min(cap, 300):
                raise AssertionError(f"cap {cap} GS: no tile holds "
                                     f"{min(cap, 300)}")
            gst = jittered(gst, 0.3 * tiled.tile_geometry(gcfg)[0],
                           seed=cap)
            check_rank(f"cap{cap}-K16", gcfg, gst, errs)
            check_window(f"cap{cap}-K16", gcfg, gst, errs)
            if cap > tk.WIDE_CAP:
                _rank_streamed(f"cap{cap}-K16", gcfg, gst)
        log(f"[caps] cap {cap}: the GS kernels, "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg, st = _pile_state(4096, False, (12.0, 5.0), 0)
    if tk.k2_window_bytes(4096, False) != 0:
        raise AssertionError("K2 at cap 4,096 runs in shared memory")
    check_relocate("cap4096-scratch", cfg, st,
                   [("flip", 0.0), ("greedy", -1.0)], errs)
    check_relocate_one("cap4096-scratch", cfg, st, errs)
    for cap, K, radii in ((16, 17, (False, True)), (16, 32, (True,)),
                          (16, 64, (True,)), (140, 64, (True,))):
        for uniform in radii:
            gcfg, gst = _gs_ragged_state(cap, K, uniform, 3000,
                                         (40.0, 30.0), jam_sd=0.6)
            gst = jittered(gst, 0.3 * tiled.tile_geometry(gcfg)[0],
                           seed=K)
            check_rank(f"cap{cap}-K{K}", gcfg, gst, errs)
            check_window(f"cap{cap}-K{K}", gcfg, gst, errs)
    for K, uniform in zip(DEEP_KS, (False, True)):
        gcfg, gst = _gs_ragged_state(16, K, uniform, 3000, (40.0, 30.0),
                                     jam_sd=0.6)
        gst = _crowd_cell(jittered(gst, 0.3 * tiled.tile_geometry(gcfg)[0],
                                   seed=K), gcfg)
        check_rank(f"cap16-K{K}-crowd", gcfg, gst, errs)
        _deep_colors(f"cap16-K{K}-crowd", gcfg, gst, errs)
        log(f"[k6] cap16-K{K}-crowd uniform={uniform}: K6 flat and K6-par "
            f"(origin 0{_tails(gcfg)}) a whole solve bit-equal and repeat "
            f"bit-equal")
    log(f"[caps] cap 4,096 and K 17-128: {time.perf_counter() - t0:.1f} s")


def _wide_path(label, e, n, steps, expect, paths, errs, key, smi,
               band=None) -> dict:
    """8 warm-up steps of ``e`` (cap past 32), then ``steps`` steps with
    the launch counts zeroed just before, which must equal ``expect`` just
    after; every pid kept, finite, inside the world; ms/step (CUDA
    events), the idle share and launches a step over 8 more steps
    (``profile_run``, a window that holds every K1 launch, else fail);
    then K2 (the engine's match and hysteresis) on the final state
    against its plain version, twice, bit-equal.  Returns the time rows
    {name[key]: (kernel ms, plain ms, bound)} of K1 on the final state and
    K2 on it jittered by 0.3 tile, each held bit-equal, twice, to its plain
    version on those inputs first.  ``band`` = (row0, row1): K2's plain
    comparison and its time row
    take those tile rows of the state, and K2's time on the whole state is
    logged beside."""
    import torch
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    from gpu_physics_engine_torch.utils.profiling import profile_run
    cfg = e.config
    if cfg.tile_cap <= tk.NARROW_CAP:
        raise AssertionError(f"{label}: cap {cfg.tile_cap} is not past "
                             f"{tk.NARROW_CAP}")
    # 8 warm-up steps first: the first launches of the engine's kernels
    # at this cap (and their shared-memory set-up) stay out of the window
    warm = cuda_ms(lambda: e.run(8), reps=1, warmup=0) / 8
    reset_launches()
    ms = cuda_ms(lambda: e.run(steps), reps=1, warmup=0) / steps
    torch.cuda.synchronize()
    got = launches()
    bad = {k: (got[k], v) for k, v in expect.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{label}: launches (got, expected) {bad}")
    paths[label] = got
    q = _check_engine(e, n, label)

    def per_launch(prof, tag):
        rows = [k for k in prof["kernels"] if tag in k["name"]]
        calls = sum(k["calls"] for k in rows)
        return sum(k["ms"] for k in rows) / max(1, calls), calls

    # a profiler window that lost kernel records would understate the busy
    # time: take the window again, with a wider pad (kernel_window), until
    # it holds every K1 launch of its 8 steps and no more busy time than
    # its span, at most three times, else fail.  Each window's two passes
    # (16 steps) start clear of the periodic sweep, which runs at a step's
    # start when the step count is a multiple of its interval.
    iv = e._sweep_interval
    for tries, pad in enumerate(PADS, 1):
        k = e._steps_done % iv if iv else 1
        if iv and (k == 0 or k + 16 > iv):
            e.run(iv - k + 1 if k else 1)  # the sweep, then one step
        prof = profile_run(e, 8, pad_s=pad)
        # K1: collide_integrate_kernel (the masks) or _pack_kernel; K2:
        # relocate_window_kernel (the masks) or relocate_warp_kernel
        k1_ms, k1_n = per_launch(prof, "gpe::collide_integrate")
        if k1_n == 8 * cfg.substeps and prof["idle_share"] >= 0.0:
            k2_ms, k2_n = per_launch(prof, "gpe::relocate_w")
            break
    else:
        raise AssertionError(
            f"{label}: three profiler windows of 8 steps (pads {PADS} s), "
            f"the last with {k1_n} of {8 * cfg.substeps} K1 launches, idle "
            f"share {prof['idle_share']:.4f}")
    log(f"[{label}] cap {cfg.tile_cap} x {list(e.state.dims[1:])} (tile "
        f"edge {tiled.tile_geometry(cfg)[0]:.3f}) match {cfg.tiled_match} "
        f"uniform radius {cfg.tiled_uniform_radius}: {steps} steps, "
        f"launches {got}; all {n} pids present, finite, inside the world; "
        f"stale {q['stale_pct']:.4f}%; {ms:.4f} ms/step (CUDA events over "
        f"the {steps} steps, after 8 warm-up steps at {warm:.4f} ms/step)")
    log(f"[{label}] ({smi}) 8 more steps: {prof['device_span_ms'] / 8:.4f} "
        f"ms/step (CUDA events), device busy "
        f"{prof['device_busy_ms'] / 8:.4f} ms/step, idle share "
        f"{prof['idle_share']:.4f}, {prof['device_launches'] / 8:.2f} "
        f"launches a step; K1 {k1_ms:.4f} ms a launch ({k1_n}), K2 "
        f"{k2_ms:.4f} ms a launch ({k2_n}) in the step (profiler window "
        f"{tries} of 3, pad {pad} s)")
    st = e.state
    prm = e.params().as_tensor("cuda", 1.0 / cfg.substeps)
    moved = jittered(st, 0.3 * tiled.tile_geometry(cfg)[0], seed=2)
    dims = list(st.dims)
    if band is not None:
        whole = cuda_ms(lambda: tk.relocate_pull_cuda(moved, cfg), reps=20)
        log(f"[{label}] K2 on the whole jittered state {dims}: {whole:.4f} "
            f"ms a launch; its plain comparisons on tile rows {band[0]}-"
            f"{band[1] - 1}")
        st, moved = (s.replace(**{f: getattr(s, f)[:, band[0]:band[1]]
                                  .contiguous() for f in tiled.FIELDS})
                     for s in (st, moved))
    check_relocate(f"{label} in-step", cfg, st,
                   [(cfg.tiled_match, cfg.tiled_hysteresis)], errs, jitter=0)
    st = e.state
    return {
        f"collide_integrate[{key}]": _time_pair(
            f"collide_integrate[{key}]", dims,
            lambda: tk.collide_integrate_cuda(st, prm, cfg),
            lambda: tk.collide_integrate_plain(st, prm, cfg), plain_reps=1,
            errs=errs)
        + (_k1_bound(cfg, st),),
        f"relocate_pull[{key}]": _time_pair(
            f"relocate_pull[{key}]", list(moved.dims),
            lambda: tk.relocate_pull_cuda(moved, cfg),
            lambda: tk.relocate_pull_plain(moved, cfg), plain_reps=1,
            errs=errs)
        + (_k2_bound(moved),)}


def _retile_1m(smi, paths, errs) -> dict:
    """The 1M engine with tiled_spawn="retile": 64 steps, then
    ``spawn_at`` (100 particles of radius 1-3) re-tiles for radius 3 at
    the scene's cap, past 32; then 128 steps (K1's general form every
    step, K2 every 4th) through ``_wide_path``, with the re-tile's host
    seconds."""
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    n = RETILE_N
    e = make_tuned_engine(n, tiled_spawn="retile", device="cuda")
    e.run(64)
    cap0, dims0 = e.config.tile_cap, list(e.state.dims)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e.spawn_at(CENTRE, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if e.num_particles() != n + 100 or e.config.tiled_uniform_radius:
        raise AssertionError(f"1M-retile: {e.num_particles()} particles, "
                             f"uniform radius {e.config.tiled_uniform_radius}")
    log(f"[1M-retile] 64 steps at {dims0}, then spawn_at({CENTRE}) of 100 "
        f"particles of radius 1-3: re-tiled to {list(e.state.dims)} (tile "
        f"edge {e.cell_size():.3f}, the cap from the scene), "
        f"tiled_uniform_radius off, {n + 100} particles; the spawn with its "
        f"re-tile took {secs:.2f} s on the host (cap was {cap0})")
    return _wide_path("1M-retile", e, n + 100, 128,
                      {"collide_integrate": 128, "relocate_pull": 32,
                       "collide": 0}, paths, errs, "retile", smi)


def _cap36_1m(smi, paths, errs) -> dict:
    """The 1M engine with tile_max_radius 1 and the cap from the scene
    (tile_cap=0): 128 steps through ``_wide_path`` (K1's uniform form);
    then K3's path (the same engine unfused, 16 steps) and K4's (the
    engine's state, 16 steps of K1 with ``relocate_one`` every 4th), each
    with its launch counts, and K3's and K4's time rows on the final
    state (K4's on it jittered by 0.3 tile), each held bit-equal, twice,
    to its plain version on those inputs first."""
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    from gpu_physics_engine_torch.ops import tiled, tiled_kernels as tk
    n = RETILE_N
    t0 = time.perf_counter()
    e = make_tuned_engine(n, tile_max_radius=1.0, tile_cap=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[1M-cap36] make_tuned_engine({n}, tile_max_radius=1.0, "
        f"tile_cap=0): cap {e.config.tile_cap} x {list(e.state.dims[1:])} "
        f"from the scene, built in {time.perf_counter() - t0:.2f} s")
    rows = _wide_path("1M-cap36", e, n, 128,
                      {"collide_integrate": 128, "relocate_pull": 32,
                       "collide": 0}, paths, errs, "cap36", smi)
    cfg, st = e.config, e.state
    # K3: the same scene unfused
    u = make_tuned_engine(n, tile_max_radius=1.0, tile_cap=0, device="cuda",
                          tiled_fuse_integrate=False)
    reset_launches()
    u.run(16)
    torch.cuda.synchronize()
    got = launches()
    want = {"collide": 16, "relocate_pull": 4, "collide_integrate": 0}
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"1M-cap36-unfused: launches {got}, "
                             f"expected {want}")
    paths["1M-cap36-unfused"] = got
    _check_engine(u, n, "1M-cap36-unfused")
    del u
    # K4: relocate_one every 4th step and K1, from the engine's state
    prm = e.params().as_tensor("cuda", 1.0 / cfg.substeps)
    s = st
    reset_launches()
    for i in range(16):
        if i % 4 == 0:
            s = tk.relocate_one(s, cfg)
        s = tk.collide_integrate(s, prm, cfg)
    torch.cuda.synchronize()
    got = launches()
    if got["relocate_one"] != 4 or got["collide_integrate"] != 16:
        raise AssertionError(f"1M-cap36-one: launches {got}")
    paths["1M-cap36-one"] = got
    if int((s.pid >= 0).sum()) != n:
        raise AssertionError("1M-cap36-one: particles lost")
    log(f"[1M-cap36] K3's path (unfused, 16 steps) and K4's (16 steps of "
        f"K1, relocate_one every 4th): launches {paths['1M-cap36-unfused']}"
        f" and {got}; all {n} pids kept")
    check_relocate_one("1M-cap36", cfg, st, errs)
    moved = jittered(st, 0.3 * tiled.tile_geometry(cfg)[0], seed=2)
    dims = list(st.dims)
    rows["collide[cap36]"] = _time_pair(
        "collide[cap36]", dims, lambda: tk.collide_cuda(st, cfg),
        lambda: tk.collide_plain(st, cfg), plain_reps=1, errs=errs) + (
            _k3_bound(cfg, st),)
    rows["relocate_one[cap36]"] = _time_pair(
        "relocate_one[cap36]", dims, lambda: tk.relocate_one_cuda(moved, cfg),
        lambda: tk.relocate_one_plain(moved, cfg), plain_reps=1,
        errs=errs) + (_k2_bound(moved),)
    return rows


def _retile_4m(smi, paths, errs) -> dict:
    """The 4M engine with tiled_spawn="retile": ``spawn_at`` on the seeded
    scene re-tiles for radius 3 at the cap the scene gives (``_auto_cap``
    on the exported particles: 140 on [140, 168, 464]; after 64 steps the
    scene gives 108), then ``_wide_path`` (K1's general form every step,
    K2 every 2nd), K2's plain comparisons on a band of tile rows through
    the spawn."""
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    from gpu_physics_engine_torch.core.tiled_engine import _auto_cap
    from gpu_physics_engine_torch.ops import tiled
    n = 4_194_304
    e = make_tuned_engine(n, tiled_spawn="retile", device="cuda")
    cap0, dims0 = e.config.tile_cap, list(e.state.dims)
    pos = tiled.export_particles(e.state)[1]
    want = _auto_cap(e.config.replace(tile_max_radius=3.0,
                                      tile_multiplier=2.2, tile_cap=0), pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e.spawn_at(CENTRE, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dims = list(e.state.dims)
    if (e.num_particles() != n + 100 or e.config.tiled_uniform_radius
            or dims != [want, 168, 464] or want != 140):
        raise AssertionError(f"4M-retile: {e.num_particles()} particles, "
                             f"dims {dims}, _auto_cap {want}, uniform "
                             f"radius {e.config.tiled_uniform_radius}")
    log(f"[4M-retile] the seeded scene at {dims0}, spawn_at({CENTRE}) of 100 "
        f"particles of radius 1-3: re-tiled to {dims} (tile edge "
        f"{e.cell_size():.3f}; _auto_cap of the exported scene {want}), "
        f"tiled_uniform_radius off, {n + 100} particles; the spawn with its "
        f"re-tile took {secs:.2f} s on the host (cap was {cap0})")
    row = int(CENTRE[1] / e.cell_size()) + 1
    return _wide_path("4M-retile", e, n + 100, 128,
                      {"collide_integrate": 128, "relocate_pull": 64,
                       "collide": 0}, paths, errs, "cap140", smi,
                      band=(row - 16, row + 16))


def _spawn_ready_1m(smi, paths, errs) -> dict:
    """JAX's spawn-ready 1M tiling: make_tuned_engine(1_048_576,
    tile_max_radius=3.0, tile_cap=0) (the cap from the scene: 144), a
    spawn whose radii 1-3 fit its tiles (into the tiles, K1's general form
    from there), then ``_wide_path``."""
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    n = RETILE_N
    t0 = time.perf_counter()
    e = make_tuned_engine(n, tile_max_radius=3.0, tile_cap=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[1M-spawn-ready] make_tuned_engine({n}, tile_max_radius=3.0, "
        f"tile_cap=0): cap {e.config.tile_cap} x {list(e.state.dims[1:])} "
        f"from the scene, built in {time.perf_counter() - t0:.2f} s")
    dims = list(e.state.dims)
    e.spawn_at(CENTRE, verbose=False)
    if (e.num_particles() != n + 100 or list(e.state.dims) != dims
            or e.big is not None and int(e.big.num_active)):
        raise AssertionError(f"1M-spawn-ready: the spawn went elsewhere "
                             f"than the tiles ({e.num_particles()} "
                             f"particles, dims {list(e.state.dims)})")
    log(f"[1M-spawn-ready] spawn_at({CENTRE}): 100 particles of radius 1-3 "
        f"into the tiles, tiled_uniform_radius "
        f"{e.config.tiled_uniform_radius}")
    return _wide_path("1M-spawn-ready", e, n + 100, 128,
                      {"collide_integrate": 128, "relocate_pull": 32,
                       "collide": 0}, paths, errs, "cap144", smi)


def _r5_cap312(smi, paths, errs) -> dict:
    """The tuned 1M engine with tiles for radius-5 particles:
    make_tuned_engine(1_048_576, tile_max_radius=5.0, tile_cap=0) (the cap
    from the seeded scene: 312 on [312, 56, 141]), a spawn whose radii 1-3
    fit its tiles (into the tiles, K1's general form from there), then
    ``_wide_path``."""
    import torch
    from gpu_physics_engine_torch import make_tuned_engine
    n = RETILE_N
    t0 = time.perf_counter()
    e = make_tuned_engine(n, tile_max_radius=5.0, tile_cap=0, device="cuda")
    torch.cuda.synchronize()
    dims = list(e.state.dims)
    log(f"[1M-r5-cap312] make_tuned_engine({n}, tile_max_radius=5.0, "
        f"tile_cap=0): cap {dims[0]} x {dims[1:]} from the scene, built in "
        f"{time.perf_counter() - t0:.2f} s")
    if dims != [312, 56, 141]:
        raise AssertionError(f"1M-r5-cap312: dims {dims}, not [312, 56, 141]")
    e.spawn_at(CENTRE, verbose=False)
    if (e.num_particles() != n + 100 or list(e.state.dims) != dims
            or e.big is not None and int(e.big.num_active)
            or e.config.tiled_uniform_radius):
        raise AssertionError(f"1M-r5-cap312: the spawn went elsewhere than "
                             f"the tiles ({e.num_particles()} particles, "
                             f"dims {list(e.state.dims)})")
    log(f"[1M-r5-cap312] spawn_at({CENTRE}): 100 particles of radius 1-3 "
        f"into the tiles, tiled_uniform_radius off")
    return _wide_path("1M-r5-cap312", e, n + 100, 128,
                      {"collide_integrate": 128, "relocate_pull": 32,
                       "collide": 0}, paths, errs, "cap312", smi)


def _growth_257(paths) -> None:
    """Capacity growth on the card past 256, as in the JAX package: an
    engine at cap 256 whose deferred population passes
    ``tiled_auto_cap_pct`` grows to 257 through ``_maybe_grow_cap``, then
    runs 8 steps there (K1 and K2 at cap 257), every pid kept."""
    import torch
    from gpu_physics_engine_torch import SimConfig, TiledEngine
    n = 20_000
    cfg = SimConfig(max_particles=n, initial_particles=n, world_width=96.0,
                    world_height=64.0, pipeline="tiled", tile_cap=256,
                    tiled_auto_cap_pct=50.0, tiled_relocate_interval=2)
    e = TiledEngine(cfg, seed=0, device="cuda")
    # a deferred population of 2,500% a step over a 4-step window: past
    # the bound (a run's own deferrals stay far below it)
    e._maybe_grow_cap(4, int(e.state.overflow_count) - 1_000_000)
    if e.config.tile_cap != 257 or e.state.dims[0] != 257:
        raise AssertionError(f"growth: cap {e.config.tile_cap}, dims "
                             f"{list(e.state.dims)}")
    reset_launches()
    e.run(8)
    torch.cuda.synchronize()
    got = launches()
    if (got["collide_integrate"] != 8 * cfg.substeps
            or got["relocate_pull"] < 1 or e.config.tile_cap != 257):
        raise AssertionError(f"growth-257: launches {got}, cap "
                             f"{e.config.tile_cap}")
    paths["growth-257"] = got
    _check_engine(e, n, "growth-257")
    log(f"[growth-257] cap 256 -> {e.config.tile_cap} through "
        f"_maybe_grow_cap on the card ({list(e.state.dims)}); 8 steps "
        f"there, launches {got}; all {n} pids kept")


def _gs_wide(tag, key, cap, K, paths, errs) -> dict:
    """The GS engine at ``cap`` with max_occupancy ``K`` (both set by hand:
    no tuned GS row reaches past cap 32 or K 8) on 262,144 particles over a
    1524 x 524 world (the 1M-GS scene's density): one flat frame from the
    seeded scene, then 16 steps (48 past cap 64 or K 16) in the flat, par
    and mega layouts from that state (``tag``, ``tag``-par, ``tag``-mega),
    each with its launch counts (K5, K6, K2 / K5-par, K6-par, K2-par /
    K5-par, colors_mega, relocate_mega; past cap 64 or K 16 the packed
    rank's and the ranked-slot solve's too), the three final states
    bit-equal.  Returns the time rows {name[key]: (kernel ms, plain ms,
    bound)} of K5 and K6 (flat) and the parity kernels on the seeded
    frame's state, each held bit-equal, twice, to its plain version on
    those inputs first; past cap 64 or K 16 the rank's and the solves'
    rows are named by the new kernels (``WIDE_NAMES``)."""
    import torch
    from gpu_physics_engine_torch import TiledEngine
    from gpu_physics_engine_torch.core.tuned import gs_config
    from gpu_physics_engine_torch.ops import gs_kernels as gk, tiled
    n, (w, h) = GS64

    def cfg_of(layout):
        kw = dict(world_width=w, world_height=h, tile_cap=cap,
                  max_occupancy=K)
        if layout == "mega":
            return gs_config(n, gs_layout="par", gs_colors_mega=True,
                             gs_relocate_mega=True, **kw)
        return gs_config(n, gs_layout=layout, **kw)

    flat = cfg_of("flat")
    seed = TiledEngine(flat, seed=0, chunk=64, device="cuda")
    start = tiled.tiled_step_fn(seed.state, seed.params(), flat)
    del seed
    ranked = not gk.windowed(cap, K)
    steps = 48 if ranked else 16
    runs = {}
    for layout in ("flat", "par", "mega"):
        name = tag if layout == "flat" else f"{tag}-{layout}"
        runs[layout] = phase_engine(
            lambda: TiledEngine(cfg_of(layout), chunk=64,
                                initial_state=_clone(start)),
            n, [(steps, None)], name, _gs_expect(steps, layout, ranked))
        paths[name] = runs[layout]["launches"]
    for layout in ("par", "mega"):
        cross_check(tag, runs["flat"]["engine"], runs[layout]["engine"],
                    layout)
    del runs
    torch.cuda.empty_cache()
    cfg, st = flat, start
    src, _, rrad, count = gk.rank_cuda(st, cfg)
    b = gs_bounds(cfg, st)
    timed = {
        "gs_rank": (lambda: gk.rank_cuda(st, cfg),
                    lambda: gk.rank_plain(st, cfg), ()),
        "gs_color": (lambda: gk.colors_cuda(st.x, st.y, src, rrad, cfg,
                                            count=count),
                     lambda: gk.colors_plain(st.x, st.y, src, rrad, cfg),
                     ())}
    par, _ = _par_runs(cfg, st)
    for name in ("gs_rank_par", "gs_color_par", "relocate_par",
                 "gs_colors_mega", "relocate_mega"):
        kern, plain, _, *keep = par[name]
        timed[name] = (kern, plain, keep[0] if keep else ())
    rows = {}
    for name, (kern, plain, keep) in timed.items():
        row = f"{WIDE_NAMES.get(name, name) if ranked else name}[{key}]"
        rows[row] = _time_pair(row, list(st.dims), kern, plain,
                               plain_reps=1, errs=errs, keep=keep) + (
                                   b[name],)
    return rows


# past cap 64 or K 16 the time rows and the kernels line name the GS rank
# and solve by their kernels: the packed rank and the ranked-slot solve
WIDE_NAMES = {"gs_rank": "gs_rank_pack", "gs_rank_par": "gs_rank_pack_par",
              "gs_color": "gs_color_ranked",
              "gs_color_par": "gs_color_ranked_par",
              "gs_colors_mega": "gs_color_ranked_mega"}


def phase_wide_caps(smi: str, paths: dict, errs: dict) -> dict:
    """Tile caps past 32 and K past 16 on the card (the 64-bit mask
    instantiations, K1's and the relocate window's kernels without a mask,
    the packed GS rank and the ranked-slot solve): ``check_window_formula``
    (run first, in
    main) holds the window bytes at every cap 1-256 and past it to 4,096;
    ``_wide_kernels`` holds every kernel at caps 33-520 (K2 at 4,096) and
    K 17-128; ``_growth_257`` grows an engine past 256; then the engine
    paths past cap 32: 1M-retile, 1M-cap36 (with K3's and K4's paths),
    4M-retile (cap 140), 1M-spawn-ready (cap 144), 1M-r5-cap312 (cap 312),
    and the GS engine at cap 64, 128 and 312 and at K 32.  Returns their
    time rows."""
    import torch
    t0 = time.perf_counter()
    _wide_kernels(errs)
    log(f"[caps] the kernels at caps 33-4,096 and K 17-128: "
        f"{time.perf_counter() - t0:.1f} s")
    _growth_257(paths)
    rows = {}
    for path in (_retile_1m, _cap36_1m, _retile_4m, _spawn_ready_1m,
                 _r5_cap312):
        t1 = time.perf_counter()
        rows.update(path(smi, paths, errs))
        torch.cuda.empty_cache()
        log(f"[caps] {path.__name__}: {time.perf_counter() - t1:.1f} s")
    for tag, key, cap, K in (("GS-cap64", "cap64", 64, 8),
                             ("GS-cap128", "cap128", 128, 8),
                             ("GS-K32", "K32", 16, 32),
                             ("GS-cap312", "cap312", 312, 8)):
        t1 = time.perf_counter()
        rows.update(_gs_wide(tag, key, cap, K, paths, errs))
        torch.cuda.empty_cache()
        log(f"[caps] {tag}: {time.perf_counter() - t1:.1f} s")
    log(f"[caps] phase {time.perf_counter() - t0:.1f} s")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import gpu_physics_engine_torch  # noqa: F401  (fails outside the repo)
    from gpu_physics_engine_torch import TiledEngine, make_tuned_engine
    from gpu_physics_engine_torch.core.tuned import gs_config

    t0 = time.perf_counter()

    def clock(what):  # seconds since the start, after each phase
        log(f"[clock] {what}: {time.perf_counter() - t0:.1f} s")

    smi = phase_environment()
    phase_build()
    check_window_formula()
    clock("build, window bytes")

    errs: dict = {}
    jacobi = []
    for label, n in (("4M", 4_194_304), ("1M", 1_048_576),
                     ("256k", 256_000)):
        e = make_tuned_engine(n, device="cuda")
        moving = jittered(e.state, 0.05, seed=3)  # some velocity
        jacobi.append((label, e.config,
                       e.state.replace(px=moving.x, py=moving.y)))
        del e
    phase_jacobi_kernels(jacobi, errs)
    big_cfg, big_state = jacobi[0][1:]
    del jacobi
    phase_tile_division(big_cfg, big_state)
    clock("Jacobi kernels, tile division")

    gs = []
    for label, n in (("1M-GS", 1_048_576), ("4M-GS", 4_194_304)):
        e = TiledEngine(gs_config(n), seed=0, chunk=64, device="cuda")
        gs.append((label, e.config, e.state))
        del e
    phase_gs_kernels(gs, errs)
    phase_par_kernels(gs, errs)
    phase_fused_kernels(gs, big_cfg, big_state, errs)
    clock("GS, parity and fused kernels")
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
    clock("Jacobi paths, spawn")

    phase_gs_paths(paths, errs)
    clock("GS paths")
    phase_k4_path(paths)
    phase_render(smi, paths)
    clock("K4 path, render")
    radix_keys = phase_array_kernels(errs)
    phase_array_paths(paths)
    clock("array kernels and paths")
    phase_options(paths, saved)
    clock("options")
    run = phase_engine(
        lambda: make_tuned_engine(4_194_304, device="cuda",
                                  tiled_fuse_integrate=False),
        4_194_304, [(64, None)], "4M-unfused",
        {"collide": 64, "relocate_pull": 32, "collide_integrate": 0})
    paths["4M-unfused"] = run["launches"]
    del run
    torch.cuda.empty_cache()
    phase_apps(smi, paths, errs)
    clock("unfused, apps")
    sharded = phase_sharded(paths, errs)
    clock("sharded")
    wide = phase_wide_caps(smi, paths, errs)
    clock("caps")

    times, library = phase_times(big_cfg, big_state, gs_cfg, gs_state,
                                 radix_keys)
    bound = bounds(big_cfg, big_state, gs_cfg, gs_state, radix_keys)
    times["collide_integrate[general]"] = spawn_times
    bound["collide_integrate[general]"] = _k1_bound(spawn_cfg, spawn_state)
    for name, (k_ms, p_ms, b) in list(sharded["slab_runs"].items()) + list(
            wide.items()):
        times[name] = (k_ms, p_ms)
        bound[name] = b
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
    clock("times, bounds")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
