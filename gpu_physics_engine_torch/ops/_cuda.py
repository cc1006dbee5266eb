"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for sm_90a, one process per source
and all started together, then linked into one shared library with a
plain C interface, at first use, into ``gpu_physics_engine_torch/_build/``
(listed in .gitignore).  The library's name carries a hash of the sources
and flags, so an edited source is rebuilt and a current build is reused.
Nothing here runs at import: this module is imported on machines without
nvcc or a GPU, where only the plain PyTorch versions run.  A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -fmad=false: see csrc/tiled_kernels.cuh.  Never --use_fast_math.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
                     "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "gpe_collide_integrate": [_P] * 11 + [_I] * 5 + [_P, _P],
    "gpe_collide_integrate_pack": [_P] * 11 + [_I] * 5 + [_P, _P]
    + [_I] * 3,
    "gpe_collide": [_P] * 6 + [_I] * 4 + [_P, _P],
    "gpe_relocate_pull": [_P] * 13 + [_I] * 7 + [_F, _F, _P, _P],
    "gpe_relocate_pull_warp": [_P] * 13 + [_I] * 7 + [_F, _F, _P, _P],
    "gpe_relocate_window_bytes": [_I, _I],
    "gpe_relocate_scratch_bytes": [_I] * 4,
    "gpe_collide_window_bytes": [_I, _I],
    "gpe_gs_rank": [_P] * 8 + [_I] * 4 + [_F, _P],
    "gpe_gs_rank_par": [_P] * 8 + [_I] * 9 + [_F, _F, _P],
    "gpe_gs_rank_window_bytes": [_I, _I, _I],
    "gpe_relocate_par": [_P] * 13 + [_I] * 9 + [_F, _F, _P, _P],
    "gpe_radix_scratch_bytes": [_I],
    "gpe_radix_digit_hist": [_P] * 2 + [_I] * 2 + [_P],
    "gpe_radix_onesweep": [_P] * 5 + [_I] * 4 + [_P],
    "gpe_relocate_one": [_P] * 13 + [_I] * 6 + [_F, _P, _P],
    "gpe_relocate_mega": [_P] * 13 + [_I] * 7 + [_F, _F, _P, _P],
    "gpe_gs_colors_window": [_P] * 11 + [_I] * 9 + [_F, _F, _I, _P, _P],
    "gpe_gs_colors_window_bytes": [_I, _I],
    "gpe_gs_route": [_I, _I],
    "gpe_gs_rank_pack_bytes": [_I, _I],
    "gpe_gs_rank_pack": [_P] * 8 + [_I] * 10 + [_F, _F, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _flags(defines) -> tuple:
    """NVCC_FLAGS with a -D per entry of ``defines`` ("NAME=VALUE")."""
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(defines=()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgpe_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise on the first failure.
    Returns their joined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}):\n"
                      f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def build(defines=()) -> dict:
    """Compile the library if no current build exists: one nvcc per source,
    all started together, then one link.  ``defines`` ("NAME=VALUE") build
    a variant of the sources' tunables (utils/kernel_study.py); the
    library the wrappers load has none.  Returns {"path", "seconds" (0.0
    when reused), "log" (nvcc/ptxas output)}."""
    so = library_path(defines)
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        cus = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(work, s.stem + ".o") for s in cus]
        log = _run_all([nvcc, *_flags(defines), "-c", str(s), "-o", o]
                       for s, o in zip(cus, objs))
        tmp = os.path.join(work, "lib.so")
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)  # atomic: no process sees a partial .so
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "log": log}


# entry points that return other than a cudaError_t or an int count
_RESTYPES = {"gpe_relocate_scratch_bytes": ctypes.c_longlong}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
