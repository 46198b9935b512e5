"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, under ``build/kernels/`` at the root of
the checkout.  The file name carries a hash of the sources, headers and
flags, so an edit rebuilds and an unchanged tree loads the library it built
before.  There is no fallback: a missing ``nvcc`` or a failed build raises
with the compiler's output.  ``build_log`` keeps ptxas's report of the last
compile (registers, shared memory, spills, stack per kernel).

The whole-solve kernels of ``krylov_ops.cu`` and ``ell_ops.cu`` use
cooperative groups' grid barrier, which needs no relocatable device code
(``-rdc``) on CUDA 11 and later, so the sources compile and link as
ordinary objects.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_lock = threading.Lock()
_lib = None
build_seconds: float | None = None  # wall time of the last compile, None if loaded
build_log = ""  # compiler output of the last compile

P, I, D, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_AMG = [P, P, I, LL] + [P] * 6 + [I, LL, I, I] + [P] * 6 + [I] + [P] * 3 + [I, I, P]
# entry point -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    "oasisx_ell_matvec": [P] * 5 + [I, LL, LL, I, I, P],
    "oasisx_ell_bicgstab": [P] * 11 + [I, P, P, I, I, LL, I, I, P],
    "oasisx_ell_cg": [P] * 10 + [I, P, P, I, I, LL, I, I, P],
    "oasisx_ell_pcg_amg": _AMG,
    "oasisx_ell_vcycle": _AMG,
    "oasisx_ell_warp_row_k": [],
    "oasisx_matvec_const": [P, P, P, I, I, I, I, I, I, I, P],
    "oasisx_const_tile": [I] * 3 + [P],
    "oasisx_matvec_win": [P] * 6 + [LL] + [I] * 7 + [P],
    "oasisx_win_route": [I] * 8 + [P],
    "oasisx_mixed": [P, P, P, I, I, I, I, I, I, I, I, P],
    "oasisx_divergence": [P, P, P, I, I, I, I, I, I, I, I, P],
    "oasisx_mixed_route": [I] * 9 + [P],
    "oasisx_cube_gather": [P, P, I, I, I, I, I, I, I, P],
    "oasisx_cube_gather_loop": [P, P, I, I, I, I, I, I, I, P],
    "oasisx_cube_scatter": [P, P, I, I, I, I, I, I, I, P],
    "oasisx_band_matvec": [P] * 6 + [I] * 5 + [P],
    "oasisx_band_bicgstab": [P] * 12 + [I, P, P] + [I] * 5 + [P],
    "oasisx_band_cg": [P] * 11 + [I, P, P] + [I] * 5 + [P],
    "oasisx_cg_mass": [P] * 8 + [I] + [P] * 2 + [I] * 8 + [P],
    "oasisx_cg_mass_barriers": [I],
    "oasisx_cg_mass_route": [I] * 4 + [P],
    "oasisx_bicgstab": [P] * 9 + [LL, P, I] + [P] * 2 + [I] * 8 + [P],
    "oasisx_pressure_mg": [P] * 7 + [I] + [P] * 3 + [I] * 7 + [D] * 3 + [I, D, I, P],
    "oasisx_pressure_mg_plan": [I] * 8 + [P],
    "oasisx_pressure_cg": [P] * 7 + [I] + [P] * 3 + [I] * 6 + [D] * 3 + [I, P],
    "oasisx_pressure_cg_plan": [I] * 3 + [P],
    "oasisx_pressure_cg_barriers": [I] * 3,
    "oasisx_loop_open": [P] * 4,
    "oasisx_loop_close": [P, P, LL],
    "oasisx_loop_abort": [P],
}


def build_dir() -> Path:
    return _CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources: list[Path], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources + sorted(_CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        out = build_dir() / f"liboasisx_kernels_{_digest(sources, _FLAGS)}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            tag = f"{out.stem}.{os.getpid()}"
            objs = [out.parent / f"{tag}.{s.stem}.o" for s in sources]
            nvcc = _nvcc()
            cmds = [[nvcc, *_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(sources, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for c in cmds]
            logs = [p.communicate()[0] for p in procs]
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            link = [nvcc, *_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            for cmd, proc, log in zip(cmds, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
            for o in objs:
                o.unlink(missing_ok=True)
            build_seconds = time.perf_counter() - t0
            build_log = "".join(logs) + proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib
