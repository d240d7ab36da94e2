"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use and is keyed on a hash of the source, the
``csrc/`` headers it includes and the flags, so ``python3 chip_smoke.py``
in a fresh checkout builds it and a later process of the same checkout
reuses it.  The libraries go to
``nonlocalheatequation_torch/_build/`` (listed in ``.gitignore``).

Nothing here runs at import: the CPU tests import every module of the port
on hosts that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES_2D = ("nsum2d.cu", "carried2d.cu", "superstep2d.cu", "resident2d.cu",
              "batched_step2d.cu", "batched_carried2d.cu", "batched_superstep2d.cu")
SOURCES_3D = ("nsum3d.cu", "carried3d.cu", "resident3d.cu")
#: the stencil kernels (every one includes stencil_tile.cuh)
SOURCES = SOURCES_2D + SOURCES_3D
#: the unstructured kernels, a group of their own: they include no stencil
#: header, so a change to them neither rebuilds the stencil libraries nor
#: starts new 2D or 3D tuner records
SOURCES_UNSTRUCTURED = ("windowed_matvec.cu", "gather_L.cu")
ALL_SOURCES = SOURCES + SOURCES_UNSTRUCTURED
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def included_headers(source: str) -> list[str]:
    """The headers of ``csrc/`` that ``source`` includes, directly or through
    another header, sorted by name (``#include "..."`` lines; system headers
    in angle brackets are not followed)."""
    seen: set[str] = set()
    todo = [source]
    while todo:
        for name in _INCLUDE.findall((CSRC / todo.pop()).read_bytes()):
            name = name.decode()
            if name not in seen and (CSRC / name).is_file():
                seen.add(name)
                todo.append(name)
    return sorted(seen)


def source_digest(source: str) -> str:
    """A hash of what decides the library built from ``source``: its text,
    the headers of ``csrc/`` it includes and the compiler flags.  A header
    that ``source`` does not include leaves its digest as it is."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in included_headers(source):
        digest.update((CSRC / header).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path(source: str) -> Path:
    """Where the library for ``source`` lives, named by its digest."""
    return BUILD_DIR / f"lib{Path(source).stem}-{source_digest(source)}.so"


def _start(source: str):
    """Start nvcc for ``source`` unless its library exists; returns
    ``(target, tmp, process)`` or ``None``."""
    target = library_path(source)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, tmp, proc


def build(sources=SOURCES) -> dict:
    """Compile every source whose library is missing, one nvcc per source,
    all started together.  Returns ``{source: seconds}`` (0.0 when the
    library was already built).  The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``.log``.  Raises RuntimeError with the compiler output on failure."""
    t0 = time.perf_counter()
    jobs = {s: _start(s) for s in sources}
    out = {}
    try:
        for source, job in jobs.items():
            if job is None:
                out[source] = 0.0
                continue
            target, tmp, proc = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):\n{log}")
            target.with_suffix(".log").write_text(log)
            os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
            out[source] = time.perf_counter() - t0
    finally:  # a failed build leaves no compiler running
        for job in jobs.values():
            if job is not None and job[2].poll() is None:
                job[2].kill()
                job[2].wait()
                job[1].unlink(missing_ok=True)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, built first if needed."""
    lib = _libs.get(source)
    if lib is None:
        build((source,))
        lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
    return lib
