"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles ``csrc/sweep.cu`` into a shared library with a plain
C interface (no PyTorch headers, so the build takes seconds), and
``ctypes`` loads it.  The library goes to ``build/kernels/`` at the root
of the checkout, named by a hash of the source and the flags, so a
changed source builds anew and an unchanged one is loaded as it is.
Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# sm_90a for Hopper; -fmad=false keeps every product and sum separately
# rounded, as the plain PyTorch versions round them (no fast math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_s: float          # seconds spent in nvcc (0.0 when reused)
    log: str                # nvcc / ptxas output (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return path


def _declare(lib: ctypes.CDLL) -> None:
    from .sweep import _SweepConsts

    fn = lib.dynims_sweep_segment
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 4
                   + [ctypes.POINTER(_SweepConsts), ctypes.c_void_p])
    fn.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library(source: str = "sweep.cu") -> Library:
    """Build ``csrc/<source>`` if needed and load it (once per process)."""
    src = _CSRC / source
    digest = hashlib.sha1(src.read_bytes()
                          + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    build_s, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return Library(lib=lib, path=out, build_s=build_s, log=log)
