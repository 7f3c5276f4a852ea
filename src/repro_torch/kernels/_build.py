"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles each ``csrc/<name>.cu`` into a shared library of its
own with a plain C interface (no PyTorch headers, so a build takes
seconds), and ``ctypes`` loads it.  :data:`LIBRARIES` gives each source
its flags and the C function it exports with its argument types.
The library goes to ``build/kernels/`` at the root of the checkout,
named by a hash of the source and its flags, so a changed source builds
anew and an unchanged one is loaded as it is.  Nothing here runs at
import: the CPU tests import every module on a machine with no
``nvcc``.
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
from typing import Callable, Dict, Tuple

from ..analysis.runtime import record_trace

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# The sweep's flags: sm_90a for Hopper; -fmad=false keeps every product
# and sum separately rounded, as the plain PyTorch version rounds them
# (no fast math).  They enter the sweep library's hash, so they stay as
# they are.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# The attention kernels' flags: the same without -fmad=false.  They are
# held to their plain versions by a tolerance, not bit for bit, so nvcc
# may contract multiply-adds.
ATTENTION_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")


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


def _sweep_argtypes():
    from .sweep import _SweepConsts
    # (paper_law, unit_occupancy, has_cache, bf16, demand, lp, np_rows,
    #  alive, state_in, state_out, hist, T, L, N, t0, consts, stream)
    return ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 4
            + [ctypes.POINTER(_SweepConsts), ctypes.c_void_p])


def _decode_argtypes():
    # (q_bf16, kv_bf16, q, k, v, lengths, out, workspace, counters, B, H,
    #  KV, S, hd, window, splits, stream)
    return ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _ssm_argtypes():
    # (bf16, decay, drive, h0, out, B, S, C, N, stream)
    return ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])


def _flash_argtypes():
    # (bf16, q, k, v, out, B, Sq, Skv, H, KV, hd, causal, window, stream)
    return ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class LibrarySpec:
    """How one source is built and the C function its library exports."""

    flags: Tuple[str, ...]
    symbol: str
    # gives the function's ctypes argument types; called at load, so a
    # wrapper's structs import lazily
    argtypes: Callable[[], list]


LIBRARIES: Dict[str, LibrarySpec] = {
    "sweep.cu": LibrarySpec(NVCC_FLAGS, "dynims_sweep_segment",
                            _sweep_argtypes),
    "decode_attention.cu": LibrarySpec(
        ATTENTION_FLAGS, "dynims_decode_attention", _decode_argtypes),
    "flash_attention.cu": LibrarySpec(
        ATTENTION_FLAGS, "dynims_flash_attention", _flash_argtypes),
    # the sweep's flags: the scan is held to its plain version bit for bit
    "ssm_scan.cu": LibrarySpec(NVCC_FLAGS, "dynims_ssm_scan", _ssm_argtypes),
}


def _declare(lib: ctypes.CDLL, spec: LibrarySpec) -> None:
    fn = getattr(lib, spec.symbol)
    fn.argtypes = spec.argtypes()
    fn.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library(source: str = "sweep.cu") -> Library:
    """Build ``csrc/<source>`` if needed and load it (once per process).

    Sources are independent, so several may build at once from threads
    (``nvcc`` runs in a subprocess).
    """
    if source not in LIBRARIES:
        raise KeyError(f"no library is declared for {source!r}; known: "
                       f"{sorted(LIBRARIES)}")
    spec = LIBRARIES[source]
    src = _CSRC / source
    digest = hashlib.sha1(src.read_bytes()
                          + repr(spec.flags).encode()).hexdigest()[:16]
    # once per library and flags in a process, unless the cache is lost
    record_trace("kernels.build", library=src.stem, digest=digest)
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    build_s, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *spec.flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib, spec)
    return Library(lib=lib, path=out, build_s=build_s, log=log)
