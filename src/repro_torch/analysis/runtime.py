"""PlaneCheck runtime sanitizers for the port: build counters and a
sync guard (the counterpart of ``repro.analysis.runtime``).

* **Build counters** -- :func:`record_trace` counts one compile of a
  call site keyed by ``(name, dims)``.  Eager torch traces nothing, so
  nothing retraces; what the port does compile is a kernel library
  (``kernels/_build.py::load_library`` records ``kernels.build`` with
  the library and a digest of its source and flags).  A key counted
  twice, :func:`excess_traces`, is a library built or loaded twice in
  one process: the port's "retrace".

* **Sync guard** -- :func:`dispatch_guard` runs its block under
  ``torch.cuda.set_sync_debug_mode("error")`` when sanitizers are
  enabled, so a host sync inside a dispatch loop (``.item()``, a
  blocking copy to or from the host) raises instead of serializing
  every launch, and restores the previous mode on exit.  The mode is
  the process's, not the thread's: enable the sanitizers where no other
  thread syncs on the card meanwhile.

Both do nothing unless ``PLANECHECK_SANITIZERS`` is set to a truthy
value (``1``/``true``/``yes``/``on``), so production hot paths pay
nothing.  torch is imported inside :func:`dispatch_guard` only.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Optional, Tuple

_ENV_VAR = "PLANECHECK_SANITIZERS"

_counts_lock = threading.Lock()
_counts: Dict[Tuple[str, Tuple[Tuple[str, object], ...]], int] = {}


def sanitizers_enabled() -> bool:
    """Are the runtime sanitizers switched on (``PLANECHECK_SANITIZERS``)?"""
    return os.environ.get(_ENV_VAR, "").strip().lower() in (
        "1", "true", "yes", "on")


def record_trace(name: str, **dims) -> None:
    """Count one compile of the call site keyed by ``(name, dims)``.

    A no-op with sanitizers off.  Call it where the compile happens
    (once per cached build), with the dims that key the cache.
    """
    if not sanitizers_enabled():
        return
    key = (name, tuple(sorted(dims.items())))
    with _counts_lock:
        _counts[key] = _counts.get(key, 0) + 1


def trace_counts(prefix: Optional[str] = None) -> Dict[str, int]:
    """Snapshot of compile counts, formatted ``name{k=v,...}`` -> n."""
    with _counts_lock:
        items = list(_counts.items())
    out = {}
    for (name, dims), n in items:
        if prefix is not None and not name.startswith(prefix):
            continue
        label = name
        if dims:
            label += "{" + ",".join(f"{k}={v}" for k, v in dims) + "}"
        out[label] = n
    return out


def reset_trace_counts() -> None:
    with _counts_lock:
        _counts.clear()


def excess_traces(prefix: str) -> Dict[str, int]:
    """Keys under ``prefix`` compiled more than once."""
    return {k: n for k, n in trace_counts(prefix).items() if n > 1}


@contextlib.contextmanager
def dispatch_guard():
    """Make every host sync inside the block raise (when enabled).

    With sanitizers off, or with no card, this does nothing.  Callers
    stage every operand on the device before entering.
    """
    if not sanitizers_enabled():
        yield
        return
    import torch
    if not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)
