"""PlaneCheck for the port: static analysis of its two fragile
invariants (the counterpart of ``repro.analysis``).

* :mod:`.tracelint` -- host syncs, host casts, Python control flow on a
  tensor's value and per-call host-to-device constructions inside the
  hot loops marked ``# planecheck: hot-loop`` and every package
  function they reach (rules ``PC-H001`` .. ``PC-H004``).
* :mod:`.locklint` -- a copy of JAX's: lock-order inversions, guarded
  fields mutated without their lock, blocking work under a lock (rules
  ``PC-L001`` .. ``PC-L003``).
* :mod:`.runtime` -- the runtime sanitizers: kernel-build counters and
  a sync guard for the dispatch loops, both enabled by
  ``PLANECHECK_SANITIZERS=1``.

Pure stdlib (``ast``); importing this package imports neither torch nor
anything else of the port.  Run ``python -m repro_torch.analysis --check
src/repro_torch``: findings not listed in
``PLANECHECK_TORCH_BASELINE.json`` (each entry justified) fail the
gate.  Suppress a single line with ``# planecheck: ignore[RULE]``.
"""

from .findings import Baseline, Finding, RULES
from .locklint import analyze_locks
from .tracelint import analyze_hot_loops

__all__ = [
    "Baseline",
    "Finding",
    "RULES",
    "analyze_hot_loops",
    "analyze_locks",
    "run",
]


def run(paths, baseline=None):
    """Analyze ``paths`` with both pass families.

    Returns ``(findings, new)`` where ``new`` is the subset not covered
    by ``baseline`` (all of them when no baseline is given).
    """
    findings = sorted(
        analyze_hot_loops(paths) + analyze_locks(paths),
        key=lambda f: (f.file, f.line, f.rule))
    if baseline is None:
        return findings, list(findings)
    return findings, [f for f in findings if not baseline.covers(f)]
