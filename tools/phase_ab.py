#!/usr/bin/env python3
"""Time phases of one checkout's ``chip_smoke.py``, for an A/B on one card.

    python3 tools/phase_ab.py CHECKOUT PHASE [PHASE ...]

On the card only.  PHASE is ``16c`` (``halving_tune``'s wall time on
the card), ``16e`` (the graph instance's kernel time at each of its
fleets) or ``24b`` (the node-sharded AppGraph route and ``devices=1``,
ms end to end on the host clock).  The script imports CHECKOUT's
``chip_smoke.py`` and package, builds its sweep library, runs each
phase twice, and prints one line ``AB <checkout> <json>``.  To compare
two trees, unpack the parent with ``git archive`` into a gitignored
directory and run this once a checkout, one process each, in the order
parent, change, change, parent within one call.
"""

import json
import os
import sys

CHECKOUT = os.path.abspath(sys.argv[1])
PHASES = sys.argv[2:]
REPS = 2
sys.path[:0] = [os.path.join(CHECKOUT, "src"), CHECKOUT]
sys.argv = sys.argv[:1]        # chip_smoke reads its own arguments
os.chdir(CHECKOUT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def run(phase):
    """One run of ``phase``: its times, by name."""
    if phase == "16c":
        return {"wall_s": cs.phase16c()["wall_s"]}
    if phase == "16e":
        return {tag: r["ms"] for tag, r in cs.phase16e().items()}
    if phase == "24b":
        b = cs.phase24b(float("nan"))
        return {"route_ms": b["route_ms"], "devices1_ms": b["devices1_ms"]}
    raise SystemExit(f"unknown phase {phase!r}: 16c, 16e or 24b")


def main() -> int:
    if not PHASES:
        raise SystemExit(__doc__)
    _build.load_library("sweep.cu")
    out = {p: [run(p) for _ in range(REPS)] for p in PHASES}
    print("AB", os.path.basename(CHECKOUT), json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
