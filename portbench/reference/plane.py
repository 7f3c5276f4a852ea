"""Plain NumPy replay of the DynIMS control law (paper Eq. 1).

For each recorded decision, from the utilization the plane observed and
the capacity it held before it, the law gives the next capacity:

    err  = v / M - r0
    u'   = clip(u - lam_eff * v * err / r0, u_min, u_max)

with ``lam_eff`` the grant gain ``lam_grant`` where err < 0 (when the
configuration states one) and ``lam`` otherwise, in float64.  The
replay follows the program's own sequence of capacities (each decision
starts from the one before it), so it checks each decision, not the
whole trajectory from its start.  :func:`law_gap` judges the decisions
the law makes before its clip alone: a plane that clips every decision
to ``u_max`` would pass :func:`replay_gap` with any gains.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np


def law(decisions: Iterable[tuple], plane: dict,
        total_memory: float) -> tuple:
    """(u_next as the program decided, the law's u' before the clip) of
    ``decisions`` ((u_prev, u_next, utilization) each), in float64."""
    d = np.asarray(list(decisions), dtype=np.float64).reshape(-1, 3)
    u, u_next, util = d[:, 0], d[:, 1], d[:, 2]
    r0, lam = plane["r0"], plane["lam"]
    grant = plane.get("lam_grant")
    v = util * total_memory
    err = v / total_memory - r0
    lam_eff = np.where(err < 0, grant if grant is not None else lam, lam)
    return u_next, u - lam_eff * v * err / r0


def _gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))


def replay_gap(decisions: Iterable[tuple], plane: dict,
               total_memory: float) -> float:
    """Largest |u' - the program's u'| over ``decisions`` ((u_prev,
    u_next, utilization) each), as a share of u' (of a byte at least);
    0.0 when there are none."""
    got, raw = law(decisions, plane, total_memory)
    if not len(got):
        return 0.0
    return _gap(got, np.clip(raw, plane["u_min"], plane["u_max"]))


def law_gap(decisions: Iterable[tuple], plane: dict,
            total_memory: float) -> float:
    """:func:`replay_gap` over the decisions whose u' before the clip lies
    inside (u_min, u_max), where the gains and r0 decide it; infinite
    when there are none."""
    got, raw = law(decisions, plane, total_memory)
    inside = (raw > plane["u_min"]) & (raw < plane["u_max"])
    if not inside.any():
        return float("inf")
    return _gap(got[inside], raw[inside])
