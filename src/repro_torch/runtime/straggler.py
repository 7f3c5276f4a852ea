"""Straggler detection + DynIMS-coupled mitigation.

A copy of ``repro/runtime/straggler.py``.

Synchronous data-parallel training runs at the pace of the slowest
worker.  Per-step wall times are kept in a per-worker ring buffer; a
worker whose median exceeds ``threshold`` x the fleet median is flagged.

Mitigation order (the coupling is the paper's own observation -- Fig. 2:
memory pressure is a leading cause of host slowdown):

1. Squeeze the straggler's DynIMS-managed stores (set a ``pressure_factor``
   multiplier on its controller's u_max) -- reclaiming host RAM from the
   cache often un-straggles a swapping host within one control interval.
2. If still slow after ``grace`` checks, report it for eviction: the
   trainer treats it as failed (checkpoint/restart on a degraded mesh).
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional

import numpy as np


def limplock_nodes(per_node_times: np.ndarray,
                   threshold: float = 1.5) -> List[int]:
    """Indices of nodes whose time exceeds ``threshold`` x fleet median.

    The batch (offline) form of :class:`StragglerDetector`: given one
    per-node timing vector -- per-stage drain times from an AppGraph
    run (:func:`repro_torch.core.cluster_sim.simulate_app_graph` /
    ``FleetStats.makespan`` analysis), or any per-worker wall times --
    flag the limplock candidates.  Under barrier stages one flagged
    node bounds the *fleet's* stage time, which is exactly why it is
    worth finding.
    """
    times = np.asarray(per_node_times, np.float64).reshape(-1)
    if times.size < 2:
        return []
    fleet = float(np.median(times))
    if fleet <= 0.0:
        return []
    return [int(i) for i in np.flatnonzero(times > threshold * fleet)]


@dataclass
class StragglerReport:
    worker: str
    median_s: float
    fleet_median_s: float
    action: str                  # "squeeze" | "evict"


class StragglerDetector:
    def __init__(self, window: int = 32, threshold: float = 1.5,
                 grace: int = 3,
                 squeeze_cb: Optional[Callable[[str, float], None]] = None,
                 evict_cb: Optional[Callable[[str], None]] = None):
        self.window = window
        self.threshold = threshold
        self.grace = grace
        self._times: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))
        self._strikes: Dict[str, int] = defaultdict(int)
        self._squeeze_cb = squeeze_cb
        self._evict_cb = evict_cb
        self.reports: List[StragglerReport] = []

    def record(self, worker: str, step_time_s: float) -> None:
        self._times[worker].append(step_time_s)

    def check(self) -> List[StragglerReport]:
        medians = {w: float(np.median(t)) for w, t in self._times.items()
                   if len(t) >= max(4, self.window // 4)}
        if len(medians) < 2:
            return []
        fleet = float(np.median(list(medians.values())))
        out = []
        for w, med in medians.items():
            if med > self.threshold * fleet:
                self._strikes[w] += 1
                if self._strikes[w] >= self.grace:
                    action = "evict"
                    if self._evict_cb:
                        self._evict_cb(w)
                else:
                    action = "squeeze"
                    if self._squeeze_cb:
                        # squeeze proportional to the overshoot
                        self._squeeze_cb(w, fleet / med)
                rep = StragglerReport(w, med, fleet, action)
                out.append(rep)
                self.reports.append(rep)
            else:
                self._strikes[w] = 0
        return out
