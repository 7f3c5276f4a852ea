"""Fault/straggler-driven demand synthesis: runtime churn for the lab.

A copy of ``repro/runtime/churn.py``; it imports the port's own
``core/traces.py``, and ``tests/test_torch_churn.py`` holds its demand
and event log equal to the original's byte for byte.

Bridges the runtime's failure machinery -- :class:`StragglerDetector`
(per-worker step-time rings, squeeze-then-evict mitigation) and
:class:`HeartbeatMonitor` (timeout-based failure detection) -- into a
deterministic demand trace the ScenarioLab sweep engine can replay.
The generator actually *runs* both detectors over a simulated fleet:
straggler nodes report inflated step times, the detector's escalation
(squeeze -> evict) modulates their memory demand, workers in scripted
failure windows stop heartbeating and the monitor's ``check`` collapses
their demand until the heartbeat resumes.

The result is registered in the scenario registry as ``runtime-churn``
(a ``replay``-family :class:`~repro_torch.lab.scenarios.ScenarioSpec`)
-- the path by which fault injection reaches lab sweeps -- and composed
into the multi-tenant ``tenant-churn`` fleet scenario
(:mod:`repro_torch.fleet.scenario`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.traces import GiB, fleet_demand_traces
from .fault import HeartbeatMonitor
from .straggler import StragglerDetector

# Demand modulation the detector/monitor events map to.
SQUEEZE_DEMAND_SPIKE = 1.25    # a swapping straggler's usage inflates
EVICT_DEMAND_DRAIN = 0.6       # evicted worker restarts with a cold heap
FAILED_DEMAND = 0.05           # crashed node: OS baseline only


def churn_demand(
    n_nodes: int = 24,
    n_intervals: int = 480,
    interval_s: float = 0.1,
    *,
    seed: int = 0,
    straggler_frac: float = 0.2,
    slow_factor: float = 2.5,
    failure_frac: float = 0.15,
    failure_len: int = 60,
    check_every: int = 8,
) -> Tuple[np.ndarray, Dict[str, List[int]]]:
    """Synthesize ``(N, T)`` demand (bytes) by running the detectors.

    A fraction of nodes are stragglers: their reported step times are
    ``slow_factor`` x the fleet's, so :class:`StragglerDetector` first
    squeezes them (modeled as a demand spike -- the swap pressure that
    made them slow) and, ``grace`` strikes later, evicts them (demand
    drains to a cold restart).  A disjoint fraction get one scripted
    failure window: they stop heartbeating, :class:`HeartbeatMonitor`
    declares them failed, and their demand collapses to the OS baseline
    until the heartbeat resumes.

    Deterministic given ``seed``.  Returns the demand matrix and an
    event log (``{"squeeze": [...], "evict": [...], "fail": [...],
    "recover": [...]}``, interval indices) the tests assert against.
    """
    rng = np.random.default_rng(seed)
    base = fleet_demand_traces(n_nodes, n_intervals, interval_s, seed=seed,
                               amp_range=(0.85, 1.15))
    workers = [f"node{i}" for i in range(n_nodes)]
    n_strag = max(int(round(straggler_frac * n_nodes)), 1)
    n_fail = max(int(round(failure_frac * n_nodes)), 1)
    perm = rng.permutation(n_nodes)
    stragglers = {workers[i] for i in perm[:n_strag]}
    failers = {workers[i] for i in perm[n_strag:n_strag + n_fail]}
    fail_start = {w: int(rng.integers(n_intervals // 4,
                                      max(n_intervals - failure_len - 1,
                                          n_intervals // 4 + 1)))
                  for w in failers}

    scale = np.ones(n_nodes)
    events: Dict[str, List[int]] = {"squeeze": [], "evict": [],
                                    "fail": [], "recover": []}
    idx = {w: i for i, w in enumerate(workers)}
    tick = {"t": 0}

    def on_squeeze(worker: str, factor: float) -> None:
        # Squeezing the straggler's stores is the *mitigation*; the
        # demand trace models the pressure that triggered it.
        scale[idx[worker]] = SQUEEZE_DEMAND_SPIKE
        events["squeeze"].append(tick["t"])

    def on_evict(worker: str) -> None:
        scale[idx[worker]] = EVICT_DEMAND_DRAIN
        events["evict"].append(tick["t"])

    detector = StragglerDetector(window=16, threshold=1.5, grace=3,
                                 squeeze_cb=on_squeeze, evict_cb=on_evict)
    monitor = HeartbeatMonitor(interval_s=interval_s, timeout_intervals=5)

    def on_fail(worker: str) -> None:
        scale[idx[worker]] = FAILED_DEMAND
        events["fail"].append(tick["t"])

    def on_recover(worker: str) -> None:
        scale[idx[worker]] = 1.0
        events["recover"].append(tick["t"])

    monitor.on_failure(on_fail)
    monitor.on_recovery(on_recover)
    for w in workers:
        monitor.register(w)

    demand = np.empty_like(base)
    base_step = interval_s
    for t in range(n_intervals):
        tick["t"] = t
        now = t * interval_s
        for w in workers:
            i = idx[w]
            jitter = 1.0 + 0.05 * rng.standard_normal()
            step = base_step * max(jitter, 0.1)
            if w in stragglers:
                step *= slow_factor
            detector.record(w, step)
            in_window = (w in failers
                         and fail_start[w] <= t < fail_start[w] + failure_len)
            if not in_window:
                monitor.heartbeat(w, now=now)
        monitor.check(now=now)
        if t % check_every == 0 and t > 0:
            detector.check()
        demand[:, t] = base[:, t] * scale
    return demand, events
