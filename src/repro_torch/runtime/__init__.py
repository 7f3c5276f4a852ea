"""Distributed runtime: failure detection and stragglers.

Copies of ``repro/runtime/{fault,straggler,churn}.py``: the heartbeat
monitor, the straggler detector and the churn demand they drive, which
the scenario registry replays as ``runtime-churn``.  The chaos harness
(ROADMAP A8) and the elastic mesh planner (ROADMAP A5) are not ported
yet.
"""

from .churn import churn_demand
from .fault import HeartbeatMonitor, WorkerState
from .straggler import StragglerDetector, limplock_nodes

__all__ = ["HeartbeatMonitor", "StragglerDetector", "WorkerState",
           "churn_demand", "limplock_nodes"]
