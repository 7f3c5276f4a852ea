"""Distributed runtime: failure detection, stragglers, chaos.

Copies of ``repro/runtime/{fault,straggler,churn,chaos}.py``: the
heartbeat monitor, the straggler detector and the churn demand they
drive (the scenario registry replays it as ``runtime-churn``), and the
ChaosPlane harness, which injects a seed-deterministic fault schedule
into a live ``MemoryPlane`` or ``FleetPlane``.  The elastic mesh
planner comes with the sharding substrate (ROADMAP A5.4).
"""

from .chaos import (ACTUATION_KINDS, ChaosError, ChaosHandle, ChaosSpec,
                    FAULT_KINDS, FaultSpec, InjectedFault, TELEMETRY_KINDS,
                    inject)
from .churn import churn_demand
from .fault import HeartbeatMonitor, WorkerState
from .straggler import StragglerDetector, limplock_nodes

__all__ = ["ACTUATION_KINDS", "ChaosError", "ChaosHandle", "ChaosSpec",
           "FAULT_KINDS", "FaultSpec", "HeartbeatMonitor", "InjectedFault",
           "StragglerDetector", "TELEMETRY_KINDS", "WorkerState",
           "churn_demand", "inject", "limplock_nodes"]
