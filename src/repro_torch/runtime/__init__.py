"""Distributed runtime: failure detection, stragglers, chaos, re-mesh.

Copies of ``repro/runtime/{fault,straggler,churn,chaos,elastic}.py``:
the heartbeat monitor, the straggler detector and the churn demand they
drive (the scenario registry replays it as ``runtime-churn``), the
ChaosPlane harness, which injects a seed-deterministic fault schedule
into a live ``MemoryPlane`` or ``FleetPlane``, and the elastic mesh
planner, which picks a (data, model) mesh for the chips that survive.
"""

from .chaos import (ACTUATION_KINDS, ChaosError, ChaosHandle, ChaosSpec,
                    FAULT_KINDS, FaultSpec, InjectedFault, TELEMETRY_KINDS,
                    inject)
from .churn import churn_demand
from .elastic import ElasticMeshPlanner, MeshPlan
from .fault import HeartbeatMonitor, WorkerState
from .straggler import StragglerDetector, limplock_nodes

__all__ = ["ACTUATION_KINDS", "ChaosError", "ChaosHandle", "ChaosSpec",
           "ElasticMeshPlanner", "FAULT_KINDS", "FaultSpec",
           "HeartbeatMonitor", "InjectedFault", "MeshPlan",
           "StragglerDetector", "TELEMETRY_KINDS", "WorkerState",
           "churn_demand", "inject", "limplock_nodes"]
