"""DynIMS core of the port: the paper's closed loop as a library.

The counterpart of ``repro/core``, module for module:

* :mod:`.monitor`    -- monitoring agents (collectd analogue)
* :mod:`.bus`        -- messaging bus (Kafka analogue)
* :mod:`.stream`     -- stream aggregation (Flink analogue)
* :mod:`.control`    -- the Eq. 1 feedback law + stability analysis
* :mod:`.controller` -- the memory controller service (Vert.x analogue)
* :mod:`.plane`      -- **MemoryPlane**, the declarative control-plane
  API (PlaneSpec -> MemoryPlane facade)
* :mod:`.eviction`   -- LFU/LRU/FIFO/adaptive eviction policies
* :mod:`.store`      -- managed stores: ShardCache, KVBlockPool
* :mod:`.traces`     -- HPCC/HPL workload models (paper Figs 1-2)
* :mod:`.cluster_sim`-- discrete-event reproduction of Sec. IV (the
  paper's 5-node testbed over a scalar-backend plane), and
  :func:`simulate_fleet` at fleet scale

The plane's two backends: the scalar reference controller
(:class:`DynIMSController`, host float64) and the batched
:class:`ArrayController` (one fused ``vectorized_step`` per interval on
the plane's device, the card by default).
"""

from .bus import MessageBus
from .cluster_sim import (SimConfig, SimResult, make_cache_parity_config,
                          make_paper_config, paper_controller_params,
                          run_paper_experiment, simulate, simulate_app_graph,
                          simulate_fleet)
from .control import (ControllerParams, GiB, Signal, closed_loop_eigenvalue,
                      control_step, fixed_point_capacity, is_stable,
                      settling_time, simulate_saturated_loop,
                      vectorized_step)
from .controller import (ActionHistory, CONTROL_TOPIC, ControlAction,
                         DynIMSController)
from .eviction import (AdaptivePolicy, FIFOPolicy, LFUPolicy, LRUPolicy,
                       make_policy)
from .monitor import (DeviceMemoryMonitor, HostMemoryMonitor, MemorySample,
                      MonitorFault, SimulatedMonitor)
from .plane import (ArrayController, CapturedTrace, ControlPlane,
                    DEFAULT_TRACE_CAPACITY, FaultEvent, FaultLog,
                    HealthPolicy, HealthReport, MemoryPlane, NodeHealth,
                    NodeHealthInfo, NodeSpec, PlaneSpec, StoreSpec,
                    TraceRecorder, make_fused_step, validate_sample)
from .store import (EvictionReport, KVBlockPool, ManagedStore, ShardCache,
                    StoreRegistry, StoreStats)
from .stream import AGG_TOPIC, RAW_TOPIC, AggregatedMetrics, MetricAggregator

__all__ = [
    "AGG_TOPIC", "ActionHistory", "AdaptivePolicy", "AggregatedMetrics",
    "ArrayController", "CONTROL_TOPIC", "CapturedTrace", "ControlAction",
    "ControlPlane", "ControllerParams", "DEFAULT_TRACE_CAPACITY",
    "DeviceMemoryMonitor", "DynIMSController", "TraceRecorder",
    "EvictionReport", "FIFOPolicy", "FaultEvent", "FaultLog", "GiB",
    "HealthPolicy", "HealthReport", "HostMemoryMonitor",
    "KVBlockPool", "LFUPolicy", "LRUPolicy",
    "ManagedStore", "MemoryPlane", "MemorySample", "MessageBus",
    "MetricAggregator", "MonitorFault", "NodeHealth", "NodeHealthInfo",
    "NodeSpec", "PlaneSpec", "RAW_TOPIC",
    "ShardCache", "Signal", "SimConfig", "SimResult", "SimulatedMonitor",
    "StoreRegistry",
    "StoreSpec", "StoreStats", "closed_loop_eigenvalue",
    "control_step", "fixed_point_capacity",
    "is_stable", "make_cache_parity_config", "make_fused_step",
    "make_paper_config", "make_policy", "paper_controller_params",
    "run_paper_experiment", "settling_time", "simulate",
    "simulate_app_graph", "simulate_fleet", "simulate_saturated_loop",
    "validate_sample", "vectorized_step",
]
