"""MemoryPlane: the declarative DynIMS control-plane API.

The port of ``repro/core/plane.py``.  The paper's DynIMS is *one*
controller service adapting in-memory storage for all nodes from a
single feedback loop (Eq. 1).  This module is that service's API
surface: consumers declare *what* they manage -- nodes, monitors,
stores, eviction policy, signal, transport -- in a :class:`PlaneSpec`
and hand it to a :class:`MemoryPlane`; they never touch
bus/aggregator/controller internals.

    spec = PlaneSpec(
        params=hbm_pool_params(),
        nodes=(NodeSpec("serve0", monitor=DeviceMemoryMonitor(),
                        stores=(StoreSpec(pool, max_bytes=pool_bytes),)),),
    )
    with MemoryPlane(spec) as plane:      # start()s the real-time loop
        ...                               # or: plane.tick() per interval
    print(plane.actions(node="serve0", limit=8))

Two controller backends sit behind the facade:

* ``backend="scalar"`` -- :class:`~repro_torch.core.controller.DynIMSController`,
  the host float64 per-node reference implementation.
* ``backend="array"`` (default) -- :class:`ArrayController`, which packs
  every attached node's ``(u, v, v_prev, M, u_min, u_max)`` into one
  float32 staging array and runs the fleet's Eq. 1 as one fused
  ``vectorized_step`` on ``PlaneSpec.device`` (the card by default).
  On the CPU its ``u_next`` equals the JAX package's ``ArrayController``
  bit for bit.

The health layer (telemetry validation, stale holdover, fail-static
quarantine, actuation backoff, the bounded fault log) and the ReplayLoop
capture ring (:class:`TraceRecorder`, :class:`CapturedTrace`) are
copies; hot-swapping gains with :meth:`MemoryPlane.swap_params` lands at
an interval boundary and stamps every action with the parameter epoch.

``ControlPlane`` remains importable (also via
``repro_torch.core.controller``) as a deprecated shim over the scalar
backend.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import math
import threading
import time
import warnings
import zlib
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .bus import MessageBus
from .control import ControllerParams, Signal, f32, vectorized_step
from .controller import (ActionHistory, CONTROL_TOPIC, ControlAction,
                         DEFAULT_HISTORY, DynIMSController)
from .monitor import MemoryMonitor
from .monitor import MemorySample
from .store import ManagedStore, ShardCache, StoreRegistry
from .stream import AGG_TOPIC, RAW_TOPIC, AggregatedMetrics, MetricAggregator

BACKENDS = ("array", "scalar")

#: Default ring-buffer capacity (control intervals) of a TraceRecorder.
DEFAULT_TRACE_CAPACITY = 4096


# ---------------------------------------------------------------------------
# ReplayLoop: live-trace capture
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class CapturedTrace:
    """A dense snapshot of what a running plane observed and decided.

    All arrays are numpy, node-major: ``(N, T)`` over the captured
    control intervals (``total_memory`` is ``(N,)``).  ``demand`` is the
    compute tenant's usage (``used - storage_used``, bytes) -- the
    quantity a replay scenario feeds back through the sweep engine;
    ``utilization`` is the observed ``v / M``; ``grant`` the
    controller's post-decision capacity ``u``; ``residency`` the bytes
    the managed stores actually held (the CacheLoop observable).

    Serializable: :meth:`save` writes one compressed ``.npz``,
    :meth:`load` restores it bit-for-bit.
    """

    nodes: Tuple[str, ...]
    interval_s: float
    demand: np.ndarray
    utilization: np.ndarray
    grant: np.ndarray
    residency: np.ndarray
    total_memory: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.demand.shape[0]

    @property
    def n_intervals(self) -> int:
        return self.demand.shape[1]

    @property
    def duration_s(self) -> float:
        return self.n_intervals * self.interval_s

    def utilization_p99(self) -> float:
        """Observed fleet p99 utilization (replay-fidelity yardstick)."""
        return float(np.quantile(self.utilization, 0.99))

    def has_residency(self) -> bool:
        """Did the managed stores ever hold bytes during the capture?"""
        return bool(np.nanmax(self.residency, initial=0.0) > 0.0)

    def save(self, path) -> None:
        np.savez_compressed(
            path, nodes=np.asarray(self.nodes, dtype=np.str_),
            interval_s=np.float64(self.interval_s), demand=self.demand,
            utilization=self.utilization, grant=self.grant,
            residency=self.residency, total_memory=self.total_memory)

    @classmethod
    def load(cls, path) -> "CapturedTrace":
        with np.load(path, allow_pickle=False) as z:
            return cls(nodes=tuple(str(n) for n in z["nodes"]),
                       interval_s=float(z["interval_s"]),
                       demand=z["demand"], utilization=z["utilization"],
                       grant=z["grant"], residency=z["residency"],
                       total_memory=z["total_memory"])


class TraceRecorder:
    """Bounded, thread-safe ring buffer of per-tick fleet snapshots.

    :meth:`MemoryPlane.tick` feeds it one record per control interval
    (the interval's monitor samples plus the actions the controller
    produced); the ring retains the last ``capacity`` intervals, so a
    long-running deployment pays O(capacity * fleet) memory however
    long it runs.  :meth:`snapshot` densifies the ring into a
    :class:`CapturedTrace`; nodes that joined late or skipped an
    interval are forward/backward-filled so the arrays stay rectangular.
    """

    def __init__(self, capacity: int = DEFAULT_TRACE_CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def record(self, samples: Dict[str, MemorySample],
               actions: List[ControlAction]) -> None:
        """Append one control interval's observations and decisions."""
        grant = {a.node: a.u_next for a in actions}
        tick = {
            node: (max(s.used - s.storage_used, 0.0), s.used, s.total,
                   grant.get(node, np.nan), s.storage_used)
            for node, s in samples.items()}
        with self._lock:
            self._ring.append(tick)

    def snapshot(self, interval_s: float = 0.1) -> CapturedTrace:
        """Densify the ring into a :class:`CapturedTrace` (numpy)."""
        with self._lock:
            ring = list(self._ring)
        if not ring:
            raise ValueError("nothing recorded yet")
        names = sorted({n for tick in ring for n in tick})
        n, t = len(names), len(ring)
        idx = {name: i for i, name in enumerate(names)}
        demand = np.full((n, t), np.nan)
        usage = np.full((n, t), np.nan)
        total = np.full((n, t), np.nan)
        grant = np.full((n, t), np.nan)
        residency = np.full((n, t), np.nan)
        for j, tick in enumerate(ring):
            for name, (d, v, m, u, res) in tick.items():
                i = idx[name]
                demand[i, j] = d
                usage[i, j] = v
                total[i, j] = m
                grant[i, j] = u
                residency[i, j] = res
        for arr in (demand, usage, total, grant, residency):
            _fill_gaps(arr)
        with np.errstate(invalid="ignore", divide="ignore"):
            utilization = np.where(total > 0, usage / total, 0.0)
        return CapturedTrace(
            nodes=tuple(names), interval_s=float(interval_s),
            demand=demand, utilization=utilization, grant=grant,
            residency=residency, total_memory=total[:, -1].copy())


def _fill_gaps(arr: np.ndarray) -> None:
    """In-place forward- then backward-fill NaN runs along axis 1."""
    n, t = arr.shape
    for i in range(n):
        row = arr[i]
        mask = np.isnan(row)
        if not mask.any():
            continue
        if mask.all():
            row[:] = 0.0
            continue
        valid = np.flatnonzero(~mask)
        # forward fill from the previous valid sample, backward fill the
        # leading gap from the first one
        fill_idx = np.clip(
            np.maximum.accumulate(np.where(mask, -1, np.arange(t))),
            valid[0], None)
        row[:] = row[fill_idx]


# ---------------------------------------------------------------------------
# ChaosPlane: telemetry health, fault log, fail-static degradation
# ---------------------------------------------------------------------------
#
# DynIMS's contract is that dynamic control must never be *worse* than
# the static allocation it replaces (PAPER.md Sec. III): a late, frozen,
# or non-finite observation acted on verbatim is exactly the
# swap-storming failure the feedback model exists to prevent.  The
# health layer below sits between the monitors and the law:
#
#     healthy --bad sample--> stale (publish last-good holdover)
#     stale   --stale_budget exceeded--> quarantined (fail-static pin)
#     quarantined --rejoin_intervals consecutive good--> healthy
#
# A quarantined node is pinned to the conservative fail-static grant
# derived from ``u_min`` (the paper's most compute-protective static
# configuration; Liang et al. arxiv 1712.05554 make the same move when
# the workload model is unreliable) and its telemetry stops feeding the
# law until the rejoin hysteresis clears.  Actuation failures never
# abort an interval: they degrade to bounded, jittered exponential
# backoff in *intervals* (no sleeping under any lock).

#: Default bound on retained fault events (per plane).
DEFAULT_FAULT_LOG = 256


class NodeHealth(enum.Enum):
    """Per-node telemetry health state."""

    HEALTHY = "healthy"
    STALE = "stale"
    QUARANTINED = "quarantined"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Degradation policy of a :class:`MemoryPlane`.

    Fields:
      stale_budget:     consecutive bad intervals a node may ride on its
                        last-good holdover before quarantine.
      rejoin_intervals: consecutive good samples a quarantined node must
                        deliver before re-entering closed-loop control
                        (rejoin hysteresis -- a flapping sensor stays
                        quarantined).
      fail_static_fraction: where the fail-static pin sits in
                        ``[u_min, u_max]``; 0.0 (default) pins to
                        ``u_min``, the most conservative static grant.
      actuation_retries: consecutive actuation failures before the node
                        is reported actuation-degraded (retries continue
                        at the capped backoff).
      retry_backoff_cap: max backoff between actuation retries, in
                        control intervals (base 1, doubling, jittered).
      sample_deadline_s: monitor sample slower than this is treated as
                        stale -- a late observation is a wrong one
                        (paper Sec. II.B).  None disables.
      tick_deadline_s:  whole-tick watchdog; a slower interval is logged
                        as a ``tick-deadline`` fault.  None disables.
      fault_log:        bound on retained :class:`FaultEvent` records.
      seed:             seeds the retry jitter (deterministic tests).
    """

    stale_budget: int = 3
    rejoin_intervals: int = 5
    fail_static_fraction: float = 0.0
    actuation_retries: int = 3
    retry_backoff_cap: int = 16
    sample_deadline_s: Optional[float] = None
    tick_deadline_s: Optional[float] = None
    fault_log: int = DEFAULT_FAULT_LOG
    seed: int = 0

    def __post_init__(self) -> None:
        if self.stale_budget < 1:
            raise ValueError("stale_budget must be >= 1")
        if self.rejoin_intervals < 1:
            raise ValueError("rejoin_intervals must be >= 1")
        if not 0.0 <= self.fail_static_fraction <= 1.0:
            raise ValueError("fail_static_fraction must be in [0, 1]")
        if self.actuation_retries < 1:
            raise ValueError("actuation_retries must be >= 1")
        if self.retry_backoff_cap < 1:
            raise ValueError("retry_backoff_cap must be >= 1")
        if self.fault_log < 1:
            raise ValueError("fault_log must be >= 1")

    def fail_static_grant(self, u_min: float, u_max: float) -> float:
        """The static capacity a quarantined node is pinned to."""
        return u_min + self.fail_static_fraction * (u_max - u_min)

    def replace(self, **kw) -> "HealthPolicy":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One observed fault, mirrored after :class:`ControlAction`."""

    kind: str                 # sample-error | telemetry-invalid | ...
    node: Optional[str]
    tick: int                 # plane tick index when observed
    timestamp: float
    detail: str = ""


class FaultLog:
    """Bounded, thread-safe log of fault events (cf. ActionHistory)."""

    def __init__(self, maxlen: int = DEFAULT_FAULT_LOG):
        if maxlen < 1:
            raise ValueError("fault log bound must be >= 1")
        self.maxlen = maxlen
        self._lock = threading.Lock()
        self._log: deque = deque(maxlen=maxlen)     # guarded-by: _lock
        self._counts: Dict[str, int] = {}           # guarded-by: _lock

    def append(self, event: FaultEvent) -> None:
        with self._lock:
            self._log.append(event)
            self._counts[event.kind] = self._counts.get(event.kind, 0) + 1

    def snapshot(self, kind: Optional[str] = None,
                 node: Optional[str] = None,
                 limit: Optional[int] = None) -> List[FaultEvent]:
        with self._lock:
            out = list(self._log)
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        if node is not None:
            out = [e for e in out if e.node == node]
        if limit is not None:
            out = out[-limit:]
        return out

    def counts(self) -> Dict[str, int]:
        """Total events seen per kind (including evicted ones)."""
        with self._lock:
            return dict(self._counts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._log)


def validate_sample(s: MemorySample) -> Optional[str]:
    """Why ``s`` must not reach the control law, or None if it may.

    Rejects non-finite, non-positive-total, and negative telemetry --
    the law divides by ``total`` and feeds ``used`` straight into the
    grant, so any of these would poison the fleet state arrays.
    """
    for name in ("used", "total", "storage_used", "swap_used"):
        v = getattr(s, name)
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            return f"non-finite {name}={v!r}"
    if s.total <= 0:
        return f"non-positive total={s.total!r}"
    if s.used < 0 or s.storage_used < 0 or s.swap_used < 0:
        return (f"negative telemetry used={s.used} "
                f"storage={s.storage_used} swap={s.swap_used}")
    return None


class _NodeHealthState:
    """Mutable per-node health bookkeeping (guarded by the plane)."""

    __slots__ = ("state", "last_good", "stale_ticks", "good_streak",
                 "faults", "pin_grant")

    def __init__(self, pin_grant: float):
        self.state = NodeHealth.HEALTHY
        self.last_good: Optional[MemorySample] = None
        self.stale_ticks = 0
        self.good_streak = 0
        self.faults = 0
        self.pin_grant = float(pin_grant)


class _ResilientRegistry:
    """Actuation shield: a StoreRegistry whose failures never escape.

    A raising ``set_capacity`` (hung store, injected chaos, dead
    transport) must not abort the whole fleet's interval, and must not
    be hammered every tick while it is down.  Failures degrade to
    bounded retry with exponential backoff *measured in apply calls*
    (one per control interval) plus deterministic jitter -- nothing
    ever sleeps, so the plane's tick path stays lock-discipline clean.
    After ``actuation_retries`` consecutive failures the registry is
    reported degraded and keeps retrying at the capped backoff.
    """

    def __init__(self, inner: StoreRegistry, node: str,
                 policy: HealthPolicy, fault_log: FaultLog,
                 clock: Optional[Callable[[], int]] = None):
        self._inner = inner          # swapped by chaos injection proxies
        self._node = node
        self._policy = policy
        self._fault_log = fault_log
        self._clock = clock or (lambda: -1)
        self._lock = threading.Lock()
        self._failures = 0           # guarded-by: _lock (consecutive)
        self._skip = 0               # guarded-by: _lock (backoff budget)
        self._pending: Optional[float] = None   # guarded-by: _lock
        self._degraded = False       # guarded-by: _lock
        self._rng = np.random.default_rng(
            [policy.seed, zlib.crc32(node.encode())])  # guarded-by: _lock

    # -- delegation ---------------------------------------------------------
    def register(self, store: ManagedStore, max_bytes: float) -> None:
        self._inner.register(store, max_bytes)

    def stores(self) -> List[ManagedStore]:
        return self._inner.stores()

    def total_used(self) -> float:
        return self._inner.total_used()

    def total_capacity(self) -> float:
        return self._inner.total_capacity()

    # -- resilient actuation ------------------------------------------------
    def apply_capacity(self, u: float) -> list:
        with self._lock:
            if self._skip > 0:
                self._skip -= 1
                self._pending = float(u)
                return []
            inner = self._inner
        try:
            reports = inner.apply_capacity(u)
        except Exception as exc:
            self._on_failure(u, exc)
            return []
        with self._lock:
            recovered = self._failures > 0
            self._failures = 0
            self._skip = 0
            self._pending = None
            self._degraded = False
        if recovered:
            self._fault_log.append(FaultEvent(
                kind="actuation-recovered", node=self._node,
                tick=self._clock(), timestamp=time.time()))
        return reports

    def _on_failure(self, u: float, exc: BaseException) -> None:
        with self._lock:
            self._failures += 1
            backoff = min(2 ** (self._failures - 1),
                          self._policy.retry_backoff_cap)
            # jitter in [0, backoff): desynchronizes a fleet of nodes
            # whose stores all died in the same interval
            self._skip = backoff - 1 + int(self._rng.integers(0, backoff))
            self._pending = float(u)
            newly_degraded = (not self._degraded and
                              self._failures > self._policy.actuation_retries)
            if newly_degraded:
                self._degraded = True
            failures = self._failures
        self._fault_log.append(FaultEvent(
            kind="actuation-error", node=self._node, tick=self._clock(),
            timestamp=time.time(),
            detail=f"{type(exc).__name__}: {exc} (failure #{failures})"))
        if newly_degraded:
            self._fault_log.append(FaultEvent(
                kind="actuation-degraded", node=self._node,
                tick=self._clock(), timestamp=time.time(),
                detail=f"{failures} consecutive failures; retrying at "
                       f"<= {self._policy.retry_backoff_cap}-interval "
                       "backoff"))

    def status(self) -> Tuple[int, bool]:
        """(consecutive failures, degraded?) for the health report."""
        with self._lock:
            return self._failures, self._degraded


@dataclasses.dataclass(frozen=True)
class NodeHealthInfo:
    """One node's health as reported by :meth:`MemoryPlane.health`."""

    node: str
    state: NodeHealth
    stale_ticks: int
    good_streak: int
    faults: int
    pin_grant: float
    actuation_failures: int = 0
    actuation_degraded: bool = False


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """Plane-wide degradation report (:meth:`MemoryPlane.health`)."""

    ticks: int
    deadline_misses: int
    nodes: Dict[str, NodeHealthInfo]
    fault_counts: Dict[str, int]

    def quarantined(self) -> List[str]:
        return [n for n, i in self.nodes.items()
                if i.state is NodeHealth.QUARANTINED]

    def degraded(self) -> List[str]:
        """Nodes not in closed-loop control or with failing actuation."""
        return [n for n, i in self.nodes.items()
                if i.state is not NodeHealth.HEALTHY or i.actuation_degraded]

    @property
    def healthy(self) -> bool:
        return not self.degraded() and self.deadline_misses == 0

    def summary(self) -> str:
        states = {s: 0 for s in NodeHealth}
        for info in self.nodes.values():
            states[info.state] += 1
        faults = sum(self.fault_counts.values())
        return (f"health: {states[NodeHealth.HEALTHY]} healthy / "
                f"{states[NodeHealth.STALE]} stale / "
                f"{states[NodeHealth.QUARANTINED]} quarantined of "
                f"{len(self.nodes)} nodes; {faults} faults, "
                f"{self.deadline_misses} deadline misses over "
                f"{self.ticks} ticks")


# ---------------------------------------------------------------------------
# Declarative spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """One managed store and the most memory it may ever be granted."""

    store: ManagedStore
    max_bytes: float


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One controlled node: who observes it and what gets resized.

    ``stores`` builds a priority-waterfall :class:`StoreRegistry`;
    alternatively pass a pre-built ``registry``.  ``u0`` seeds the
    capacity state (default: the registry's current total capacity).
    ``params`` overrides the plane-level law parameters for this node --
    heterogeneous ``total_memory`` / ``u_min`` / ``u_max`` fleets.
    """

    name: str
    monitor: MemoryMonitor
    stores: Tuple[StoreSpec, ...] = ()
    registry: Optional[StoreRegistry] = None
    u0: Optional[float] = None
    params: Optional[ControllerParams] = None

    def replace(self, **kw) -> "NodeSpec":
        """A modified copy -- e.g. the same node under a wrapped monitor."""
        return dataclasses.replace(self, **kw)

    def build_registry(self) -> StoreRegistry:
        if self.registry is not None:
            if self.stores:
                raise ValueError(
                    "pass either stores or a pre-built registry, not both "
                    "(stores would be silently unmanaged)")
            return self.registry
        registry = StoreRegistry()
        for spec in self.stores:
            store, max_bytes = (
                (spec.store, spec.max_bytes) if isinstance(spec, StoreSpec)
                else (spec[0], spec[1]))
            registry.register(store, max_bytes=float(max_bytes))
        return registry


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """Everything a control plane needs, declared up front.

    Fields:
      params:     plane-level Eq. 1 parameters (per-node overridable).
      nodes:      nodes managed from construction (more can ``attach``).
      signal:     which window aggregate drives the law (:class:`Signal`).
      window:     sliding-window length of the aggregator.
      ewma_alpha: EWMA smoothing factor of the aggregator.
      backend:    "array" (fused batched law) or "scalar" (reference).
      history:    bound on retained :class:`ControlAction` records.
      eviction:   default eviction policy for caches built through
                  :meth:`MemoryPlane.build_cache`.
      transport:  the message bus, or a factory for one (swap point for
                  a multi-host deployment); None -> in-process bus.
      record:     ReplayLoop capture: retain the last ``record`` control
                  intervals in a :class:`TraceRecorder` ring (0 = off;
                  enable later with :meth:`MemoryPlane.record`).
      health:     degradation policy (:class:`HealthPolicy`); None uses
                  the defaults (validation + holdover + quarantine on,
                  deadlines off).
      device:     where the array backend's fused step runs: None means
                  the CUDA card (raising without one), ``"cpu"`` the
                  host.  The scalar backend steps in host float64 and
                  ignores it.
    """

    params: ControllerParams
    nodes: Tuple[NodeSpec, ...] = ()
    signal: Union[Signal, str] = Signal.LATEST
    window: int = 8
    ewma_alpha: float = 0.5
    backend: str = "array"
    history: int = DEFAULT_HISTORY
    eviction: str = "lfu"
    transport: Union[MessageBus, Callable[[], MessageBus], None] = None
    record: int = 0
    health: Optional[HealthPolicy] = None
    device: DeviceLike = None

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if self.record < 0:
            raise ValueError("record must be >= 0 (ring capacity)")
        object.__setattr__(self, "nodes", tuple(self.nodes))
        object.__setattr__(self, "signal", Signal.coerce(self.signal))

    def replace(self, **kw) -> "PlaneSpec":
        """A modified copy -- the composition hook for nestable planes.

        A fleet plane derives each tenant's *inner* spec from the
        declared one: budget-sized ``params`` (the tenant's grant plays
        the role of ``total_memory``) and budget-reporting monitors
        wrapped around the declared ones, with everything else -- nodes,
        stores, signal, transport -- carried over unchanged.
        """
        return dataclasses.replace(self, **kw)

    def make_bus(self) -> MessageBus:
        if self.transport is None:
            return MessageBus()
        if isinstance(self.transport, MessageBus):
            return self.transport
        return self.transport()


# ---------------------------------------------------------------------------
# Batched controller backend
# ---------------------------------------------------------------------------

def make_fused_step(params: ControllerParams, device: DeviceLike = None):
    """Build the fleet update for one set of law gains on ``device``.

    Gains (``r0``/``lam``/``lam_grant``/``deadband``/``feedforward``)
    are fixed per step, as the JAX package bakes them in at trace time,
    and lifted once to float32 scalars on the device; capacities ``(u,
    v, v_prev, M, u_min, u_max)`` are per-node ``(N,)`` float32 tensors.
    ``mask`` selects the nodes observed this interval -- unobserved
    nodes pass through unchanged, matching the event-driven scalar
    backend.

    XLA folds the division by the constant ``r0`` into a multiply by its
    float32 reciprocal and contracts the law's multiply-adds into FMAs;
    the step does the same (``inv_r0``, and ``fma`` inside
    :func:`~repro_torch.core.control.vectorized_step`), so on the CPU
    its ``u_next`` equals JAX's bit for bit.  For a one-node fleet XLA
    goes further and folds ``lam`` and ``1 / r0`` into one constant
    (``u - (v_eff * err) * f32(lam / r0)``, contracted; ROADMAP C18); the
    step does that too when ``u`` holds one node.  Call it with the
    device's current stream set as the caller will run it (the constants
    are filled on that stream).
    """
    dev = resolve_device(device)
    ff = params.feedforward
    r0, lam = f32(params.r0, dev), f32(params.lam, dev)
    inv_r0 = f32(np.float32(1.0) / np.float32(params.r0), dev)
    lam_grant = (None if params.lam_grant is None
                 else f32(params.lam_grant, dev))
    lam_inv_r0 = (None if lam_grant is not None else f32(
        np.float32(params.lam) * (np.float32(1.0) / np.float32(params.r0)),
        dev))
    # a Python 0.0 lets vectorized_step skip the hold, as JAX's trace does
    deadband = (params.deadband if params.deadband == 0.0
                else f32(params.deadband, dev))

    def fused(u, v, v_prev, has_prev, mask, m, u_min, u_max):
        # A node with no previous observation runs without feedforward:
        # substituting v for v_prev zeroes the slope term exactly.
        vp = torch.where(has_prev, v_prev, v) if ff > 0.0 else None
        u_next = vectorized_step(
            u, v, total_memory=m, r0=r0, lam=lam, u_min=u_min,
            u_max=u_max, lam_grant=lam_grant, deadband=deadband,
            v_prev=vp, feedforward=ff, inv_r0=inv_r0,
            lam_inv_r0=lam_inv_r0 if u.shape[-1] == 1 else None)
        return torch.where(mask, u_next, u)

    return fused


_CAPACITY_FIELDS = ("total_memory", "u_min", "u_max")
# u, v, v_prev, M, u_min, u_max, has_prev, mask
_STAGED_ROWS = 8


class ArrayController:
    """Batched controller: all nodes' Eq. 1 in one fused update.

    State lives in packed per-node host arrays; ``observe`` only buffers
    the interval's aggregates (coalescing to the latest per node) and
    ``flush`` runs the whole fleet's control law as one fused step on
    ``device``, then actuates each observed node's registry.

    On a card the step runs on a CUDA stream of its own: the inputs go
    up from a pinned staging buffer without a sync, and reading
    ``u_next`` back -- which actuation needs -- is the one
    device-to-host sync of a flush that observed a node (none
    otherwise).  That readback waits for this controller's work only,
    never for a serving engine's steps queued on the default stream.

    Per-node ``params`` overrides may vary only capacity fields
    (``total_memory``/``u_min``/``u_max``); gains are shared by the
    fleet.  ``device=None`` means the card and raises without one.
    """

    def __init__(
        self,
        params: ControllerParams,
        bus: Optional[MessageBus] = None,
        signal: Signal | str = Signal.LATEST,
        max_history: int = DEFAULT_HISTORY,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.params = params                      # guarded-by: _lock
        self.signal = Signal.coerce(signal)
        self._bus = bus
        self._lock = threading.RLock()
        self._epoch = 0                           # guarded-by: _lock
        self._history = ActionHistory(max_history)
        self._names: List[str] = []               # guarded-by: _lock
        self._index: Dict[str, int] = {}          # guarded-by: _lock
        self._registries: List[StoreRegistry] = []  # guarded-by: _lock
        self._u = np.zeros(0, np.float64)         # guarded-by: _lock
        self._v_prev = np.zeros(0, np.float64)    # guarded-by: _lock
        self._has_prev = np.zeros(0, bool)        # guarded-by: _lock
        self._m = np.zeros(0, np.float64)         # guarded-by: _lock
        self._u_min = np.zeros(0, np.float64)     # guarded-by: _lock
        self._u_max = np.zeros(0, np.float64)     # guarded-by: _lock
        self._staging: Optional[torch.Tensor] = None  # guarded-by: _lock
        self._pending: Dict[str, AggregatedMetrics] = {}  # guarded-by: _lock
        self._fused = self._build(params)         # guarded-by: _lock
        if bus is not None:
            bus.subscribe(AGG_TOPIC, self.observe)

    def _on_device(self):
        """The context the step's device work runs in: its own stream."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _build(self, params: ControllerParams):
        with self._on_device():
            return make_fused_step(params, self.device)

    # -- wiring -------------------------------------------------------------
    def attach_node(self, node: str, registry: StoreRegistry,
                    u0: Optional[float] = None,
                    params: Optional[ControllerParams] = None) -> None:
        p = params or self.params
        if params is not None:
            for f in dataclasses.fields(params):
                if f.name in _CAPACITY_FIELDS:
                    continue
                if getattr(params, f.name) != getattr(self.params, f.name):
                    raise ValueError(
                        "ArrayController per-node overrides may only vary "
                        f"{_CAPACITY_FIELDS}; {f.name!r} differs (gains are "
                        "fused step constants)")
        with self._lock:
            if node in self._index:
                raise ValueError(f"node {node!r} already attached")
            u = registry.total_capacity() if u0 is None else float(u0)
            self._index[node] = len(self._names)
            self._names.append(node)
            self._registries.append(registry)
            self._u = np.append(self._u, u)
            self._v_prev = np.append(self._v_prev, 0.0)
            self._has_prev = np.append(self._has_prev, False)
            self._m = np.append(self._m, p.total_memory)
            self._u_min = np.append(self._u_min, p.u_min)
            self._u_max = np.append(self._u_max, p.u_max)
            if self._stream is not None:
                # Pinned, so the flush's upload is an asynchronous copy;
                # allocated here, off the tick, at the fleet's new size.
                self._staging = torch.empty(
                    (_STAGED_ROWS, self._u.size), dtype=torch.float32,
                    pin_memory=True)

    def nodes(self) -> List[str]:
        with self._lock:
            return list(self._names)

    def node_capacity(self, node: str) -> float:
        with self._lock:
            return float(self._u[self._index[node]])

    # -- online re-parameterization -----------------------------------------
    @property
    def epoch(self) -> int:
        """Parameter generation: 0 at construction, +1 per swap."""
        with self._lock:
            return self._epoch

    def prewarm(self, params: ControllerParams):
        """Build + warm the fused step for ``params`` off the hot path.

        Lifts the new gains onto the device and runs the step once on
        the current fleet shape (nothing actuated), so a subsequent
        :meth:`swap_params` is a pointer flip.
        """
        fused = self._build(params)
        with self._lock:
            packed = self._pack(self._v_prev, np.zeros(self._u.size, bool))
        if packed.shape[1]:
            with self._on_device():
                self._run(fused, torch.from_numpy(packed).to(
                    self.device)).cpu()
        return fused

    def swap_params(self, params: ControllerParams, fused=None) -> int:
        """Atomically replace the fleet's law gains in a running plane.

        The swap itself is a pointer flip under the controller lock at
        an interval boundary; pass a :meth:`prewarm`-built ``fused``
        step to keep building it off the locked path (the
        ``MemoryPlane`` facade does).  Control state (``u``,
        ``v_prev``) carries over; capacity bounds (``u_min`` /
        ``u_max`` / ``M``) move with the swap for every node still on
        the old plane-level defaults, while per-node overrides
        (heterogeneous fleets) are preserved.  Returns the new
        parameter epoch; subsequent actions are stamped with it.
        """
        if fused is None:
            fused = self.prewarm(params)
        with self._lock:
            old = self.params
            for arr, prev, new in ((self._m, old.total_memory,
                                    params.total_memory),
                                   (self._u_min, old.u_min, params.u_min),
                                   (self._u_max, old.u_max, params.u_max)):
                arr[arr == prev] = new
            self.params = params
            self._fused = fused
            self._epoch += 1
            return self._epoch

    # -- bounded action history ---------------------------------------------
    @property
    def actions(self) -> List[ControlAction]:
        return self._history.snapshot()

    def recent(self, n: Optional[int] = None,
               node: Optional[str] = None) -> List[ControlAction]:
        return self._history.snapshot(node=node, limit=n)

    # -- the fused step -----------------------------------------------------
    def _pack(self, v: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """The step's operands as one float32 ``(8, N)`` array, cast as
        JAX casts each one (called under _lock)."""
        return np.stack([self._u, v, self._v_prev, self._m, self._u_min,
                         self._u_max, self._has_prev, mask]
                        ).astype(np.float32)

    @staticmethod
    def _run(fused, rows: torch.Tensor) -> torch.Tensor:
        u, v, v_prev, m, u_min, u_max, has_prev, mask = rows
        return fused(u, v, v_prev, has_prev != 0, mask != 0, m, u_min,
                     u_max)

    def _step(self, packed: np.ndarray) -> np.ndarray:
        """``u_next`` of the whole fleet, as host float64 (under _lock)."""
        if self._stream is None:
            out = self._run(self._fused, torch.from_numpy(packed))
        else:
            with self._on_device():
                self._staging.numpy()[:] = packed
                rows = self._staging.to(self.device, non_blocking=True)
                # the flush's one device-to-host sync; it also retires
                # the upload, so the staging buffer is free again
                out = self._run(self._fused, rows).cpu()
        return out.numpy().astype(np.float64)

    # -- control ------------------------------------------------------------
    def observe(self, agg: AggregatedMetrics) -> None:
        """Buffer one node's aggregate for the next ``flush``.

        Multiple observations of a node within one interval coalesce to
        the latest (the batched law steps once per interval)."""
        with self._lock:
            self._pending[agg.node] = agg

    def flush(self) -> List[ControlAction]:      # planecheck: hot-loop
        """One control interval: fused decide, then per-node actuation."""
        with self._lock:
            pending, self._pending = self._pending, {}
            observed = sorted(
                (self._index[n], n, a) for n, a in pending.items()
                if n in self._index)
            if not observed:
                return []
            n_nodes = self._u.size
            mask = np.zeros(n_nodes, bool)
            v = self._v_prev.copy()      # placeholder; masked out below
            for i, _, agg in observed:
                mask[i] = True
                v[i] = self.signal.pick(agg)
                if agg.total > 0 and agg.total != self._m[i]:
                    self._m[i] = agg.total
            u_next = self._step(self._pack(v, mask))
            actions: List[ControlAction] = []
            for i, name, agg in observed:
                # Actuation stays atomic with the fleet-state update.
                # planecheck: ignore[PC-L003] (JAX's copy is baselined)
                reports = self._registries[i].apply_capacity(u_next[i])
                action = ControlAction(
                    node=name, timestamp=agg.timestamp,
                    u_prev=float(self._u[i]), u_next=float(u_next[i]),
                    utilization=v[i] / agg.total if agg.total else 0.0,
                    reports=reports, epoch=self._epoch)
                actions.append(action)
                self._history.append(action)
                self._u[i] = u_next[i]
                self._v_prev[i] = v[i]
                self._has_prev[i] = True
        if self._bus is not None:
            for action in actions:
                self._bus.publish(CONTROL_TOPIC, action)
        return actions

    def squeeze(self, node: str, factor: float) -> bool:
        """Transient capacity clamp (see DynIMSController.squeeze)."""
        with self._lock:
            i = self._index.get(node)
            if i is None:
                return False
            # planecheck: ignore[PC-L003] atomic with flush(), as in JAX
            self._registries[i].apply_capacity(
                float(self._u[i]) * float(factor))
            return True

    def reset_node(self, node: str, u: float) -> bool:
        """Re-seed one node's control state at capacity ``u``.

        The quarantine-rejoin hook: the law resumes from the
        fail-static grant (feedforward history cleared) instead of
        jumping back to the pre-quarantine capacity."""
        with self._lock:
            i = self._index.get(node)
            if i is None:
                return False
            self._u[i] = float(u)
            self._v_prev[i] = 0.0
            self._has_prev[i] = False
            return True


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

class MemoryPlane:
    """Declarative facade over the full DynIMS pipeline.

    Wires monitor -> bus(RAW) -> aggregator -> bus(AGG) -> controller
    backend for every declared/attached node and drives them all from
    one ``tick`` (the control interval T).  ``run``/``start``/``stop``
    tick in real time on a daemon thread; ``tick`` is used by tests and
    by the serving engine (which ticks once per step).  The plane is
    restartable and usable as a context manager.
    """

    def __init__(self, spec: PlaneSpec) -> None:
        self.spec = spec
        self.signal = spec.signal
        self.bus = spec.make_bus()
        self.aggregator = MetricAggregator(
            window=spec.window, ewma_alpha=spec.ewma_alpha, bus=self.bus)
        if spec.backend == "scalar":
            self.controller: Union[DynIMSController, ArrayController] = \
                DynIMSController(spec.params, bus=self.bus,
                                 signal=spec.signal,
                                 max_history=spec.history,
                                 track_fresh=True)   # tick() drains
        else:
            self.controller = ArrayController(
                spec.params, bus=self.bus, signal=spec.signal,
                max_history=spec.history, device=spec.device)
        self._monitors: Dict[str, MemoryMonitor] = {}  # guarded-by: _lock
        self._registries: Dict[str, _ResilientRegistry] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        # Serializes whole control intervals against hot-swaps: tick()
        # holds it for the full sample -> decide -> actuate pipeline, so
        # swap_params always lands at an interval boundary (never a
        # half-updated fleet).
        self._tick_lock = threading.Lock()
        self.recorder: Optional[TraceRecorder] = (  # guarded-by: _tick_lock
            TraceRecorder(spec.record) if spec.record else None)
        # ChaosPlane degradation state.  _health_lock is a leaf under
        # _tick_lock: tick() mutates the states while holding both,
        # health() snapshots under _health_lock alone so a report never
        # waits out a whole control interval.
        self.health_policy = spec.health or HealthPolicy()
        self.fault_log = FaultLog(self.health_policy.fault_log)
        self._health_lock = threading.Lock()
        self._health: Dict[str, _NodeHealthState] = {}  # guarded-by: _health_lock
        self._ticks = 0                       # guarded-by: _health_lock
        self._deadline_misses = 0             # guarded-by: _health_lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for node_spec in spec.nodes:
            self._attach_spec(node_spec)

    @classmethod
    def for_scenario(cls, scenario: str, *,
                     nodes: Iterable[NodeSpec] = (),
                     **spec_kw) -> "MemoryPlane":
        """A plane running the ScenarioLab-tuned gains for ``scenario``.

        Looks the named scenario up in the checked-in preset registry
        (``repro_torch.configs.dynims.tuned_params``; ``paper-*`` names map
        to Table I) and builds a :class:`PlaneSpec` around it --
        remaining keywords pass through to the spec::

            plane = MemoryPlane.for_scenario("bursty-serving",
                                             nodes=(NodeSpec(...),))
        """
        from ..configs.dynims import tuned_params
        return cls(PlaneSpec(params=tuned_params(scenario),
                             nodes=tuple(nodes), **spec_kw))

    # -- wiring -------------------------------------------------------------
    def _attach_spec(self, ns: NodeSpec) -> StoreRegistry:
        return self.attach(ns.name, ns.monitor, ns.registry,
                           stores=ns.stores, u0=ns.u0, params=ns.params)

    def attach(
        self,
        node: str,
        monitor: MemoryMonitor,
        registry: Optional[StoreRegistry] = None,
        *,
        stores: Iterable[Union[StoreSpec, Tuple[ManagedStore, float]]] = (),
        u0: Optional[float] = None,
        params: Optional[ControllerParams] = None,
    ) -> StoreRegistry:
        """Bring one node under control; returns its registry.

        Either pass a pre-built ``registry`` or an iterable of
        :class:`StoreSpec` / ``(store, max_bytes)`` pairs (not both).
        The returned registry is wrapped in the plane's actuation
        shield: a raising store degrades to bounded backoff-retried
        actuation instead of aborting the fleet's interval."""
        registry = NodeSpec(node, monitor, stores=tuple(stores),
                            registry=registry).build_registry()
        shielded = _ResilientRegistry(
            registry, node, self.health_policy, self.fault_log,
            clock=self._tick_index)
        effective = params or self.spec.params
        pin = self.health_policy.fail_static_grant(
            effective.u_min, effective.u_max)
        with self._lock:
            self._monitors[node] = monitor
            self._registries[node] = shielded
            self.controller.attach_node(node, shielded, u0=u0, params=params)
        with self._health_lock:
            self._health[node] = _NodeHealthState(pin)
        return shielded

    def build_cache(self, name: str, capacity: float, *,
                    policy: Optional[str] = None, priority: int = 0,
                    **kw) -> ShardCache:
        """A ShardCache with the plane's declared eviction default."""
        return ShardCache(name, capacity=capacity,
                          policy=policy or self.spec.eviction,
                          priority=priority, **kw)

    # -- introspection ------------------------------------------------------
    def nodes(self) -> List[str]:
        return self.controller.nodes()

    def capacity(self, node: str) -> float:
        """Current granted storage capacity ``u`` for ``node`` (bytes)."""
        return self.controller.node_capacity(node)

    def actions(self, node: Optional[str] = None,
                limit: Optional[int] = None) -> List[ControlAction]:
        """Bounded, thread-safe view of recent control actions."""
        return self.controller.recent(n=limit, node=node)

    def squeeze(self, node: str, factor: float) -> bool:
        """Transiently clamp a node's stores to ``factor`` of its grant
        (straggler/burst mitigation); the law re-grants next interval."""
        return self.controller.squeeze(node, factor)

    # -- ReplayLoop: capture and hot-swap ------------------------------------
    @property
    def params(self) -> ControllerParams:
        """The plane-level law parameters currently in force."""
        return self.controller.params

    @property
    def epoch(self) -> int:
        """Current parameter epoch (0 until the first hot-swap)."""
        return self.controller.epoch

    def record(self, capacity: int = DEFAULT_TRACE_CAPACITY) -> TraceRecorder:
        """Start (or restart) trace capture; returns the live recorder.

        Swaps under the tick lock so a concurrently running interval
        never records half to the old ring and half to the new one.
        """
        with self._tick_lock:
            self.recorder = TraceRecorder(capacity)
            return self.recorder

    def capture(self) -> CapturedTrace:
        """Snapshot the recorded ring as a :class:`CapturedTrace`.

        Raises if the plane was never recording (``PlaneSpec(record=N)``
        or :meth:`record`) or no interval has been ticked yet.
        """
        if self.recorder is None:
            raise ValueError(
                "plane is not recording; build it with PlaneSpec(record=N) "
                "or call plane.record() first")
        return self.recorder.snapshot(
            interval_s=self.controller.params.interval_s)

    def swap_params(self, params: ControllerParams) -> int:
        """Hot-swap the control-law parameters of a *running* plane.

        Delegates to the backend's atomic ``swap_params`` while holding
        the tick lock, so the swap always lands between control
        intervals: every interval runs wholly under one parameter
        epoch, and the :class:`ControlAction` history stays
        epoch-monotone with no dropped or duplicated interval.  The
        array backend's new step is built and warmed *before* the lock
        is taken, so a concurrently ticking loop never waits on it.
        """
        prewarm = getattr(self.controller, "prewarm", None)
        kw = {} if prewarm is None else {"fused": prewarm(params)}
        with self._tick_lock:
            # planecheck: ignore[PC-L003] the step was warmed above, unlocked
            return self.controller.swap_params(params, **kw)

    # -- degradation / health -----------------------------------------------
    def _tick_index(self) -> int:
        with self._health_lock:
            return self._ticks

    def log_fault(self, kind: str, node: Optional[str] = None,
                  detail: str = "") -> None:
        """Record an externally observed fault (retune supervisor,
        fleet rebalance rollback, ...) in the plane's bounded log."""
        self.fault_log.append(FaultEvent(
            kind=kind, node=node, tick=self._tick_index(),
            timestamp=time.time(), detail=detail))

    def health(self) -> HealthReport:
        """Structured degradation report: per-node health state machine
        position, actuation shield status, and fault counts.  Safe to
        call from any thread; never waits out a control interval."""
        with self._health_lock:
            states = {n: (st.state, st.stale_ticks, st.good_streak,
                          st.faults, st.pin_grant)
                      for n, st in self._health.items()}
            ticks = self._ticks
            misses = self._deadline_misses
        with self._lock:
            registries = dict(self._registries)
        nodes = {}
        for name, (state, stale, streak, faults, pin) in states.items():
            failures, degraded = (registries[name].status()
                                  if name in registries else (0, False))
            nodes[name] = NodeHealthInfo(
                node=name, state=state, stale_ticks=stale,
                good_streak=streak, faults=faults, pin_grant=pin,
                actuation_failures=failures, actuation_degraded=degraded)
        return HealthReport(ticks=ticks, deadline_misses=misses,
                            nodes=nodes,
                            fault_counts=self.fault_log.counts())

    def _observe_node(self, name: str, monitor: MemoryMonitor,
                      registry: Optional[_ResilientRegistry],
                      tick: int) -> Optional[MemorySample]:
        """Sample one node through the health state machine.

        Returns the sample the law may act on this interval (fresh, or
        the last-good holdover while stale), or None while the node is
        quarantined / has no good sample yet.  Called under _tick_lock.
        """
        policy = self.health_policy
        t0 = time.monotonic()
        sample: Optional[MemorySample] = None
        fault: Optional[Tuple[str, str]] = None
        try:
            sample = monitor.sample()
        except Exception as exc:
            fault = ("sample-error", f"{type(exc).__name__}: {exc}")
        else:
            reason = validate_sample(sample)
            if reason is not None:
                fault = ("telemetry-invalid", reason)
            elif (policy.sample_deadline_s is not None
                  and time.monotonic() - t0 > policy.sample_deadline_s):
                # A sample that arrives after its deadline is as stale
                # as one that never arrived (paper Sec. II.B).
                fault = ("sample-slow",
                         f"{time.monotonic() - t0:.3f}s "
                         f"> {policy.sample_deadline_s}s")
        events: List[FaultEvent] = []
        with self._health_lock:
            st = self._health.get(name)
            if st is None:       # attached behind our back; adopt it
                effective = self.spec.params
                st = _NodeHealthState(policy.fail_static_grant(
                    effective.u_min, effective.u_max))
                self._health[name] = st
            out, pin = self._transition(name, st, sample, fault,
                                        tick, events)
        for e in events:
            self.fault_log.append(e)
        if pin and registry is not None:
            # (Re-)pin the fail-static grant outside _health_lock; the
            # shield absorbs and backs off actuation failures.
            registry.apply_capacity(st.pin_grant)
        return out

    def _transition(self, name: str, st: _NodeHealthState,
                    sample: Optional[MemorySample],
                    fault: Optional[Tuple[str, str]], tick: int,
                    events: List[FaultEvent]) -> Tuple[
                        Optional[MemorySample], bool]:
        """Advance one node's health state machine by one interval.

        Returns ``(sample_to_publish, pin_fail_static_now)``.  Called
        with _health_lock held; appends pending events to ``events``
        (logged by the caller after the lock is dropped).
        """
        policy = self.health_policy
        now = time.time()
        if fault is None:
            assert sample is not None
            if st.state is NodeHealth.QUARANTINED:
                # Rejoin hysteresis: demand a sustained good streak, and
                # ramp back up from the fail-static grant rather than
                # jumping to the pre-quarantine capacity.
                st.good_streak += 1
                st.last_good = sample
                if st.good_streak >= policy.rejoin_intervals:
                    st.state = NodeHealth.HEALTHY
                    st.stale_ticks = 0
                    st.good_streak = 0
                    self.controller.reset_node(name, st.pin_grant)
                    events.append(FaultEvent(
                        kind="rejoin", node=name, tick=tick, timestamp=now,
                        detail=f"closed-loop control resumed from "
                               f"fail-static grant {st.pin_grant:.3e}"))
                    return sample, False
                return None, True
            if st.state is NodeHealth.STALE:
                events.append(FaultEvent(
                    kind="stale-recover", node=name, tick=tick,
                    timestamp=now,
                    detail=f"fresh sample after {st.stale_ticks} "
                           "holdover intervals"))
            st.state = NodeHealth.HEALTHY
            st.stale_ticks = 0
            st.good_streak = 0
            st.last_good = sample
            return sample, False
        # -- faulted interval ------------------------------------------------
        kind, detail = fault
        st.faults += 1
        events.append(FaultEvent(kind=kind, node=name, tick=tick,
                                 timestamp=now, detail=detail))
        if st.state is NodeHealth.QUARANTINED:
            st.good_streak = 0
            return None, True
        st.stale_ticks += 1
        st.state = NodeHealth.STALE
        if st.stale_ticks >= policy.stale_budget or st.last_good is None:
            # Sustained loss (or never a good sample): fail static.
            st.state = NodeHealth.QUARANTINED
            st.good_streak = 0
            events.append(FaultEvent(
                kind="quarantine", node=name, tick=tick, timestamp=now,
                detail=f"{st.stale_ticks} bad intervals "
                       f"(stale_budget={policy.stale_budget}); pinned to "
                       f"fail-static grant {st.pin_grant:.3e}"))
            return None, True
        # Stale holdover: act on the last-good observation.
        return st.last_good, False

    # -- control loop -------------------------------------------------------
    def tick(self) -> List[ControlAction]:
        """One control interval: sample every node, run the law once.

        Every sample passes telemetry validation and the per-node
        health state machine first -- a faulty monitor degrades that
        node (holdover, then fail-static quarantine) instead of feeding
        the law garbage or taking the interval down with an exception.
        """
        t0 = time.monotonic()
        with self._tick_lock:
            with self._lock:
                monitors = dict(self._monitors)
                registries = dict(self._registries)
            tick = self._tick_index()
            samples: Dict[str, MemorySample] = {}
            for name, mon in monitors.items():
                # The interval is atomic against swap_params by design.
                # planecheck: ignore[PC-L003] (JAX's copy is baselined)
                s = self._observe_node(name, mon, registries.get(name),
                                       tick)
                if s is not None:
                    samples[name] = s
            for sample in samples.values():
                self.bus.publish(RAW_TOPIC, sample)
            # planecheck: ignore[PC-L003] flush() actuates by design
            actions = self.controller.flush()
            if self.recorder is not None:
                self.recorder.record(samples, actions)
            deadline = self.health_policy.tick_deadline_s
            elapsed = time.monotonic() - t0
            missed = deadline is not None and elapsed > deadline
            with self._health_lock:
                self._ticks += 1
                if missed:
                    self._deadline_misses += 1
            if missed:
                self.fault_log.append(FaultEvent(
                    kind="tick-deadline", node=None, tick=tick,
                    timestamp=time.time(),
                    detail=f"interval took {elapsed:.3f}s "
                           f"> {deadline}s"))
            return actions

    def run(self, duration_s: Optional[float] = None) -> None:
        """Tick in real time at ``params.interval_s`` until stopped."""
        deadline = (None if duration_s is None
                    else time.time() + duration_s)
        while not self._stop.is_set():
            t0 = time.time()
            self.tick()
            if deadline is not None and time.time() >= deadline:
                break
            sleep = self.controller.params.interval_s - (time.time() - t0)
            if sleep > 0:
                self._stop.wait(sleep)

    def start(self) -> None:
        """Start (or restart) the real-time loop on a daemon thread."""
        self.stop()
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "MemoryPlane":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Legacy shim
# ---------------------------------------------------------------------------

class ControlPlane(MemoryPlane):
    """Deprecated: imperative predecessor of :class:`MemoryPlane`.

    Kept as a thin shim (scalar backend, old constructor signature) so
    existing callers keep working; new code should declare a
    :class:`PlaneSpec` and use :class:`MemoryPlane`.
    """

    def __init__(
        self,
        params: ControllerParams,
        window: int = 8,
        ewma_alpha: float = 0.5,
        signal: Signal | str = "latest",
        max_history: int = DEFAULT_HISTORY,
    ) -> None:
        warnings.warn(
            "ControlPlane is deprecated; declare a PlaneSpec and use "
            "MemoryPlane instead", DeprecationWarning, stacklevel=2)
        super().__init__(PlaneSpec(
            params=params, window=window, ewma_alpha=ewma_alpha,
            signal=signal, backend="scalar", history=max_history))
