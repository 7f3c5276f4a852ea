"""The DynIMS memory-controller service (the paper's Vert.x component).

A copy of ``repro/core/controller.py``.  Event-driven: subscribes to
aggregated metrics on the bus, runs the control law, and actuates each
node's registered stores through a
:class:`~repro_torch.core.store.StoreRegistry`.

Two backends implement the same observe -> decide -> actuate contract
(see :mod:`repro_torch.core.plane` for the facade that wires them):

* :class:`DynIMSController` -- the scalar *reference* backend.  Steps
  each node's Eq. 1 in host float64 the moment its aggregate arrives,
  exactly as the paper's per-node controller would.
* :class:`~repro_torch.core.plane.ArrayController` -- the *batched*
  backend: all attached nodes' ``(u, v, v_prev, M, u_min, u_max)`` in
  tensors and one fused ``vectorized_step`` per control interval.

Both keep a bounded, thread-safe :class:`ActionHistory` instead of an
unbounded action list -- the memory controller must not itself grow
without bound.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .bus import MessageBus
from .control import ControllerParams, Signal, control_step
from .store import EvictionReport, StoreRegistry
from .stream import AGG_TOPIC, AggregatedMetrics

CONTROL_TOPIC = "control.actions"

#: Default bound on retained control actions (per controller).
DEFAULT_HISTORY = 1024


@dataclass
class ControlAction:
    """One capacity decision, published to the bus for observability.

    ``epoch`` counts the controller's parameter generations: 0 until the
    first :meth:`~DynIMSController.swap_params`, then incremented by
    every hot-swap.  Actions from one control interval always share one
    epoch (swaps land at interval boundaries), so a reader can verify a
    swap dropped or duplicated no interval by checking the history is
    epoch-monotone with no gaps per node.
    """

    node: str
    timestamp: float
    u_prev: float
    u_next: float
    utilization: float
    reports: List[EvictionReport] = field(default_factory=list)
    epoch: int = 0

    @property
    def delta(self) -> float:
        return self.u_next - self.u_prev


class ActionHistory:
    """Bounded, thread-safe log of control actions.

    Keeps the last ``maxlen`` actions for observability.  With
    ``track_fresh=True`` it additionally buffers every action since the
    last :meth:`drain` so a caller (``MemoryPlane.tick``) can return a
    complete interval even when the fleet is larger than ``maxlen``;
    the buffer is a plain list emptied on each drain, so only a caller
    that actually drains should enable it (a standalone event-driven
    controller would otherwise grow it without bound).
    """

    def __init__(self, maxlen: int = DEFAULT_HISTORY,
                 track_fresh: bool = False):
        if maxlen < 1:
            raise ValueError("history bound must be >= 1")
        self.maxlen = maxlen
        self._lock = threading.Lock()
        self._log: deque = deque(maxlen=maxlen)     # guarded-by: _lock
        self._track_fresh = track_fresh
        self._fresh: List[ControlAction] = []       # guarded-by: _lock

    def append(self, action: ControlAction) -> None:
        with self._lock:
            self._log.append(action)
            if self._track_fresh:
                self._fresh.append(action)

    def snapshot(self, node: Optional[str] = None,
                 limit: Optional[int] = None) -> List[ControlAction]:
        with self._lock:
            out = list(self._log)
        if node is not None:
            out = [a for a in out if a.node == node]
        if limit is not None:
            out = out[-limit:]
        return out

    def drain(self) -> List[ControlAction]:
        """All actions appended since the last drain (requires
        ``track_fresh``; empty otherwise)."""
        with self._lock:
            out, self._fresh = self._fresh, []
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._log)


@dataclass
class _NodeState:
    registry: StoreRegistry
    u: float
    v_prev: Optional[float] = None
    params: Optional[ControllerParams] = None   # per-node override


class DynIMSController:
    """Per-node feedback control of registered in-memory stores.

    The scalar reference backend: one float64 Python ``control_step``
    per node per observation, exactly the paper's per-node law.
    """

    def __init__(
        self,
        params: ControllerParams,
        bus: Optional[MessageBus] = None,
        signal: Signal | str = Signal.LATEST,
        max_history: int = DEFAULT_HISTORY,
        track_fresh: bool = False,
    ) -> None:
        self.params = params                        # guarded-by: _lock
        self.signal = Signal.coerce(signal)
        self._nodes: Dict[str, _NodeState] = {}     # guarded-by: _lock
        self._bus = bus
        self._lock = threading.RLock()
        self._epoch = 0                             # guarded-by: _lock
        self._history = ActionHistory(max_history, track_fresh=track_fresh)
        if bus is not None:
            bus.subscribe(AGG_TOPIC, self._on_agg)

    # -- wiring -------------------------------------------------------------
    def attach_node(self, node: str, registry: StoreRegistry,
                    u0: Optional[float] = None,
                    params: Optional[ControllerParams] = None) -> None:
        """Register one node.  ``params`` overrides the plane-level law
        parameters for this node (heterogeneous M / u_min / u_max)."""
        with self._lock:
            u = registry.total_capacity() if u0 is None else float(u0)
            self._nodes[node] = _NodeState(registry=registry, u=u,
                                           params=params)

    def node_capacity(self, node: str) -> float:
        with self._lock:
            return self._nodes[node].u

    def nodes(self) -> List[str]:
        with self._lock:
            return list(self._nodes)

    # -- online re-parameterization -----------------------------------------
    @property
    def epoch(self) -> int:
        """Parameter generation: 0 at construction, +1 per swap."""
        with self._lock:
            return self._epoch

    def swap_params(self, params: ControllerParams) -> int:
        """Atomically replace the plane-level law parameters.

        Control state (``u``, ``v_prev``) carries over -- the new law
        continues the old trajectory from the next observation, so no
        interval is dropped or replayed.  Nodes with a per-node
        ``params`` override keep it (their operator pinned it
        deliberately).  Returns the new parameter epoch, which every
        subsequent :class:`ControlAction` is stamped with.
        """
        with self._lock:
            self.params = params
            self._epoch += 1
            return self._epoch

    # -- bounded action history ---------------------------------------------
    @property
    def actions(self) -> List[ControlAction]:
        """Snapshot of the bounded action history (thread-safe)."""
        return self._history.snapshot()

    def recent(self, n: Optional[int] = None,
               node: Optional[str] = None) -> List[ControlAction]:
        return self._history.snapshot(node=node, limit=n)

    # -- control ------------------------------------------------------------
    def _on_agg(self, agg: AggregatedMetrics) -> None:
        self.step(agg)

    def observe(self, agg: AggregatedMetrics) -> None:
        """Backend interface: the scalar backend acts immediately."""
        self.step(agg)

    def flush(self) -> List[ControlAction]:
        """Backend interface: actions produced since the last flush.

        Complete only when constructed with ``track_fresh=True`` (as
        :class:`~repro_torch.core.plane.MemoryPlane` does)."""
        return self._history.drain()

    def step(self, agg: AggregatedMetrics) -> Optional[ControlAction]:
        """Run Eq. 1 for one node from one aggregated observation."""
        with self._lock:
            state = self._nodes.get(agg.node)
            if state is None:
                return None
            v = self.signal.pick(agg)
            params = state.params or self.params
            if params.total_memory != agg.total and agg.total > 0:
                params = params.replace(total_memory=agg.total)
            u_next = control_step(state.u, v, params, v_prev=state.v_prev)
            # Actuation stays atomic with the control-state update.
            # planecheck: ignore[PC-L003] (JAX's copy is baselined)
            reports = state.registry.apply_capacity(u_next)
            action = ControlAction(
                node=agg.node, timestamp=agg.timestamp, u_prev=state.u,
                u_next=u_next, utilization=v / agg.total if agg.total else 0.0,
                reports=reports, epoch=self._epoch)
            state.u = u_next
            state.v_prev = v
            self._history.append(action)
        if self._bus is not None:
            self._bus.publish(CONTROL_TOPIC, action)
        return action

    def reset_node(self, node: str, u: float) -> bool:
        """Re-seed one node's control state at capacity ``u``.

        The quarantine-rejoin hook (see ``MemoryPlane.health``): the
        law resumes from the fail-static grant with slope history
        cleared instead of jumping back to the pre-quarantine state."""
        with self._lock:
            state = self._nodes.get(node)
            if state is None:
                return False
            state.u = float(u)
            state.v_prev = None
            return True

    def squeeze(self, node: str, factor: float) -> bool:
        """Transiently clamp a node's stores to ``factor * u`` without
        moving the control state -- the controller re-grants on the next
        interval once pressure clears (straggler mitigation hook)."""
        with self._lock:
            state = self._nodes.get(node)
            if state is None:
                return False
            # planecheck: ignore[PC-L003] atomic with step(), as in JAX
            state.registry.apply_capacity(state.u * float(factor))
            return True


def __getattr__(name: str):
    # Legacy import path: the ControlPlane shim now lives in plane.py
    # (importing it here eagerly would be circular).
    if name == "ControlPlane":
        from .plane import ControlPlane
        return ControlPlane
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
