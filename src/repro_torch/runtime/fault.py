"""Heartbeat-based failure detection.

A copy of ``repro/runtime/fault.py``.

Workers report heartbeats (in production: over the control-plane bus;
here: direct calls or bus messages).  A worker missing
``timeout_intervals`` consecutive intervals is declared failed and the
registered callbacks fire -- the trainer responds by pausing, asking the
elastic mesh planner for a degraded mesh,
and restoring from the last complete checkpoint (checkpoint/restart is
the recovery path; partial state on the failed host is never trusted).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class WorkerState:
    worker: str
    last_heartbeat: float
    healthy: bool = True
    meta: dict = field(default_factory=dict)


class HeartbeatMonitor:
    """Thread-safe: heartbeats, checks, and callback registration may
    race freely.  Callback lists are mutated only under ``_lock`` and
    snapshotted before firing, so a callback registered mid-``check``
    never mutates the list a concurrent iteration is walking; the
    callbacks themselves run *outside* the lock (they may call back
    into the monitor without deadlocking, and a slow callback never
    delays heartbeat intake)."""

    def __init__(self, interval_s: float = 1.0, timeout_intervals: int = 3):
        self.interval_s = interval_s
        self.timeout_s = interval_s * timeout_intervals
        self._workers: Dict[str, WorkerState] = {}  # guarded-by: _lock
        self._on_failure: List[Callable[[str], None]] = []   # guarded-by: _lock
        self._on_recovery: List[Callable[[str], None]] = []  # guarded-by: _lock
        self._lock = threading.Lock()

    def register(self, worker: str, **meta) -> None:
        with self._lock:
            self._workers[worker] = WorkerState(worker, time.monotonic(),
                                                meta=meta)

    def heartbeat(self, worker: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._workers.get(worker)
            if st is None:
                self._workers[worker] = WorkerState(worker, now)
                return
            was_healthy = st.healthy
            st.last_heartbeat = now
            st.healthy = True
            callbacks = list(self._on_recovery)   # snapshot, fire unlocked
        if not was_healthy:
            for cb in callbacks:
                cb(worker)

    def check(self, now: Optional[float] = None) -> List[str]:
        """Mark/return newly failed workers."""
        now = time.monotonic() if now is None else now
        newly_failed = []
        with self._lock:
            for st in self._workers.values():
                if st.healthy and now - st.last_heartbeat > self.timeout_s:
                    st.healthy = False
                    newly_failed.append(st.worker)
            callbacks = list(self._on_failure)    # snapshot, fire unlocked
        for w in newly_failed:
            for cb in callbacks:
                cb(w)
        return newly_failed

    def on_failure(self, cb: Callable[[str], None]) -> None:
        with self._lock:
            self._on_failure.append(cb)

    def on_recovery(self, cb: Callable[[str], None]) -> None:
        with self._lock:
            self._on_recovery.append(cb)

    def healthy_workers(self) -> List[str]:
        with self._lock:
            return [w for w, st in self._workers.items() if st.healthy]

    def failed_workers(self) -> List[str]:
        with self._lock:
            return [w for w, st in self._workers.items() if not st.healthy]
