"""In-process messaging bus (the paper's Kafka analogue).

A copy of ``repro/core/bus.py``.

Topic-based pub/sub with the same role Kafka plays in DynIMS: decouple
monitoring agents, the stream processor, and the memory controller.  Two
consumption styles, matching Kafka's consumer groups:

* callback subscription (``subscribe``) -- push, used by the aggregator,
* bounded per-topic retention + cursors (``poll``) -- pull, used by tests
  and by slow consumers.

Thread-safe; publishing never blocks on slow subscribers (exceptions in a
callback are recorded, not propagated -- a monitoring plane must not take
down the data plane).
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Tuple


class MessageBus:
    def __init__(self, retention: int = 4096):
        self._lock = threading.RLock()
        self._retention = retention
        self._log: Dict[str, deque] = defaultdict(   # guarded-by: _lock
            lambda: deque(maxlen=retention))
        self._offsets: Dict[str, int] = defaultdict(int)  # guarded-by: _lock
        self._subs: Dict[str, List[Callable[[Any], None]]] = \
            defaultdict(list)                        # guarded-by: _lock
        self._cursors: Dict[Tuple[str, str], int] = {}  # guarded-by: _lock
        self.errors: List[Tuple[str, Exception]] = []   # guarded-by: _lock

    # -- producer side ---------------------------------------------------
    def publish(self, topic: str, message: Any) -> None:
        with self._lock:
            self._log[topic].append(message)
            self._offsets[topic] += 1
            subs = list(self._subs[topic])
        for fn in subs:
            try:
                fn(message)
            except Exception as exc:  # monitoring must not crash data plane
                with self._lock:
                    self.errors.append((topic, exc))

    # -- push consumers ----------------------------------------------------
    def subscribe(self, topic: str, fn: Callable[[Any], None]) -> Callable[[], None]:
        """Register a callback; returns an unsubscribe handle."""
        with self._lock:
            self._subs[topic].append(fn)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._subs[topic].remove(fn)
                except ValueError:
                    pass
        return unsubscribe

    # -- pull consumers ----------------------------------------------------
    def poll(self, topic: str, group: str = "default", max_items: int = 256) -> List[Any]:
        """Return messages this consumer group has not seen yet."""
        with self._lock:
            log = self._log[topic]
            total = self._offsets[topic]
            first_retained = total - len(log)
            cursor = self._cursors.get((topic, group), 0)
            cursor = max(cursor, first_retained)
            start = cursor - first_retained
            out = list(log)[start:start + max_items]
            self._cursors[(topic, group)] = cursor + len(out)
            return out

    def depth(self, topic: str) -> int:
        with self._lock:
            return len(self._log[topic])
