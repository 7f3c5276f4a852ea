"""Streaming metric aggregation (the paper's Flink analogue).

A copy of ``repro/core/stream.py``.  Consumes raw
:class:`~repro_torch.core.monitor.MemorySample` messages from the
bus topic ``metrics``, maintains a per-node sliding window, and publishes
an :class:`AggregatedMetrics` record to topic ``metrics.agg`` for the
controller.  The paper's stream job computes "the optimized in-memory
storage space for each node online"; here the aggregation (smoothing,
slope) is separated from the control law so either can be swapped.

Aggregations per node over a window of the last ``window`` samples:
latest / mean / max / EWMA (alpha) / slope (d usage / d interval, by
least-squares over the window) -- the slope feeds the beyond-paper
feedforward term of the control law.
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional

import numpy as np

from .bus import MessageBus
from .monitor import MemorySample

RAW_TOPIC = "metrics"
AGG_TOPIC = "metrics.agg"


@dataclass(frozen=True)
class AggregatedMetrics:
    node: str
    timestamp: float
    total: float
    used_latest: float
    used_ewma: float
    used_mean: float
    used_max: float
    slope_per_interval: float     # least-squares d(used)/d(sample)
    storage_used: float
    swap_used: float
    n_samples: int

    @property
    def utilization(self) -> float:
        return self.used_latest / self.total if self.total else 0.0


class MetricAggregator:
    """Per-node sliding-window aggregation; bus-attached or standalone."""

    def __init__(self, window: int = 8, ewma_alpha: float = 0.5,
                 bus: Optional[MessageBus] = None):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self.alpha = ewma_alpha
        self._samples: Dict[str, Deque[MemorySample]] = defaultdict(
            lambda: deque(maxlen=window))
        self._ewma: Dict[str, float] = {}
        self._bus = bus
        if bus is not None:
            bus.subscribe(RAW_TOPIC, self._on_message)

    def _on_message(self, msg) -> None:
        sample = msg if isinstance(msg, MemorySample) else MemorySample.from_json(msg)
        agg = self.update(sample)
        if self._bus is not None:
            self._bus.publish(AGG_TOPIC, agg)

    def update(self, sample: MemorySample) -> AggregatedMetrics:
        q = self._samples[sample.node]
        q.append(sample)
        prev = self._ewma.get(sample.node, sample.used)
        ewma = self.alpha * sample.used + (1 - self.alpha) * prev
        self._ewma[sample.node] = ewma

        used = np.array([s.used for s in q], dtype=np.float64)
        if len(used) >= 2:
            x = np.arange(len(used), dtype=np.float64)
            slope = float(np.polyfit(x, used, 1)[0])
        else:
            slope = 0.0
        return AggregatedMetrics(
            node=sample.node,
            timestamp=sample.timestamp,
            total=sample.total,
            used_latest=sample.used,
            used_ewma=float(ewma),
            used_mean=float(used.mean()),
            used_max=float(used.max()),
            slope_per_interval=slope,
            storage_used=sample.storage_used,
            swap_used=sample.swap_used,
            n_samples=len(used),
        )

    def latest(self, node: str) -> Optional[MemorySample]:
        q = self._samples.get(node)
        return q[-1] if q else None
