"""Eviction policies for managed in-memory stores.

A copy of ``repro/core/eviction.py``.  The paper runs Alluxio with LFU;
LRU and FIFO are baselines, and :class:`AdaptivePolicy` switches between
LFU and LRU on the regret its ghost lists record (the adaptive policy
the paper's related work motivates).  All per-key policies expose::

    on_insert(key) / on_access(key) / remove(key) / victim() -> key | None

The analytic :class:`PolicyModel` table below is what the scenarios and
the sweep's CacheLoop carry read in place of a per-key policy.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import OrderedDict, deque
from typing import Dict, Hashable, Optional, Protocol

Key = Hashable


class EvictionPolicy(Protocol):
    def on_insert(self, key: Key) -> None: ...
    def on_access(self, key: Key) -> None: ...
    def remove(self, key: Key) -> None: ...
    def victim(self) -> Optional[Key]: ...
    def __len__(self) -> int: ...


class LFUPolicy:
    """Least-frequently-used (lazy heap) with a configurable tie-break.

    ``tie="lru"`` (classic) evicts the least-recently-touched block among
    the minimum-frequency set.  ``tie="mru"`` evicts the most-recently-
    admitted one instead -- the scan-resistant variant: during a cold
    sequential scan (every block freq==1) it preserves the resident
    prefix and drops the block that was fetched last, which is also the
    block most likely still present in a lower cache tier (keeps the
    two-level hierarchy inclusive, Sec. IV.B of the paper).
    """

    def __init__(self, tie: str = "lru") -> None:
        if tie not in ("lru", "mru"):
            raise ValueError("tie must be 'lru' or 'mru'")
        self._freq: Dict[Key, int] = {}
        self._heap: list = []          # (freq, +/-seq, key) lazy entries
        self._seq = itertools.count()
        self._sign = 1 if tie == "lru" else -1
        self.tie = tie

    def on_insert(self, key: Key) -> None:
        self._freq[key] = 1
        heapq.heappush(self._heap, (1, self._sign * next(self._seq), key))

    def on_access(self, key: Key) -> None:
        if key not in self._freq:
            raise KeyError(key)
        self._freq[key] += 1
        heapq.heappush(
            self._heap,
            (self._freq[key], self._sign * next(self._seq), key))

    def remove(self, key: Key) -> None:
        self._freq.pop(key, None)   # heap entries invalidated lazily

    def victim(self) -> Optional[Key]:
        while self._heap:
            freq, _, key = self._heap[0]
            if self._freq.get(key) != freq:
                heapq.heappop(self._heap)   # stale entry
                continue
            return key
        return None

    def __len__(self) -> int:
        return len(self._freq)


class LRUPolicy:
    def __init__(self) -> None:
        self._order: "OrderedDict[Key, None]" = OrderedDict()

    def on_insert(self, key: Key) -> None:
        self._order[key] = None
        self._order.move_to_end(key)

    def on_access(self, key: Key) -> None:
        if key not in self._order:
            raise KeyError(key)
        self._order.move_to_end(key)

    def remove(self, key: Key) -> None:
        self._order.pop(key, None)

    def victim(self) -> Optional[Key]:
        return next(iter(self._order)) if self._order else None

    def __len__(self) -> int:
        return len(self._order)


class FIFOPolicy:
    def __init__(self) -> None:
        self._order: "OrderedDict[Key, None]" = OrderedDict()

    def on_insert(self, key: Key) -> None:
        self._order[key] = None

    def on_access(self, key: Key) -> None:
        if key not in self._order:
            raise KeyError(key)

    def remove(self, key: Key) -> None:
        self._order.pop(key, None)

    def victim(self) -> Optional[Key]:
        return next(iter(self._order)) if self._order else None

    def __len__(self) -> int:
        return len(self._order)


class AdaptivePolicy:
    """Regret-switching LFU<->LRU via ghost lists (AFA-inspired).

    Tracks recently evicted keys per inner policy in bounded ghost lists;
    a hit on a ghost entry means that policy's eviction was a mistake.
    When one policy accumulates ``switch_margin`` more mistakes than the
    other, switch to the other.
    """

    def __init__(self, ghost_size: int = 512, switch_margin: int = 8) -> None:
        self._lfu, self._lru = LFUPolicy(), LRUPolicy()
        self._active: EvictionPolicy = self._lfu
        self._ghost_lfu: deque = deque(maxlen=ghost_size)
        self._ghost_lru: deque = deque(maxlen=ghost_size)
        self._regret = {"lfu": 0, "lru": 0}
        self._margin = switch_margin

    @property
    def active_name(self) -> str:
        return "lfu" if self._active is self._lfu else "lru"

    def on_insert(self, key: Key) -> None:
        if key in self._ghost_lfu:
            self._regret["lfu"] += 1
        if key in self._ghost_lru:
            self._regret["lru"] += 1
        self._maybe_switch()
        self._lfu.on_insert(key)
        self._lru.on_insert(key)

    def on_access(self, key: Key) -> None:
        self._lfu.on_access(key)
        self._lru.on_access(key)

    def remove(self, key: Key) -> None:
        # Record what each policy would have evicted into its ghost list.
        if self._lfu.victim() == key:
            self._ghost_lfu.append(key)
        if self._lru.victim() == key:
            self._ghost_lru.append(key)
        self._lfu.remove(key)
        self._lru.remove(key)

    def victim(self) -> Optional[Key]:
        return self._active.victim()

    def _maybe_switch(self) -> None:
        if self._regret["lfu"] - self._regret["lru"] >= self._margin:
            self._active = self._lru
        elif self._regret["lru"] - self._regret["lfu"] >= self._margin:
            self._active = self._lfu

    def __len__(self) -> int:
        return len(self._lfu)


POLICIES = {
    "lfu": LFUPolicy,
    "lru": LRUPolicy,
    "fifo": FIFOPolicy,
    "adaptive": AdaptivePolicy,
}


def make_policy(name: str) -> EvictionPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown eviction policy {name!r}; "
                         f"available: {sorted(POLICIES)}") from None


# ---------------------------------------------------------------------------
# Analytic policy models (the sweep engine's reuse-distance abstraction)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PolicyModel:
    """Analytic stand-in for a policy inside the vectorized sweep.

    The discrete policies above run per-key; the ScenarioLab sweep
    engine (``repro_torch.lab.fused_sweep``) cannot, so it models a cache holding a
    fraction ``f`` of the working set under Zipf(``alpha``)-skewed
    reuse with the hit curve

        h(f) = c * f**(1 - alpha) + (1 - c) * f

    ``concentration`` ``c`` is how closely the policy approximates
    keeping exactly the hottest ``f`` fraction resident (the
    frequency-ideal mass of the top-``f`` slice is ``f**(1-alpha)``):
    LFU with the scan-resistant admission filter tracks it, LRU mixes
    recency in and captures less of the skew, FIFO barely exploits it.
    At ``alpha == 0`` (uniform / cyclic-scan reuse) every policy
    degrades to ``h = f``, matching the admission-stabilized resident
    prefix :class:`~repro.core.store.ShardCache` sustains under cyclic
    scans (Sec. IV.B).
    """

    concentration: float

    def __post_init__(self) -> None:
        if not (0.0 <= self.concentration <= 1.0):
            raise ValueError("concentration must be in [0, 1]")


POLICY_MODELS: Dict[str, PolicyModel] = {
    "lfu": PolicyModel(concentration=1.0),
    "adaptive": PolicyModel(concentration=0.9),
    "lru": PolicyModel(concentration=0.65),
    "fifo": PolicyModel(concentration=0.35),
}


def policy_model(name: str) -> PolicyModel:
    """The analytic :class:`PolicyModel` behind a named policy."""
    try:
        return POLICY_MODELS[name]
    except KeyError:
        raise ValueError(f"no analytic model for policy {name!r}; "
                         f"available: {sorted(POLICY_MODELS)}") from None
