"""Managed in-memory stores (the paper's Alluxio analogue).

A copy of ``repro/core/store.py``.  A :class:`ManagedStore` is any
memory consumer whose capacity DynIMS may resize at runtime; the
actuation is an in-process ``set_capacity`` that evicts at once.

* :class:`ShardCache` -- byte-addressed object cache with a pluggable
  eviction policy (the paper uses LFU) and optional TinyLFU admission.
* :class:`KVBlockPool` -- the paged-KV block bookkeeping the serving
  engine draws its cache from: block grants per sequence, and
  preemption of whole sequences when the capacity shrinks (largest
  allocation first, then least recently touched).  Pure Python; it
  holds no device memory itself.
* :class:`StoreRegistry` -- splits one node-level capacity across its
  stores by priority.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Optional, Protocol, Tuple

from .eviction import EvictionPolicy, make_policy

Key = Hashable


@dataclass
class EvictionReport:
    """What a capacity change did (returned by ``set_capacity``)."""

    store: str
    requested_capacity: float
    applied_capacity: float
    evicted_keys: List[Key] = field(default_factory=list)
    evicted_bytes: float = 0.0


@dataclass
class StoreStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    rejected: int = 0              # inserts too large for current capacity
    bytes_evicted: float = 0.0
    bytes_read_remote: float = 0.0

    @property
    def hit_ratio(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class ManagedStore(Protocol):
    """Anything DynIMS can resize."""

    name: str
    priority: int                  # higher = keep memory longer

    def capacity(self) -> float: ...
    def used(self) -> float: ...
    def set_capacity(self, capacity: float) -> EvictionReport: ...


class ShardCache:
    """In-memory object cache with controller-adjustable capacity.

    Thread-safe.  ``get`` takes an optional ``loader`` so a miss can be
    transparently filled from the backing tier (OrangeFS in the paper,
    the on-disk shard store here); loader bytes are accounted in
    ``stats.bytes_read_remote`` -- the quantity the paper's Fig. 5
    hit-ratio argument is about.
    """

    def __init__(
        self,
        name: str = "shard-cache",
        capacity: float = 0.0,
        policy: str | EvictionPolicy = "lfu",
        priority: int = 0,
        sizeof: Callable[[object], float] = None,
        admission: bool = False,
    ) -> None:
        self.name = name
        self.priority = priority
        self._capacity = float(capacity)
        self._policy = make_policy(policy) if isinstance(policy, str) else policy
        self._data: Dict[Key, object] = {}
        self._sizes: Dict[Key, float] = {}
        self._used = 0.0
        self._sizeof = sizeof or _default_sizeof
        self._lock = threading.RLock()
        self.stats = StoreStats()
        # TinyLFU-style admission: a global access-frequency doorkeeper.
        # On a full cache a newcomer is admitted only if it has been seen
        # strictly more often than the eviction victim.  This is what
        # keeps a cyclic scan (the paper's iterative Spark apps) from
        # thrashing LFU and is how the static-Alluxio configuration
        # sustains a stable ~cache/partition hit ratio (Sec. IV.B).
        self._admission = admission
        self._seen: Dict[Key, int] = {}

    # -- ManagedStore interface -------------------------------------------
    def capacity(self) -> float:
        return self._capacity

    def used(self) -> float:
        return self._used

    def set_capacity(self, capacity: float) -> EvictionReport:
        """Resize; evict (policy order) until usage fits the new budget."""
        with self._lock:
            capacity = max(float(capacity), 0.0)
            report = EvictionReport(
                store=self.name, requested_capacity=capacity,
                applied_capacity=capacity)
            self._capacity = capacity
            self._evict_to(capacity, report)
            return report

    # -- cache interface ---------------------------------------------------
    def get(self, key: Key, loader: Optional[Callable[[], object]] = None):
        with self._lock:
            if self._admission:
                self._seen[key] = self._seen.get(key, 0) + 1
            if key in self._data:
                self.stats.hits += 1
                self._policy.on_access(key)
                return self._data[key]
            self.stats.misses += 1
        if loader is None:
            return None
        value = loader()
        self.stats.bytes_read_remote += self._sizeof(value)
        self.put(key, value)
        return value

    def put(self, key: Key, value: object) -> bool:
        """Insert; returns False if the object cannot fit at all."""
        size = self._sizeof(value)
        with self._lock:
            if key in self._data:
                self._used -= self._sizes[key]
                self._policy.remove(key)
            if size > self._capacity:
                self.stats.rejected += 1
                self._data.pop(key, None)
                self._sizes.pop(key, None)
                return False
            if self._admission and self._used + size > self._capacity:
                victim = self._policy.victim()
                if victim is not None and (
                        self._seen.get(key, 0) <= self._seen.get(victim, 0)):
                    self.stats.rejected += 1
                    return False
            report = EvictionReport(self.name, self._capacity, self._capacity)
            self._evict_to(self._capacity - size, report)
            self._data[key] = value
            self._sizes[key] = size
            self._used += size
            self._policy.on_insert(key)
            self.stats.insertions += 1
            return True

    def drop(self, key: Key) -> None:
        with self._lock:
            if key in self._data:
                self._used -= self._sizes.pop(key)
                del self._data[key]
                self._policy.remove(key)

    def __contains__(self, key: Key) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def keys(self) -> List[Key]:
        with self._lock:
            return list(self._data)

    def _evict_to(self, budget: float, report: EvictionReport) -> None:
        while self._used > budget:
            victim = self._policy.victim()
            if victim is None:
                break
            size = self._sizes.pop(victim, 0.0)
            self._data.pop(victim, None)
            self._policy.remove(victim)
            self._used -= size
            self.stats.evictions += 1
            self.stats.bytes_evicted += size
            report.evicted_keys.append(victim)
            report.evicted_bytes += size


def _default_sizeof(value: object) -> float:
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return float(nbytes)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return float(len(value))
    if isinstance(value, str):
        return float(len(value.encode()))
    raise TypeError(
        f"cannot size object of type {type(value).__name__}; "
        "pass sizeof= to ShardCache")


@dataclass
class SeqAllocation:
    seq_id: Key
    blocks: List[int] = field(default_factory=list)
    last_touch: int = 0


class KVBlockPool:
    """Paged-KV block bookkeeping with controller-adjustable capacity.

    The serving engine owns the actual ``(num_blocks, block_tokens, ...)``
    device arrays; this pool hands out block indices, maintains per-
    sequence block tables, and -- when DynIMS shrinks it -- preempts
    whole sequences (largest-allocation-first, then least-recently-
    touched) and reports them so the engine can requeue their requests.
    Preemption over partial-block eviction keeps KV pages consistent,
    which is the accelerator analogue of Alluxio evicting whole blocks.
    """

    def __init__(self, name: str, num_blocks: int, block_bytes: float,
                 priority: int = 1) -> None:
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.name = name
        self.priority = priority
        self.total_blocks = int(num_blocks)
        self.block_bytes = float(block_bytes)
        self._usable = int(num_blocks)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._seqs: Dict[Key, SeqAllocation] = {}
        self._clock = 0
        self._lock = threading.RLock()
        self.preempted: List[Key] = []     # drained by the serving engine
        self.stats = StoreStats()

    # -- ManagedStore interface -------------------------------------------
    def capacity(self) -> float:
        return self._usable * self.block_bytes

    def used(self) -> float:
        with self._lock:
            n = sum(len(s.blocks) for s in self._seqs.values())
        return n * self.block_bytes

    def set_capacity(self, capacity: float) -> EvictionReport:
        with self._lock:
            usable = int(max(capacity, 0.0) // self.block_bytes)
            usable = min(usable, self.total_blocks)
            report = EvictionReport(
                store=self.name, requested_capacity=capacity,
                applied_capacity=usable * self.block_bytes)
            self._usable = usable
            # Preempt sequences until allocation fits the usable budget.
            while self._allocated_blocks() > self._usable:
                victim = self._preemption_victim()
                if victim is None:
                    break
                freed = self._release(victim)
                self.preempted.append(victim)
                self.stats.evictions += 1
                self.stats.bytes_evicted += freed * self.block_bytes
                report.evicted_keys.append(victim)
                report.evicted_bytes += freed * self.block_bytes
            return report

    # -- allocator interface -----------------------------------------------
    def alloc_block(self, seq_id: Key) -> Optional[int]:
        """Allocate one block to ``seq_id``; None if at budget."""
        with self._lock:
            self._clock += 1
            if self._allocated_blocks() >= self._usable or not self._free:
                self.stats.rejected += 1
                return None
            blk = self._free.pop()
            alloc = self._seqs.setdefault(seq_id, SeqAllocation(seq_id))
            alloc.blocks.append(blk)
            alloc.last_touch = self._clock
            self.stats.insertions += 1
            return blk

    def touch(self, seq_id: Key) -> None:
        with self._lock:
            self._clock += 1
            if seq_id in self._seqs:
                self._seqs[seq_id].last_touch = self._clock

    def free_seq(self, seq_id: Key) -> int:
        with self._lock:
            return self._release(seq_id)

    def block_table(self, seq_id: Key) -> List[int]:
        with self._lock:
            alloc = self._seqs.get(seq_id)
            return list(alloc.blocks) if alloc else []

    def num_free_blocks(self) -> int:
        with self._lock:
            return self._usable - self._allocated_blocks()

    def drain_preempted(self) -> List[Key]:
        with self._lock:
            out, self.preempted = self.preempted, []
            return out

    def live_sequences(self) -> List[Key]:
        with self._lock:
            return list(self._seqs)

    # -- internals ----------------------------------------------------------
    def _allocated_blocks(self) -> int:
        return sum(len(s.blocks) for s in self._seqs.values())

    def _release(self, seq_id: Key) -> int:
        alloc = self._seqs.pop(seq_id, None)
        if alloc is None:
            return 0
        for blk in alloc.blocks:
            self._free.append(blk)
        return len(alloc.blocks)

    def _preemption_victim(self) -> Optional[Key]:
        if not self._seqs:
            return None
        # Largest allocation first (frees most per preemption), then LRU.
        return max(
            self._seqs.values(),
            key=lambda s: (len(s.blocks), -s.last_touch),
        ).seq_id


class StoreRegistry:
    """Per-node registry splitting one capacity signal across N stores.

    The paper controls a single Alluxio worker per node; a serving or
    training worker has several resizable tenants (dataset cache, KV pool, checkpoint staging
    buffers).  The registry applies the controller's node-level capacity
    ``u`` with a priority waterfall: stores are filled highest-priority
    first, each up to its own ``max_bytes``.
    """

    def __init__(self) -> None:
        self._stores: List[Tuple[ManagedStore, float]] = []   # (store, max)

    def register(self, store: ManagedStore, max_bytes: float) -> None:
        self._stores.append((store, float(max_bytes)))
        self._stores.sort(key=lambda t: -t[0].priority)

    def stores(self) -> List[ManagedStore]:
        return [s for s, _ in self._stores]

    def total_used(self) -> float:
        return sum(s.used() for s, _ in self._stores)

    def total_capacity(self) -> float:
        return sum(s.capacity() for s, _ in self._stores)

    def apply_capacity(self, u: float) -> List[EvictionReport]:
        remaining = max(float(u), 0.0)
        reports = []
        for store, max_bytes in self._stores:
            grant = min(remaining, max_bytes)
            reports.append(store.set_capacity(grant))
            remaining -= grant
        return reports
