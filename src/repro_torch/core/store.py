"""Paged-KV block bookkeeping the serving engine draws its cache from.

A copy of ``KVBlockPool`` (with ``SeqAllocation``, ``EvictionReport`` and
``StoreStats``) from ``repro/core/store.py``: block grants per sequence,
preemption of whole sequences when the capacity shrinks (largest
allocation first, then least recently touched), and ``set_capacity``,
the resize a DynIMS controller actuates.  Pure Python; it holds no
device memory itself.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional

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
