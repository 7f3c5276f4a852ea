"""Memory monitoring agents (the paper's collectd analogue).

The port of ``repro/core/monitor.py``.  Each agent samples one node's
memory state and emits a ``MemorySample``; ``to_json``/``from_json``
mirror the paper's JSON-over-Kafka metric encoding so samples can travel
the :mod:`repro_torch.core.bus` unchanged.

Three agents:

* :class:`HostMemoryMonitor` -- reads ``/proc/meminfo`` (psutil
  fallback): the host-RAM view that governs a dataset shard cache.
* :class:`DeviceMemoryMonitor` -- one device's memory through PyTorch's
  allocator counters.  Governs the serving KV-block pool.
* :class:`SimulatedMonitor` -- trace- or callback-driven, with seeded
  fault injection; a copy, bit for bit, of the JAX package's.
"""

from __future__ import annotations

import json
import time
import zlib
from dataclasses import asdict, dataclass
from typing import Callable, Iterator, Mapping, Optional, Protocol, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class MonitorFault(RuntimeError):
    """A monitor failed to produce a sample (dropout / crash / timeout).

    The health layer in :mod:`repro_torch.core.plane` catches this (and
    any other exception from ``sample()``) and degrades to the last-good
    holdover instead of letting one dead sensor take the interval down.
    """


@dataclass(frozen=True)
class MemorySample:
    """One observation of a node's memory state (bytes)."""

    node: str
    timestamp: float
    used: float           # v_i: total used incl. in-memory storage
    total: float          # M
    storage_used: float = 0.0   # portion attributable to managed stores
    swap_used: float = 0.0

    @property
    def utilization(self) -> float:
        return self.used / self.total if self.total else 0.0

    @property
    def compute_used(self) -> float:
        """Usage attributable to the priority (compute) tenant."""
        return max(self.used - self.storage_used, 0.0)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @staticmethod
    def from_json(payload: str) -> "MemorySample":
        return MemorySample(**json.loads(payload))


class MemoryMonitor(Protocol):
    def sample(self) -> MemorySample: ...


def _read_proc_meminfo() -> Optional[dict]:
    try:
        with open("/proc/meminfo") as fh:
            fields = {}
            for line in fh:
                key, _, rest = line.partition(":")
                fields[key.strip()] = int(rest.strip().split()[0]) * 1024
            return fields
    except (OSError, ValueError, IndexError):
        return None


class HostMemoryMonitor:
    """Samples host RAM from /proc/meminfo (psutil fallback)."""

    def __init__(self, node: str = "localhost",
                 storage_used_fn: Optional[Callable[[], float]] = None):
        self.node = node
        self._storage_used_fn = storage_used_fn or (lambda: 0.0)

    def sample(self) -> MemorySample:
        info = _read_proc_meminfo()
        if info is not None:
            total = float(info["MemTotal"])
            avail = float(info.get("MemAvailable", info.get("MemFree", 0)))
            swap = float(info.get("SwapTotal", 0) - info.get("SwapFree", 0))
            used = total - avail
        else:  # pragma: no cover - psutil fallback path
            import psutil
            vm = psutil.virtual_memory()
            total, used = float(vm.total), float(vm.total - vm.available)
            swap = float(psutil.swap_memory().used)
        return MemorySample(
            node=self.node, timestamp=time.time(), used=used, total=total,
            storage_used=float(self._storage_used_fn()), swap_used=swap,
        )


class DeviceMemoryMonitor:
    """Samples one device's memory through PyTorch's allocator counters.

    On a CUDA device ``total`` is the card's memory as
    ``torch.cuda.mem_get_info`` reports it, read once at construction
    (the counterpart of XLA's ``bytes_limit``), and ``used`` is
    ``torch.cuda.memory_allocated``: the bytes of live tensors (XLA's
    ``bytes_in_use``), not the allocator's reserve, so freeing a tensor
    lowers it.  Neither read waits for the device.  The CPU device keeps
    no such counters: there ``total`` is ``assumed_total`` and ``used``
    0, as the JAX monitor reads on its CPU backend.  On a card a counter
    that cannot be read raises; it never falls back to ``assumed_total``.

    ``device=None`` means the card and raises without one.
    """

    def __init__(self, device: DeviceLike = None,
                 node: Optional[str] = None,
                 assumed_total: float = 16 * 2**30,
                 storage_used_fn: Optional[Callable[[], float]] = None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"no memory counters on a {dev.type} device")
        self.device = dev
        self.node = node or f"{dev.type}:{dev.index or 0}"
        self.assumed_total = assumed_total
        self._storage_used_fn = storage_used_fn or (lambda: 0.0)
        self.total = (float(torch.cuda.mem_get_info(dev)[1])
                      if dev.type == "cuda" else float(assumed_total))

    def sample(self) -> MemorySample:
        used = (float(torch.cuda.memory_allocated(self.device))
                if self.device.type == "cuda" else 0.0)
        return MemorySample(
            node=self.node, timestamp=time.time(), used=used,
            total=self.total, storage_used=float(self._storage_used_fn()),
        )


#: Fault modes a SimulatedMonitor can deterministically inject.
SIM_FAULT_KINDS = ("dropout", "freeze", "nan")


class SimulatedMonitor:
    """Trace- or callback-driven monitor for simulation and tests.

    ``faults`` turns on deterministic fault injection: a mapping from
    fault kind (``"dropout"`` raises :class:`MonitorFault`,
    ``"freeze"`` re-delivers the previous sample verbatim, ``"nan"``
    corrupts ``used``) to a per-tick probability.  Whether tick ``i``
    faults -- and which kind fires -- is a pure function of
    ``(fault_seed, node, i)``, so chaos tests replay bit-identically
    with no wall-clock timing involved.
    """

    def __init__(
        self,
        node: str,
        total: float,
        usage: Sequence[float] | Callable[[int], float],
        storage_used_fn: Optional[Callable[[], float]] = None,
        dt: float = 0.1,
        faults: Optional[Mapping[str, float]] = None,
        fault_seed: int = 0,
    ):
        self.node = node
        self.total = float(total)
        self._usage = usage
        self._storage_used_fn = storage_used_fn or (lambda: 0.0)
        self._dt = dt
        self._i = 0
        if faults:
            unknown = set(faults) - set(SIM_FAULT_KINDS)
            if unknown:
                raise ValueError(
                    f"unknown fault kinds {sorted(unknown)}; "
                    f"choose from {SIM_FAULT_KINDS}")
        self._faults = dict(faults or {})
        self._fault_seed = int(fault_seed)
        self._last: Optional[MemorySample] = None

    def _fault_at(self, i: int) -> Optional[str]:
        """Which fault (if any) fires at tick ``i`` -- pure, seeded."""
        if not self._faults:
            return None
        rng = np.random.default_rng(
            [self._fault_seed, zlib.crc32(self.node.encode()), i])
        for kind in SIM_FAULT_KINDS:          # fixed order: deterministic
            p = self._faults.get(kind, 0.0)
            if p > 0.0 and rng.random() < p:
                return kind
        return None

    def sample(self) -> MemorySample:
        i = self._i
        self._i += 1
        if callable(self._usage):
            used = float(self._usage(i))
        else:
            used = float(self._usage[min(i, len(self._usage) - 1)])
        s = MemorySample(
            node=self.node, timestamp=i * self._dt,
            used=used + self._storage_used_fn(),
            total=self.total, storage_used=float(self._storage_used_fn()),
            swap_used=max(0.0, used + self._storage_used_fn() - self.total),
        )
        kind = self._fault_at(i)
        if kind == "dropout":
            raise MonitorFault(f"{self.node}: simulated dropout at tick {i}")
        if kind == "freeze" and self._last is not None:
            return self._last                  # stuck sensor: stale repeat
        if kind == "nan":
            s = MemorySample(
                node=s.node, timestamp=s.timestamp, used=float("nan"),
                total=s.total, storage_used=s.storage_used,
                swap_used=s.swap_used)
            return s                           # corrupt: not cached as good
        self._last = s
        return s

    def __iter__(self) -> Iterator[MemorySample]:
        while True:
            yield self.sample()
