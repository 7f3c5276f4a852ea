"""ChaosPlane: declarative, seed-deterministic fault injection.

A copy of ``repro/runtime/chaos.py`` over the port's planes: the same
schedule (:meth:`ChaosSpec.fires`, zlib- and numpy-seeded) delivers the
same faults to a port plane as to a JAX one, tick for tick.  A proxy's
sleep (``slow-sample``, ``actuate-timeout``) never holds a device sync:
an array plane on a card reads ``u_next`` back before it actuates.

DynIMS exists because a compute burst acted on late is a swap storm
(PAPER.md Sec. II.B/III); the dual claim -- that the *controller*
degrades gracefully when its own sensors and actuators fail -- needs an
adversary to prove.  This module is that adversary: a
:class:`ChaosSpec` declares *which* faults hit *which* nodes *when*,
and :func:`inject` wires it into a live
:class:`~repro_torch.core.plane.MemoryPlane` or
:class:`~repro_torch.fleet.plane.FleetPlane` purely by proxying its monitors
and store registries -- the code under test is never modified, and the
health layer in ``core/plane.py`` is exercised exactly as deployed.

Determinism: whether fault ``f`` fires on node ``n`` at tick ``t`` is a
pure function of ``(spec.seed, f, n, t)``, so a chaos run replays
bit-identically -- no wall-clock coin flips, no flaky CI.

Fault catalog (``FaultSpec.kind``):

==================  ======================================================
``dropout``         monitor raises (sensor gone)
``freeze``          monitor re-delivers its last sample (sensor stuck)
``nan`` / ``inf``   monitor reports non-finite ``used``
``negative``        monitor reports negative ``used``
``slow-sample``     monitor blocks ``magnitude`` seconds before answering
``crash``           node down: monitor raises AND actuation raises
``actuate-raise``   ``set_capacity`` raises (store wedged)
``actuate-timeout`` actuation blocks ``magnitude`` seconds, then raises
``actuate-partial`` only ``magnitude`` of the capacity delta lands
``retune-kill``     ``plane.capture()`` raises, killing a retune round
==================  ======================================================

Usage::

    spec = ChaosSpec(faults=(
        FaultSpec("nan", nodes=("node0",), start=10, duration=20,
                  probability=0.5),
        FaultSpec("crash", nodes=("node3",), start=40, duration=30),
    ), seed=0)
    with inject(plane, spec) as chaos:
        for _ in range(200):
            plane.tick()
    print(chaos.counts(), plane.health().summary())
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.monitor import MemoryMonitor, MemorySample, MonitorFault

FAULT_KINDS = (
    "dropout", "freeze", "nan", "inf", "negative", "slow-sample", "crash",
    "actuate-raise", "actuate-timeout", "actuate-partial", "retune-kill",
)

#: Fault kinds applied on the telemetry (monitor) path.
TELEMETRY_KINDS = ("dropout", "freeze", "nan", "inf", "negative",
                   "slow-sample", "crash")
#: Fault kinds applied on the actuation (registry) path.
ACTUATION_KINDS = ("actuate-raise", "actuate-timeout", "actuate-partial",
                   "crash")

_DEFAULT_MAGNITUDE = {
    "slow-sample": 0.01,      # seconds the sample blocks
    "actuate-timeout": 0.0,   # seconds the actuation blocks (then raises)
    "actuate-partial": 0.5,   # fraction of the capacity delta applied
}


class ChaosError(MonitorFault):
    """An injected fault (monitor or actuation path)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault family scheduled onto part of the fleet.

    Fields:
      kind:        one of :data:`FAULT_KINDS`.
      nodes:       node names hit by this fault; None = every node.
      start:       first tick (inclusive) the fault is eligible.
      duration:    ticks the window stays open; None = forever.
      probability: per-tick firing chance while the window is open
                   (1.0 = every tick in the window).
      magnitude:   kind-specific knob (seconds for ``slow-sample`` /
                   ``actuate-timeout``, applied fraction for
                   ``actuate-partial``); None uses the kind's default.
    """

    kind: str
    nodes: Optional[Tuple[str, ...]] = None
    start: int = 0
    duration: Optional[int] = None
    probability: float = 1.0
    magnitude: Optional[float] = None

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {FAULT_KINDS}")
        if self.nodes is not None:
            object.__setattr__(self, "nodes", tuple(self.nodes))
        if self.start < 0:
            raise ValueError("start must be >= 0")
        if self.duration is not None and self.duration < 1:
            raise ValueError("duration must be >= 1 (or None for forever)")
        if not 0.0 < self.probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")

    def effective_magnitude(self) -> float:
        if self.magnitude is not None:
            return float(self.magnitude)
        return _DEFAULT_MAGNITUDE.get(self.kind, 0.0)

    def covers(self, node: str) -> bool:
        return self.nodes is None or node in self.nodes

    def open_at(self, t: int) -> bool:
        if t < self.start:
            return False
        return self.duration is None or t < self.start + self.duration

    def replace(self, **kw) -> "FaultSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """A full fault schedule: what the adversary throws at the plane."""

    faults: Tuple[FaultSpec, ...]
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "faults", tuple(self.faults))
        for f in self.faults:
            if not isinstance(f, FaultSpec):
                raise TypeError(f"faults must be FaultSpec, got {type(f)}")

    def replace(self, **kw) -> "ChaosSpec":
        return dataclasses.replace(self, **kw)

    def fires(self, fault_index: int, node: str, t: int) -> bool:
        """Does fault ``fault_index`` hit ``node`` at tick ``t``?

        Pure and order-independent: seeded per ``(seed, fault, node,
        tick)``, so the schedule replays identically however the
        queries interleave.
        """
        f = self.faults[fault_index]
        if not (f.open_at(t) and f.covers(node)):
            return False
        if f.probability >= 1.0:
            return True
        rng = np.random.default_rng(
            [self.seed, fault_index, zlib.crc32(node.encode()), t])
        return bool(rng.random() < f.probability)


@dataclasses.dataclass(frozen=True)
class InjectedFault:
    """One fault actually delivered (the injector's own audit log)."""

    kind: str
    node: str
    tick: int


class _Clock:
    """Shared tick counter: advanced once per outer ``tick()``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._now = -1                 # guarded-by: _lock

    def advance(self) -> int:
        with self._lock:
            self._now += 1
            return self._now

    def now(self) -> int:
        with self._lock:
            return self._now


class _EventLog:
    """Thread-safe append-only audit log of delivered faults."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[InjectedFault] = []   # guarded-by: _lock

    def add(self, kind: str, node: str, tick: int) -> None:
        with self._lock:
            self._events.append(InjectedFault(kind, node, tick))

    def snapshot(self) -> List[InjectedFault]:
        with self._lock:
            return list(self._events)


class ChaosMonitor:
    """Telemetry-path fault proxy around one node's monitor.

    Always advances the underlying monitor (the *world* keeps moving;
    only the *sensor* misbehaves), then corrupts, freezes, delays, or
    drops the observation according to the schedule.
    """

    def __init__(self, base: MemoryMonitor, node: str, spec: ChaosSpec,
                 clock: _Clock, events: _EventLog):
        self._base = base
        self._node = node
        self._spec = spec
        self._clock = clock
        self._events = events
        self._indices = [i for i, f in enumerate(spec.faults)
                         if f.kind in TELEMETRY_KINDS and f.covers(node)]
        self._last: Optional[MemorySample] = None

    def _fires(self, t: int) -> Dict[str, FaultSpec]:
        out: Dict[str, FaultSpec] = {}
        for i in self._indices:
            if self._spec.fires(i, self._node, t):
                out.setdefault(self._spec.faults[i].kind,
                               self._spec.faults[i])
        return out

    def sample(self) -> MemorySample:
        t = self._clock.now()
        fired = self._fires(t)
        if "slow-sample" in fired:
            self._events.add("slow-sample", self._node, t)
            time.sleep(fired["slow-sample"].effective_magnitude())
        try:
            s = self._base.sample()
        except Exception:
            # The base monitor faulted on its own; let it through --
            # the health layer treats it like any dropout.
            raise
        if "crash" in fired or "dropout" in fired:
            kind = "crash" if "crash" in fired else "dropout"
            self._events.add(kind, self._node, t)
            raise ChaosError(f"{self._node}: injected {kind} at tick {t}")
        if "freeze" in fired and self._last is not None:
            self._events.add("freeze", self._node, t)
            return self._last
        for kind, bad in (("nan", float("nan")), ("inf", float("inf")),
                          ("negative", None)):
            if kind in fired:
                self._events.add(kind, self._node, t)
                used = -abs(s.used) - 1.0 if bad is None else bad
                return MemorySample(
                    node=s.node, timestamp=s.timestamp, used=used,
                    total=s.total, storage_used=s.storage_used,
                    swap_used=s.swap_used)
        self._last = s
        return s


class ChaosRegistry:
    """Actuation-path fault proxy around one node's store registry."""

    def __init__(self, base, node: str, spec: ChaosSpec, clock: _Clock,
                 events: _EventLog):
        self._base = base
        self._node = node
        self._spec = spec
        self._clock = clock
        self._events = events
        self._indices = [i for i, f in enumerate(spec.faults)
                         if f.kind in ACTUATION_KINDS and f.covers(node)]

    # -- delegation ---------------------------------------------------------
    def register(self, store, max_bytes: float) -> None:
        self._base.register(store, max_bytes)

    def stores(self):
        return self._base.stores()

    def total_used(self) -> float:
        return self._base.total_used()

    def total_capacity(self) -> float:
        return self._base.total_capacity()

    # -- faulted actuation --------------------------------------------------
    def apply_capacity(self, u: float) -> list:
        t = self._clock.now()
        fired = {self._spec.faults[i].kind: self._spec.faults[i]
                 for i in self._indices if self._spec.fires(i, self._node, t)}
        if "crash" in fired or "actuate-raise" in fired:
            kind = "crash" if "crash" in fired else "actuate-raise"
            self._events.add(kind, self._node, t)
            raise ChaosError(
                f"{self._node}: injected {kind} actuation at tick {t}")
        if "actuate-timeout" in fired:
            self._events.add("actuate-timeout", self._node, t)
            time.sleep(fired["actuate-timeout"].effective_magnitude())
            raise ChaosError(
                f"{self._node}: injected actuation timeout at tick {t}")
        if "actuate-partial" in fired:
            self._events.add("actuate-partial", self._node, t)
            frac = fired["actuate-partial"].effective_magnitude()
            cur = self._base.total_capacity()
            return self._base.apply_capacity(cur + frac * (u - cur))
        return self._base.apply_capacity(u)


class ChaosHandle:
    """A live injection: proxies installed, clock wired, revertible.

    Usable as a context manager; :meth:`revert` restores every proxied
    monitor, registry, and method so the plane runs clean again (the
    way a chaos drill ends: faults stop, the plane must rejoin).
    """

    def __init__(self, target, spec: ChaosSpec):
        self.spec = spec
        self.target = target
        self.clock = _Clock()
        self._events = _EventLog()
        self._undo: List = []
        self._reverted = False
        planes = self._member_planes(target)
        for plane in planes:
            self._wire_plane(plane)
        # The outer tick drives the fault schedule's clock.
        orig_tick = target.tick

        def _ticked(*a, **kw):
            self.clock.advance()
            return orig_tick(*a, **kw)

        target.tick = _ticked
        self._undo.append(lambda: setattr(target, "tick", orig_tick))
        self._wire_retune_kill(planes)

    @staticmethod
    def _member_planes(target) -> List:
        tenants = getattr(target, "_tenants", None)
        if tenants is not None:                       # FleetPlane
            return [rt.plane for rt in tenants.values()]
        return [target]                               # MemoryPlane

    def _wire_plane(self, plane) -> None:
        # Proxy monitors and the raw registries *inside* the plane's
        # actuation shield, under the plane's own wiring lock, so a
        # concurrently ticking plane never sees a half-installed proxy.
        with plane._lock:
            for node, mon in list(plane._monitors.items()):
                proxy = ChaosMonitor(mon, node, self.spec, self.clock,
                                     self._events)
                plane._monitors[node] = proxy
                self._undo.append(
                    lambda p=plane, n=node, m=mon: p._monitors
                    .__setitem__(n, m))
            for node, shield in list(plane._registries.items()):
                inner = shield._inner
                shield._inner = ChaosRegistry(inner, node, self.spec,
                                              self.clock, self._events)
                self._undo.append(
                    lambda s=shield, i=inner: setattr(s, "_inner", i))

    def _wire_retune_kill(self, planes: List) -> None:
        if not any(f.kind == "retune-kill" for f in self.spec.faults):
            return
        idx = [i for i, f in enumerate(self.spec.faults)
               if f.kind == "retune-kill"]
        for plane in planes:
            orig = getattr(plane, "capture", None)
            if orig is None:
                continue

            def _capture(*a, _orig=orig, _plane=plane, **kw):
                t = self.clock.now()
                for i in idx:
                    if self.spec.fires(i, "retune", t):
                        self._events.add("retune-kill", "retune", t)
                        raise ChaosError(
                            f"injected retune kill at tick {t}")
                return _orig(*a, **kw)

            plane.capture = _capture
            self._undo.append(
                lambda p=plane, o=orig: setattr(p, "capture", o))

    # -- audit ---------------------------------------------------------------
    def events(self) -> List[InjectedFault]:
        """Every fault actually delivered, in delivery order."""
        return self._events.snapshot()

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self._events.snapshot():
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    # -- lifecycle -----------------------------------------------------------
    def revert(self) -> None:
        """Uninstall every proxy; the plane runs clean afterwards."""
        if self._reverted:
            return
        self._reverted = True
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    def __enter__(self) -> "ChaosHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.revert()


def inject(target, spec: ChaosSpec) -> ChaosHandle:
    """Install ``spec``'s fault schedule into a live plane.

    ``target`` is a :class:`~repro_torch.core.plane.MemoryPlane` or a
    :class:`~repro_torch.fleet.plane.FleetPlane` (every tenant's nested plane
    is wired; the fleet tick drives the shared clock).  Returns a
    :class:`ChaosHandle`; ``handle.revert()`` (or leaving the context)
    uninstalls everything.
    """
    return ChaosHandle(target, spec)
