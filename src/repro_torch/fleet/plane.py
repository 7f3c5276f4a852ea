"""FleetPlane: the live two-level multi-tenant control plane.

A copy of ``repro/fleet/plane.py`` over the port's
:class:`~repro_torch.core.plane.MemoryPlane`.  Each nested plane
inherits its tenant's ``PlaneSpec.device``: on a card every tenant's
array backend runs its fused step on a CUDA stream of its own, with one
readback per tick, and ``device="cpu"`` ticks the whole fleet on the
host.  On the CPU its budgets equal the JAX package's FleetPlane bit for
bit (the arbiter is the same float64 numpy; the tenants' steps are
JAX's roundings, ``core/plane.py``).

Level two of the hierarchy declared in :mod:`repro_torch.fleet.specs`: a
:class:`FleetPlane` nests one :class:`~repro_torch.core.plane.MemoryPlane`
per tenant inside the budgets a :class:`~repro_torch.fleet.arbiter.FleetArbiter`
grants.  Nesting is pure spec composition -- each tenant's declared
``PlaneSpec`` is re-derived with budget-sized ``params`` (the tenant's
grant plays the role of ``total_memory``) and with its monitors wrapped
in :class:`TenantMonitor` so the nested loop observes utilization
*of the grant*, not of the physical node.  The tenant's Eq. 1 loop is
otherwise exactly the standalone one; a tenant spec runs unmodified
inside or outside a fleet.

Budget changes ride the existing epoch-stamped hot-swap machinery:
:meth:`FleetPlane.rebalance` pushes each tenant's new budget through
``MemoryPlane.swap_params`` (prewarmed off-lock, committed at an
interval boundary), so **no tenant interval ever runs under a torn
budget** -- every :class:`~repro_torch.core.controller.ControlAction` is
stamped with the parameter epoch of the budget it was decided under.
Shrinking tenants commit before growing ones, so the instantaneous sum
of live budgets never exceeds the physical node memory even mid-swap.

Lock hierarchy (acyclic, leaf-to-root)::

    FleetPlane._tick_lock
      -> MemoryPlane._tick_lock (per tenant)
           -> ArrayController._lock
    FleetPlane._lock            (budget/telemetry snapshot state; leaf)
    FleetArbiter._lock          (leaf; never held around plane calls)
    _BudgetRef._lock            (leaf; single float)
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core.controller import ControlAction
from ..core.monitor import MemoryMonitor, MemorySample
from ..core.plane import (DEFAULT_FAULT_LOG, FaultEvent, FaultLog,
                          HealthReport, MemoryPlane, PlaneSpec)
from .arbiter import (FleetArbiter, FleetGrant, MIN_TENANT_BUDGET,
                      TenantTelemetry)
from .specs import FleetSpec, TenantSpec


class _BudgetRef:
    """A thread-safe mutable float: one tenant's live budget (bytes)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: float) -> None:
        self._lock = threading.Lock()
        self._value = float(value)     # guarded-by: _lock

    def get(self) -> float:
        with self._lock:
            return self._value

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class TenantMonitor:
    """Budget-scoped view of a node: the composition shim.

    Wraps the tenant's declared monitor so the nested plane's
    aggregator and controller see the *grant* as the node total -- the
    tenant's utilization ratio is usage-of-budget, and the array
    backend's per-node ``M`` self-heals to the live budget on the very
    next flush after a rebalance (``agg.total`` drives it).  ``used``
    and ``storage_used`` pass through untouched: what the tenant does
    inside its grant is its own business.
    """

    def __init__(self, base: MemoryMonitor, budget: _BudgetRef) -> None:
        self._base = base
        self._budget = budget

    def sample(self) -> MemorySample:
        s = self._base.sample()
        return MemorySample(
            node=s.node, timestamp=s.timestamp, used=s.used,
            total=self._budget.get(), storage_used=s.storage_used,
            swap_used=s.swap_used)


class _TenantRuntime:
    """One tenant's nested plane plus its telemetry accumulators."""

    __slots__ = ("spec", "budget", "plane", "u_max0", "u_min0", "stores",
                 "util_sum", "util_n", "hits0", "misses0", "last_telemetry")

    def __init__(self, spec: TenantSpec, budget: _BudgetRef,
                 plane: MemoryPlane) -> None:
        self.spec = spec
        self.budget = budget
        self.plane = plane
        self.u_max0 = spec.plane.params.u_max
        self.u_min0 = spec.plane.params.u_min
        self.stores = [s.store if hasattr(s, "store") else s[0]
                       for ns in spec.plane.nodes for s in ns.stores]
        # epoch accumulators -- guarded-by: FleetPlane._lock
        self.util_sum = 0.0
        self.util_n = 0
        self.hits0 = 0
        self.misses0 = 0
        # last telemetry from a *non-quarantined* epoch; what operators
        # see for a dark tenant -- guarded-by: FleetPlane._lock
        self.last_telemetry: Optional[TenantTelemetry] = None

    def budget_params(self, budget: float):
        """The tenant's law params re-sized to ``budget`` bytes."""
        u_max = min(self.u_max0, budget)
        return self.spec.plane.params.replace(
            total_memory=max(budget, MIN_TENANT_BUDGET),
            u_max=u_max, u_min=min(self.u_min0, u_max))

    def hit_counts(self) -> Tuple[int, int]:
        hits = misses = 0
        for store in self.stores:
            stats = getattr(store, "stats", None)
            if stats is not None:
                hits += stats.hits
                misses += stats.misses
        return hits, misses


class FleetPlane:
    """N tenants' DynIMS loops arbitrated over one physical fleet.

    Drive it like a :class:`~repro_torch.core.plane.MemoryPlane`: one
    :meth:`tick` per control interval runs *every* tenant's nested
    loop; every ``spec.epoch_intervals`` ticks the closing epoch's
    telemetry is folded through the arbiter and the new budgets are
    hot-swapped in.  ``tick`` returns the tenants' actions keyed by
    tenant name.
    """

    def __init__(self, spec: FleetSpec,
                 node_memory: Optional[float] = None) -> None:
        self.spec = spec
        self.node_memory = float(node_memory if node_memory is not None
                                 else spec.fleet_memory_bytes)
        self.arbiter = FleetArbiter(spec)
        self._lock = threading.Lock()
        # Serializes whole fleet intervals against budget commits, the
        # same boundary discipline MemoryPlane._tick_lock gives one
        # plane: an interval never observes half-old, half-new budgets.
        self._tick_lock = threading.Lock()
        self._intervals = 0                 # guarded-by: _tick_lock
        self._last_grant: Optional[FleetGrant] = None  # guarded-by: _lock
        # Fleet-level degradation log (tenant quarantines, rebalance
        # rollbacks); tenant-internal faults live in each nested
        # plane's own fault_log.
        self.fault_log = FaultLog(DEFAULT_FAULT_LOG)
        self._quarantined: set = set()      # guarded-by: _lock
        budgets0 = self.arbiter.initial_budgets(self.node_memory)
        self._tenants: Dict[str, _TenantRuntime] = {}
        for t in spec.tenants:
            ref = _BudgetRef(budgets0[t.name])
            runtime = _TenantRuntime(
                t, ref, MemoryPlane(self._nest(t, ref, budgets0[t.name])))
            h, m = runtime.hit_counts()
            runtime.hits0, runtime.misses0 = h, m
            self._tenants[t.name] = runtime

    @staticmethod
    def _nest(tenant: TenantSpec, ref: _BudgetRef,
              budget: float) -> PlaneSpec:
        """Derive the tenant's inner spec: budget-sized, budget-scoped.

        Per-node ``params`` overrides are rejected -- the nested
        plane's capacity fields *are* the budget, and a node pinned to
        its own ``total_memory`` would silently escape arbitration.
        """
        for ns in tenant.plane.nodes:
            if ns.params is not None:
                raise ValueError(
                    f"tenant {tenant.name!r} node {ns.name!r} carries a "
                    "per-node params override; tenant planes must leave "
                    "capacity sizing to the fleet arbiter")
        p = tenant.plane.params
        u_max = min(p.u_max, budget)
        params = p.replace(total_memory=max(budget, MIN_TENANT_BUDGET),
                           u_max=u_max, u_min=min(p.u_min, u_max))
        nodes = tuple(
            ns.replace(monitor=TenantMonitor(ns.monitor, ref))
            for ns in tenant.plane.nodes)
        return tenant.plane.replace(params=params, nodes=nodes)

    # -- introspection -------------------------------------------------------
    def tenants(self) -> List[str]:
        return list(self._tenants)

    def plane(self, name: str) -> MemoryPlane:
        """The named tenant's live nested plane."""
        return self._tenants[name].plane

    def budgets(self) -> Dict[str, float]:
        """Live per-tenant budgets (bytes).  Always conserving: the
        shrink-first commit order keeps the sum <= node memory even
        when read mid-rebalance."""
        return {name: rt.budget.get() for name, rt in self._tenants.items()}

    @property
    def epoch(self) -> int:
        """Arbitration epochs closed so far."""
        return self.arbiter.epoch

    def last_grant(self) -> Optional[FleetGrant]:
        with self._lock:
            return self._last_grant

    # -- degradation / health ------------------------------------------------
    def log_fault(self, kind: str, node: Optional[str] = None,
                  detail: str = "") -> None:
        """Record a fleet-level fault (quarantine edge, rollback, ...).

        ``_intervals`` is read without the tick lock: a report one
        interval off is fine, a health probe stalling a control
        interval is not.
        """
        self.fault_log.append(FaultEvent(
            kind=kind, node=node, tick=self._intervals,
            timestamp=time.time(), detail=detail))

    def health(self) -> Dict[str, HealthReport]:
        """Per-tenant degradation reports from the nested planes."""
        return {name: rt.plane.health()
                for name, rt in self._tenants.items()}

    def quarantined_tenants(self) -> List[str]:
        """Tenants currently dark: every node quarantined.  These bid
        floors-only at the next rebalance (fail-static at fleet level)."""
        with self._lock:
            return sorted(self._quarantined)

    @staticmethod
    def _tenant_dark(report: HealthReport) -> bool:
        return bool(report.nodes) and (
            len(report.quarantined()) == len(report.nodes))

    def fleet_utilization(self) -> float:
        """Instantaneous fleet-level usage over physical memory."""
        used = 0.0
        nodes = 0
        for rt in self._tenants.values():
            for ns in rt.spec.plane.nodes:
                s = ns.monitor.sample()
                used += s.used
                nodes += 1
        n_phys = max(max(len(rt.spec.plane.nodes)
                         for rt in self._tenants.values()), 1)
        return used / (self.node_memory * n_phys) if nodes else 0.0

    # -- control loop --------------------------------------------------------
    def tick(self) -> Dict[str, List[ControlAction]]:
        """One fleet control interval: every tenant's loop, once.

        On an epoch boundary the closing epoch's telemetry snapshot is
        taken under the tick lock, then :meth:`rebalance` runs *after*
        the lock is released -- arbitration and the fused steps'
        prewarms never stall a concurrent interval.
        """
        telemetry: Optional[Dict[str, TenantTelemetry]] = None
        with self._tick_lock:
            actions: Dict[str, List[ControlAction]] = {}
            for name, rt in self._tenants.items():
                # The fleet interval is atomic against budget commits.
                # planecheck: ignore[PC-L003] (JAX's copy is baselined)
                acts = rt.plane.tick()
                actions[name] = acts
                if acts:
                    util = sum(a.utilization for a in acts) / len(acts)
                    with self._lock:
                        rt.util_sum += util
                        rt.util_n += 1
            self._intervals += 1
            if self._intervals % self.spec.epoch_intervals == 0:
                telemetry = self._snapshot_telemetry()
        if telemetry is not None:
            self.rebalance(telemetry)
        return actions

    def _snapshot_telemetry(self) -> Dict[str, TenantTelemetry]:
        """Close the epoch's accumulators into per-tenant telemetry.

        A *dark* tenant -- every node quarantined by its nested plane's
        health state machine -- is not trusted to bid: its accumulators
        were fed by holdover/garbage telemetry.  It bids zero usage, so
        the arbiter grants exactly its effective floor (fail-static at
        fleet level), and its last non-quarantined telemetry is kept on
        the runtime for operators.  Quarantine/rejoin edges land in the
        fleet fault log.
        """
        # Health probes take the nested planes' locks; do them before
        # taking self._lock so fleet _lock stays a leaf.
        dark = {name for name, rt in self._tenants.items()
                if self._tenant_dark(rt.plane.health())}
        events: List[Tuple[str, str]] = []
        out: Dict[str, TenantTelemetry] = {}
        with self._lock:
            for name, rt in self._tenants.items():
                budget = rt.budget.get()
                mean_util = (rt.util_sum / rt.util_n) if rt.util_n else 0.0
                hits, misses = rt.hit_counts()
                dh, dm = hits - rt.hits0, misses - rt.misses0
                hit_ratio = dh / (dh + dm) if (dh + dm) > 0 else 1.0
                tel = TenantTelemetry(
                    usage_bytes=mean_util * budget, budget_bytes=budget,
                    hit_ratio=hit_ratio)
                if name in dark:
                    out[name] = TenantTelemetry(
                        usage_bytes=0.0, budget_bytes=budget, hit_ratio=1.0)
                else:
                    out[name] = tel
                    rt.last_telemetry = tel
                rt.util_sum = 0.0
                rt.util_n = 0
                rt.hits0, rt.misses0 = hits, misses
            for name in dark - self._quarantined:
                events.append(("tenant-quarantine", name))
            for name in self._quarantined - dark:
                events.append(("tenant-rejoin", name))
            self._quarantined = dark
        for kind, name in events:
            self.log_fault(kind, node=name,
                           detail="all nodes quarantined; bidding floor"
                           if kind == "tenant-quarantine"
                           else "nodes healthy again; bidding normally")
        return out

    def rebalance(self, telemetry: Dict[str, TenantTelemetry]) -> FleetGrant:
        """Arbitrate one epoch and hot-swap the new budgets in.

        Tenants commit in shrink-first order (most-shrinking first), so
        the instantaneous sum of live budgets stays conserving at every
        point of the transition.  Each tenant's swap goes through
        ``MemoryPlane.swap_params`` -- built and warmed off-lock,
        committed at that tenant's next interval boundary, actions
        epoch-stamped -- which is exactly the torn-budget guarantee the
        single-plane retune loop already has.

        **Partial-failure rollback**: if any tenant's budget swap
        raises mid-commit, every already-committed tenant is restored
        to its pre-rebalance budget in *reverse commit order* -- the
        unwind retraces exactly the intermediate states the commit
        passed through, each of which conserved ``sum(budgets) <=
        node_memory``, so conservation holds at every instant of the
        rollback too.  The fleet then keeps running on the old budgets
        (fail-static) and a ``rebalance-rollback`` event is logged;
        the failed grant is never published as ``last_grant``.
        """
        grant = self.arbiter.allocate(telemetry, self.node_memory)
        deltas = sorted(
            ((grant.budgets[name] - rt.budget.get(), name)
             for name, rt in self._tenants.items()))
        committed: List[Tuple[str, float]] = []   # (tenant, old budget)
        try:
            for _, name in deltas:
                rt = self._tenants[name]
                b = grant.budgets[name]
                old = rt.budget.get()
                rt.budget.set(b)
                rt.plane.swap_params(rt.budget_params(b))
                committed.append((name, old))
        except Exception as exc:
            # The failing tenant's budget ref may already hold the new
            # value with no swap behind it: restore it first (deepest
            # state), then unwind the committed prefix in reverse.
            failed_rt = self._tenants[name]
            failed_rt.budget.set(old)
            for tname, told in reversed(committed):
                trt = self._tenants[tname]
                trt.budget.set(told)
                try:
                    trt.plane.swap_params(trt.budget_params(told))
                except Exception:
                    # Budget ref is restored either way; the nested
                    # plane self-heals its M from agg.total next flush.
                    pass
            self.log_fault(
                "rebalance-rollback", node=name,
                detail=f"swap failed after {len(committed)} commits: "
                       f"{type(exc).__name__}: {exc}")
            with self._lock:
                return self._last_grant if self._last_grant is not None \
                    else FleetGrant(epoch=grant.epoch,
                                    timestamp=grant.timestamp,
                                    budgets=self.budgets(), policy="rollback")
        with self._lock:
            self._last_grant = grant
        return grant

    def __enter__(self) -> "FleetPlane":
        return self

    def __exit__(self, *exc) -> None:
        for rt in self._tenants.values():
            rt.plane.stop()
