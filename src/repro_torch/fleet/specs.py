"""Nestable control-plane specs: tenants composed over one fleet.

A copy of ``repro/fleet/specs.py`` over the port's own
:class:`~repro_torch.core.plane.PlaneSpec`.

The paper's Eq. 1 sizes *one* in-memory store against *one* compute
workload per node.  FleetPlane generalizes the declaration: a
:class:`TenantSpec` wraps an ordinary :class:`~repro_torch.core.plane.PlaneSpec`
with arbitration metadata (weight / priority / floor), and a
:class:`FleetSpec` composes N tenants over one physical fleet whose
per-node DRAM they share.  Nothing here runs -- these are pure data, the
fleet analogue of :class:`~repro_torch.core.plane.PlaneSpec`; the runtime
lives in :mod:`repro_torch.fleet.plane` and the policy math in
:mod:`repro_torch.fleet.arbiter`.

Nesting works through ``PlaneSpec.replace``: the fleet runtime derives
each tenant's *inner* plane from the declared one by re-sizing its
``params`` to the tenant's current budget and wrapping its monitors so
they report the budget as the node total.  The declared spec is never
mutated; a tenant spec is reusable across fleets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..core.plane import PlaneSpec
from ..core.traces import GiB

#: Arbitration policies the fleet arbiter implements (see
#: :mod:`repro_torch.fleet.arbiter` for the exact semantics of each).
POLICIES = ("priority", "round_robin", "proportional")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a plane spec plus its claim on the shared fleet.

    Fields:
      name:      unique tenant id within a :class:`FleetSpec`.
      plane:     the tenant's control plane, declared exactly as a
                 standalone :class:`~repro_torch.core.plane.PlaneSpec` --
                 the fleet runtime nests it unchanged except for
                 budget-sized params and budget-reporting monitors.
      weight:    proportional-share weight (> 0); the share of
                 above-floor memory this tenant receives when demand
                 exceeds supply under the ``proportional`` policy.
      priority:  static rank for the ``priority`` policy (higher wins;
                 ties break in declaration order).
      floor_gib: guaranteed minimum per-node budget (GiB) honored by
                 every policy before any discretionary allocation.
    """

    name: str
    plane: PlaneSpec
    weight: float = 1.0
    priority: int = 0
    floor_gib: float = 0.0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if not self.weight > 0.0:
            raise ValueError("weight must be > 0")
        if self.floor_gib < 0.0:
            raise ValueError("floor_gib must be >= 0")

    @property
    def floor_bytes(self) -> float:
        return self.floor_gib * GiB

    def replace(self, **kw) -> "TenantSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """N tenants arbitrated over one physical fleet's DRAM.

    Fields:
      tenants:          the composed :class:`TenantSpec` s (unique
                        names; >= 1).
      policy:           one of :data:`POLICIES`.
      epoch_intervals:  control intervals per arbitration epoch --
                        tenants run Eq. 1 every interval, the global
                        arbiter re-budgets every ``epoch_intervals``.
      fleet_memory_gib: physical per-node DRAM M shared by all tenants
                        (Table I: 125).  Budget conservation
                        (sum of grants <= M per node) is the arbiter's
                        core invariant.
    """

    tenants: Tuple[TenantSpec, ...]
    policy: str = "proportional"
    epoch_intervals: int = 10
    fleet_memory_gib: float = 125.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "tenants", tuple(self.tenants))
        if not self.tenants:
            raise ValueError("need at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique; got {names}")
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        if self.epoch_intervals < 1:
            raise ValueError("epoch_intervals must be >= 1")
        if self.fleet_memory_gib <= 0:
            raise ValueError("fleet_memory_gib must be positive")
        floors = sum(t.floor_gib for t in self.tenants)
        if floors > self.fleet_memory_gib + 1e-9:
            raise ValueError(
                f"tenant floors ({floors} GiB) exceed fleet memory "
                f"({self.fleet_memory_gib} GiB); floors must be "
                "admissible")

    def __len__(self) -> int:
        return len(self.tenants)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tenants)

    @property
    def fleet_memory_bytes(self) -> float:
        return self.fleet_memory_gib * GiB

    def weights(self) -> np.ndarray:
        """``(K,)`` float64 proportional-share weights, tenant order."""
        return np.array([t.weight for t in self.tenants], np.float64)

    def floors_bytes(self) -> np.ndarray:
        """``(K,)`` float64 per-node floors in bytes, tenant order."""
        return np.array([t.floor_bytes for t in self.tenants], np.float64)

    def priority_order(self) -> Tuple[int, ...]:
        """Tenant indices from highest to lowest priority (stable)."""
        return tuple(sorted(range(len(self.tenants)),
                            key=lambda i: (-self.tenants[i].priority, i)))

    def index(self) -> Dict[str, int]:
        return {t.name: i for i, t in enumerate(self.tenants)}

    def replace(self, **kw) -> "FleetSpec":
        return dataclasses.replace(self, **kw)
