"""FleetScenario: composed multi-tenant experiments for the lab.

A copy of ``repro/fleet/scenario.py`` over the port's own scenario
registry; ``tests/test_torch_port_rules.py`` holds its demand equal to
the original's byte for byte.

A :class:`FleetScenario` stacks per-tenant
:class:`~repro_torch.lab.scenarios.ScenarioSpec` s (by registry name or
inline) into one ``(tenants, nodes, intervals)`` demand tensor plus the
arbitration shape (policy, weights, floors, epoch length), which is
exactly what :func:`repro_torch.fleet.sweep.fleet_sweep_demand` consumes --
the *composed* two-level system sweeps in ScenarioLab the same way a
single plane does.

A registry mirrors the lab's: :func:`register_fleet_scenario` /
:func:`get_fleet_scenario` / :func:`list_fleet_scenarios`.  Registered
out of the box:

``hpcc-spark``
    The paper's Sec. IV mix as two tenants -- an HPCC-style compute
    tenant (high priority, weighted heavy) beside a Spark-style
    storage tenant with a floor (its executor + RDD baseline).
``tenant-churn``
    Three tenants over the fault-injected ``runtime-churn`` trace
    (straggler squeezes/evictions + heartbeat failures -- see
    :mod:`repro_torch.runtime.churn`), the scenario the arbiter's
    starvation/conservation behavior is stress-tested on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import numpy as np

from ..lab.scenarios import ScenarioSpec, get_scenario
from .specs import POLICIES


@dataclasses.dataclass(frozen=True)
class FleetTenant:
    """One tenant's workload plus its arbitration claim.

    ``scenario`` is a lab scenario name or an inline
    :class:`~repro_torch.lab.scenarios.ScenarioSpec`; its demand becomes this
    tenant's compute demand.  ``weight`` / ``priority`` / ``floor_gib``
    mean what they do on :class:`~repro_torch.fleet.specs.TenantSpec`.
    """

    name: str
    scenario: Union[str, ScenarioSpec]
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

    def resolve(self) -> ScenarioSpec:
        return get_scenario(self.scenario)


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """N tenant scenarios composed over one physical fleet."""

    name: str
    tenants: Tuple[FleetTenant, ...]
    policy: str = "proportional"
    epoch_intervals: int = 50
    node_memory_gib: float = 125.0
    description: str = ""

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
        specs = [t.resolve() for t in self.tenants]
        shapes = {(s.n_nodes, s.n_intervals, s.interval_s) for s in specs}
        if len(shapes) != 1:
            raise ValueError(
                "tenant scenarios must agree on (n_nodes, n_intervals, "
                f"interval_s); got {sorted(shapes)}")
        n_intervals = specs[0].n_intervals
        if n_intervals % self.epoch_intervals:
            raise ValueError(
                f"n_intervals ({n_intervals}) must divide into whole "
                f"epochs of {self.epoch_intervals}")
        floors = sum(t.floor_gib for t in self.tenants)
        if floors > self.node_memory_gib + 1e-9:
            raise ValueError(
                f"tenant floors ({floors} GiB) exceed node memory "
                f"({self.node_memory_gib} GiB)")

    # -- derived shape -------------------------------------------------------
    @property
    def n_tenants(self) -> int:
        return len(self.tenants)

    @property
    def n_nodes(self) -> int:
        return self.tenants[0].resolve().n_nodes

    @property
    def n_intervals(self) -> int:
        return self.tenants[0].resolve().n_intervals

    @property
    def interval_s(self) -> float:
        return self.tenants[0].resolve().interval_s

    def weights(self) -> np.ndarray:
        return np.array([t.weight for t in self.tenants], np.float64)

    def floors_bytes(self) -> np.ndarray:
        from ..core.traces import GiB
        return np.array([t.floor_gib * GiB for t in self.tenants],
                        np.float64)

    def priority_order(self) -> Tuple[int, ...]:
        return tuple(sorted(range(len(self.tenants)),
                            key=lambda i: (-self.tenants[i].priority, i)))

    def build_demand(self, seed: int = 0) -> np.ndarray:
        """Per-tenant demand tensor ``(K, N, T)`` bytes.

        Tenant ``k`` builds under ``seed + k * 7919`` so tenants are
        decorrelated but the whole composition stays deterministic in
        one seed.
        """
        return np.stack([t.resolve().build_demand(seed=seed + k * 7919)
                         for k, t in enumerate(self.tenants)])

    def replace(self, **kw) -> "FleetScenario":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_FLEET_REGISTRY: Dict[str, FleetScenario] = {}


def register_fleet_scenario(spec: FleetScenario, *,
                            overwrite: bool = False) -> FleetScenario:
    if not overwrite and spec.name in _FLEET_REGISTRY:
        raise ValueError(f"fleet scenario {spec.name!r} already registered")
    _FLEET_REGISTRY[spec.name] = spec
    return spec


def get_fleet_scenario(
        scenario: Union[str, FleetScenario]) -> FleetScenario:
    if isinstance(scenario, FleetScenario):
        return scenario
    try:
        return _FLEET_REGISTRY[scenario]
    except KeyError:
        known = ", ".join(sorted(_FLEET_REGISTRY))
        raise KeyError(f"unknown fleet scenario {scenario!r}; "
                       f"known: {known}") from None


def list_fleet_scenarios() -> List[str]:
    return sorted(_FLEET_REGISTRY)


# The paper's Sec. IV mix as a two-tenant fleet: HPCC is the priority
# compute tenant (its bursts must never be squeezed by storage), Spark
# the storage-heavy analytics tenant with a floor covering its executor
# + RDD baseline.  5 nodes / 125 GB per Table I; 4200 intervals = 7
# minutes of 100 ms epochs, re-arbitrated every 5 s.
register_fleet_scenario(FleetScenario(
    name="hpcc-spark",
    tenants=(
        FleetTenant("hpcc", "paper-c3-dynims60", weight=3.0, priority=1),
        FleetTenant("spark",
                    ScenarioSpec(
                        name="spark-analytics", family="constant",
                        n_nodes=5, n_intervals=4200, base_gib=30.0,
                        amp_range=(0.9, 1.1),
                        description="Spark executor + RDD cache baseline "
                                    "with mild load jitter"),
                    weight=1.0, priority=0, floor_gib=22.0),
    ),
    policy="proportional", epoch_intervals=50,
    description="paper Sec. IV mix: HPCC compute tenant beside a "
                "Spark-style storage tenant, arbitrated every 5 s"))

# Three tenants over the fault-injected runtime trace: the churn tenant
# replays the StragglerDetector/HeartbeatMonitor-generated demand, a
# serving tenant brings periodic admission bursts, and a best-effort
# batch tenant (no floor, lowest priority) probes starvation behavior.
register_fleet_scenario(FleetScenario(
    name="tenant-churn",
    tenants=(
        FleetTenant("churny-train", "runtime-churn", weight=2.0,
                    priority=2, floor_gib=10.0),
        FleetTenant("serving",
                    ScenarioSpec(
                        name="serving-waves", family="bursty", n_nodes=24,
                        n_intervals=480, base_gib=25.0, burst_gib=20.0,
                        burst_every_s=12.0, burst_len_s=2.0,
                        amp_range=(0.9, 1.1),
                        description="KV-admission waves for the churn "
                                    "composition"),
                    weight=1.5, priority=1, floor_gib=8.0),
        FleetTenant("batch",
                    ScenarioSpec(
                        name="batch-besteffort", family="constant",
                        n_nodes=24, n_intervals=480, base_gib=15.0,
                        amp_range=(0.8, 1.2),
                        description="best-effort batch filler"),
                    weight=1.0, priority=0),
    ),
    policy="proportional", epoch_intervals=48,
    description="fault-injected 3-tenant fleet: straggler/heartbeat "
                "churn + serving bursts + best-effort batch"))
