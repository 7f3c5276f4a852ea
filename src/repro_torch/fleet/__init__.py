"""FleetPlane on PyTorch: hierarchical multi-tenant memory arbitration.

The port of ``repro/fleet``: a two-level generalization of the paper's
single-tenant controller, many tenants arbitrated over one memory.

* :mod:`.specs`    -- nestable declarations: :class:`TenantSpec` wraps
  a :class:`~repro_torch.core.plane.PlaneSpec` with weight / priority /
  floor; :class:`FleetSpec` composes N tenants over one physical fleet.
* :mod:`.arbiter`  -- the epoch-driven global allocator: priority,
  round-robin, and proportional-share (weighted max-min with floors)
  policies; a float64 numpy reference (:func:`arbitrate_reference`)
  and the batched torch form (:func:`arbitrate`).
* :mod:`.plane`    -- the live :class:`FleetPlane`: one nested
  :class:`~repro_torch.core.plane.MemoryPlane` per tenant, budgets
  hot-swapped through the epoch-stamped ``swap_params`` path (no torn
  budgets).
* :mod:`.sweep`    -- :func:`fleet_sweep_demand` rolls the composed
  system over a :class:`~repro_torch.lab.sweep.GainSet` in plain
  PyTorch on the card (the JAX package runs it as XLA, not Pallas),
  with the arbitration invariants as :class:`FleetExtras`, on one
  device or over a (gains x nodes) layout (``devices=``,
  ``node_shards=``; :mod:`repro_torch.lab.mesh`);
  :func:`fleet_reference` is the float64 oracle.
* :mod:`.scenario` -- :class:`FleetScenario` composes per-tenant
  :class:`~repro_torch.lab.scenarios.ScenarioSpec` s (``hpcc-spark``,
  ``tenant-churn``) for registry-driven sweeps.
"""

from .arbiter import (FleetArbiter, FleetGrant, MIN_TENANT_BUDGET,
                      TenantTelemetry, arbitrate, arbitrate_reference)
from .plane import FleetPlane, TenantMonitor
from .scenario import (FleetScenario, FleetTenant, get_fleet_scenario,
                       list_fleet_scenarios, register_fleet_scenario)
from .specs import FleetSpec, POLICIES, TenantSpec
from .sweep import (FLEET_CHUNK, FleetExtras, fleet_reference,
                    fleet_sweep_demand, run_fleet_sweep)

__all__ = [
    "FLEET_CHUNK", "FleetArbiter", "FleetExtras", "FleetGrant",
    "FleetPlane", "FleetScenario", "FleetSpec", "FleetTenant",
    "MIN_TENANT_BUDGET", "POLICIES", "TenantMonitor", "TenantSpec",
    "TenantTelemetry", "arbitrate", "arbitrate_reference",
    "fleet_reference", "fleet_sweep_demand", "get_fleet_scenario",
    "list_fleet_scenarios", "register_fleet_scenario", "run_fleet_sweep",
]
