"""Benchmark cells as fleet tenants.

The part of ``repro/launch/cells.py`` the port has: the per-cell
FleetPlane deployment hook, :func:`cell_tenant`, and the cell-kind
priorities it defaults to.  The rest of the JAX module -- building a
lowerable train, prefill or decode step for an (arch x shape x mesh)
cell -- is the sharding and mesh substrate, which comes with ROADMAP
A5.4.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..configs import get_config, get_shape
from ..fleet.specs import TenantSpec

# Serving cells are latency-critical (decode above prefill); training
# tolerates throughput dips, so it arbitrates at the bottom.
DEFAULT_CELL_PRIORITY: Dict[str, int] = {"decode": 2, "prefill": 1,
                                         "train": 0}


def cell_tenant(arch: str, shape_name: str, *, plane,
                weight: Optional[float] = None,
                priority: Optional[int] = None,
                floor_gib: float = 0.0) -> TenantSpec:
    """Wrap one benchmark cell's memory plane as a fleet tenant.

    A cell (arch x shape) that declares a host-memory ``PlaneSpec`` for
    its dataset / KV caches becomes a
    :class:`~repro_torch.fleet.specs.TenantSpec` that a
    :class:`~repro_torch.fleet.specs.FleetSpec` can arbitrate beside
    other cells sharing the host.  Defaults derive from the cell
    itself: ``weight`` scales with active parameters (bigger models keep
    more working state per node), ``priority`` from the cell kind
    (:data:`DEFAULT_CELL_PRIORITY` -- serving above training).
    """
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if weight is None:
        weight = max(cfg.n_active_params() / 1e9, 0.25)
    if priority is None:
        priority = DEFAULT_CELL_PRIORITY.get(shape.kind, 0)
    return TenantSpec(name=f"{arch}:{shape_name}", plane=plane,
                      weight=float(weight), priority=int(priority),
                      floor_gib=float(floor_gib))
