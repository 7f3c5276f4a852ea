"""Elastic re-meshing: pick a working mesh for whatever chips survive.

A copy of ``repro/runtime/elastic.py``.  On failure the planner chooses
the largest usable (data, model) grid from the healthy-device count,
preferring to keep the model axis intact (changing TP width re-shards
every weight; changing the data axis only re-shards the batch and
re-balances FSDP).  The trainer then rebuilds the step for the degraded
mesh and restores the last checkpoint into the new sharding --
parameters saved as full logical arrays re-shard freely.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..device import DeviceLike
from ..launch.mesh import Mesh, make_mesh


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_devices: int
    dropped: int                  # healthy devices left unused

    def make(self, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
        """The planned mesh over the first ``n_devices`` of ``devices``
        (None: the cards, raising without one)."""
        use = None if devices is None else list(devices)[: self.n_devices]
        return make_mesh(self.shape, self.axis_names, use)


class ElasticMeshPlanner:
    def __init__(self, model_axis: int = 16,
                 axis_names: Tuple[str, str] = ("data", "model")):
        self.model_axis = model_axis
        self.axis_names = axis_names

    def plan(self, healthy_devices: int,
             model_axis: Optional[int] = None) -> MeshPlan:
        tp = model_axis or self.model_axis
        while tp > 1 and healthy_devices < tp:
            tp //= 2                       # degrade TP only as a last resort
        data = healthy_devices // tp
        if data < 1:
            raise RuntimeError(
                f"cannot build a mesh from {healthy_devices} devices")
        used = data * tp
        return MeshPlan(shape=(data, tp), axis_names=self.axis_names,
                        n_devices=used, dropped=healthy_devices - used)

    def replan_after_failures(self, total: int, failed: int) -> MeshPlan:
        return self.plan(total - failed)
