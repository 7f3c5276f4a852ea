"""Production mesh construction.

The port of ``repro/launch/mesh.py``.  A :class:`Mesh` is a grid of
chips with named axes (JAX's ``jax.sharding.Mesh``):

* ``pod``   -- pure data parallelism across pods; the gradient
  all-reduce is the only collective crossing it (optionally
  int8-compressed);
* ``data``  -- FSDP + batch sharding within a pod;
* ``model`` -- tensor/expert parallelism (heads, d_ff, vocab, experts).

A mesh of 256 or 512 chips (:func:`make_production_mesh`) is a
description: it holds no devices, and the dry-run
(``repro_torch.launch.dryrun``) counts a step's per-chip work on it from
the specs alone, on ``meta`` tensors.  A mesh that is to run
(:func:`make_mesh`, :func:`single_device_mesh`) holds ``torch.device``s;
``devices=None`` means the cards, and raises without one.  Eager
PyTorch has no ambient mesh for sharding constraints to resolve
against, so JAX's ``activate_mesh`` has no counterpart (ROADMAP, by
design).  ``lab/mesh.py`` holds the sweeps' shard layouts, which are a
different thing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Mesh:
    """``shape`` chips along ``axis_names``; ``devices`` the chips in
    row-major order, or None for a mesh that only describes a layout."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {self.shape} mesh needs {self.size} "
                             f"devices; got {len(self.devices)}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """The axis's length, 1 for an axis the mesh lacks."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)


def _cards(n: int) -> Tuple[torch.device, ...]:
    resolve_device(None)                      # raises without a card
    local = torch.cuda.device_count()
    if n > local:
        raise RuntimeError(f"a mesh of {n} chips needs {n} cards; "
                           f"{local} are visible")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh to run on (elastic re-mesh path, tests): ``devices`` in
    row-major order, as many as the mesh has chips; None means the
    first cards, raising without one."""
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    devs = (_cards(n) if devices is None
            else tuple(torch.device(d) for d in devices))
    return Mesh(shape, axes, devs)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 16 x 16 pod, or two of them: a description (no devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def single_device_mesh(device: DeviceLike = None) -> Mesh:
    """A 1 x 1 (data, model) mesh over one device (the card by default)."""
    return make_mesh((1, 1), ("data", "model"),
                     [resolve_device(device)])


def describe(mesh: Mesh) -> dict:
    return {
        "shape": dict(zip(mesh.axis_names, mesh.shape)),
        "n_devices": int(mesh.size),
        "axis_names": list(mesh.axis_names),
    }
