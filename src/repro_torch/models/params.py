"""Sharding specs: which mesh axes split each dimension of a tensor.

The port of the spec half of ``repro/models/params.py``.  JAX declares
every parameter as a ``ParamDef`` (shape, initializer and
``PartitionSpec``) and derives its arrays, specs and shape stand-ins
from that one schema.  The port's :class:`~repro_torch.models.Model`
builds and initializes its ``nn.Module``s itself, and on the ``meta``
device they are the shape stand-ins; what is left to declare is the
spec of each tensor:

* :class:`Spec`, the counterpart of ``PartitionSpec``: one entry per
  tensor dimension, each ``None`` (not split), a mesh axis name, or a
  tuple of axis names (split over their product);
* :class:`Axes`, the logical-to-mesh axis mapping, and its three
  instances; :func:`axes_for` picks one from a mesh's axis names;
* :func:`shard_shape`, what JAX's ``NamedSharding.shard_shape`` gives:
  one chip's block of a tensor under a spec on a mesh;
* :func:`count_params` and :func:`bytes_of` over a dict of tensors.

Eager PyTorch has no sharding constraint to pin, so JAX's ``shard_act``
has no counterpart; neither have ``ParamDef``'s initializers,
``init_params`` or ``stack_schema`` (ROADMAP, by design).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

Part = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """A ``PartitionSpec``: ``Spec("data", None)`` splits dim 0 over the
    ``data`` axis and leaves dim 1 whole; ``Spec()`` replicates.  Dims
    past the spec's length are not split."""

    def __new__(cls, *parts: Part) -> "Spec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def with_layer_axis(self) -> "Spec":
        """The spec of a stack of such tensors along a new leading layer
        axis, which is never split (``ParamDef.with_layer_axis``)."""
        return Spec(None, *self)

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec names, in order."""
        out = []
        for part in self:
            for a in (part,) if isinstance(part, str) else (part or ()):
                out.append(a)
        return tuple(out)


@dataclass(frozen=True)
class Axes:
    """Logical -> mesh axis mapping.

    ``fsdp`` shards parameters and optimizer state (the "data" mesh
    axis); ``tp`` shards heads / d_ff / vocab / experts (the "model"
    axis); ``batch`` is what activations' leading dim shards over --
    ("pod", "data") on the multi-pod mesh, ("data",) on one pod.
    """

    fsdp: Optional[str] = "data"
    tp: Optional[str] = "model"
    batch: Tuple[Optional[str], ...] = ("data",)

    def batch_spec(self, *rest: Part) -> Spec:
        return Spec(self.batch if len(self.batch) > 1 else self.batch[0],
                    *rest)


SINGLE_POD_AXES = Axes(batch=("data",))
MULTI_POD_AXES = Axes(batch=("pod", "data"))
UNSHARDED_AXES = Axes(fsdp=None, tp=None, batch=(None,))

# The production model-axis size: a dimension shards over ``tp`` only
# when this divides it, on every mesh (the schemas' ``_size_hint``).
TP_HINT = 16


def tp_if(axes: Axes, dim: int, hint: int = TP_HINT) -> Optional[str]:
    """``axes.tp`` when ``hint`` divides ``dim``, else None."""
    return axes.tp if (axes.tp and dim % hint == 0) else None


def axes_for(mesh) -> Axes:
    names = tuple(mesh.axis_names)
    if "pod" in names:
        return MULTI_POD_AXES
    if "data" in names and "model" in names:
        return SINGLE_POD_AXES
    return UNSHARDED_AXES


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def split_factors(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """How many ways each dimension of ``shape`` splits under ``spec``."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{len(shape)} dims of shape {tuple(shape)}")
    sizes = _axis_sizes(mesh)
    out = []
    for i in range(len(shape)):
        part = spec[i] if i < len(spec) else None
        names = (part,) if isinstance(part, str) else (part or ())
        unknown = [a for a in names if a not in sizes]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} that the "
                             f"mesh {tuple(mesh.axis_names)} lacks")
        out.append(math.prod(sizes[a] for a in names))
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One chip's block of a ``shape`` tensor split by ``spec`` over
    ``mesh`` (``NamedSharding(mesh, spec).shard_shape(shape)``); raises
    ``ValueError`` where a dimension does not divide evenly, as JAX
    does."""
    factors = split_factors(shape, spec, mesh)
    for i, (n, f) in enumerate(zip(shape, factors)):
        if n % f:
            raise ValueError(
                f"spec {spec} implies that array axis {i} is partitioned "
                f"{f} times, but the dimension size is {n} (full shape: "
                f"{tuple(shape)}, per-dimension tiling factors: {factors} "
                f"should evenly divide the shape)")
    return tuple(n // f for n, f in zip(shape, factors))


def count_params(tensors: Mapping[str, torch.Tensor]) -> int:
    return sum(math.prod(t.shape) for t in tensors.values())


def bytes_of(tensors: Mapping[str, torch.Tensor],
             bytes_per_el: int = 2) -> int:
    return count_params(tensors) * bytes_per_el
