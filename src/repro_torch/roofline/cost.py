"""A step's FLOPs and bytes, counted by running it once: the counterpart
of JAX's ``hlo_cost``, which reads XLA's compiled HLO (eager torch has
none).

* FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``: matmuls,
  convolutions and attention, 2 * output elements * contraction, as
  ``hlo_cost`` counts dots (element-wise work is not counted).
* Bytes are each aten op's operand and result bytes, ``hlo_cost``'s
  convention for unfused top-level instructions, since eager torch fuses
  nothing.  Views, reshapes and allocations move nothing; a broadcast
  (stride 0) operand is read once.  As ``hlo_cost`` counts a slice as
  twice its result and a dynamic-update-slice as twice its update:
  a gather by index (``t[ids]``, ``embedding``, ``index_select``,
  ``gather``) counts its result twice and its indices, not the whole
  source; an in-place write into part of a tensor (``index_put_``,
  ``index_copy_``, ``scatter_``) counts the written values twice and the
  indices, and the accumulating ones (``index_add_``, ``scatter_add_``,
  ``index_put_`` with ``accumulate``) read the destination too; an
  overwrite of a whole tensor (``copy_``, ``fill_``, ``zero_``) writes
  it without reading it.  (``hlo_cost`` has no rule for a gather: a
  fused gather counts its whole source there.)
* A hand-written kernel is launched through ``ctypes``, which no
  dispatch mode sees.  Its wrapper reports each call here
  (:func:`repro_torch.kernels.count_call`) with its :mod:`.kernels`
  work, on the card and on ``meta`` tensors alike, so a decode step
  counts its attention.
* Collectives: a sharded sweep reports each fold and exchange over its
  shards (:func:`repro_torch.kernels.count_collective`) through the
  same records; they are summed by :func:`.collectives.
  parse_collectives` into ``collective_bytes``, not into ``bytes``.
  An unsharded step has none.

Run the step on ``device="meta"`` and counting costs no device time and
no memory: every op computes only its output's shape.  On meta tensors
data-dependent work (decode attention's lengths, a boolean mask's kept
entries) is counted at its most.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import WORK_COUNTS
from .collectives import COLLECTIVE_OPS, parse_collectives

# allocations: no bytes move until an op writes them
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided", "lift_fresh", "_unsafe_view"}
_GATHERS = {"index", "embedding", "index_select", "gather", "take"}
# in-place writes into part of ``self``: does each read it too?  (None:
# ``index_put_`` reads it when its ``accumulate`` is set)
_PARTIAL_WRITES = {"index_put_": None, "index_copy_": False,
                   "scatter_": False, "index_add_": True,
                   "scatter_add_": True, "scatter_reduce_": True}
_OVERWRITES = {"copy_", "fill_", "zero_"}


def _tensor_bytes(t: torch.Tensor) -> int:
    """The distinct bytes a tensor's elements occupy: a broadcast
    (stride 0) dimension is read once."""
    if t.numel() == 0 or t.layout != torch.strided:
        return t.numel() * t.element_size()
    return math.prod(n for n, st in zip(t.shape, t.stride())
                     if st) * t.element_size()


def _nbytes(tree) -> int:
    return sum(_tensor_bytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    """The op returns a view of an input (no bytes move)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _indexed_elements(dst: torch.Tensor, indices) -> int:
    """Elements of ``dst`` that ``dst[indices]`` names (a boolean mask at
    its most)."""
    shapes, used = [], 0
    for i in indices:
        if i is None:
            continue
        shapes.append((i.numel(),) if i.dtype == torch.bool else i.shape)
        used += i.dim() if i.dtype == torch.bool else 1
    rest = [n for d, n in enumerate(dst.shape)
            if d >= len(indices) or indices[d] is None]
    return math.prod(torch.broadcast_shapes(*shapes)) * math.prod(rest) \
        if shapes else dst.numel()


def _op_bytes(name: str, args, kwargs, out) -> int:
    if name in _GATHERS:
        return 2 * _nbytes(out) + _nbytes((args[1:], kwargs))
    if name in _OVERWRITES:
        return _nbytes((args[1:], kwargs)) + _tensor_bytes(args[0])
    if name in _PARTIAL_WRITES:
        dst, reads = args[0], _nbytes((args[1:], kwargs))
        if name == "index_put_":
            n = _indexed_elements(dst, args[1])
            accumulate = bool(args[3] if len(args) > 3
                              else kwargs.get("accumulate", False))
        elif name.startswith("scatter"):
            n, accumulate = args[2].numel(), _PARTIAL_WRITES[name]
            src = args[3] if len(args) > 3 else kwargs.get("src")
            if isinstance(src, torch.Tensor) and src.numel() > n:
                reads -= (src.numel() - n) * src.element_size()
        else:                              # index_copy_, index_add_
            n, accumulate = args[3].numel(), _PARTIAL_WRITES[name]
        return reads + n * dst.element_size() * (2 if accumulate else 1)
    return _nbytes((args, kwargs)) + _nbytes(out)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.bytes_by_op: Dict[str, int] = collections.Counter()
        self.kernels: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name not in _ALLOCS and not _is_view(func):
            n = _op_bytes(name, args, kwargs, out)
            self.bytes += n
            self.bytes_by_op[name] += n
        return out


def step_cost(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once, counting; returns ``hlo_cost``'s
    keys (``flops``, ``bytes``, ``collective_bytes``, ``per_kind_bytes``,
    ``bytes_by_op``) and ``kernels``: each hand-written kernel's counted
    calls (on meta tensors none of them launched), operations, bytes and
    summed bound in ms.  The kernels' work is in ``flops`` and ``bytes``
    too.  ``collectives`` is :func:`.collectives.parse_collectives` of
    the folds and exchanges the step's shards reported."""
    count = _Count()
    WORK_COUNTS.append(count.kernels)
    try:
        with FlopCounterMode(display=False) as flops, count:
            fn(*args, **kwargs)
    finally:
        WORK_COUNTS.remove(count.kernels)
    kernels: Dict[str, dict] = {}
    records = []
    for name, work, data in count.kernels:
        if name in COLLECTIVE_OPS:
            records.append((name, work(*data)))
            continue
        w = work(*data)
        k = kernels.setdefault(name, dict(calls=0, ops=0, bytes=0,
                                          bound_ms=0.0))
        k["calls"] += 1
        k["ops"] += w.ops
        k["bytes"] += w.bytes
        k["bound_ms"] += w.bound_ms
    collectives = parse_collectives(records)
    return {
        "flops": float(flops.get_total_flops()
                       + sum(k["ops"] for k in kernels.values())),
        "bytes": float(count.bytes
                       + sum(k["bytes"] for k in kernels.values())),
        "collective_bytes": collectives["total_bytes"],
        "per_kind_bytes": collectives["per_kind_bytes"],
        "collectives": collectives,
        "bytes_by_op": dict(count.bytes_by_op),
        "kernels": kernels,
    }
