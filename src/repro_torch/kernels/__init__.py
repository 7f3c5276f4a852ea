"""Hand-written CUDA kernels of the port, each beside its plain version."""

from typing import Callable, List, Optional, Sequence

import torch

# Work counts open in this process, innermost last: lists that
# ``repro_torch.roofline.cost`` opens around a step and each wrapper's
# :func:`count_call` appends to.
WORK_COUNTS: List[list] = []


def refuse_autograd(kernel: str, tensors, instead: str) -> None:
    """Raise when autograd would need a backward of ``kernel``.

    The kernels are launched through ``ctypes``, so their outputs carry
    no autograd history: a gradient through one would silently be
    missing.  Every wrapper calls this first, on either device, while
    grad mode is on and an input requires grad.
    """
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward and an input requires grad; use "
            f"{instead}, or call it under torch.no_grad()")


def count_call(kernel: str, x: torch.Tensor, work: Callable,
               *data: torch.Tensor,
               layout: Optional[torch.Tensor] = None) -> bool:
    """Report one call of ``kernel`` to every open work count.

    A ``ctypes`` launch is invisible to any dispatch mode, so each
    wrapper calls this before it runs its kernel.  ``work(*data)`` gives
    the call's :class:`repro_torch.roofline.kernels.Work` when the count
    closes: ``data`` (small tensors the step may overwrite, such as
    decode's lengths) is cloned now unless it is on meta, so reading it
    waits for no device inside the step.  Returns True when ``x`` lies on the meta device
    under a count: the call is counted, not run, and the wrapper returns
    an empty output.  Outside a count it does nothing and returns False.
    ``layout`` (``x`` if None) is the operand whose split over a mesh
    splits the call's work, which :mod:`repro_torch.roofline.sharding`
    reads.
    """
    if not WORK_COUNTS:
        return False
    data = tuple(d if d.device.type == "meta" else d.clone() for d in data)
    for count in WORK_COUNTS:
        count.append((kernel, work, data, x if layout is None else layout))
    return x.device.type == "meta"


def count_collective(kind: str, parts: Sequence[torch.Tensor]) -> None:
    """Report one collective over shards to every open work count.

    ``kind`` is the HLO name of the collective JAX would run (a fold over
    shards is an ``"all-reduce"``, as ``psum``, ``pmax`` and ``pmin``
    are); ``parts`` are the shards' operands, whose bytes (from their
    shapes, so meta tensors count too) are the payload, every shard's
    summed.  :func:`repro_torch.roofline.cost.step_cost` reads these
    records into its ``collective_bytes``.
    """
    if not WORK_COUNTS:
        return
    n_bytes = float(sum(p.numel() * p.element_size() for p in parts))
    count_call(kind, parts[0], lambda: n_bytes)
