"""Hand-written CUDA kernels of the port, each beside its plain version."""

import torch


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
