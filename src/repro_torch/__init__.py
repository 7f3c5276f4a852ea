"""DynIMS on PyTorch and CUDA: the port of the ``repro`` JAX package.

The paper's closed-loop memory controller (Eq. 1) swept over fleets of
gain points and nodes, with the fused sweep step as a hand-written
CUDA kernel for Hopper (``csrc/sweep.cu``).  The package imports
nothing of ``repro`` or of JAX.  Entry points run on the card unless the
caller passes ``device="cpu"``; see :mod:`repro_torch.device`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
