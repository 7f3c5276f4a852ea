"""DynIMS on PyTorch and CUDA: the port of the ``repro`` JAX package.

The paper's closed-loop memory controller (Eq. 1) swept over fleets of
gain points and nodes, and the model-serving substrate whose KV cache
is the storage tenant DynIMS resizes (the dense, hybrid, moe, vlm and
audio models through a continuous-batching engine), and their
training, the paper's priority tenant.  Every TPU kernel of ``repro``
is a hand-written CUDA kernel for Hopper under ``csrc/``: the fused
sweep step, flash attention, decode attention and the selective scan.
The package imports nothing of ``repro`` or of JAX.  Entry points run
on the card unless the caller passes ``device="cpu"``; see
:mod:`repro_torch.device`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
