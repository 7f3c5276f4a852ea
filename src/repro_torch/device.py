"""Device policy of the port: the card, unless the caller asks for the CPU.

Every entry point takes ``device=None`` and resolves it here.  ``None``
means CUDA and raises when no card is present -- an entry point never
carries on on the CPU by itself.  ``"cpu"`` (or any explicit device)
is honoured as given; on the CPU the kernels' plain PyTorch versions
run, which is how the tests drive the port.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA by default, else as asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
