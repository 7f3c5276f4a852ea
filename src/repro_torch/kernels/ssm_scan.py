"""Selective scan (Mamba S6): the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``_ssm_kernel`` of
``repro/kernels/ssm_scan/kernel.py`` (wrapper ``ssm_scan``; oracle
``ssm_scan/ref.py::ssm_scan_ref``).  ``h_t = decay_t * h_{t-1} +
drive_t`` over decay/drive ``(B, S, C, N)`` from ``h0`` ``(B, C, N)``;
every ``h_t`` comes back, ``(B, S, C, N)`` float32.

* :func:`ssm_scan` dispatches on where ``decay`` lies: CPU tensors take
  :func:`ssm_scan_plain`; CUDA tensors launch the kernel in
  ``csrc/ssm_scan.cu`` (built at first use by
  :mod:`repro_torch.kernels._build`) or raise.  Nothing falls back.
  Inputs that require grad raise under grad mode: the kernel has no
  backward.
* :func:`ssm_scan_plain` walks time on tensors in float32, with the
  product and the sum rounded separately, as the kernel rounds them:
  the two agree bit for bit.
* :data:`LAUNCHES` counts kernel launches, and only those.

Types: decay and drive alike in float32 or bfloat16, h0 float32.  Any
``S``, ``C`` and ``N``.
"""

from __future__ import annotations

import torch

from . import count_call, refuse_autograd

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0


def ssm_scan_plain(decay: torch.Tensor, drive: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    a, b = decay.float(), drive.float()
    h = h0.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h
        h = h + b[:, t]
        out[:, t] = h
    return out


def _check(decay, drive, h0) -> None:
    """Shapes, types and devices the kernel takes; raises on anything else."""
    if decay.ndim != 4 or drive.shape != decay.shape:
        raise ValueError(f"decay and drive must both be (B, S, C, N); got "
                         f"{tuple(decay.shape)} and {tuple(drive.shape)}")
    b, _, c, n = decay.shape
    if tuple(h0.shape) != (b, c, n):
        raise ValueError(f"h0 must be ({b}, {c}, {n}); got "
                         f"{tuple(h0.shape)}")
    if decay.dtype not in (torch.float32, torch.bfloat16) \
            or drive.dtype != decay.dtype:
        raise ValueError(f"decay and drive must share float32 or bfloat16; "
                         f"got {decay.dtype}, {drive.dtype}")
    if h0.dtype != torch.float32:
        raise ValueError(f"h0 must be float32; got {h0.dtype}")
    if drive.device != decay.device or h0.device != decay.device:
        raise ValueError(f"drive on {drive.device}, h0 on {h0.device}, "
                         f"decay on {decay.device}")


def _launch(decay, drive, h0) -> torch.Tensor:
    from ._build import load_library

    _check(decay, drive, h0)
    decay, drive, h0 = (x.contiguous() for x in (decay, drive, h0))
    b, s, c, n = decay.shape
    out = torch.empty(decay.shape, dtype=torch.float32, device=decay.device)
    if out.numel() == 0:
        return out
    lib = load_library("ssm_scan.cu").lib
    rc = lib.dynims_ssm_scan(
        int(decay.dtype == torch.bfloat16), decay.data_ptr(),
        drive.data_ptr(), h0.data_ptr(), out.data_ptr(), b, s, c, n,
        torch.cuda.current_stream(decay.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm scan kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _work(decay):
    """One call's :func:`repro_torch.roofline.kernels.ssm_scan` work."""
    from ..roofline.kernels import ssm_scan as scan_work
    return scan_work(*decay.shape, itemsize=decay.element_size())


def ssm_scan(decay: torch.Tensor, drive: torch.Tensor,
             h0: torch.Tensor) -> torch.Tensor:
    """decay/drive (B, S, C, N), h0 (B, C, N) -> (B, S, C, N) float32.

    CPU tensors run :func:`ssm_scan_plain`; CUDA tensors launch the kernel.
    Under a :mod:`repro_torch.roofline.cost` count each call reports its
    work, and meta tensors are counted, not run.  Any other device raises,
    and so do inputs that require grad while grad mode is on.
    """
    refuse_autograd("ssm_scan", (decay, drive, h0),
                    "the differentiable plain path, repro_torch.models."
                    "ssm.mamba_apply_chunked (Model.forward_train)")
    if decay.device.type == "cpu":
        return ssm_scan_plain(decay, drive, h0)
    if count_call("ssm_scan", decay, lambda: _work(decay)):
        return torch.empty(decay.shape, dtype=torch.float32,
                           device="meta")         # counted on meta, not run
    if decay.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cpu or cuda, not {decay.device}")
    return _launch(decay, drive, h0)
