"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``_flash_kernel`` of
``repro/kernels/flash_attention/kernel.py`` (wrapper
``flash_attention``).  GQA attention of q ``(B, Sq, H, hd)`` over k/v
``(B, Skv, KV, hd)`` at positions ``arange(Sq)`` and ``arange(Skv)``,
causal and/or with a sliding window (key ``k`` kept for query ``i`` iff
``k <= i`` when causal and ``k > i - window`` when windowed), in
float32, out in q's type.  Query head ``h`` reads kv head
``h // (H // KV)``.

* :func:`flash_attention` dispatches on where ``q`` lies: CPU tensors
  take :func:`flash_attention_plain`; CUDA tensors launch the kernel in
  ``csrc/flash_attention.cu`` or raise.  Nothing falls back.
  Inputs that require grad raise under grad mode: the kernel has no
  backward.
* :func:`flash_attention_plain` is ``attention_ref`` of the JAX package:
  materialized float32 logits, masked, softmax.
* :data:`LAUNCHES` counts kernel launches, and only those.

q, k and v share one type, float32 or bfloat16; head dims 16, 32, 64,
128 and 256; any ``Sq`` and ``Skv`` (the kernel masks ragged tiles
itself); ``B`` and ``H`` at most 65535.  The kernel runs bf16 on the
tensor cores and f32 as 3xTF32 on them, near f32 accuracy.
"""

from __future__ import annotations

import torch

from . import count_call, refuse_autograd

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GRID = 65535          # B and H are the grid's z and y: at most 65535

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0


def make_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: int = 0) -> torch.Tensor:
    """(..., Sq, Skv) boolean mask; True = attend (attention.py l.90)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / (hd ** 0.5)
    mask = make_mask(torch.arange(sq, device=q.device),
                     torch.arange(skv, device=q.device), causal=causal,
                     window=window)
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _check(q, k, v) -> None:
    """Shapes, types and layout the kernel takes; raises on anything else."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be (B, Sq, H, hd) and k/v (B, Skv, KV, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, h, hd = q.shape
    _, skv, kvh, hd_k = k.shape
    if v.shape != k.shape or k.shape[0] != b or hd_k != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if hd not in HEAD_DIMS or h % kvh:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS} and H a "
                         f"multiple of KV; got hd={hd}, H={h}, KV={kvh}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"k/v on {k.device}/{v.device}, q on {q.device}")
    if b > MAX_GRID or h > MAX_GRID:
        raise ValueError(f"the kernel's grid takes B and H up to {MAX_GRID}"
                         f"; got B={b}, H={h}")


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    from ._build import load_library

    _check(q, k, v)
    q, k, v = (x.contiguous() for x in (q, k, v))
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("flash attention needs 16-byte aligned inputs")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    lib = load_library("flash_attention.cu").lib
    rc = lib.dynims_flash_attention(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh, hd, int(causal),
        int(window), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _work(q, k, causal: bool, window: int):
    """One call's :func:`repro_torch.roofline.kernels.flash` work."""
    from ..roofline.kernels import flash
    b, sq, h, hd = q.shape
    return flash(b, sq, h, k.shape[2], hd, skv=k.shape[1], causal=causal,
                 window=window, bf16=q.dtype == torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq, H, hd).

    CPU tensors run :func:`flash_attention_plain`; CUDA tensors launch the
    kernel.  Under a :mod:`repro_torch.roofline.cost` count each call
    reports its work, and meta tensors are counted, not run.  Any other
    device raises, and so do inputs that require grad while grad mode is
    on.
    """
    refuse_autograd("flash_attention", (q, k, v),
                    "the differentiable plain path, repro_torch.models."
                    "attention.attention_dense or attention_chunked "
                    "(Model.forward_train)")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if count_call("flash_attention", q,
                  lambda: _work(q, k, causal, window)):
        return torch.empty_like(q)                # counted on meta, not run
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, window)
