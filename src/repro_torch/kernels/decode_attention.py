"""Decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``_decode_kernel`` of
``repro/kernels/decode_attention/kernel.py`` (wrapper
``decode_attention``).  One query token per (sequence, head) attends
keys ``[0, len_b)`` of a ``(B, S, KV, hd)`` cache -- with a window, only
``k >= len_b - window`` -- and the output comes back in q's type.  Query
head ``h`` reads kv head ``h // (H // KV)``.

* :func:`decode_attention` dispatches on where ``q`` lies: CPU tensors
  take :func:`decode_attention_plain`; CUDA tensors launch the kernel in
  ``csrc/decode_attention.cu`` (built at first use by
  :mod:`repro_torch.kernels._build`) or raise.  Nothing falls back.
  Inputs that require grad raise under grad mode: the kernel has no
  backward.
* :func:`decode_attention_plain` is ``decode_attention_ref`` of the JAX
  package in float32, except that cache rows outside the kept range are
  zeroed before use: the kernel never reads them, so a NaN written there
  reaches neither output.  A sequence with no kept key gets zeros, as
  the TPU kernel gives.
* :data:`LAUNCHES` counts kernel launches, and only those: one per
  call, however many blocks share a sequence's keys.

Split-KV: when ``B * KV`` blocks cannot fill the card,
:func:`choose_splits` (from the shapes and the SM count, never from the
lengths, which stay on the card) lets several blocks share each
(sequence, kv head)'s live keys; each writes a float32 partial to a
workspace allocated here, and the last block of each pair to finish
merges them in split order, so the output's bits do not depend on the
blocks' timing.  That block finds itself through a per-device counter
buffer, zeroed once here and left zeroed by the kernel; launches that
share it must run on one stream.

Types: q in float32 or bfloat16, both caches in float32 or bfloat16
(mixed is the serving path's normal case: float32 activations over a
bfloat16 cache), lengths int32.  Head dims 16, 32, 64, 128 and 256, at
most 16 query heads per kv head.  Any cache length ``S``: the kernel
masks the ragged last tile itself.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from . import count_call, refuse_autograd

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16
MAX_GRID = 65535          # B and the split count are the grid's y and z
# Blocks of the kernel one SM holds (registers bound it); the split
# count aims at this many blocks per SM.
BLOCKS_PER_SM = 2

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0
# Per device: the (sequence, kv head) counters the kernel's last block of
# each pair takes its merge ticket from.
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    b, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    k_pos = torch.arange(s, device=q.device)
    lens = lengths.to(device=q.device, dtype=torch.int64)[:, None]
    valid = k_pos[None, :] < lens                               # (B, S)
    if window:
        valid &= k_pos[None, :] >= lens - window
    keep = valid[:, :, None, None]
    kf = torch.where(keep, k_cache.float(), 0.0)
    vf = torch.where(keep, v_cache.float(), 0.0)
    qg = q.reshape(b, kvh, g, hd).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, kf) / (hd ** 0.5)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, vf)
    return o.reshape(b, h, hd).to(q.dtype)


def tile_keys(group: int, hd: int = 64, cache_itemsize: int = 2) -> int:
    """Keys per K/V tile of the kernel at ``group`` query heads per kv head.

    Up to 8 heads, the block's 8 warps each take 8 keys of a tile; above
    8, two sets of 4 warps split the heads, so a tile holds 32 keys.  A
    row of more than 512 bytes (a float32 cache at hd 256) halves the
    keys a warp takes, so that two stages of the ring fit shared memory.
    """
    keys = 64 if group <= 8 else 32
    return keys // 2 if hd * cache_itemsize > 512 else keys


def choose_splits(batch: int, kv_heads: int, seq_len: int, group: int,
                  sm_count: int) -> int:
    """How many blocks may share one (sequence, kv head)'s keys.

    From the shapes alone, never from the lengths (they stay on the
    card): 1 when ``batch * kv_heads`` blocks already fill the card at
    :data:`BLOCKS_PER_SM`, else as many as fit in one wave of resident
    blocks, at most one per tile of the cache.  The kernel then uses
    fewer for a sequence whose live keys are short (parts of at least 8
    tiles), so a short sequence pays for no merge.
    """
    pairs = batch * kv_heads
    target = BLOCKS_PER_SM * sm_count
    if pairs >= target:
        return 1
    tiles = -(-seq_len // tile_keys(group))
    return max(1, min(target // pairs, tiles))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The card's number of SMs (cached per device index)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k_cache, v_cache, lengths) -> None:
    """Shapes, types and layout the kernel takes; raises on anything else."""
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"q must be (B, H, hd) and caches (B, S, KV, hd); "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, h, hd = q.shape
    _, s, kvh, hd_k = k_cache.shape
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b or hd_k != hd:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 of shape ({b},); got "
                         f"{lengths.dtype} of shape {tuple(lengths.shape)}")
    if hd not in HEAD_DIMS or h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS} and H a "
                         f"multiple of KV with H/KV <= {MAX_GROUP}; got "
                         f"hd={hd}, H={h}, KV={kvh}")
    if b > MAX_GRID:
        raise ValueError(f"the kernel's grid takes B up to {MAX_GRID}; "
                         f"got B={b}")
    floats = (torch.float32, torch.bfloat16)
    if q.dtype not in floats or k_cache.dtype not in floats \
            or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"q and caches must be float32 or bfloat16 (caches "
                         f"alike); got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.device != q.device or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"and on {q.device}")
    if lengths.device != q.device:
        raise ValueError(f"lengths is on {lengths.device}, q on {q.device}")


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's merge counters, zeroed once; the kernel leaves them 0."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def _launch(q, k_cache, v_cache, lengths, window: int) -> torch.Tensor:
    from ._build import load_library

    _check(q, k_cache, v_cache, lengths)
    q = q.contiguous()
    lengths = lengths.contiguous()
    b, h, hd = q.shape
    _, s, kvh, _ = k_cache.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    splits = choose_splits(b, kvh, s, h // kvh, sm_count(q.device.index))
    ws = counters = None
    if splits > 1:                 # one f32 partial (acc, m, l) per block
        ws = torch.empty(b * kvh * splits * (h // kvh) * (hd + 2),
                         dtype=torch.float32, device=q.device)
        counters = _counters(q.device, b * kvh)
    lib = load_library("decode_attention.cu").lib
    rc = lib.dynims_decode_attention(
        int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16),
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), b, h, kvh, s, hd,
        int(window), splits, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _work(q, k_cache, lengths, window: int):
    """One call's :func:`repro_torch.roofline.kernels.decode` work; on
    meta tensors the lengths are unknown and every sequence counts at
    the cache's length."""
    from ..roofline.kernels import decode
    b, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    lens = [s] * b if lengths.device.type == "meta" else lengths.tolist()
    return decode(lens, s, h, kvh, hd, window=window,
                  q_itemsize=q.element_size(),
                  kv_itemsize=k_cache.element_size())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q (B, H, hd), caches (B, S, KV, hd), lengths (B,) -> (B, H, hd).

    CPU tensors run :func:`decode_attention_plain`; CUDA tensors launch the
    kernel.  Under a :mod:`repro_torch.roofline.cost` count each call
    reports its work, and meta tensors are counted, not run.  Any other
    device raises, and so do inputs that require grad while grad mode is
    on.
    """
    refuse_autograd("decode_attention", (q, k_cache, v_cache),
                    "the differentiable plain path, repro_torch.models."
                    "attention.attention_dense over the cache")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      window=window)
    if count_call("decode_attention", q,
                  lambda lens: _work(q, k_cache, lens, window), lengths):
        return torch.empty_like(q)                # counted on meta, not run
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _launch(q, k_cache, v_cache, lengths, window)
