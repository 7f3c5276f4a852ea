"""Grouped-query attention: projections, self-attention, decode.

The port of ``repro/models/attention.py`` for the dense family.  Where
the JAX package chooses between materialized logits and a chunked scan
(``attention_dense``/``attention_chunked``), the port's self-attention
is the flash kernel (B2) over positions ``arange(S)``; one token
against a cache is the decode kernel (B3).  Weights keep the JAX
layouts: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d).
``make_mask`` is the flash kernel module's, whose plain version uses it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention, make_mask
from .layers import apply_rope, matmul_f32

__all__ = ["attention_decode", "make_mask", "out_project", "qkv_project",
           "self_attention", "update_kv_cache"]


def _no_softcap(cfg: ArchConfig) -> None:
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            f"{cfg.name}: attention logit softcap is not ported (neither "
            f"attention kernel has one; it comes with gemma's slice)")


def qkv_project(p, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig,
                q_positions: torch.Tensor, k_positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, d) -> q (B, S, H, hd), k and v (B, S, KV, hd) with RoPE.

    Products accumulate in float32 and are cast to ``xq``'s type, then
    rotated (attention.py ``qkv_project``).
    """
    def proj(x, w):
        d, heads, hd = w.shape
        out = matmul_f32(x, w.reshape(d, heads * hd))
        return out.reshape(*x.shape[:-1], heads, hd).to(xq.dtype)

    q = proj(xq, p.wq)
    k = proj(xkv, p.wk)
    v = proj(xkv, p.wv)
    q = apply_rope(q, q_positions, cfg.rope_theta)
    k = apply_rope(k, k_positions, cfg.rope_theta)
    return q, k, v


def out_project(p, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, d), float32 accumulation, cast to dtype."""
    h, hd, d = p.wo.shape
    out = matmul_f32(o.reshape(*o.shape[:-2], h * hd), p.wo.reshape(h * hd, d))
    return out.to(dtype)


def self_attention(p, x: torch.Tensor, cfg: ArchConfig,
                   window: int) -> torch.Tensor:
    """Causal self-attention of (B, S, d) over positions ``arange(S)``."""
    _no_softcap(cfg)
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = qkv_project(p, x, x, cfg, pos, pos)
    o = flash_attention(q, k, v, causal=True, window=window)
    return out_project(p, o, x.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor) -> None:
    """Write one token's K/V into (B, S, KV, hd) caches, in place.

    ``k``/``v`` are (B, 1, KV, hd) and ``pos`` (B,) the per-sequence
    write positions.  JAX returns new caches; the port writes into the
    preallocated tensors (``index_put_``), which saves a copy of the cache
    per layer per step.  A position at or past ``S`` writes to ``S - 1``,
    as JAX's ``dynamic_update_slice`` clamps it: a free serving slot
    keeps ticking past the cache's end.  The cast to the cache's type
    rounds to nearest even, as JAX's does.  Everything stays on the
    device; nothing syncs with the host.
    """
    b, s = k_cache.shape[0], k_cache.shape[1]
    rows = torch.arange(b, device=k_cache.device)
    at = pos.clamp(max=s - 1).to(torch.int64)
    k_cache.index_put_((rows, at), k[:, 0].to(k_cache.dtype))
    v_cache.index_put_((rows, at), v[:, 0].to(v_cache.dtype))


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     cfg: ArchConfig, *, window: int = 0) -> torch.Tensor:
    """q (B, 1, H, hd) against caches holding positions ``[0, pos]``.

    The JAX ``attention_decode`` attends ``[0, pos]`` inclusive with the
    window ``k > pos - window``; the kernel attends ``[0, len)`` with
    ``k >= len - window``.  The two agree at ``len = pos + 1``, clamped
    to the cache length ``S`` where JAX's mask admits every key.  With a
    window, a position past ``S - 1`` (only a free serving slot gets
    there, and its output is discarded) attends the cache's last
    ``window`` keys, where JAX attends ``(pos - window, S)``.
    """
    _no_softcap(cfg)
    s = k_cache.shape[1]
    lengths = (pos + 1).clamp(max=s).to(torch.int32)
    o = decode_attention(q[:, 0], k_cache, v_cache, lengths, window=window)
    return o[:, None]
