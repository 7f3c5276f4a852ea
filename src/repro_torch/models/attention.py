"""Grouped-query attention: projections, self- and cross-attention, decode.

The port of ``repro/models/attention.py``, QKV biases included.  The
inference attention is the flash kernel (B2): causal self-attention
over positions ``arange(S)``, the whisper encoder's non-causal
self-attention, and cross-attention of the text over image tokens or
encoder frames (non-causal, no RoPE).  One token against a cache is
the decode kernel (B3), over a layer's own KV cache or over a static
cross cache.  Neither kernel has a backward, so training takes JAX's
two plain paths under autograd: ``attention_dense`` (materialized
logits) and ``attention_chunked`` (the online-softmax carry over KV
chunks), chosen by JAX's rule (:func:`self_attention_train`).  Weights
keep the JAX layouts: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd),
``wo`` (H, hd, d), and with ``qkv_bias`` ``bq`` (H, hd), ``bk``/``bv``
(KV, hd) -- never on a cross-attention module (``attention_schema``
with ``cross=True``).  ``make_mask`` is the flash kernel module's,
whose plain version uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention, make_mask
from .layers import apply_rope, matmul_f32
from .params import TP_HINT, Axes, Spec

__all__ = ["attention_chunked", "attention_decode", "attention_dense",
           "attention_specs", "attn_tp", "cross_decode", "kv_project",
           "make_mask", "out_project", "qkv_project", "self_attention",
           "self_attention_train", "update_kv_cache"]

F32 = torch.float32
NEG_INF = -1e30
# attn_impl="auto" takes the dense path up to this many (query, key) pairs
DENSE_MAX_PAIRS = 2048 * 2048


def _no_softcap(cfg: ArchConfig) -> None:
    if cfg.attn_logit_softcap:
        raise NotImplementedError(
            f"{cfg.name}: attention logit softcap is not ported (neither "
            f"attention kernel has one, and no config of the registry "
            f"sets it; ROADMAP A5.2)")


def attn_tp(cfg: ArchConfig, axes: Axes, tp_size_hint: int = TP_HINT
            ) -> Tuple[Optional[str], Optional[str]]:
    """(query heads' axis, kv heads' axis) under the divisibility policy
    (``_attn_tp``): query heads split over ``tp`` when the production
    size divides them, kv heads too when it divides theirs; otherwise
    each shard holds every kv head (Megatron KV replication)."""
    if axes.tp is None or cfg.n_heads % tp_size_hint:
        return None, None
    kv_axis = axes.tp if cfg.n_kv_heads % tp_size_hint == 0 else None
    return axes.tp, kv_axis


def attention_specs(cfg: ArchConfig, axes: Axes, *,
                    cross: bool = False) -> dict:
    """The specs of an :class:`~repro_torch.models.transformer.Attention`
    (``attention_schema``): heads over ``tp`` by :func:`attn_tp`, d over
    ``fsdp``; ``wo`` is row-parallel."""
    q_tp, kv_tp = attn_tp(cfg, axes)
    out = {"wq": Spec(axes.fsdp, q_tp, None),
           "wk": Spec(axes.fsdp, kv_tp, None),
           "wv": Spec(axes.fsdp, kv_tp, None),
           "wo": Spec(q_tp, None, axes.fsdp)}
    if cfg.qkv_bias and not cross:
        out.update(bq=Spec(q_tp, None), bk=Spec(kv_tp, None),
                   bv=Spec(kv_tp, None))
    return out


def _proj(x: torch.Tensor, w: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """(B, S, d) @ (d, heads, hd) -> (B, S, heads, hd), float32
    accumulation, cast to ``dtype``."""
    d, heads, hd = w.shape
    out = matmul_f32(x, w.reshape(d, heads * hd))
    return out.reshape(*x.shape[:-1], heads, hd).to(dtype)


def qkv_project(p, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig,
                q_positions: Optional[torch.Tensor] = None,
                k_positions: Optional[torch.Tensor] = None, *,
                rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, Sq, d), (B, Skv, d) -> q (B, Sq, H, hd), k and v (B, Skv, KV,
    hd), with RoPE at the positions unless ``rope`` is False.

    Products accumulate in float32 and are cast to ``xq``'s type; the
    biases, when the layer has them, are added, then q and k rotated
    (attention.py ``qkv_project``).
    """
    q = _proj(xq, p.wq, xq.dtype)
    k, v = kv_project(p, xkv, xq.dtype)
    if p.bq is not None:
        q = q + p.bq
    if rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, k_positions, cfg.rope_theta)
    return q, k, v


def kv_project(p, xkv: torch.Tensor, dtype: torch.dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v (B, S, KV, hd) of (B, S, d) in ``dtype``, biases added,
    not rotated: :func:`qkv_project`'s k and v with ``rope=False``, for
    a cross cache that needs no queries."""
    k = _proj(xkv, p.wk, dtype)
    v = _proj(xkv, p.wv, dtype)
    if p.bk is not None:
        k, v = k + p.bk, v + p.bv
    return k, v


def out_project(p, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, d), float32 accumulation, cast to dtype."""
    h, hd, d = p.wo.shape
    out = matmul_f32(o.reshape(*o.shape[:-2], h * hd), p.wo.reshape(h * hd, d))
    return out.to(dtype)


def _project(p, x: torch.Tensor, xkv: Optional[torch.Tensor],
             cfg: ArchConfig, rope: bool):
    """q, k, v and their positions ``arange(Sq)``, ``arange(Skv)`` for
    attention of ``x`` over itself, or over ``xkv`` when given."""
    src = x if xkv is None else xkv
    q_pos = torch.arange(x.shape[1], device=x.device)
    k_pos = q_pos if xkv is None else torch.arange(src.shape[1],
                                                   device=x.device)
    q, k, v = qkv_project(p, x, src, cfg, q_pos, k_pos, rope=rope)
    return q, k, v, q_pos, k_pos


def self_attention(p, x: torch.Tensor, cfg: ArchConfig, window: int, *,
                   causal: bool = True, xkv: Optional[torch.Tensor] = None,
                   rope: bool = True) -> torch.Tensor:
    """Attention of (B, S, d) over itself at positions ``arange(S)``, or
    with ``xkv`` (B, Skv, d) over that at ``arange(Skv)``, on the flash
    kernel (``Model._attend``): causal by default; the encoder's is not,
    and cross-attention (``xkv``) is neither causal nor rotated."""
    _no_softcap(cfg)
    q, k, v, _, _ = _project(p, x, xkv, cfg, rope)
    o = flash_attention(q, k, v, causal=causal, window=window)
    return out_project(p, o, x.dtype)


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    cfg: ArchConfig) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd), mask (Sq, Skv) or None.

    Materialized float32 logits, masked to -1e30, softmax, cast to v's
    type (attention.py ``attention_dense``); differentiable.
    """
    _no_softcap(cfg)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(F32),
                          k.to(F32)) / (hd ** 0.5)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w.to(F32), v.to(F32))
    return o.reshape(b, sq, h, hd).to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      cfg: ArchConfig, *, causal: bool, window: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention in plain PyTorch, O(Sq * chunk) logits.

    The online-softmax carry (running max ``m``, sum ``l``, weighted
    values ``acc``) over KV chunks of ``attention.py
    attention_chunked``; the last chunk is padded with zero keys at
    position -1e9.  A window's mask drops them, but a causal mask alone
    keeps them (-1e9 <= i), as JAX's does (ROADMAP C20): chunk sizes
    that divide Skv avoid the padding.  Differentiable: autograd keeps
    each chunk's probabilities.
    """
    _no_softcap(cfg)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-10 ** 9)
    qg = q.reshape(b, sq, kvh, g, hd).to(F32).permute(0, 2, 3, 1, 4)
    kc = k.reshape(b, n_chunks, chunk, kvh, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, n_chunks, chunk, kvh, hd).permute(1, 0, 3, 2, 4)
    kpc = k_pos.reshape(n_chunks, chunk)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=F32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=F32, device=q.device)
    scale = 1.0 / (hd ** 0.5)
    for j in range(n_chunks):
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kc[j].to(F32)) * scale
        mask = make_mask(q_pos, kpc[j], causal=causal, window=window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p, vc[j].to(F32))
        m = m_new
    o = acc / l.clamp(min=1e-30)[..., None]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return o.to(q.dtype)


def self_attention_train(p, x: torch.Tensor, cfg: ArchConfig, window: int,
                         *, impl: str = "auto", chunk: int = 1024,
                         causal: bool = True,
                         xkv: Optional[torch.Tensor] = None,
                         rope: bool = True) -> torch.Tensor:
    """:func:`self_attention` for training, differentiable, in plain
    PyTorch.

    ``impl`` is JAX's ``Model.attn_impl``: "auto" takes the dense path
    when Sq * Skv <= 2048^2, else the chunked one (``Model._attend``).
    The dense path masks only when causal or windowed.
    """
    q, k, v, q_pos, k_pos = _project(p, x, xkv, cfg, rope)
    sq, skv = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "dense" if sq * skv <= DENSE_MAX_PAIRS else "chunked"
    if impl == "dense":
        mask = (make_mask(q_pos, k_pos, causal=causal, window=window)
                if causal or window else None)
        o = attention_dense(q, k, v, mask, cfg)
    elif impl == "chunked":
        o = attention_chunked(q, k, v, q_pos, k_pos, cfg, causal=causal,
                              window=window, chunk=chunk)
    else:
        raise ValueError(f"attn_impl must be auto, dense or chunked; got "
                         f"{impl!r}")
    return out_project(p, o, x.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor, uniform: bool = False) -> None:
    """Write one token's K/V into (B, S, KV, hd) caches, in place.

    ``k``/``v`` are (B, 1, KV, hd) and ``pos`` (B,) the per-sequence
    write positions.  JAX returns new caches; the port writes into the
    preallocated tensors (``index_put_``), which saves a copy of the cache
    per layer per step.  A position at or past ``S`` writes to ``S - 1``,
    as JAX's ``dynamic_update_slice`` clamps it: a free serving slot
    keeps ticking past the cache's end.  The cast to the cache's type
    rounds to nearest even, as JAX's does.  Everything stays on the
    device; nothing syncs with the host.

    ``uniform=True`` asserts that every sequence sits at ``pos[0]``
    (bulk decode benchmarks, synchronized batches): the token's K/V go
    in as one slice along the sequence dim (``index_copy_``), the same
    bits the per-sequence write gives there.  JAX's ``uniform`` path
    writes nothing at a position past the cache's end; this one clamps
    it as the per-sequence path does.
    """
    b, s = k_cache.shape[0], k_cache.shape[1]
    if uniform:
        at = pos[:1].clamp(max=s - 1).to(torch.int64)
        k_cache.index_copy_(1, at, k.to(k_cache.dtype))
        v_cache.index_copy_(1, at, v.to(v_cache.dtype))
        return
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


def cross_decode(p, h: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """One token (B, 1, d) against a static cross cache (B, S, KV, hd):
    queries without RoPE over keys ``[0, lengths_b)`` on the decode
    kernel, projected out.

    JAX projects k and v from ``h`` too and discards them; this does
    not.  A length of 0 gives zeros (the kernel keeps no key), where
    JAX's mask keeps none either and its softmax spreads evenly over
    the cache: both give 0 over the zero cache an engine starts with.
    """
    _no_softcap(cfg)
    q = _proj(h, p.wq, h.dtype)
    if p.bq is not None:
        q = q + p.bq
    o = decode_attention(q[:, 0], k_cache, v_cache, lengths)
    return out_project(p, o[:, None], h.dtype)
