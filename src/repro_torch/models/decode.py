"""Serving decode: the KV caches and the one-token step.

The port of ``repro/models/decode.py`` (``init_state``, ``decode_step``,
``_self_layer_decode``, ``prefill``) for the dense family's flat stack.
The state is one ``(L, B, S, KV, hd)`` tensor each for k and v and the
per-sequence positions ``pos`` (B,) int32, all on the model's device.

Unlike JAX, which returns a new state, :func:`decode_step` updates the
state in place: each layer writes its token's K/V into its cache slice
(:func:`~repro_torch.models.attention.update_kv_cache`) and ``pos``
advances by one for every slot, occupied or not, as ``decode_step``
does in JAX.  Attention over the cache is the decode kernel (B3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .attention import (attention_decode, out_project, qkv_project,
                        update_kv_cache)
from .layers import embed_tokens, rms_norm, unembed
from .transformer import Model


@dataclass
class DecodeState:
    k: torch.Tensor        # (L, B, S, KV, hd)
    v: torch.Tensor        # (L, B, S, KV, hd)
    pos: torch.Tensor      # (B,) int32: the next write position per slot


def cache_dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (the JAX config's names) -> dtype."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"cache dtype must be one of {sorted(dtypes)}; "
                         f"got {name!r}")
    return dtypes[name]


def init_state(model: Model, batch: int, max_len: int,
               cache_dtype: str = "bfloat16") -> DecodeState:
    """Zero caches and positions for ``batch`` slots of ``max_len``."""
    cfg = model.cfg
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = cache_dtype_of(cache_dtype)
    return DecodeState(
        k=torch.zeros(shape, dtype=dt, device=model.device),
        v=torch.zeros(shape, dtype=dt, device=model.device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=model.device))


def decode_step(model: Model, state: DecodeState,
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, 1) -> logits (B, 1, padded_vocab); ``state`` in place."""
    cfg = model.cfg
    window = int(cfg.sliding_window)
    pos = state.pos
    x = embed_tokens(model.tokens, tokens, model.dtype)
    q_pos = pos[:, None]                           # (B, 1) rope positions
    for i, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm)
        q, k, v = qkv_project(layer.attn, h, h, cfg, q_pos, q_pos)
        update_kv_cache(state.k[i], state.v[i], k, v, pos)
        o = attention_decode(q, state.k[i], state.v[i], pos, cfg,
                             window=window)
        x = x + out_project(layer.attn, o, x.dtype)
        x = layer.mlp_block(x)
    x = rms_norm(x, model.final_norm)
    logits = unembed(model.tokens, x)
    pos.add_(1)
    return logits


def prefill(model: Model, tokens: torch.Tensor, max_len: int,
            cache_dtype: str = "bfloat16"
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Fill a decode state from a prompt (B, S); returns (last logits, state).

    Streams the prompt through :func:`decode_step`, as the JAX
    ``prefill`` does under a scan.
    """
    b, s = tokens.shape
    state = init_state(model, b, max_len, cache_dtype)
    logits = None
    for t in range(s):
        logits = decode_step(model, state, tokens[:, t:t + 1])
    return logits, state
