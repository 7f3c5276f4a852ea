"""Serving decode: the KV caches, the recurrent state and the one-token step.

The port of ``repro/models/decode.py`` (``init_state``, ``decode_step``,
``_self_layer_decode``, ``_hybrid_layer_decode``, ``prefill``) for the
dense, hybrid and moe families.  The state is one ``(L, B, S, KV, hd)``
tensor each for k and v, the per-sequence positions ``pos`` (B,) int32
and, for the hybrid family, the Mamba state ``mamba_h`` (L, B, inner, N)
and ``mamba_conv`` (L, B, k - 1, inner) in float32 (``_mamba_state``),
all on the model's device.  Each layer attends with its own window
(:func:`~repro_torch.models.transformer.layer_windows`).

Unlike JAX, which returns a new state, :func:`decode_step` updates the
state in place: each layer writes its token's K/V into its cache slice
(:func:`~repro_torch.models.attention.update_kv_cache`) and its Mamba
state into its slices, and ``pos`` advances by one for every slot,
occupied or not, as ``decode_step`` does in JAX.  Attention over the
cache is the decode kernel (B3).  A moe layer routes the step's B
tokens as one group of B (``moe_apply`` on (B, 1, d)), free slots
included: the engine feeds them token 0, they take room in the experts'
buffers as JAX's do, and the layer's aux loss is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .attention import (attention_decode, out_project, qkv_project,
                        update_kv_cache)
from .layers import embed_tokens, rms_norm
from .ssm import mamba_decode_step, mamba_state_shape
from .transformer import Model, fuse_branches


@dataclass
class DecodeState:
    k: torch.Tensor        # (L, B, S, KV, hd)
    v: torch.Tensor        # (L, B, S, KV, hd)
    pos: torch.Tensor      # (B,) int32: the next write position per slot
    mamba_h: Optional[torch.Tensor] = None      # (L, B, inner, N) float32
    mamba_conv: Optional[torch.Tensor] = None   # (L, B, k - 1, inner)

    def reset_slot(self, i: int) -> None:
        """Start slot ``i`` afresh: position 0 and a zero Mamba state.

        The cache needs no clearing: it is masked by position.
        """
        self.pos[i] = 0
        if self.mamba_h is not None:
            self.mamba_h[:, i] = 0.0
            self.mamba_conv[:, i] = 0.0


def cache_dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (the JAX config's names) -> dtype."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"cache dtype must be one of {sorted(dtypes)}; "
                         f"got {name!r}")
    return dtypes[name]


def init_state(model: Model, batch: int, max_len: int,
               cache_dtype: str = "bfloat16") -> DecodeState:
    """Zero caches, positions and recurrent state for ``batch`` slots."""
    cfg, dev = model.cfg, model.device
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = cache_dtype_of(cache_dtype)
    state = DecodeState(
        k=torch.zeros(shape, dtype=dt, device=dev),
        v=torch.zeros(shape, dtype=dt, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))
    if cfg.family == "hybrid":
        h, conv = mamba_state_shape(cfg, batch)
        state.mamba_h = torch.zeros((cfg.n_layers, *h), device=dev)
        state.mamba_conv = torch.zeros((cfg.n_layers, *conv), device=dev)
    return state


def _attend(layer, h, state: DecodeState, i: int, q_pos, cfg,
            window: int) -> torch.Tensor:
    """Self-attention of one token against layer ``i``'s cache."""
    q, k, v = qkv_project(layer.attn, h, h, cfg, q_pos, q_pos)
    update_kv_cache(state.k[i], state.v[i], k, v, state.pos)
    o = attention_decode(q, state.k[i], state.v[i], state.pos, cfg,
                         window=window)
    return out_project(layer.attn, o, h.dtype)


def decode_step(model: Model, state: DecodeState,
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, 1) -> logits (B, 1, padded_vocab); ``state`` in place."""
    cfg = model.cfg
    x = embed_tokens(model.tokens, tokens, model.dtype, cfg.name)
    q_pos = state.pos[:, None]                     # (B, 1) rope positions
    for i, (layer, window) in enumerate(zip(model.layers, model.windows)):
        if cfg.family == "hybrid":                 # _hybrid_layer_decode
            h = rms_norm(x, layer.norm)
            a = _attend(layer, h, state, i, q_pos, cfg, window)
            m, hs, conv = mamba_decode_step(layer.mamba, h, state.mamba_h[i],
                                            state.mamba_conv[i], cfg)
            state.mamba_h[i].copy_(hs)
            state.mamba_conv[i].copy_(conv)
            x = x + fuse_branches(a, m).to(x.dtype)
        else:                                      # _self_layer_decode
            h = rms_norm(x, layer.attn_norm)
            x = x + _attend(layer, h, state, i, q_pos, cfg, window)
        x, _ = layer.mlp_block(x, cfg)     # a moe layer's aux is dropped
    logits = model.logits(x)
    state.pos.add_(1)
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
