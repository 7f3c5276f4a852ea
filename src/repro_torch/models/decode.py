"""Serving decode: the KV caches, the recurrent state and the one-token step.

The port of ``repro/models/decode.py`` (``init_state``, ``decode_step``,
``_self_layer_decode``, ``_hybrid_layer_decode``, ``_decode_vlm``,
``_decode_audio``, ``_decode_ssm``, ``_attach_cross_context``,
``prefill``) for every family.  The state is one ``(L, B, S, KV, hd)``
tensor each for k and v over the self layers (L = 0 for the ssm
family, which attends nowhere), the per-sequence positions ``pos``
(B,) int32 and, for the hybrid family, the Mamba state ``mamba_h`` (L,
B, inner, N) and ``mamba_conv`` (L, B, k - 1, inner) in float32
(``_mamba_state``), all on the model's device.  The ssm family's
recurrent state, ``recurrent``, is JAX's tree: per block of a pair
(``"0_mlstm"``, ``"1_slstm"``) its leaves stacked over the pairs in
float32, the mLSTM's c (P, B, H, hd, hd), n (P, B, H, hd) and m (P, B,
H), the sLSTM's c, n, h and m (P, B, H, hd) each; every m starts at
-1e30 and the rest at 0 (``_mlstm_state``, ``_slstm_state``).
The cross-attention families add a static cross cache, ``cross_k`` and
``cross_v`` in the cache's type: (groups, B, vision_tokens, KV, hd) for
the vlm family, one per cross layer; (L, B, enc_len_max, KV, hd) for
the audio family, one per decoder layer, with ``enc_len``, a scalar
int32, the encoder frames they hold (``state_schema``).  Each layer
attends with its own window
(:func:`~repro_torch.models.transformer.layer_windows`).

Unlike JAX, which returns a new state, :func:`decode_step` updates the
state in place: each layer writes its token's K/V into its cache slice
(:func:`~repro_torch.models.attention.update_kv_cache`) and its Mamba
or mLSTM/sLSTM state into its slices, and ``pos`` advances by one for
every slot,
occupied or not, as ``decode_step`` does in JAX.  Attention over the
cache is the decode kernel (B3), over a self cache and over a cross
cache alike.  The cross caches are zero, and ``enc_len`` 0, until
:func:`attach_cross_context` projects the images or the encoder's
output into them, as :func:`prefill` does; JAX's serving engine never
does, and neither does the port's.  A moe layer routes the step's B
tokens as one group of B (``moe_apply`` on (B, 1, d)), free slots
included: the engine feeds them token 0, they take room in the experts'
buffers as JAX's do, and the layer's aux loss is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .attention import (attention_decode, cross_decode, kv_project,
                        out_project, qkv_project, update_kv_cache)
from .layers import embed_tokens
from .ssm import (mamba_decode_step, mamba_state_shape, mlstm_decode_step,
                  mlstm_state_shapes, slstm_decode_step, slstm_state_shapes)
from .transformer import Model, fuse_branches, norm_of


@dataclass
class DecodeState:
    k: torch.Tensor        # (L, B, S, KV, hd)
    v: torch.Tensor        # (L, B, S, KV, hd)
    pos: torch.Tensor      # (B,) int32: the next write position per slot
    mamba_h: Optional[torch.Tensor] = None      # (L, B, inner, N) float32
    mamba_conv: Optional[torch.Tensor] = None   # (L, B, k - 1, inner)
    cross_k: Optional[torch.Tensor] = None      # (n_cross, B, S_ctx, KV, hd)
    cross_v: Optional[torch.Tensor] = None      # (n_cross, B, S_ctx, KV, hd)
    enc_len: Optional[torch.Tensor] = None      # () int32, audio only
    # ssm: block name -> leaf name -> (P, B, ...) float32
    recurrent: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    def reset_slot(self, i: int) -> None:
        """Start slot ``i`` afresh: position 0 and its recurrent state at
        its starting values (``_reset_slot_state``): the Mamba state at
        0, every mLSTM and sLSTM m at -1e30 and their other leaves at 0.

        The cache needs no clearing: it is masked by position.  The cross
        caches and ``enc_len`` stay, as JAX's ``_reset_slot_state``
        leaves them.
        """
        self.pos[i] = 0
        if self.mamba_h is not None:
            self.mamba_h[:, i] = 0.0
            self.mamba_conv[:, i] = 0.0
        for leaves in (self.recurrent or {}).values():
            for name, leaf in leaves.items():
                leaf[:, i] = STATE_START.get(name, 0.0)


# A recurrent leaf's starting value, by name, where it is not 0
STATE_START = {"m": -1e30}


def cache_dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (the JAX config's names) -> dtype."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"cache dtype must be one of {sorted(dtypes)}; "
                         f"got {name!r}")
    return dtypes[name]


def init_state(model: Model, batch: int, max_len: int,
               cache_dtype: str = "bfloat16") -> DecodeState:
    """Zero caches and positions for ``batch`` slots and the recurrent
    state at its starting values; zero cross caches and ``enc_len`` for
    the cross-attention families."""
    cfg, dev = model.cfg, model.device
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    n = 0 if cfg.family == "ssm" else len(model.layers)
    dt = cache_dtype_of(cache_dtype)
    state = DecodeState(
        k=torch.zeros((n, *kv), dtype=dt, device=dev),
        v=torch.zeros((n, *kv), dtype=dt, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))
    if cfg.family == "hybrid":
        h, conv = mamba_state_shape(cfg, batch)
        state.mamba_h = torch.zeros((n, *h), device=dev)
        state.mamba_conv = torch.zeros((n, *conv), device=dev)
    if cfg.family in ("vlm", "audio"):
        n_cross = (len(model.cross_layers) if cfg.family == "vlm" else n)
        shape = (n_cross, batch, cfg.vision_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        state.cross_k = torch.zeros(shape, dtype=dt, device=dev)
        state.cross_v = torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family == "audio":
        state.enc_len = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        shapes = {"mlstm": mlstm_state_shapes, "slstm": slstm_state_shapes}
        state.recurrent = {
            key: {name: torch.full((len(model.layers), *shape),
                                   STATE_START.get(name, 0.0), device=dev)
                  for name, shape in shapes[block.kind](cfg, batch).items()}
            for key, block in model.layers[0].items()}
    return state


def _ssm_pair_decode(pair, state: DecodeState, i: int, x: torch.Tensor,
                     cfg) -> torch.Tensor:
    """One token through pair ``i`` of the ssm stack (``_decode_ssm``):
    ``x + block(norm(x))`` per block, its state written back in place."""
    for key, block in pair.items():
        leaves = state.recurrent[key]
        step = (mlstm_decode_step if block.kind == "mlstm"
                else slstm_decode_step)
        h, new = step(block.block, norm_of(block, "norm", x, cfg),
                      {name: leaf[i] for name, leaf in leaves.items()}, cfg)
        for name, leaf in leaves.items():
            leaf[i].copy_(new[name])
        x = x + h
    return x


def _attend(layer, h, state: DecodeState, i: int, q_pos, cfg,
            window: int) -> torch.Tensor:
    """Self-attention of one token against layer ``i``'s cache."""
    q, k, v = qkv_project(layer.attn, h, h, cfg, q_pos, q_pos)
    update_kv_cache(state.k[i], state.v[i], k, v, state.pos)
    o = attention_decode(q, state.k[i], state.v[i], state.pos, cfg,
                         window=window)
    return out_project(layer.attn, o, h.dtype)


def _cross_lengths(state: DecodeState) -> torch.Tensor:
    """The keys each slot's cross-attention reads: all ``vision_tokens``
    (vlm, JAX's ``cross_k.shape[1] - 1`` inclusive), or ``enc_len``
    (audio, JAX's ``enc_len - 1`` inclusive), for every slot."""
    b, s = state.cross_k.shape[1], state.cross_k.shape[2]
    if state.enc_len is None:
        return torch.full((b,), s, dtype=torch.int32, device=state.pos.device)
    return state.enc_len.expand(b).contiguous()


def decode_step(model: Model, state: DecodeState,  # planecheck: hot-loop
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, 1) -> logits (B, 1, padded_vocab); ``state`` in place."""
    cfg = model.cfg
    x = embed_tokens(model.tokens, tokens, model.dtype, cfg.name)
    q_pos = state.pos[:, None]                     # (B, 1) rope positions
    lens = _cross_lengths(state) if state.cross_k is not None else None
    g = cfg.cross_attn_group
    for i, (layer, window) in enumerate(zip(model.layers, model.windows)):
        if cfg.family == "ssm":                    # _decode_ssm
            x = _ssm_pair_decode(layer, state, i, x, cfg)
            continue
        if cfg.family == "hybrid":                 # _hybrid_layer_decode
            h = norm_of(layer, "norm", x, cfg)
            a = _attend(layer, h, state, i, q_pos, cfg, window)
            m, hs, conv = mamba_decode_step(layer.mamba, h, state.mamba_h[i],
                                            state.mamba_conv[i], cfg)
            state.mamba_h[i].copy_(hs)
            state.mamba_conv[i].copy_(conv)
            x = x + fuse_branches(a, m).to(x.dtype)
        else:                                      # _self_layer_decode
            h = norm_of(layer, "attn_norm", x, cfg)
            x = x + _attend(layer, h, state, i, q_pos, cfg, window)
        if layer.cross is not None:                # _decode_audio
            h = norm_of(layer, "cross_norm", x, cfg)
            x = x + cross_decode(layer.cross, h, state.cross_k[i],
                                 state.cross_v[i], lens, cfg)
        x, _ = layer.mlp_block(x, cfg)     # a moe layer's aux is dropped
        if cfg.family == "vlm" and (i + 1) % g == 0:   # _decode_vlm
            c = model.cross_layers[i // g]
            h = norm_of(c, "attn_norm", x, cfg)
            h = cross_decode(c.attn, h, state.cross_k[i // g],
                             state.cross_v[i // g], lens, cfg)
            x, _ = c.mlp_block(c.gated(x, h), cfg)
    logits = model.logits(x)
    state.pos.add_(1)
    return logits


def attach_cross_context(model: Model, state: DecodeState, *,
                         images: Optional[torch.Tensor] = None,
                         frames: Optional[torch.Tensor] = None) -> None:
    """Project the images (vlm) or the encoder's output over the frames
    (audio) into the state's cross caches, in place
    (``_attach_cross_context``).

    vlm: each cross layer's k and v of the images rounded to bfloat16
    first, as JAX rounds them (its forward does not: the two differ by
    ~1e-3), then cast to the cache's type.  audio: the encoder runs on
    the kernel path (:meth:`Model.encode`), its output is cut to the
    cache's ``enc_len_max`` frames, each decoder layer's k and v of it
    fill the cache from the left with zeros after them, and ``enc_len``
    becomes the frames kept.  Other families take neither and keep no
    cross cache.
    """
    fam = model.cfg.family
    if fam == "vlm":
        if images is None or frames is not None:
            raise ValueError("the vlm family's context is images alone")
        img = images.to(torch.bfloat16)
        for g, c in enumerate(model.cross_layers):
            k, v = kv_project(c.attn, img, img.dtype)
            state.cross_k[g].copy_(k)
            state.cross_v[g].copy_(v)
    elif fam == "audio":
        if frames is None or images is not None:
            raise ValueError("the audio family's context is frames alone")
        enc = model.encode(frames)[:, :state.cross_k.shape[2]]
        pad = state.cross_k.shape[2] - enc.shape[1]
        for i, layer in enumerate(model.layers):
            k, v = kv_project(layer.cross, enc, enc.dtype)
            state.cross_k[i].copy_(F.pad(k, (0, 0, 0, 0, 0, pad)))
            state.cross_v[i].copy_(F.pad(v, (0, 0, 0, 0, 0, pad)))
        state.enc_len.fill_(enc.shape[1])
    elif images is not None or frames is not None:
        raise ValueError(f"the {fam} family attends to no images or frames")


def prefill(model: Model, tokens: torch.Tensor, max_len: int,
            cache_dtype: str = "bfloat16", *,
            images: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Fill a decode state from a prompt (B, S); returns (last logits, state).

    The cross-attention families' context (``images`` or ``frames``) is
    projected once up front (:func:`attach_cross_context`); then the
    prompt streams through :func:`decode_step`, as the JAX ``prefill``
    does under a scan.
    """
    b, s = tokens.shape
    state = init_state(model, b, max_len, cache_dtype)
    attach_cross_context(model, state, images=images, frames=frames)
    logits = None
    for t in range(s):
        logits = decode_step(model, state, tokens[:, t:t + 1])
    return logits, state
