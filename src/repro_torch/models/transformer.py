"""The dense decoder: parameters, initialization and the parallel forward.

The port of ``repro/models/transformer.py`` (``Model``, ``forward``,
``_self_layer``) and of the init kinds of ``repro/models/params.py`` for
the ``dense`` family with a flat layer stack -- the family of
llama3.2-1b.  Other families and features (experts, the grouped local:
global window schedule, QKV biases, untied embeddings, softcaps) raise
``NotImplementedError``; they come with later slices (ROADMAP A5).

Parameters keep the JAX package's names and layouts, one
:class:`Layer` per entry of the JAX stack's leading axis, so
:func:`repro_torch.convert.model_params_from_numpy` copies them
tensor for tensor.  They are initialized from an explicit
``torch.Generator`` seeded by ``seed`` on the model's device; the
numbers differ from ``jax.random``'s, the kinds and scales do not.
Nothing here trains: parameters carry no gradient.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .attention import self_attention
from .layers import embed_tokens, rms_norm, swiglu_mlp, unembed


def init_tensor(shape: Tuple[int, ...], kind: str, gen: torch.Generator,
                dtype: torch.dtype, device: torch.device, *,
                scale: float = 1.0,
                fan_in_axes: Sequence[int] = (0,)) -> torch.Tensor:
    """One parameter by init kind, as ``params._init_leaf`` draws it.

    Kinds: "zeros", "ones", "const" (``scale``), "normal" (std
    ``scale``), "small" (std ``0.02 * scale``), "fan_in" (std ``scale /
    sqrt(fan)``, fan the product of ``shape`` over ``fan_in_axes``).
    Draws are float32 normals cast to ``dtype``.
    """
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "const":
        return torch.full(shape, scale, dtype=dtype, device=device)
    if kind == "normal":
        std = scale
    elif kind == "small":
        std = 0.02 * scale
    elif kind == "fan_in":
        fan = math.prod(shape[a] for a in fan_in_axes)
        std = scale / max(fan, 1) ** 0.5
    else:
        raise ValueError(f"unknown init {kind!r}")
    draw = torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)
    return (draw * std).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    """``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d)."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _param(make((d, h, hd), "fan_in"))
        self.wk = _param(make((d, kv, hd), "fan_in"))
        self.wv = _param(make((d, kv, hd), "fan_in"))
        self.wo = _param(make((h, hd, d), "fan_in"))


class MLP(nn.Module):
    """SwiGLU: ``wi``/``wg`` (d, f), ``wo`` (f, d)."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wi = _param(make((d, f), "fan_in"))
        self.wo = _param(make((f, d), "fan_in"))
        self.wg = _param(make((d, f), "fan_in"))


class Layer(nn.Module):
    """One pre-norm decoder layer (``_self_layer``)."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        self.attn_norm = _param(make((cfg.d_model,), "ones"))
        self.attn = Attention(cfg, make)
        self.mlp_norm = _param(make((cfg.d_model,), "ones"))
        self.mlp = MLP(cfg, make)

    def mlp_block(self, x: torch.Tensor) -> torch.Tensor:
        """x + MLP(norm(x))."""
        h = rms_norm(x, self.mlp_norm)
        return x + swiglu_mlp(h, self.mlp.wi, self.mlp.wg, self.mlp.wo)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for any config feature the port does not carry yet."""
    unsupported = {
        "family": cfg.family != "dense",
        "experts": cfg.is_moe,
        "grouped window schedule (global_every)": bool(cfg.global_every),
        "qkv_bias": cfg.qkv_bias,
        "untied embeddings": not cfg.tie_embeddings,
        "attn_logit_softcap": bool(cfg.attn_logit_softcap),
        "norm": cfg.norm != "rmsnorm",
        "activation": cfg.act != "silu" or not cfg.mlp_gated,
    }
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense llama family only; "
            f"not ported: {missing} (ROADMAP A5)")


class Model(nn.Module):
    """A dense decoder on one device.

    ``device=None`` means the card, and raises without one;
    ``device="cpu"`` runs the kernels' plain versions.  ``init=False``
    leaves the parameters unset (``torch.empty``) for a caller that
    fills them, as the converter does.
    """

    def __init__(self, cfg: ArchConfig, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, init: bool = True):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def make(shape, kind):
            if not init:
                return torch.empty(shape, dtype=dtype, device=dev)
            return init_tensor(shape, kind, gen, dtype, dev)

        self.tokens = _param(make((cfg.padded_vocab, cfg.d_model), "small"))
        self.layers = nn.ModuleList(Layer(cfg, make)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _param(make((cfg.d_model,), "ones"))

    @property
    def dtype(self) -> torch.dtype:
        """The activation type: the embedding's (``Model._adtype``)."""
        return self.tokens.dtype

    @property
    def device(self) -> torch.device:
        return self.tokens.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, padded_vocab), float32.

        Self-attention of every layer runs the flash kernel (B2) over
        positions ``arange(S)``.
        """
        cfg = self.cfg
        window = int(cfg.sliding_window)
        x = embed_tokens(self.tokens, tokens, self.dtype)
        for layer in self.layers:
            h = rms_norm(x, layer.attn_norm)
            x = x + self_attention(layer.attn, h, cfg, window)
            x = layer.mlp_block(x)
        x = rms_norm(x, self.final_norm)
        return unembed(self.tokens, x)
