"""The decoder: parameters, initialization and the parallel forward.

The port of ``repro/models/transformer.py`` (``Model``, ``forward``,
``_self_layer``, ``_hybrid_layer``) and of the init kinds of
``repro/models/params.py`` for three families: ``dense`` (llama3.2-1b;
gemma3-1b with its gelu MLP and scaled embedding; qwen2-1.5b with its
QKV biases), ``hybrid`` (hymba-1.5b: attention and Mamba in parallel
in every layer, fused by the mean of their RMS-normalized outputs) and
``moe`` (qwen2-moe-a2.7b, dbrx-132b: the dense layer with its MLP
replaced by routed experts, :mod:`~repro_torch.models.moe`).  Other
families and features (softcaps, layernorm) raise
``NotImplementedError``; they come with later slices (ROADMAP A5).

The layers form one flat ``nn.ModuleList``, each with its window from
:func:`layer_windows`, where JAX nests the grouped local:global
schedule into stacks (``_windowed_stack_schema``).  Parameters keep the
JAX package's names and layouts, so
:func:`repro_torch.convert.model_params_from_numpy` copies them tensor
for tensor.  They are initialized from an explicit ``torch.Generator``
seeded by ``seed`` on the model's device; the numbers differ from
``jax.random``'s, the kinds and scales do not.

Two forwards: :meth:`Model.forward`, the kernels' (flash attention,
B2, and the scan, B4), which serving calls; and
:meth:`Model.forward_train`, plain PyTorch under autograd for every
family (JAX's ``attention_dense``/``attention_chunked`` by its
``attn_impl`` rule, the hybrid's Mamba branch as JAX's chunked
associative scan, each layer under the ``remat`` policy), which
:meth:`Model.loss` and the trainer call.  Both run the experts of a moe
layer through :func:`~repro_torch.models.moe.moe_apply` and, asked
with ``aux=True``, return the layers' mean load-balance loss beside
the logits, as JAX's ``Model.forward`` does.  The kernels have no backward
and refuse inputs that require grad.  Parameters are created with
``requires_grad=False``; the train step turns it on.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .attention import self_attention, self_attention_train
from .layers import (ACTIVATIONS, apply_mlp, cross_entropy, embed_tokens,
                     rms_norm, unembed)
from .moe import MoE, moe_apply
from .ssm import Mamba, mamba_apply, mamba_apply_chunked

F32 = torch.float32
REMAT_POLICIES = ("full", "dots", "none")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Keep the matrix products' outputs, recompute everything else
    (``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under JAX's remat policy (transformer.py ``_remat``):
    "full" saves only the layer's inputs, "dots" also its products,
    "none" everything autograd keeps."""
    if policy == "none":
        return fn
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat must be one of {REMAT_POLICIES}; got "
                     f"{policy!r}")


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


class Attention(nn.Module):
    """``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d);
    with ``qkv_bias`` also ``bq`` (H, hd), ``bk``/``bv`` (KV, hd), zeros
    at init (``attention_schema``), else None."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = make((d, h, hd), "fan_in")
        self.wk = make((d, kv, hd), "fan_in")
        self.wv = make((d, kv, hd), "fan_in")
        self.wo = make((h, hd, d), "fan_in")
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = make((h, hd), "zeros")
            self.bk = make((kv, hd), "zeros")
            self.bv = make((kv, hd), "zeros")


class MLP(nn.Module):
    """``wi`` (d, f), ``wo`` (f, d) and, gated, ``wg`` (d, f)
    (``mlp_schema``); ``act`` is the config's activation."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.act = cfg.act
        self.wi = make((d, f), "fan_in")
        self.wo = make((f, d), "fan_in")
        self.wg = make((d, f), "fan_in") if cfg.mlp_gated else None


class _Block(nn.Module):
    """What every layer ends with: the pre-norm MLP, or the experts."""

    def mlp_block(self, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x + MLP(norm(x)), the layer's aux loss): a moe layer's from
        :func:`moe_apply` under ``cfg`` (the model's), else None."""
        h = rms_norm(x, self.mlp_norm)
        if self.moe is not None:
            out, aux = moe_apply(self.moe, h, cfg)
            return x + out, aux
        m = self.mlp
        return x + apply_mlp(h, m.wi, m.wg, m.wo, m.act), None


class Layer(_Block):
    """One pre-norm decoder layer (``_self_layer``): ``attn_norm``,
    ``attn``, ``mlp_norm``, and ``mlp`` or, with experts, ``moe``."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        self.attn_norm = make((cfg.d_model,), "ones")
        self.attn = Attention(cfg, make)
        self.mlp_norm = make((cfg.d_model,), "ones")
        self.mlp = None if cfg.is_moe else MLP(cfg, make)
        self.moe = MoE(cfg, make) if cfg.is_moe else None


class HybridLayer(_Block):
    """Attention and Mamba in parallel (``_hybrid_layer_schema``): ``norm``,
    ``attn``, ``mamba``, ``mlp_norm``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        self.norm = make((cfg.d_model,), "ones")
        self.attn = Attention(cfg, make)
        self.mamba = Mamba(cfg, make)
        self.mlp_norm = make((cfg.d_model,), "ones")
        self.mlp = MLP(cfg, make)
        self.moe = None


def rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Weightless RMS normalization (``transformer._rms``)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def fuse_branches(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """0.5 * (rms(a) + rms(m)) in float32: the hybrid layer's mean fusion."""
    return 0.5 * (rms(a.to(F32)) + rms(m.to(F32)))


def layer_windows(cfg: ArchConfig) -> List[int]:
    """Each layer's attention window (0 = global), in stack order.

    The schedule of ``_windowed_stack_schema``/``_run_windowed``: with a
    window and a period p = ``global_every`` <= L, the first L // p
    groups of p layers end in a global layer and the tail layers are
    local; otherwise every layer takes ``sliding_window``.
    """
    w, p, n = int(cfg.sliding_window), cfg.global_every, cfg.n_layers
    if not (w and p) or n < p:
        return [w] * n
    grouped = n // p * p
    return [0 if i < grouped and i % p == p - 1 else w for i in range(n)]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for any config feature the port does not carry yet."""
    unsupported = {
        "family": cfg.family not in ("dense", "hybrid", "moe"),
        "attn_logit_softcap": bool(cfg.attn_logit_softcap),
        "norm": cfg.norm != "rmsnorm",
        "activation": cfg.act not in ACTIVATIONS,
    }
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense, hybrid and moe "
            f"families only; not ported: {missing} (ROADMAP A5)")


class Model(nn.Module):
    """A dense, hybrid or moe decoder on one device.

    ``device=None`` means the card, and raises without one;
    ``device="cpu"`` runs the kernels' plain versions.  ``init=False``
    leaves the parameters unset (``torch.empty``) for a caller that
    fills them, as the converter does.  ``remat``, ``attn_impl`` and
    ``attn_chunk`` are JAX's ``Model`` fields and shape only
    :meth:`forward_train`.
    """

    def __init__(self, cfg: ArchConfig, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, init: bool = True,
                 remat: str = "full", attn_impl: str = "auto",
                 attn_chunk: int = 1024):
        super().__init__()
        check_supported(cfg)
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat must be one of {REMAT_POLICIES}; got "
                             f"{remat!r}")
        self.cfg = cfg
        self.remat = remat
        self.attn_impl = attn_impl
        self.attn_chunk = attn_chunk
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def make(shape, kind):
            t = (init_tensor(shape, kind, gen, dtype, dev) if init
                 else torch.empty(shape, dtype=dtype, device=dev))
            return nn.Parameter(t, requires_grad=False)

        self.tokens = make((cfg.padded_vocab, cfg.d_model), "small")
        kind = HybridLayer if cfg.family == "hybrid" else Layer
        self.layers = nn.ModuleList(kind(cfg, make)
                                    for _ in range(cfg.n_layers))
        self.windows = layer_windows(cfg)
        self.final_norm = make((cfg.d_model,), "ones")
        # the untied readout (d, Vp), ``embed["unembed"]`` in JAX
        self.unembed = (None if cfg.tie_embeddings
                        else make((cfg.d_model, cfg.padded_vocab), "fan_in"))

    @property
    def dtype(self) -> torch.dtype:
        """The activation type: the embedding's (``Model._adtype``)."""
        return self.tokens.dtype

    @property
    def device(self) -> torch.device:
        return self.tokens.device

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and readout: (..., d) -> float32 (..., padded_vocab)."""
        return unembed(self.tokens, rms_norm(x, self.final_norm),
                       self.unembed)

    def _mean_aux(self, aux: torch.Tensor) -> torch.Tensor:
        """The layers' summed aux over their count for the moe family
        (``_run_windowed``); the dense and hybrid sum stays zero."""
        return aux / max(self.cfg.n_layers, 1) if self.cfg.is_moe else aux

    def forward(self, tokens: torch.Tensor, *, aux: bool = False):
        """tokens (B, S) -> logits (B, S, padded_vocab), float32; with
        ``aux``, (logits, the moe layers' mean aux loss).

        Self-attention of every layer runs the flash kernel (B2) over
        positions ``arange(S)`` with the layer's window; a hybrid layer's
        Mamba branch runs the scan kernel (B4) over the whole sequence.
        """
        cfg = self.cfg
        x = embed_tokens(self.tokens, tokens, self.dtype, cfg.name)
        total = torch.zeros((), dtype=F32, device=x.device)
        for layer, window in zip(self.layers, self.windows):
            if cfg.family == "hybrid":
                h = rms_norm(x, layer.norm)
                a = self_attention(layer.attn, h, cfg, window)
                m = mamba_apply(layer.mamba, h, cfg)
                x = x + fuse_branches(a, m).to(x.dtype)
            else:
                h = rms_norm(x, layer.attn_norm)
                x = x + self_attention(layer.attn, h, cfg, window)
            x, a = layer.mlp_block(x, cfg)
            if a is not None:
                total = total + a
        logits = self.logits(x)
        return (logits, self._mean_aux(total)) if aux else logits

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    def _train_layer(self, i: int, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Layer ``i`` in plain torch: ``_self_layer`` or, hybrid,
        ``_hybrid_layer`` with the chunked Mamba scan; returns (x, the
        layer's aux loss or None)."""
        cfg, layer = self.cfg, self.layers[i]
        hybrid = cfg.family == "hybrid"
        h = rms_norm(x, layer.norm if hybrid else layer.attn_norm)
        a = self_attention_train(layer.attn, h, cfg, self.windows[i],
                                 impl=self.attn_impl, chunk=self.attn_chunk)
        if hybrid:
            m = mamba_apply_chunked(layer.mamba, h, cfg)
            x = x + fuse_branches(a, m).to(x.dtype)
        else:
            x = x + a
        return layer.mlp_block(x, cfg)

    def forward_train(self, tokens: torch.Tensor, *, aux: bool = False):
        """tokens (B, S) -> logits (B, S, padded_vocab), float32, under
        autograd: no kernel, every layer under the ``remat`` policy; with
        ``aux``, (logits, the moe layers' mean aux loss).

        The hybrid's Mamba branch runs :func:`~repro_torch.models.ssm.
        mamba_apply_chunked`, JAX's chunked associative scan, where
        :meth:`forward` runs the scan kernel (B4), which has no backward.
        """
        x = embed_tokens(self.tokens, tokens, self.dtype, self.cfg.name)
        total = torch.zeros((), dtype=F32, device=x.device)
        for i in range(len(self.layers)):
            x, a = _remat(functools.partial(self._train_layer, i),
                          self.remat)(x)
            if a is not None:
                total = total + a
        logits = self.logits(x)
        return (logits, self._mean_aux(total)) if aux else logits

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CE + aux losses (``Model.loss``).  ``batch["labels"]``, when
        present, is already position-aligned (``labels[i]`` is the target
        of position ``i``: the pipeline emits next-token labels); only
        the ``tokens`` fallback needs the one-position shift.  ``aux`` is
        the moe layers' mean load-balance loss; the dense and hybrid
        families have none, and theirs is a float32 zero."""
        logits, aux = self.forward_train(batch["tokens"], aux=True)
        labels = batch.get("labels")
        if labels is None:
            ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
        else:
            ce = cross_entropy(logits, labels)
        return ce + aux, {"ce": ce, "aux": aux}
