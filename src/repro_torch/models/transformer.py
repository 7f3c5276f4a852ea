"""The models: parameters, initialization and the parallel forward.

The port of ``repro/models/transformer.py`` (``Model``, ``forward``,
``_self_layer``, ``_hybrid_layer``, ``_run_vlm``, ``_run_encoder``,
``_run_audio_decoder``, ``_run_ssm_stack``) and of the init kinds of
``repro/models/params.py`` for every family: ``dense`` (llama3.2-1b;
gemma3-1b with its gelu MLP and scaled embedding; qwen2-1.5b with its
QKV biases; mistral-large-123b), ``hybrid`` (hymba-1.5b: attention and
Mamba in parallel in every layer, fused by the mean of their
RMS-normalized outputs), ``moe`` (qwen2-moe-a2.7b, dbrx-132b: the dense
layer with its MLP replaced by routed experts,
:mod:`~repro_torch.models.moe`), ``vlm`` (llama-3.2-vision-11b: groups
of ``cross_attn_group`` self layers, each group followed by a cross
layer whose attention over the image tokens enters the residual through
``tanh(gate)``) and ``audio`` (whisper-large-v3: a non-causal encoder
over frame embeddings, with RoPE over frame positions, and a decoder
whose layers attend to its output after their self-attention; layernorm
with a bias) and ``ssm`` (xlstm-125m: pairs of an mLSTM and an sLSTM
block, each ``x + block(norm(x))``, no attention and no MLP).  The
attention logit softcap, which no config of the registry sets, raises
``NotImplementedError``.

The self layers form one flat ``nn.ModuleList``, ``layers``, each with
its window from :func:`layer_windows`, where JAX nests the grouped
local:global schedule into stacks (``_windowed_stack_schema``).  The vlm
family's cross layers are ``cross_layers`` (cross layer g follows self
layer ``(g + 1) * cross_attn_group - 1``); the audio family's encoder
is ``enc_layers`` and ``enc_norm``, and its decoder layers
(``layers``) carry ``cross_norm`` and ``cross``.  The ssm family's
``layers`` are its ``n_layers / len(block_pattern)`` pairs, each an
:class:`SSMPair` of blocks named as JAX names them (``0_mlstm``,
``1_slstm``), each block its ``norm`` and its ``block``.  A layernorm's bias is
the parameter ``<norm>_bias`` beside the norm's scale ``<norm>``.
Parameters keep the JAX package's names and layouts, so
:func:`repro_torch.convert.model_params_from_numpy` copies them tensor
for tensor.  They are initialized from an explicit ``torch.Generator``
seeded by ``seed`` on the model's device; the numbers differ from
``jax.random``'s, the kinds and scales do not.

Two forwards, each taking the images (vlm) or frames (audio) beside
the tokens: :meth:`Model.forward`, the kernels' (flash attention, B2,
and the scan, B4), which serving calls; and
:meth:`Model.forward_train`, plain PyTorch under autograd for every
family (JAX's ``attention_dense``/``attention_chunked`` by its
``attn_impl`` rule, the hybrid's Mamba branch as JAX's chunked
associative scan, each layer under the ``remat`` policy; an ssm pair
is one such layer), which
:meth:`Model.loss` and the trainer call.  Both run the experts of a moe
layer through :func:`~repro_torch.models.moe.moe_apply` and, asked
with ``aux=True``, return the layers' mean load-balance loss beside
the logits, as JAX's ``Model.forward`` does.  The ssm family launches
no kernel in either forward: JAX has no Pallas kernel behind the mLSTM
or the sLSTM (:mod:`~repro_torch.models.ssm`).  The kernels have no backward
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
from .layers import (ACTIVATIONS, apply_mlp, apply_norm, cross_entropy,
                     embed_tokens, rms, unembed)
from .moe import MoE, moe_apply
from .ssm import (MLSTM, SLSTM, Mamba, mamba_apply, mamba_apply_chunked,
                  mlstm_apply, slstm_apply)

F32 = torch.float32
REMAT_POLICIES = ("full", "dots", "none")
FAMILIES = ("dense", "hybrid", "moe", "vlm", "audio", "ssm")
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
    at init (``attention_schema``), else None.  A cross-attention module
    (``cross``) has no biases whatever the config says."""

    def __init__(self, cfg: ArchConfig, make, cross: bool = False):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = make((d, h, hd), "fan_in")
        self.wk = make((d, kv, hd), "fan_in")
        self.wv = make((d, kv, hd), "fan_in")
        self.wo = make((h, hd, d), "fan_in")
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias and not cross:
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


def add_norm(module: nn.Module, name: str, cfg: ArchConfig, make) -> None:
    """The norm ``name`` of ``module`` (``norm_schema``): its scale, ones
    at init, and for layernorm its bias ``<name>_bias``, zeros at init
    (None for RMSNorm)."""
    setattr(module, name, make((cfg.d_model,), "ones"))
    setattr(module, name + "_bias", make((cfg.d_model,), "zeros")
            if cfg.norm == "layernorm" else None)


def norm_of(module: nn.Module, name: str, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """``module``'s norm ``name`` applied to ``x`` (``apply_norm``)."""
    return apply_norm(x, getattr(module, name),
                      getattr(module, name + "_bias"), cfg.norm)


class _Block(nn.Module):
    """What every layer ends with: the pre-norm MLP, or the experts."""

    def mlp_block(self, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x + MLP(norm(x)), the layer's aux loss): a moe layer's from
        :func:`moe_apply` under ``cfg`` (the model's), else None."""
        h = norm_of(self, "mlp_norm", x, cfg)
        if self.moe is not None:
            out, aux = moe_apply(self.moe, h, cfg)
            return x + out, aux
        m = self.mlp
        return x + apply_mlp(h, m.wi, m.wg, m.wo, m.act), None


class Layer(_Block):
    """One pre-norm layer (``_self_layer``): ``attn_norm``, ``attn``,
    ``mlp_norm``, and ``mlp`` or, with experts, ``moe``; an audio
    decoder layer (``_decoder_cross_layer_schema``, ``cross=True``) also
    ``cross_norm`` and ``cross``, its attention over the encoder."""

    def __init__(self, cfg: ArchConfig, make, cross: bool = False):
        super().__init__()
        add_norm(self, "attn_norm", cfg, make)
        self.attn = Attention(cfg, make)
        add_norm(self, "mlp_norm", cfg, make)
        self.mlp = None if cfg.is_moe else MLP(cfg, make)
        self.moe = MoE(cfg, make) if cfg.is_moe else None
        self.cross = None
        if cross:
            add_norm(self, "cross_norm", cfg, make)
            self.cross = Attention(cfg, make, cross=True)


class CrossLayer(_Block):
    """The vlm family's gated cross-attention layer
    (``_cross_layer_schema``): ``attn_norm``, ``attn`` (over the image
    tokens, no biases), ``mlp_norm``, ``mlp`` and ``gate`` (1,), zeros at
    init, so that at init the attention adds nothing: ``x + tanh(gate)
    * attn``.  The MLP is not gated."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        add_norm(self, "attn_norm", cfg, make)
        self.attn = Attention(cfg, make, cross=True)
        add_norm(self, "mlp_norm", cfg, make)
        self.mlp = MLP(cfg, make)
        self.gate = make((1,), "zeros")
        self.moe = None

    def gated(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """x + tanh(gate) * h, the tanh in float32 (``_run_vlm``)."""
        return x + torch.tanh(self.gate.to(F32)).to(x.dtype) * h


class HybridLayer(_Block):
    """Attention and Mamba in parallel (``_hybrid_layer_schema``): ``norm``,
    ``attn``, ``mamba``, ``mlp_norm``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__()
        add_norm(self, "norm", cfg, make)
        self.attn = Attention(cfg, make)
        self.mamba = Mamba(cfg, make)
        add_norm(self, "mlp_norm", cfg, make)
        self.mlp = MLP(cfg, make)
        self.moe = None
        self.cross = None


class SSMBlock(nn.Module):
    """One block of an ssm pair: its pre-norm ``norm`` and its ``block``,
    an :class:`~repro_torch.models.ssm.MLSTM` or an
    :class:`~repro_torch.models.ssm.SLSTM` by ``kind``."""

    def __init__(self, cfg: ArchConfig, make, kind: str):
        super().__init__()
        if kind not in ("mlstm", "slstm"):
            raise ValueError(f"unknown ssm block {kind!r}")
        self.kind = kind
        add_norm(self, "norm", cfg, make)
        self.block = MLSTM(cfg, make) if kind == "mlstm" else SLSTM(cfg, make)

    def forward(self, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
        """x + block(norm(x)) over a whole sequence (``_run_ssm_stack``)."""
        apply = mlstm_apply if self.kind == "mlstm" else slstm_apply
        return x + apply(self.block, norm_of(self, "norm", x, cfg), cfg)


class SSMPair(nn.ModuleDict):
    """One pair of the ssm stack: a block per entry of ``block_pattern``,
    keyed ``f"{i}_{kind}"`` as JAX keys them, applied in that order."""

    def __init__(self, cfg: ArchConfig, make):
        super().__init__({f"{i}_{kind}": SSMBlock(cfg, make, kind)
                          for i, kind in enumerate(cfg.block_pattern)})


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
        "family": cfg.family not in FAMILIES,
        "attn_logit_softcap": bool(cfg.attn_logit_softcap),
        "activation": cfg.act not in ACTIVATIONS,
    }
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port builds the {', '.join(FAMILIES)} "
            f"families (every family of the JAX package) with silu or "
            f"gelu MLPs; not ported: {missing} (the attention logit "
            f"softcap, which no config of the registry sets: ROADMAP A5.2)")


class Model(nn.Module):
    """A dense, hybrid, moe, vlm, audio or ssm model on one device.

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
        gen = None                 # none on "meta", where nothing is drawn
        if init:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)

        def make(shape, kind, **kw):
            t = (init_tensor(shape, kind, gen, dtype, dev, **kw) if init
                 else torch.empty(shape, dtype=dtype, device=dev))
            return nn.Parameter(t, requires_grad=False)

        fam = cfg.family
        self.tokens = make((cfg.padded_vocab, cfg.d_model), "small")
        self.enc_layers = None
        if fam == "audio":
            self.enc_layers = nn.ModuleList(
                Layer(cfg, make) for _ in range(cfg.n_encoder_layers))
            add_norm(self, "enc_norm", cfg, make)
        n_self = cfg.n_layers
        if fam == "vlm":       # JAX stacks L // g groups of g self layers
            n_self = cfg.n_layers // cfg.cross_attn_group \
                * cfg.cross_attn_group
        if fam == "ssm":       # and L // len(block_pattern) pairs
            n_self = cfg.n_layers // len(cfg.block_pattern)
        layer = {"hybrid": HybridLayer, "ssm": SSMPair}.get(
            fam, functools.partial(Layer, cross=fam == "audio"))
        self.layers = nn.ModuleList(layer(cfg, make) for _ in range(n_self))
        self.windows = layer_windows(cfg)[:n_self]
        self.cross_layers = None
        if fam == "vlm":
            self.cross_layers = nn.ModuleList(
                CrossLayer(cfg, make)
                for _ in range(n_self // cfg.cross_attn_group))
        add_norm(self, "final_norm", cfg, make)
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
        return unembed(self.tokens, norm_of(self, "final_norm", x, self.cfg),
                       self.unembed)

    def _mean_aux(self, aux: torch.Tensor) -> torch.Tensor:
        """The layers' summed aux over their count for the moe family
        (``_run_windowed``); every other family's sum stays zero."""
        return aux / max(self.cfg.n_layers, 1) if self.cfg.is_moe else aux

    # ------------------------------------------------------------------ #
    # layer bodies, shared by the kernel forward and the training forward
    # ------------------------------------------------------------------ #
    def _attend(self, p, h: torch.Tensor, window: int, train: bool,
                **kw) -> torch.Tensor:
        """``Model._attend``: the flash kernel, or under ``train`` JAX's
        dense or chunked attention by ``attn_impl``."""
        if train:
            return self_attention_train(p, h, self.cfg, window,
                                        impl=self.attn_impl,
                                        chunk=self.attn_chunk, **kw)
        return self_attention(p, h, self.cfg, window, **kw)

    def _self_layer(self, i: int, x: torch.Tensor,
                    ctx: Optional[torch.Tensor], *, train: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Layer ``i`` (``_self_layer``, ``_hybrid_layer``, an audio
        decoder layer, which attends to the encoder output ``ctx`` after
        its self-attention, or an ssm pair); returns (x, the layer's aux
        loss or None).  A hybrid layer's Mamba branch runs the scan
        kernel (B4), or under ``train`` JAX's chunked associative scan;
        an ssm pair runs the same plain PyTorch either way."""
        cfg, layer = self.cfg, self.layers[i]
        window = self.windows[i]
        if cfg.family == "ssm":
            for block in layer.values():
                x = block(x, cfg)
            return x, None
        if cfg.family == "hybrid":
            h = norm_of(layer, "norm", x, cfg)
            a = self._attend(layer.attn, h, window, train)
            mamba = mamba_apply_chunked if train else mamba_apply
            m = mamba(layer.mamba, h, cfg)
            x = x + fuse_branches(a, m).to(x.dtype)
            return layer.mlp_block(x, cfg)
        h = norm_of(layer, "attn_norm", x, cfg)
        x = x + self._attend(layer.attn, h, window, train)
        if layer.cross is not None:
            h = norm_of(layer, "cross_norm", x, cfg)
            x = x + self._attend(layer.cross, h, 0, train, causal=False,
                                 xkv=ctx, rope=False)
        return layer.mlp_block(x, cfg)

    def _cross_layer(self, g: int, x: torch.Tensor, img: torch.Tensor, *,
                     train: bool) -> torch.Tensor:
        """The vlm family's cross layer ``g`` over the image tokens
        (``_run_vlm``): non-causal, no RoPE, gated by ``tanh(gate)``."""
        cfg, layer = self.cfg, self.cross_layers[g]
        h = norm_of(layer, "attn_norm", x, cfg)
        h = self._attend(layer.attn, h, 0, train, causal=False, xkv=img,
                         rope=False)
        x, _ = layer.mlp_block(layer.gated(x, h), cfg)
        return x

    def _enc_layer(self, i: int, x: torch.Tensor, *,
                   train: bool) -> torch.Tensor:
        """Encoder layer ``i`` (``_run_encoder``): non-causal
        self-attention with RoPE over the frame positions, and the MLP."""
        cfg, layer = self.cfg, self.enc_layers[i]
        h = norm_of(layer, "attn_norm", x, cfg)
        x = x + self._attend(layer.attn, h, 0, train, causal=False)
        x, _ = layer.mlp_block(x, cfg)
        return x

    def _step(self, fn, train: bool):
        """``fn`` as a layer of the forward: under ``train`` with the
        ``remat`` policy."""
        return _remat(fn, self.remat) if train else fn

    def _encode(self, frames: torch.Tensor, train: bool) -> torch.Tensor:
        x = frames.to(self.dtype)
        for i in range(len(self.enc_layers)):
            x = self._step(functools.partial(self._enc_layer, i,
                                             train=train), train)(x)
        return norm_of(self, "enc_norm", x, self.cfg)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The audio family's encoder on the kernel path: frames (B, T, d)
        -> (B, T, d) in the model's type, ``enc_norm`` applied."""
        return self._encode(frames, train=False)

    def _context(self, images: Optional[torch.Tensor],
                 frames: Optional[torch.Tensor],
                 train: bool) -> Optional[torch.Tensor]:
        """What the cross-attention attends to: the images in the model's
        type (vlm), the encoder's output over the frames (audio), or
        None."""
        fam = self.cfg.family
        want = {"vlm": ["images"], "audio": ["frames"]}.get(fam, [])
        given = [k for k, v in (("images", images), ("frames", frames))
                 if v is not None]
        if given != want:
            raise ValueError(f"the {fam} family takes the tokens and "
                             f"{want or 'nothing else'}; got {given}")
        if fam == "vlm":
            return images.to(self.dtype)
        if fam == "audio":
            return self._encode(frames, train)
        return None

    def _run(self, tokens: torch.Tensor, images, frames, aux: bool,
             train: bool):
        cfg = self.cfg
        x = embed_tokens(self.tokens, tokens, self.dtype, cfg.name)
        ctx = self._context(images, frames, train)
        total = torch.zeros((), dtype=F32, device=x.device)
        g = cfg.cross_attn_group
        for i in range(len(self.layers)):
            x, a = self._step(functools.partial(self._self_layer, i,
                                                train=train), train)(x, ctx)
            if a is not None:
                total = total + a
            if cfg.family == "vlm" and (i + 1) % g == 0:
                x = self._step(functools.partial(
                    self._cross_layer, i // g, train=train), train)(x, ctx)
        logits = self.logits(x)
        return (logits, self._mean_aux(total)) if aux else logits

    def forward(self, tokens: torch.Tensor, *,
                images: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None, aux: bool = False):
        """tokens (B, S) -> logits (B, S, padded_vocab), float32; with
        ``aux``, (logits, the moe layers' mean aux loss).

        The vlm family takes ``images`` (B, vision tokens, d), the audio
        family ``frames`` (B, T, d); the others take neither.  Every
        attention runs the flash kernel (B2): self-attention over
        positions ``arange(S)`` with the layer's window, the encoder's
        non-causal, cross-attention non-causal without RoPE; a hybrid
        layer's Mamba branch runs the scan kernel (B4) over the whole
        sequence.
        """
        return self._run(tokens, images, frames, aux, train=False)

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    def forward_train(self, tokens: torch.Tensor, *,
                      images: Optional[torch.Tensor] = None,
                      frames: Optional[torch.Tensor] = None,
                      aux: bool = False):
        """:meth:`forward` under autograd: no kernel, every layer (the
        encoder's and the cross layers too) under the ``remat`` policy.

        Attention is JAX's dense or chunked path by ``attn_impl``; the
        hybrid's Mamba branch runs :func:`~repro_torch.models.ssm.
        mamba_apply_chunked`, JAX's chunked associative scan, where
        :meth:`forward` runs the scan kernel (B4), which has no backward.
        """
        return self._run(tokens, images, frames, aux, train=True)

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CE + aux losses (``Model.loss``).  ``batch["labels"]``, when
        present, is already position-aligned (``labels[i]`` is the target
        of position ``i``: the pipeline emits next-token labels); only
        the ``tokens`` fallback needs the one-position shift.  ``aux`` is
        the moe layers' mean load-balance loss; the other families have
        none, and theirs is a float32 zero.  The vlm family reads
        ``batch["images"]``, the audio family ``batch["frames"]``."""
        logits, aux = self.forward_train(
            batch["tokens"], images=batch.get("images"),
            frames=batch.get("frames"), aux=True)
        labels = batch.get("labels")
        if labels is None:
            ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
        else:
            ce = cross_entropy(logits, labels)
        return ce + aux, {"ce": ce, "aux": aux}
