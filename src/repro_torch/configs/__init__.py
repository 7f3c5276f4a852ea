"""Configs of the port: controller presets and model architectures.

``dynims`` holds paper Table I and the ScenarioLab presets.
:func:`get_shape` resolves a run shape of :data:`SHAPES`, and
:func:`get_config` ``--arch <id>`` for the architectures the
port serves and trains so far, each with its ``-smoke`` reduction:
``llama3.2-1b``, ``gemma3-1b`` (gelu MLP, a 5:1 local:global window
schedule, head dim 256) and ``qwen2-1.5b`` (QKV bias), all dense;
``hymba-1.5b`` (hybrid: attention and Mamba in parallel); and
``qwen2-moe-a2.7b`` (60 routed experts padded to 64, top 4, 4 shared
experts) and ``dbrx-132b`` (16 experts, top 4), the moe family;
``mistral-large-123b`` (dense); and the two cross-attention families:
``llama-3.2-vision-11b`` (vlm: groups of 5 self layers and one gated
cross layer over image tokens) and ``whisper-large-v3`` (audio: a
layernorm encoder over frames and a decoder that attends to it); and
``xlstm-125m`` (ssm: six pairs of an mLSTM and an sLSTM block, no
attention).  These are all of the JAX package's registry.  dbrx-132b
and mistral-large-123b do not fit one 80 GB card at full width; their
``-smoke`` reductions serve and train.
"""

from __future__ import annotations

from .base import (ArchConfig, DECODE_32K, InputShape, LONG_500K,
                   PREFILL_32K, SHAPES, TRAIN_4K)
from .dbrx_132b import ARCH as _DBRX_132B
from .gemma3_1b import ARCH as _GEMMA3_1B
from .hymba_15b import ARCH as _HYMBA_15B
from .llama32_1b import ARCH as _LLAMA32_1B
from .llama32_vision_11b import ARCH as _LLAMA32_VISION_11B
from .mistral_large_123b import ARCH as _MISTRAL_LARGE_123B
from .qwen2_15b import ARCH as _QWEN2_15B
from .qwen2_moe_a27b import ARCH as _QWEN2_MOE_A27B
from .whisper_large_v3 import ARCH as _WHISPER_LARGE_V3
from .xlstm_125m import ARCH as _XLSTM_125M

_ARCHS = {a.name: a for a in (_LLAMA32_1B, _HYMBA_15B, _GEMMA3_1B,
                              _QWEN2_15B, _QWEN2_MOE_A27B, _DBRX_132B,
                              _MISTRAL_LARGE_123B, _LLAMA32_VISION_11B,
                              _WHISPER_LARGE_V3, _XLSTM_125M)}

ARCH_IDS = list(_ARCHS)


def get_config(name: str) -> ArchConfig:
    """The config of ``name``; a ``-smoke`` suffix gives its reduction."""
    smoke = name.endswith("-smoke")
    base = name[: -len("-smoke")] if smoke else name
    if base not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    cfg = _ARCHS[base]
    return cfg.reduced() if smoke else cfg


def get_shape(name: str) -> InputShape:
    """The run shape ``name`` (a key of :data:`SHAPES`)."""
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {list(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCH_IDS", "ArchConfig", "DECODE_32K", "InputShape",
           "LONG_500K", "PREFILL_32K", "SHAPES", "TRAIN_4K", "get_config",
           "get_shape"]
