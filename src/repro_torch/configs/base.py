"""Architecture and run-shape configuration schema.

A copy of ``repro/configs/base.py`` without the mesh sharding report:
the port runs on one card.  Configs are frozen dataclasses, equal field
for field to the JAX package's (``tests/test_torch_port_rules.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class InputShape:
    """One benchmark cell's input geometry."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: Dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclass(frozen=True)
class ArchConfig:
    """One architecture, exactly as published (see configs/<id>.py)."""

    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                 # 0 -> d_model // n_heads
    # ---- attention ------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 = full attention
    global_every: int = 0             # gemma3: 1 global per N layers (N=6)
    attn_logit_softcap: float = 0.0
    # ---- MoE --------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0              # per-expert hidden (0 -> d_ff)
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # ---- encoder-decoder ---------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # ---- vlm ----------------------------------------------------------------
    cross_attn_group: int = 0         # 1 cross layer per N self layers
    vision_tokens: int = 0
    # ---- ssm / hybrid ---------------------------------------------------------
    block_pattern: Tuple[str, ...] = ()   # e.g. ("mlstm","slstm")
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # ---- misc ------------------------------------------------------------
    norm: str = "rmsnorm"             # rmsnorm|layernorm
    act: str = "silu"                 # silu|gelu
    mlp_gated: bool = True            # SwiGLU-style (False: plain 2-layer)
    tie_embeddings: bool = False
    vocab_pad_to: int = 256
    source: str = ""
    notes: str = ""

    # ---- derived -----------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and not self.d_ff_expert:
            object.__setattr__(self, "d_ff_expert", self.d_ff)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / sliding-window dominant)."""
        return self.family in ("ssm", "hybrid") or (
            self.sliding_window > 0 and self.global_every > 0)

    def supports_shape(self, shape: InputShape) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    # ---- parameter counts ----------------------------------------------------
    def n_params(self) -> int:
        return _count_params(self, active_only=False)

    def n_active_params(self) -> int:
        return _count_params(self, active_only=True)

    # ---- smoke-test reduction ---------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        n_layers = min(self.n_layers, 4)
        if self.cross_attn_group:
            n_layers = 2 * self.cross_attn_group  # 2 groups
        if self.block_pattern:
            n_layers = max(len(self.block_pattern), 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=64 // heads,
            d_ff=128,
            d_ff_expert=128 if self.n_experts else 0,
            vocab_size=503,
            vocab_pad_to=64,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            # no capacity drops at smoke scale so decode == forward exactly
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else 0),
            # keep the local:global group structure exercised at 4 layers
            global_every=2 if self.global_every else 0,
            vision_tokens=(min(self.vision_tokens, 8)
                           if self.vision_tokens else 0),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
        )


def _count_params(c: ArchConfig, active_only: bool) -> int:
    d, hd = c.d_model, c.head_dim
    kv = c.n_kv_heads
    attn = d * c.n_heads * hd + 2 * d * kv * hd + c.n_heads * hd * d
    if c.qkv_bias:
        attn += (c.n_heads + 2 * kv) * hd
    if c.mlp_gated:
        dense_mlp = 3 * d * c.d_ff
    else:
        dense_mlp = 2 * d * c.d_ff
    per_layer = attn + 2 * d                     # + norms
    total = 0
    n_self = c.n_layers
    if c.family == "ssm":
        # mLSTM/sLSTM blocks: qkv-ish projections + gates + ff block
        inner = c.ssm_expand * d
        ff = c.d_ff if c.d_ff else 4 * d
        mlstm = 3 * d * inner + 3 * inner + inner * d + 2 * d * ff
        total = c.n_layers * (mlstm + 2 * d)
        emb = c.padded_vocab * d * (1 if c.tie_embeddings else 2)
        return total + emb + d
    if c.is_moe:
        e_ff = c.d_ff_expert
        router = d * c.n_experts
        n_e = c.experts_per_token if active_only else c.n_experts
        moe_mlp = router + n_e * 3 * d * e_ff \
            + c.n_shared_experts * 3 * d * e_ff
        total += n_self * (per_layer + moe_mlp)
    elif c.family == "hybrid":
        inner = c.ssm_expand * d
        ssm = 2 * d * inner + inner * (c.ssm_state * 2 + 1) + inner * d
        total += n_self * (per_layer + ssm + dense_mlp)
    else:
        total += n_self * (per_layer + dense_mlp)
    if c.cross_attn_group:
        n_cross = c.n_layers // c.cross_attn_group
        cross = d * c.n_heads * hd + 2 * d * kv * hd + c.n_heads * hd * d
        total += n_cross * (cross + dense_mlp + 2 * d)
    if c.is_encoder_decoder:
        enc = c.n_encoder_layers * (per_layer + dense_mlp)
        cross = c.n_layers * (attn + d)       # decoder cross-attention
        total += enc + cross
    emb = c.padded_vocab * d * (1 if c.tie_embeddings else 2)
    return total + emb + d
