"""llama-3.2-vision-11b: decoder with gated cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256; 1 cross-attn layer per 5 (8 total).
Vision frontend is a stub: ``input_specs`` supplies precomputed patch
embeddings (B, vision_tokens, d_model).
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    head_dim=128,
    cross_attn_group=5,
    vision_tokens=1600,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    notes="Nested scan: 8 groups of (4 self + 1 gated-cross). Cross-attn "
          "KV (image tokens) is a second, static KV class in the "
          "serving pool.",
)
