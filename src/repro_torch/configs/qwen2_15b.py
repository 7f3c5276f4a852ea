"""qwen2-1.5b: dense GQA with QKV bias.

[arXiv:2407.10671; hf]  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
    notes="12 heads % 16 != 0 -> attention replicated over model axis; "
          "MLP/vocab stay TP.",
)
