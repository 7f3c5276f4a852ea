"""qwen2-moe-a2.7b: 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert) vocab=151936.
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    n_experts=60,
    experts_per_token=4,
    n_shared_experts=4,
    d_ff_expert=1408,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    notes="60 routed experts padded to 64 for EP=16 (DESIGN §4); "
          "4 shared experts run densely with a sigmoid gate.",
)
