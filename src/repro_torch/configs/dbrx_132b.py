"""dbrx-132b: 16-expert top-4 fine-grained MoE.

[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (GQA kv=8)
d_ff=10752 (per expert) vocab=100352, MoE 16e top-4.
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    n_experts=16,
    experts_per_token=4,
    d_ff_expert=10752,
    rope_theta=500_000.0,
    act="silu",
    source="hf:databricks/dbrx-base",
    notes="16 experts top-4; expert dim == model-axis size -> EP=16, "
          "one expert per model shard, canonical all-to-all.",
)
