"""gemma3-1b: 5:1 local:global sliding-window schedule, 262k vocab.

[hf:google/gemma-3-1b-pt; unverified]  26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144, window 512, 1 global layer per 6.
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262_144,
    head_dim=256,
    sliding_window=512,
    global_every=6,
    rope_theta=1_000_000.0,
    act="gelu",
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
    notes="Window schedule is structural: scan over groups of 5 local + "
          "1 global (+2-layer local tail for 26 = 4*6+2). Runs "
          "long_500k (sliding-window dominant). 4 heads -> attention "
          "replicated over model axis.",
)
