"""hymba-1.5b: parallel attention + Mamba heads in every layer.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16.
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    sliding_window=1024,
    global_every=16,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    rope_theta=10_000.0,
    source="arXiv:2411.13676",
    notes="Attention and Mamba run in parallel per layer, fused by mean "
          "of RMS-normalized branch outputs (paper's mean fusion). "
          "Published pattern has 3 global-attn layers (first/middle/"
          "last); structural approximation here: 1 global per 16 "
          "(layers 15, 31). 25 heads % 16 != 0 -> attention replicated "
          "over model; Mamba shards d_inner=3200 over model. Runs "
          "long_500k (hybrid).",
)
