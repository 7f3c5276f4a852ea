"""whisper-large-v3: encoder-decoder audio backbone (conv frontend = stub).

[arXiv:2212.04356; unverified]  32L(enc)+32L(dec) d_model=1280 20H
(kv=20) d_ff=5120 vocab=51866.  ``input_specs`` supplies precomputed
frame embeddings (the conv frontend stub per the assignment).
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    n_encoder_layers=32,
    is_encoder_decoder=True,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    mlp_gated=False,
    # encoder frames: whisper's 1500 (30 s) padded to 1536 so the cross
    # cache's seq dim shards over the 16-way model axis; decode masks by
    # the true enc_len, so padding is never attended.
    vision_tokens=1536,

    source="arXiv:2212.04356",
    notes="RoPE replaces Whisper's learned/sinusoidal positions (TPU "
          "adaptation; noted in DESIGN). 20 heads % 16 != 0 -> attention "
          "replicated over model axis, MLP stays TP. Decode shapes "
          "beyond the deployed 448-token decoder exercise the backbone "
          "as a framework capability.",
)
