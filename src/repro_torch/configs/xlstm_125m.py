"""xlstm-125m: alternating sLSTM + mLSTM blocks (attention-free).

[arXiv:2405.04517; unverified]  12L d_model=768 4H d_ff=0 vocab=50304.
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=192,
    block_pattern=("mlstm", "slstm"),
    ssm_expand=2,
    tie_embeddings=True,
    source="arXiv:2405.04517",
    notes="mLSTM runs in the chunkwise-parallel linear-attention form "
          "(MXU-friendly); sLSTM is sequential by design (lax.scan over "
          "time). Attention-free -> runs long_500k with O(1) state; the "
          "serving KV pool is inapplicable (DESIGN §5) -- DynIMS manages "
          "the (tiny) recurrent-state pool instead.",
)
