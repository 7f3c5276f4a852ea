"""mistral-large-123b: the largest dense assignment.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]  88L d_model=12288
96H (GQA kv=8) d_ff=28672 vocab=32768.
"""

from .base import ArchConfig

ARCH = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32_768,
    head_dim=128,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    notes="FSDP(data) x TP(model) essential: 123B params = ~246 GB bf16 "
          "-> ~1 GB/chip on 256 chips. KV heads (8) replicated over "
          "model axis (Megatron pattern).",
)
