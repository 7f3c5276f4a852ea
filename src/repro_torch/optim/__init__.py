"""Optimizer substrate of the port: AdamW, schedules, compression.

Copies of ``repro/optim``, with ``opt_state_specs`` (the moments shard
as their parameters do) for the dry-run's train cells.
"""

from .adamw import AdamWState, adamw_init, adamw_update, opt_state_specs
from .compress import (CompressionState, compress_decompress,
                       compression_init, int8_dequantize, int8_quantize)
from .schedules import constant, linear_warmup_cosine

__all__ = ["AdamWState", "CompressionState", "adamw_init", "adamw_update",
           "compress_decompress", "compression_init", "constant",
           "int8_dequantize", "int8_quantize", "linear_warmup_cosine",
           "opt_state_specs"]
