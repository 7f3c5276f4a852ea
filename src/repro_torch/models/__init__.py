"""The decoders of the port (dense, hybrid and moe): layers, attention,
Mamba, the experts, forward and decode."""

from .decode import DecodeState, decode_step, init_state, prefill
from .transformer import Model

__all__ = ["DecodeState", "Model", "decode_step", "init_state", "prefill"]
