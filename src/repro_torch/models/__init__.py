"""The decoders of the port (dense and hybrid): layers, attention, Mamba,
forward and decode."""

from .decode import DecodeState, decode_step, init_state, prefill
from .transformer import Model

__all__ = ["DecodeState", "Model", "decode_step", "init_state", "prefill"]
