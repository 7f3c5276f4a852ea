"""The models of the port (dense, hybrid, moe, vlm and audio): layers,
attention, Mamba, the experts, forward and decode."""

from .decode import (DecodeState, attach_cross_context, decode_step,
                     init_state, prefill)
from .transformer import Model

__all__ = ["DecodeState", "Model", "attach_cross_context", "decode_step",
           "init_state", "prefill"]
