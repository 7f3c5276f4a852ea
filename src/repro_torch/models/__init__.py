"""The models of the port (dense, hybrid, moe, vlm, audio and ssm):
layers, attention, Mamba, the experts, forward and decode, and the
sharding specs of their parameters and decode state."""

from .decode import (DecodeState, attach_cross_context, decode_step,
                     init_state, prefill, state_specs)
from .params import Axes, Spec, axes_for, count_params
from .transformer import Model

__all__ = ["Axes", "DecodeState", "Model", "Spec", "attach_cross_context",
           "axes_for", "count_params", "decode_step", "init_state",
           "prefill", "state_specs"]
