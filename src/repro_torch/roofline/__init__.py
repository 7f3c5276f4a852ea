"""Roofline analysis of the port on the H100: data-sheet peaks, a
step's counted FLOPs and bytes, each kernel's work from its shapes, and
the collective bytes sharded paths report (the counterpart of
``repro.roofline``)."""

from .analysis import analyze_step, model_flops, roofline_terms
from .collectives import parse_collectives
from .constants import HBM_BW, ICI_BW, PEAK_FLOPS
from .cost import step_cost
from .kernels import Work, bound

__all__ = ["HBM_BW", "ICI_BW", "PEAK_FLOPS", "Work", "analyze_step",
           "bound", "model_flops", "parse_collectives", "roofline_terms",
           "step_cost"]
