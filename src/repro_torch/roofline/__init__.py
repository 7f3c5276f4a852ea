"""Roofline analysis of the port on the H100: data-sheet peaks, a
step's counted FLOPs and bytes, and each kernel's work from its shapes
(the counterpart of ``repro.roofline``; JAX's ``parse_collectives``
comes with multi-GPU, ROADMAP A4)."""

from .analysis import analyze_step, model_flops, roofline_terms
from .constants import HBM_BW, ICI_BW, PEAK_FLOPS
from .cost import step_cost
from .kernels import Work, bound

__all__ = ["HBM_BW", "ICI_BW", "PEAK_FLOPS", "Work", "analyze_step",
           "bound", "model_flops", "roofline_terms", "step_cost"]
