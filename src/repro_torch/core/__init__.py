"""Control law, traces and policy models of the port."""

from .control import ControllerParams, GiB, control_step, vectorized_step

__all__ = ["ControllerParams", "GiB", "control_step", "vectorized_step"]
