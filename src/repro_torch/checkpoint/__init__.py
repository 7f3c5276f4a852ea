"""Checkpoint substrate of the port: atomic, manifest-driven.

A copy of ``repro/checkpoint``.
"""

from .checkpoint import (CheckpointManager, latest_step, restore_pytree,
                         save_pytree)

__all__ = ["CheckpointManager", "latest_step", "restore_pytree",
           "save_pytree"]
