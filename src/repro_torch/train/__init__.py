"""Training substrate of the port: step builder + fault-tolerant trainer.

Copies of ``repro/train``.
"""

from .step import TrainStepConfig, build_train_step
from .trainer import Trainer, TrainerConfig

__all__ = ["TrainStepConfig", "Trainer", "TrainerConfig",
           "build_train_step"]
