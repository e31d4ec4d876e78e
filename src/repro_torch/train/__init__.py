"""Training: the train step and the fault-tolerant loop."""

from .loop import run_training
from .step import TrainState, build_train_step, init_train_state

__all__ = ["TrainState", "build_train_step", "init_train_state",
           "run_training"]
