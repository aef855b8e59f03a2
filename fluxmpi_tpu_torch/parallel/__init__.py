"""Data-parallel training: train/eval steps and the training loop."""

from .loop import train_loop
from .train import TrainState, make_eval_step, make_train_step

__all__ = ["TrainState", "make_eval_step", "make_train_step", "train_loop"]
