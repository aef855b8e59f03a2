"""Data-parallel training: train/eval steps and the training loop."""

from .loop import train_loop
from .train import TrainState, make_eval_step, make_train_step, make_window_program

__all__ = ["TrainState", "make_eval_step", "make_train_step", "make_window_program",
           "train_loop"]
