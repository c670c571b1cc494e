"""Training side of the port: the trainer, optimizers and checkpoints."""

from .trainer import (TrainState, TrainStepOutput, Trainer, make_eval_step,
                      make_train_step)

__all__ = ["TrainState", "TrainStepOutput", "Trainer", "make_eval_step",
           "make_train_step"]
