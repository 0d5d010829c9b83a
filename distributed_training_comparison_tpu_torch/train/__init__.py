"""Training: the optimizer and schedule, the guarded step, the trainer."""

from .optim import configure_optimizers, step_lr_schedule
from .step import TrainStep, eval_totals, forward_backward
from .trainer import Trainer, build_model

__all__ = [
    "TrainStep", "Trainer", "build_model", "configure_optimizers",
    "eval_totals", "forward_backward", "step_lr_schedule",
]
