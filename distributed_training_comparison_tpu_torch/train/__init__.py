"""Training: the optimizer and schedule, the guarded step, the step
program's runners, the train state and its checkpoints, the trainer."""

from .async_ckpt import AsyncCheckpointer
from .optim import DeviceSGD, configure_optimizers, lr_table, step_lr_schedule
from .state import StateSnapshot, TrainState
from .step import (
    EpochRunner,
    EvalRunner,
    TrainStep,
    eval_totals,
    forward_backward,
    guard_and_update,
    guarded_step,
    statistics_buffers,
)
from .trainer import Trainer, build_model

__all__ = [
    "AsyncCheckpointer", "DeviceSGD", "EpochRunner", "EvalRunner", "StateSnapshot",
    "TrainState", "TrainStep", "Trainer", "build_model", "configure_optimizers",
    "eval_totals", "forward_backward", "guard_and_update", "guarded_step", "lr_table",
    "statistics_buffers", "step_lr_schedule",
]
