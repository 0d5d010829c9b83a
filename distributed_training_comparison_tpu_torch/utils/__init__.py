"""Seeding, classification metrics, host-side meters, the TensorBoard
scalar writer and the experiment logger."""

from .logging import TRAIN_LOGGER, setup_logger
from .meters import AverageMeter
from .metrics import topk_hits
from .seed import fix_seed, step_generator
from .tensorboard import SummaryWriter

__all__ = [
    "AverageMeter", "SummaryWriter", "TRAIN_LOGGER", "fix_seed", "setup_logger",
    "step_generator", "topk_hits",
]
