"""Seeding, classification metrics and host-side meters."""

from .meters import AverageMeter
from .metrics import topk_hits
from .seed import fix_seed, step_generator

__all__ = ["AverageMeter", "fix_seed", "step_generator", "topk_hits"]
