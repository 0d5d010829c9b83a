"""Data helpers of the serving slice."""

from .augment import normalize_images
from .cifar100 import CIFAR100_MEAN, CIFAR100_STD

__all__ = ["CIFAR100_MEAN", "CIFAR100_STD", "normalize_images"]
