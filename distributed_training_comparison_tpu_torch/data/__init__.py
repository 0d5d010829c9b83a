"""Data: synthetic and CIFAR-100 splits, the device-resident epoch
iterator, augmentation and normalisation."""

from .augment import draw_crop_flip, draw_epoch_crop_flip, normalize_images, random_crop_flip
from .cifar100 import CIFAR100_MEAN, CIFAR100_STD, load_cifar100
from .loader import DeviceSplit, get_datasets
from .sampler import epoch_permutation, train_val_split
from .synthetic import synthetic_dataset

__all__ = [
    "CIFAR100_MEAN", "CIFAR100_STD", "DeviceSplit", "draw_crop_flip", "draw_epoch_crop_flip",
    "epoch_permutation", "get_datasets", "load_cifar100", "normalize_images",
    "random_crop_flip", "synthetic_dataset", "train_val_split",
]
