"""Input normalisation (``distributed_training_comparison_tpu/data/augment.py:92-103``)."""

from __future__ import annotations

import torch

from .cifar100 import CIFAR100_MEAN, CIFAR100_STD


def normalize_images(
    images: torch.Tensor,
    mean: tuple[float, ...] = CIFAR100_MEAN,
    std: tuple[float, ...] = CIFAR100_STD,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 NHWC → normalized NHWC: scale to [0, 1], standardize per
    channel, in fp32, then cast to ``dtype``."""
    mean_arr = torch.tensor(mean, dtype=torch.float32, device=images.device) * 255.0
    inv_std = 1.0 / (torch.tensor(std, dtype=torch.float32, device=images.device) * 255.0)
    return ((images.float() - mean_arr) * inv_std).to(dtype)
