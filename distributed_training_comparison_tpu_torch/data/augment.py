"""Input augmentation and normalisation
(``distributed_training_comparison_tpu/data/augment.py``).

``random_crop_flip`` is the JAX package's pad-4 random crop plus
horizontal flip over a whole NHWC batch, with its random draws passed in
(``draw_crop_flip`` makes them from an explicit generator): pad, then one
gather on the device.  For the same draws the uint8 result is byte-equal
to the JAX package's one-hot-matmul form.
"""

from __future__ import annotations

import torch

from .cifar100 import CIFAR100_MEAN, CIFAR100_STD


def draw_crop_flip(
    batch: int, generator: torch.Generator, padding: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example crop offsets ``(batch, 2)`` in ``[0, 2·padding]`` (row,
    column) and flip flags ``(batch,)``, drawn on the CPU from ``generator``."""
    offsets = torch.randint(0, 2 * padding + 1, (batch, 2), generator=generator)
    flips = torch.randint(0, 2, (batch,), generator=generator).bool()
    return offsets, flips


def random_crop_flip(
    images: torch.Tensor,
    offsets: torch.Tensor,
    flips: torch.Tensor,
    padding: int = 4,
) -> torch.Tensor:
    """Crop each NHWC image at ``offsets`` out of its zero-padded copy and
    flip it horizontally where ``flips`` is set; dtype and shape are kept."""
    b, h, w, c = images.shape
    dev = images.device
    offsets, flips = offsets.to(dev), flips.to(dev)
    padded = images.new_zeros((b, h + 2 * padding, w + 2 * padding, c))
    padded[:, padding : padding + h, padding : padding + w] = images
    rows = offsets[:, 0, None] + torch.arange(h, device=dev)  # (b, h) source rows
    j = torch.arange(w, device=dev)
    cols = torch.where(  # (b, w) source columns, flip folded in
        flips[:, None], offsets[:, 1, None] + (w - 1 - j), offsets[:, 1, None] + j
    )
    batch = torch.arange(b, device=dev)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


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
