"""Input augmentation and normalisation
(``distributed_training_comparison_tpu/data/augment.py``).

``random_crop_flip`` is the JAX package's pad-4 random crop plus
horizontal flip over a whole NHWC batch, with its random draws passed in
(``draw_crop_flip`` makes them from an explicit generator, and
``draw_epoch_crop_flip`` a whole epoch's at once): pad, then one gather on
the device.  For the same draws the uint8 result is byte-equal to the JAX
package's one-hot-matmul form.  Nothing here copies from the host once the
normalisation constants of a device are built, so a CUDA graph can capture
both functions.
"""

from __future__ import annotations

import torch

from ..utils.seed import step_generator
from .cifar100 import CIFAR100_MEAN, CIFAR100_STD

# (device, mean, std) -> (mean·255, 1/(std·255)) as fp32 on that device
_NORM_CONSTANTS: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def draw_crop_flip(
    batch: int, generator: torch.Generator, padding: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example crop offsets ``(batch, 2)`` in ``[0, 2·padding]`` (row,
    column) and flip flags ``(batch,)``, drawn on the CPU from ``generator``."""
    offsets = torch.randint(0, 2 * padding + 1, (batch, 2), generator=generator)
    flips = torch.randint(0, 2, (batch,), generator=generator).bool()
    return offsets, flips


def draw_epoch_crop_flip(
    batch: int, steps: int, seed: int, epoch: int, padding: int = 4
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every step's :func:`draw_crop_flip` of one epoch, each from its own
    ``step_generator(seed, epoch, i)``, stacked: offsets ``(steps, batch,
    2)`` and flips ``(steps, batch)``, on the CPU, so that an epoch's draws
    reach the device in one copy."""
    draws = [draw_crop_flip(batch, step_generator(seed, epoch, i), padding) for i in range(steps)]
    return torch.stack([o for o, _ in draws]), torch.stack([f for _, f in draws])


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
    channel, in fp32, then cast to ``dtype``.  The constants are built on
    a device once and kept."""
    key = (images.device, tuple(mean), tuple(std))
    if key not in _NORM_CONSTANTS:
        mean_arr = torch.tensor(mean, dtype=torch.float32, device=images.device) * 255.0
        inv_std = 1.0 / (torch.tensor(std, dtype=torch.float32, device=images.device) * 255.0)
        _NORM_CONSTANTS[key] = (mean_arr, inv_std)
    mean_arr, inv_std = _NORM_CONSTANTS[key]
    return ((images.float() - mean_arr) * inv_std).to(dtype)
