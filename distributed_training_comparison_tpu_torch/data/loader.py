"""Datasets and the device-resident epoch iterator
(``distributed_training_comparison_tpu/data/loader.py``).

``get_datasets`` builds (train, valid, test) with the reference's 90/10
split; the test split of ``--synthetic-data`` is seeded ``seed + 1`` with
the train split's class anchors.  ``DeviceSplit`` holds a split on the
device: training batches follow the host loader's numpy ``(seed, epoch)``
order with ``drop_last``, so the batch order is byte-identical to the JAX
package's host data mode; eval batches cover every example once, the last
batch padded with zero weights.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .cifar100 import load_cifar100
from .sampler import epoch_permutation, train_val_split
from .synthetic import synthetic_dataset


def _raw_split(hparams, split: str) -> tuple[np.ndarray, np.ndarray]:
    limit = hparams.limit_examples
    if hparams.synthetic_data:
        n = 50_000 if split == "train" else 10_000
        if limit:
            n = min(n, limit)
        size = hparams.image_size or 32
        return synthetic_dataset(
            n,
            num_classes=100,
            image_shape=(size, size, 3),
            seed=hparams.seed + (split == "test"),
            anchor_seed=hparams.seed,
            noise=hparams.synthetic_noise,
        )
    if hparams.image_size not in (0, 32):
        raise ValueError(
            "--image-size applies only to --synthetic-data "
            "(CIFAR-100 images are 32x32)"
        )
    if hparams.dset != "cifar100":
        raise ValueError(f"unknown dataset {hparams.dset!r}")
    images, labels = load_cifar100(hparams.dpath, split)
    if limit:
        images, labels = images[:limit], labels[:limit]
    return images, labels


Split = tuple[np.ndarray, np.ndarray]


def get_datasets(hparams) -> tuple[Split, Split, Split]:
    """(train, valid, test) as ``(images u8 NHWC, labels i32)`` pairs."""
    images, labels = _raw_split(hparams, "train")
    trn_idx, val_idx = train_val_split(len(images), valid_size=0.1, seed=hparams.seed)
    return (
        (images[trn_idx], labels[trn_idx]),
        (images[val_idx], labels[val_idx]),
        _raw_split(hparams, "test"),
    )


class DeviceSplit:
    """A split held on ``device``: uint8 NHWC images and int64 labels,
    uploaded once."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, device) -> None:
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        self.labels = torch.from_numpy(np.asarray(labels, dtype=np.int64)).to(device)

    def __len__(self) -> int:
        return len(self.labels)

    def steps_per_epoch(self, batch_size: int) -> int:
        return len(self) // batch_size

    def epoch_batches(
        self, batch_size: int, seed: int, epoch: int
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """The epoch's training batches: the ``(seed, epoch)`` permutation,
        cut into whole batches (the last partial batch is dropped)."""
        steps = self.steps_per_epoch(batch_size)
        perm = epoch_permutation(len(self), seed, epoch)[: steps * batch_size]
        rows = torch.from_numpy(perm).to(self.labels.device).view(steps, batch_size)
        for idx in rows:
            yield self.images[idx], self.labels[idx]

    def eval_batches(
        self, batch_size: int
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Fixed-shape batches covering every example once, in order, with
        per-example weights: the last batch is padded with copies of the
        first example at weight 0 (``train/trainer.py::_pad_batches``)."""
        n = len(self)
        for start in range(0, n, batch_size):
            idx = torch.arange(start, start + batch_size, device=self.labels.device)
            weights = (idx < n).float()
            idx = torch.where(idx < n, idx, 0)
            yield self.images[idx], self.labels[idx], weights
