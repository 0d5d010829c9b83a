"""Split and shuffle index logic (``distributed_training_comparison_tpu/data/sampler.py``)."""

from __future__ import annotations

import numpy as np


def train_val_split(
    n: int, valid_size: float = 0.1, seed: int = 42, shuffle: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Disjoint (train_idx, valid_idx) covering ``range(n)``: shuffle the
    indices with a seeded generator, the first ``floor(valid_size*n)`` are
    validation, the rest train."""
    if not 0.0 <= valid_size <= 1.0:
        raise ValueError("valid_size should be in the range [0, 1].")
    indices = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    split = int(np.floor(valid_size * n))
    return indices[split:], indices[:split]


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The order in which an epoch visits ``n`` examples: the JAX host
    loader's numpy shuffle keyed by ``(seed, epoch)`` (``data/loader.py``,
    ``HostLoader._permutation``)."""
    idx = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(idx)
    return idx
