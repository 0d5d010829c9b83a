"""Synthetic dataset (``distributed_training_comparison_tpu/data/synthetic.py``).

Class-conditional structured images, a per-class anchor pattern plus noise,
so that a model can genuinely fit them; numpy and seeded, byte-identical
to the JAX package's for the same arguments.
"""

from __future__ import annotations

import numpy as np


def synthetic_dataset(
    n: int,
    num_classes: int = 100,
    image_shape: tuple[int, int, int] = (32, 32, 3),
    seed: int = 0,
    noise: float = 0.15,
    anchor_seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """``(images u8 NHWC, labels i32)`` with learnable class structure: each
    class gets a fixed random anchor image and samples are
    ``clip(anchor + noise)``.  ``anchor_seed`` pins the anchors apart from
    the sample noise, so train and test splits share one class structure."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n, dtype=np.int32)
    anchor_rng = np.random.default_rng(seed if anchor_seed is None else anchor_seed)
    anchors = anchor_rng.uniform(0.0, 1.0, size=(num_classes, *image_shape)).astype(np.float32)
    x = anchors[labels] + rng.normal(0.0, noise, size=(n, *image_shape)).astype(np.float32)
    images = (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)
    return images, labels
