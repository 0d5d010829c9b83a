"""Seeding (``distributed_training_comparison_tpu/utils/seed.py``).

The JAX package seeds the host generators and mints one root PRNG key from
which every device-side draw is folded.  The port seeds the host generators
and hands out explicit ``torch.Generator``s: one for the weights, and one
per (epoch, step) for the augmentation draws, derived from the seed by
numpy's ``SeedSequence`` so a (seed, epoch, step) triple always draws the
same crops and flips.  Their bits differ from the JAX package's threefry
draws (a written delta); the tests feed both sides the same draws.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def fix_seed(seed: int) -> torch.Generator:
    """Seed Python's and numpy's global generators and return the seeded
    generator that initialises the model's weights.  The reference's
    ``fix_seed`` also holds cuDNN to its deterministic algorithms; in the
    port that is the device choice's (``_device.resolve_device`` pins it
    wherever a card resolves), so that no run on the card skips it."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def step_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step`` of ``epoch``'s random draws."""
    state = np.random.SeedSequence((seed, epoch, step)).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))
