"""Numerics guards of the train step (``distributed_training_comparison_tpu/health/guards.py``).

Every step computes the gradient global norm and a finite flag; a
non-finite step applies no update, so params, momentum and the schedule's
step count all keep their old values (``train/step.py``).
"""

from __future__ import annotations

import torch


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over every tensor as one fp32 scalar.  NaN anywhere gives
    NaN, Inf anywhere Inf, so its finiteness tests every element."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def step_finite(loss: torch.Tensor, grad_norm: torch.Tensor) -> torch.Tensor:
    """A step applies iff its loss and its gradient norm are finite."""
    return torch.isfinite(loss) & torch.isfinite(grad_norm)
