"""Numerics guards of the train step (``distributed_training_comparison_tpu/health/guards.py``).

Every step computes the gradient global norm and a finite flag; a
non-finite step applies no update, so params, momentum and the schedule's
step count all keep their old values (``train/step.py``).  The eager
``TrainStep`` reads the flag on the host; the step program keeps it on the
device and selects between the old and the new state with
:func:`select_tree`, as the JAX step does.
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


def select_tree(
    pred: torch.Tensor,
    on_true: list[torch.Tensor],
    on_false: list[torch.Tensor],
    out: list[torch.Tensor],
) -> None:
    """Per-tensor ``where(pred, on_true, on_false)`` over two same-shaped
    lists, written into ``out`` (which may be either list): the JAX
    ``select_tree`` over the step's state, with ``pred`` the scalar finite
    flag on the device.  A NaN in the side not taken does not reach
    ``out``."""
    if not len(on_true) == len(on_false) == len(out):
        raise ValueError(
            f"select_tree over {len(on_true)}, {len(on_false)} and {len(out)} tensors"
        )
    for a, b, o in zip(on_true, on_false, out):
        torch.where(pred, a, b, out=o)
