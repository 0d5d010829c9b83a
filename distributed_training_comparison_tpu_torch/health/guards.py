"""Numerics guards of the train step (``distributed_training_comparison_tpu/health/guards.py``).

Every step computes the gradient global norm and a finite flag; a
non-finite step applies no update, so params, momentum, BatchNorm's running
statistics and the schedule's step count all keep their old values
(``train/step.py``).  The step program keeps the flag on the device and
selects between the old and the new state with :func:`select_tree`, as the
JAX step does, over the state's flat buffers (``train/flat.py``): one
select a buffer, not one a tensor.  The eager ``TrainStep``, the yardstick
on torch's own SGD, reads the flag on the host.
"""

from __future__ import annotations

import torch


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over every tensor as one fp32 scalar: one reduction pass
    over each tensor (``vector_norm`` accumulating in fp64, so that the
    order of one flat buffer's sum costs no accuracy), the squares summed
    in fp64 and rounded to fp32 before the root: a sum of squares past the
    fp32 range gives Inf, as the JAX package's fp32 sum does.  NaN anywhere
    gives NaN, Inf anywhere Inf, so its finiteness tests every element."""
    squares = [torch.linalg.vector_norm(t, dtype=torch.float64).square() for t in tensors]
    if not squares:
        return torch.zeros((), dtype=torch.float32)
    total = squares[0] if len(squares) == 1 else torch.stack(squares).sum()
    return total.float().sqrt()


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
    flag on the device.  The step calls it with the state's flat buffers,
    one launch a buffer.  A NaN in the side not taken does not reach
    ``out``."""
    if not len(on_true) == len(on_false) == len(out):
        raise ValueError(
            f"select_tree over {len(on_true)}, {len(on_false)} and {len(out)} tensors"
        )
    for a, b, o in zip(on_true, on_false, out):
        torch.where(pred, a, b, out=o)
