"""SGD and the StepLR staircase (``distributed_training_comparison_tpu/train/optim.py``).

The JAX package's optax chain is ``add_decayed_weights(wd)`` then
``sgd(momentum=0.9, nesterov=True)``: weight decay coupled into the
gradient before the momentum buffer, on every parameter, and the nesterov
update ``d + 0.9·buf``.  ``torch.optim.SGD(momentum=0.9, nesterov=True,
weight_decay=wd)`` makes the same update (its first step seeds the buffer
with ``d``, as optax's zero-initialised trace gives).  The learning rate is
StepLR's staircase over the updates actually applied: a step the guard
skips does not advance it (``train/step.py``).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def step_lr_schedule(
    base_lr: float, step_size_epochs: int, gamma: float, steps_per_epoch: int
) -> Schedule:
    """StepLR as a staircase over global steps: ``base_lr`` times ``gamma``
    for every ``step_size_epochs`` whole epochs of steps."""
    transition = max(1, step_size_epochs * steps_per_epoch)
    return lambda step: base_lr * gamma ** (step // transition)


def configure_optimizers(
    hparams, steps_per_epoch: int, params: Iterable[torch.nn.Parameter]
) -> tuple[torch.optim.SGD, Schedule]:
    """The torch-parity SGD and its schedule (``--lr``, ``--weight-decay``,
    ``--lr-decay-step-size``, ``--lr-decay-gamma``)."""
    schedule = step_lr_schedule(
        hparams.lr, hparams.lr_decay_step_size, hparams.lr_decay_gamma, steps_per_epoch
    )
    optimizer = torch.optim.SGD(
        params, lr=hparams.lr, momentum=0.9, nesterov=True,
        weight_decay=hparams.weight_decay,
    )
    return optimizer, schedule
