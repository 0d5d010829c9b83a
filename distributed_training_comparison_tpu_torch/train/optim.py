"""SGD and the StepLR staircase (``distributed_training_comparison_tpu/train/optim.py``).

The JAX package's optax chain is ``add_decayed_weights(wd)`` then
``sgd(momentum=0.9, nesterov=True)``: weight decay coupled into the
gradient before the momentum buffer, on every parameter, and the nesterov
update ``d + 0.9·buf``.  ``torch.optim.SGD(momentum=0.9, nesterov=True,
weight_decay=wd)`` makes the same update (its first step seeds the buffer
with ``d``, as optax's zero-initialised trace gives).  The learning rate is
StepLR's staircase over the updates actually applied: a step the guard
skips does not advance it (``train/step.py``).

:class:`DeviceSGD` is the same update for the step program, with nothing
read on the host: the learning rate is an fp32 device tensor looked up in
:func:`lr_table` at the applied-step count, itself a device tensor (the
count optax keeps in its state), and a non-finite step is undone on the
device by ``health.select_tree``.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..health.guards import select_tree

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


def lr_table(schedule: Schedule, steps: int, device) -> torch.Tensor:
    """``schedule``'s learning rate at every applied-step count from 0 to
    ``steps``, fp32 on ``device``: one upload, indexed on the device (a
    count past ``steps`` reads the last entry)."""
    return torch.tensor([schedule(k) for k in range(steps + 1)], dtype=torch.float32, device=device)


class DeviceSGD:
    """``configure_optimizers``' SGD (nesterov, its momentum and coupled
    weight decay, no dampening) applied on the device: ``d = g + wd·p``,
    ``buf' = 0.9·buf + d``, ``d' = d + 0.9·buf'``, ``p' = p - lr·d'``
    (``torch._foreach_*`` ops, never a host read), the learning rate ``lr``
    read from ``table`` at the applied-step count ``applied`` (both device
    tensors), then the old or the new parameters and buffers kept by the
    step's finite flag, and ``applied`` advanced by it.

    The momentum buffers live where torch's SGD keeps them,
    ``optimizer.state[p]["momentum_buffer"]``; a missing one starts at zero
    (optax's ``trace`` init: ``0.9·0 + d`` is torch's first-step copy of
    ``d``).  The last step is ``addcmul(p, d', lr, value=-1)``, torch's own
    form for a tensor learning rate: one rounding, as ``torch.optim.SGD``'s
    ``p.add_(d', alpha=-lr)`` rounds it.  Parameters without a gradient are
    left alone, as torch's SGD leaves them."""

    def __init__(self, optimizer: torch.optim.SGD, table: torch.Tensor) -> None:
        self.optimizer = optimizer
        self.momentum = optimizer.defaults["momentum"]
        self.weight_decay = optimizer.defaults["weight_decay"]
        self.table = table
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        with torch.no_grad():
            for p in self.params:
                if optimizer.state[p].get("momentum_buffer") is None:
                    optimizer.state[p]["momentum_buffer"] = torch.zeros_like(p)
        self.applied = torch.zeros((), dtype=torch.int64, device=table.device)
        self.lr = table[0].clone()

    @torch.no_grad()
    def step(self, finite: torch.Tensor) -> None:
        """One guarded update from the parameters' ``.grad``: applied where
        ``finite`` (a bool device scalar) holds, else nothing changes."""
        last = self.table.numel() - 1
        self.lr.copy_(self.table.index_select(0, self.applied.clamp(max=last).view(1)).squeeze(0))
        pairs = [(p, self.optimizer.state[p]["momentum_buffer"])
                 for p in self.params if p.grad is not None]
        params = [p for p, _ in pairs]
        bufs = [b for _, b in pairs]
        grads = [p.grad for p in params]
        if self.weight_decay:
            d = torch._foreach_add(grads, params, alpha=self.weight_decay)
        else:
            d = torch._foreach_mul(grads, 1.0)
        new_bufs = torch._foreach_mul(bufs, self.momentum)
        torch._foreach_add_(new_bufs, d)
        torch._foreach_add_(d, new_bufs, alpha=self.momentum)
        new_params = [torch.addcmul(p, step, self.lr, value=-1) for p, step in zip(params, d)]
        select_tree(finite, new_params, params, params)
        select_tree(finite, new_bufs, bufs, bufs)
        self.applied.add_(finite.to(torch.int64))
