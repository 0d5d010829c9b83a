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
read on the host, over the parameters and momentum held in flat buffers (a
few launches a step, as the JAX package's update fuses into its step
program): the learning rate is an fp32 device tensor looked up in
:func:`lr_table` at the applied-step count, itself a device tensor (the
count optax keeps in its state), and a non-finite step is undone on the
device by ``health.select_tree``.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from ..health.guards import select_tree
from .flat import FlatGrads, FlatLayout, flatten_

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
    weight decay, no dampening) applied on the device over flat buffers:
    ``d = g + wd·p``, ``buf' = 0.9·buf + d``, ``d' = d + 0.9·buf'``,
    ``p' = p - lr·d'``, never a host read, the learning rate ``lr`` read
    from ``table`` at the applied-step count ``applied`` (both device
    tensors), then the old or the new parameters and buffers kept by the
    step's finite flag (``health.select_tree``, one ``where`` a buffer), and
    ``applied`` advanced by it.

    Construction holds the parameters, and their momentum buffers in the
    same layout, as views into one flat buffer per dtype
    (``train/flat.py``): ``flat_params`` and ``flat_momentum``.  The
    buffers live where torch's SGD keeps them,
    ``optimizer.state[p]["momentum_buffer"]`` (the same objects, an existing
    one taken as it is); a missing one starts at zero (optax's ``trace``
    init: ``0.9·0 + d`` is torch's first-step copy of ``d``).  The
    gradients are gathered into ``grads``' flat buffers, the update's
    scratch.  Each op rounds as torch's per-tensor SGD does (the last one
    ``addcmul(p, d', lr, value=-1)``, torch's own form for a tensor
    learning rate: one rounding, as ``p.add_(d', alpha=-lr)``), so on the
    CPU the flat update equals ``torch.optim.SGD`` bit for bit; on the card
    torch's kernels round the last op apart by up to an ulp.  Parameters
    without a gradient at the first step are left alone from then on, as
    torch's SGD leaves them."""

    def __init__(self, optimizer: torch.optim.SGD, table: torch.Tensor) -> None:
        self.optimizer = optimizer
        self.momentum = optimizer.defaults["momentum"]
        self.weight_decay = optimizer.defaults["weight_decay"]
        self.table = table
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        layout = FlatLayout(self.params)
        with torch.no_grad():
            for p in self.params:
                if optimizer.state[p].get("momentum_buffer") is None:
                    optimizer.state[p]["momentum_buffer"] = torch.zeros_like(p)
        self.flat_params = flatten_(self.params, layout)
        self.flat_momentum = flatten_(
            [optimizer.state[p]["momentum_buffer"] for p in self.params], layout)
        self.grads = FlatGrads(self.params, layout)
        self.applied = torch.zeros((), dtype=torch.int64, device=table.device)
        self.lr = table[0].clone()

    @torch.no_grad()
    def step(self, finite: torch.Tensor, grads: list[torch.Tensor] | None = None) -> None:
        """One guarded update: applied where ``finite`` (a bool device
        scalar) holds, else nothing changes.  ``grads`` are the flat
        gradients (``self.grads.gather()``, scaled as the caller needs);
        by default the parameters' ``.grad`` gathered now."""
        last = self.table.numel() - 1
        self.lr.copy_(self.table.index_select(0, self.applied.clamp(max=last).view(1)).squeeze(0))
        grads = self.grads.gather() if grads is None else grads
        for g, start, end in self.grads.layout.runs(self.grads.present):
            p = self.flat_params[g][start:end]
            buf = self.flat_momentum[g][start:end]
            d = grads[g][start:end]
            if self.weight_decay:
                d.add_(p, alpha=self.weight_decay)
            new_buf = torch.mul(buf, self.momentum).add_(d)
            d.add_(new_buf, alpha=self.momentum)
            new_p = torch.addcmul(p, d, self.lr, value=-1)
            select_tree(finite, [new_p, new_buf], [p, buf], [p, buf])
        self.applied.add_(finite.to(torch.int64))
