"""The train and eval steps (``distributed_training_comparison_tpu/train/step.py``).

The step program is the counterpart of the JAX package's compiled epoch and
eval programs.  :func:`guarded_step` is its ``_make_step_core``: crop/flip
→ normalize → forward/backward → mean softmax cross-entropy plus an MoE
model's load-balance loss → numerics guard → SGD update, with
``--grad-accum`` micro-batches, and nothing read on the host.  An MoE
model's routing health (``moe_dropped_frac``, ``moe_load_max``, as
``_moe_health``) comes back among the step's metrics.  The gradients are
gathered into flat buffers (``train/flat.py``), the norm is one reduction
over them, the update is ``optim.DeviceSGD`` over the flat parameters and
momentum, and a non-finite step is undone by ``health.select_tree`` over
the flat buffers of the whole state: parameters, momentum and BatchNorm's
running statistics, a few launches in all, as the JAX update fuses into
its program.  :class:`EpochRunner` (``make_epoch_runner``) trains an epoch
by one step body, captured once as a CUDA graph on a card and replayed
(``utils/graphs.py``), over the resident split (``--data-mode device``) or
the host loader's staging ring (``--data-mode host``, ``data/loader.py``);
:class:`EvalRunner` (``make_eval_runner``) does the same for the padded
eval batches.  Where JAX compiles the whole epoch as one ``lax.scan``, the
port replays one captured step a step.  On the CPU the same bodies run
eagerly.

:class:`TrainStep` is the eager yardstick: the same gradients, flat norm
and guard, then torch's own ``torch.optim.SGD`` where the host reads the
flag, once a step.  It stays a path of its own: a skipped first step
leaves torch's optimizer without state, as the tests of it hold, where the
step program's momentum exists from the start.

``eval_totals`` is the exact eval over padded batches (``_make_eval_core``),
in eval mode: a BatchNorm normalizes with its running statistics there.

**Data parallelism** (``--backend dp``/``ddp``; ``group`` a process group
of ``n`` processes, one per card): each process takes its rows of every
global batch (``parallel/sharding.py::rank_rows``: its contiguous part of
each micro-batch) with the same rows of the global batch's crop and flip
draws, BatchNorm reduces over the global micro-batch
(``models/norms.py``), and after the gather each flat gradient buffer is
all-reduced once, as a mean, and divided by the micro-batches
(``parallel/dist.py::all_reduce_mean_``); the loss (a mean), ``top1_count``
(a sum) and an MoE model's health (means) are all-reduced in one more
collective before the guard, so the norm, the finite flag and the update
are the same on every process, bit for bit.  All of it runs inside the
captured step: one replay carries the collectives.  An eval pass
evaluates each process's rows of every padded batch and sums the totals
over the group once, outside the graph.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data.augment import draw_epoch_crop_flip, normalize_images, random_crop_flip
from ..data.cifar100 import CIFAR100_MEAN, CIFAR100_STD
from ..data.loader import DeviceSplit, StagingRing
from ..data.sampler import epoch_permutation
from ..health.guards import global_norm, select_tree, step_finite
from ..models.norms import BatchNorm2d
from ..ops import counted_wrappers
from ..parallel.dist import all_reduce_mean_
from ..parallel.sharding import rank_rows
from ..utils.graphs import CapturedStep
from ..utils.metrics import topk_hits
from .flat import FlatGrads, flat_buffers, flatten_
from .optim import DeviceSGD, Schedule

STEP_METRICS = ("loss", "top1_count", "grad_norm", "skipped")

COMPUTE_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def moe_health(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The JAX ``_moe_health`` of the last forward: the mean dropped-token
    fraction over the MoE blocks and the mean over blocks of the largest
    expert load (1/E at perfect balance, 1 when the router collapses onto
    one expert), as device scalars; empty for a dense model."""
    health = model.moe_health() if hasattr(model, "moe_health") else {}
    if not health:
        return {}
    return {
        "moe_dropped_frac": health["dropped_frac"].mean(),
        "moe_load_max": health["expert_load"].amax(-1).mean(),
    }


def forward_backward(
    model: torch.nn.Module,
    images: torch.Tensor,
    labels: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.float32,
    grad_accum: int = 1,
    average: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """The objective of the uint8 NHWC ``images``, mean cross-entropy plus
    an MoE model's summed load-balance loss, and its gradients, left in each
    parameter's ``.grad`` (which this sets, not adds to).

    ``grad_accum > 1`` splits the batch into that many sequential
    micro-batches, sums their gradients and, with ``average``, divides each
    by their number (without it the caller divides, as the step program
    does once over its flat gradient buffer), and averages their losses and
    routing health, as the JAX package's scan does; a BatchNorm in train
    mode advances its running statistics once a micro-batch, in order, as
    the scan carries them.  Returns ``(loss, top1_count, moe health)`` as
    device scalars (the health empty for a dense model)."""
    model.zero_grad(set_to_none=True)
    b = images.shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} does not split into {grad_accum} micro-batches")
    micro = b // grad_accum
    losses, top1 = [], torch.zeros((), dtype=torch.int64, device=labels.device)
    health: list[dict[str, torch.Tensor]] = []
    aux_of = getattr(model, "moe_aux_loss", lambda: None)
    for i in range(grad_accum):
        x = normalize_images(images[i * micro : (i + 1) * micro], dtype=compute_dtype)
        y = labels[i * micro : (i + 1) * micro]
        logits = model(x)
        loss = F.cross_entropy(logits.float(), y)
        aux = aux_of()
        if aux is not None:
            loss = loss + aux
        loss.backward()
        losses.append(loss.detach())
        top1 += topk_hits(logits.detach(), y)[0].sum()
        health.append({k: v.detach() for k, v in moe_health(model).items()})
    if grad_accum > 1 and average:
        for p in model.parameters():
            if p.grad is not None:
                p.grad /= grad_accum
    extras = {k: torch.stack([h[k] for h in health]).mean() for k in health[0]}
    return torch.stack(losses).mean(), top1, extras


def _running_statistics(model: torch.nn.Module) -> list[torch.Tensor]:
    """Every BatchNorm's running mean and variance: the forward advances
    them, and a skipped step puts them back."""
    return [b for m in model.modules() if isinstance(m, BatchNorm2d)
            for b in (m.running_mean, m.running_var)]


def statistics_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    """The running statistics as a step saves and restores them: their
    flat buffers where they lie in them (``EpochRunner`` flattens them),
    else the tensors."""
    running = _running_statistics(model)
    flats = flat_buffers(running)
    return running if flats is None else flats


def _forward_backward_saved(model, images, labels, draws, running, *, compute_dtype, grad_accum):
    """The guarded step up to its backward, shared by :class:`TrainStep`
    and :func:`guarded_step`: crop/flip by ``draws`` when given, one copy of
    the ``running`` statistics taken before any micro-batch, then
    forward/backward with the micro-batches' gradients summed.  Returns
    ``(the running statistics' old values, loss, top1_count, MoE health)``."""
    if draws is not None:
        images = random_crop_flip(images, *draws)
    saved = [t.clone() for t in running]
    loss, top1, extras = forward_backward(
        model, images, labels, compute_dtype=compute_dtype, grad_accum=grad_accum, average=False,
    )
    return saved, loss, top1, extras


def flat_gradient_norm(grads: FlatGrads, grad_accum: int = 1, group=None):
    """The parameters' gradients gathered into ``grads``' flat buffers,
    divided there by ``grad_accum`` (once, not a tensor at a time), and
    their global norm: ``(flat gradients, grad_norm)``.  With a process
    ``group`` each buffer is all-reduced to its mean over the group first,
    in one collective (``parallel.dist.all_reduce_mean_``)."""
    flat = grads.gather()
    if group is not None:
        all_reduce_mean_(flat, group, grad_accum)
    elif grad_accum > 1:
        for g in flat:
            g.div_(grad_accum)
    return flat, global_norm(flat)


def reduce_step_metrics(loss: torch.Tensor, top1: torch.Tensor, extras: dict, group):
    """A step's metrics over a process ``group`` in one collective, as the
    JAX step reduces them over the global batch: the loss and an MoE
    model's routing health as means, ``top1_count`` as a sum (the sum in
    fp64, exact for any count).  Without a group they are returned as they
    are."""
    if group is None:
        return loss, top1, extras
    keys = sorted(extras)
    row = torch.stack([loss.double(), top1.double(), *(extras[k].double() for k in keys)])
    dist.all_reduce(row, group=group)
    world = dist.get_world_size(group)
    means = (row / world).float()
    return means[0], row[1].long(), {k: means[2 + i] for i, k in enumerate(keys)}


def guard_and_update(sgd: DeviceSGD, loss: torch.Tensor, running: list[torch.Tensor],
                     saved: list[torch.Tensor], *, grad_accum: int = 1, group=None):
    """The guarded step after its backward, with nothing read on the host:
    the flat gradients (over a process ``group``, their mean over it) and
    their norm (:func:`flat_gradient_norm`), the finite flag, ``sgd``'s
    update over the flat parameters and momentum (which keeps them and the
    step count where the flag is down), and the ``running`` statistics put
    back to ``saved`` where it is down, one select a buffer.  ``loss`` is
    the step's loss over the group.  Returns ``(grad_norm, finite)``."""
    flat, grad_norm = flat_gradient_norm(sgd.grads, grad_accum, group)
    finite = step_finite(loss, grad_norm)
    sgd.step(finite, flat)
    with torch.no_grad():
        select_tree(finite, running, saved, running)
    return grad_norm, finite


class TrainStep:
    """One guarded SGD step over a global batch, eagerly, with torch's own
    SGD: the yardstick of the step program (module docstring).

    ``applied`` counts the updates applied: the schedule's step count, read
    from ``counter`` (an int64 device scalar; ``Trainer`` passes its
    ``DeviceSGD.applied``, so that the eager step and the step program
    keep one count), by default a count of its own.  A step whose loss or
    gradient norm is not finite applies nothing, so the parameters, the
    momentum buffers, BatchNorm's running statistics and the count keep
    their old values.  The step runs the model in train mode.  With a
    process ``group`` it takes the step program's collectives (module
    docstring) on this process's rows of the global batch, and torch's SGD
    reads the all-reduced gradients.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        schedule: Schedule,
        *,
        precision: str = "fp32",
        augment: bool = True,
        grad_accum: int = 1,
        counter: torch.Tensor | None = None,
        group=None,
    ) -> None:
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.compute_dtype = COMPUTE_DTYPES[precision]
        self.augment = augment
        self.grad_accum = grad_accum
        self.group = group
        self.counter = torch.zeros((), dtype=torch.int64) if counter is None else counter
        self.grads = FlatGrads([p for g in optimizer.param_groups for p in g["params"]])

    @property
    def applied(self) -> int:
        return int(self.counter)

    def __call__(self, images, labels, draws=None) -> dict[str, torch.Tensor]:
        """``images`` uint8 NHWC and ``labels`` on the model's device;
        ``draws`` the crop offsets and flips (``data.draw_crop_flip``) when
        augmenting.  Returns the step's metrics as device scalars: ``loss``,
        ``top1_count``, ``count``, ``grad_norm``, ``skipped``, and for an
        MoE model ``moe_dropped_frac`` and ``moe_load_max``."""
        if not self.model.training:
            self.model.train()
        running = statistics_buffers(self.model)
        saved, loss, top1, extras = _forward_backward_saved(
            self.model, images, labels, draws if self.augment else None, running,
            compute_dtype=self.compute_dtype, grad_accum=self.grad_accum,
        )
        loss, top1, extras = reduce_step_metrics(loss, top1, extras, self.group)
        _, grad_norm = flat_gradient_norm(self.grads, self.grad_accum, self.group)
        finite = step_finite(loss, grad_norm)
        # the guard reads the finite flag on the host, one device sync per
        # step (the JAX package selects between old and new state on the
        # device instead); a skipped step touches no state at all
        if bool(finite):
            self.grads.scatter()  # torch's SGD reads .grad: the flat buffers' values
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.applied)
            self.optimizer.step()
            self.counter.add_(1)
        else:
            for b, old in zip(running, saved):
                b.copy_(old)
        return {
            "loss": loss,
            "top1_count": top1,
            "count": labels.shape[0] * (1 if self.group is None
                                        else dist.get_world_size(self.group)),
            "grad_norm": grad_norm,
            "skipped": (~finite).float(),
            **extras,
        }


def guarded_step(
    model: torch.nn.Module,
    sgd: DeviceSGD,
    images: torch.Tensor,
    labels: torch.Tensor,
    draws: tuple[torch.Tensor, torch.Tensor] | None = None,
    *,
    compute_dtype: torch.dtype = torch.float32,
    grad_accum: int = 1,
    group=None,
) -> dict[str, torch.Tensor]:
    """One guarded SGD step with nothing read on the host: crop/flip by
    ``draws`` when given, normalize, forward/backward, the gradients
    gathered into ``sgd.grads``' flat buffers, their global norm and the
    finite flag, ``sgd``'s update over the flat parameters and momentum,
    then the running statistics of every BatchNorm put back where the step
    is not finite, one select over their flat buffer (the update keeps the
    parameters, momentum and step count itself).  With a process ``group``
    the images are this process's rows, and the metrics and gradients are
    reduced over the group before the guard (module docstring).  The model
    runs in the mode it is in (train mode for training).  Returns
    ``loss``, ``top1_count``, ``grad_norm``, ``skipped`` and an MoE
    model's routing health, as device scalars."""
    running = statistics_buffers(model)
    saved, loss, top1, extras = _forward_backward_saved(
        model, images, labels, draws, running, compute_dtype=compute_dtype, grad_accum=grad_accum,
    )
    loss, top1, extras = reduce_step_metrics(loss, top1, extras, group)
    grad_norm, finite = guard_and_update(sgd, loss, running, saved, grad_accum=grad_accum,
                                         group=group)
    return {
        "loss": loss,
        "top1_count": top1,
        "grad_norm": grad_norm,
        "skipped": (~finite).float(),
        **extras,
    }


class EpochRunner:
    """The epoch program (JAX ``make_epoch_runner``): the steps of an epoch
    over ``split``, in the ``(seed, epoch)`` order of
    ``split.epoch_batches`` with the draws of ``draw_epoch_crop_flip``.
    ``split`` is a ``DeviceSplit`` that stays on the device
    (``--data-mode device``), or a ``data.StagingRing`` that the host
    loader fills chunk by chunk (``--data-mode host``): the same order,
    from the host.

    An epoch uploads its draws (and over a ``DeviceSplit`` its permutation)
    into static buffers once; each step reads its batch at a step counter
    on the device, runs :func:`guarded_step` and writes its metrics into a
    static ``(steps, k)`` buffer, fetched once at the end of the epoch.
    Construction holds the model's BatchNorm running statistics in one flat
    buffer (``train/flat.py``; ``sgd`` holds the parameters and momentum),
    before any capture.  On a card the step is a
    :class:`~..utils.graphs.CapturedStep`: the first step runs eagerly on a
    side stream (it is a step of the epoch), the next is captured, in train
    mode, and every later step of this and later epochs replays it.
    ``program.body()``, called in train mode, runs the next step eagerly.

    ``batch_size`` is the global batch.  With a process ``group`` this
    process runs on its rows of it (``parallel.sharding.rank_rows``): of
    the permutation's batch over a ``DeviceSplit``, which every process
    holds whole, and of the global batch's draws; a ring holds only this
    process's rows, its shard's batches.  The step is then captured in
    ``thread_local`` mode (``utils/graphs.py``)."""

    def __init__(
        self,
        model: torch.nn.Module,
        sgd: DeviceSGD,
        split: DeviceSplit | StagingRing,
        batch_size: int,
        *,
        seed: int,
        precision: str = "fp32",
        augment: bool = True,
        grad_accum: int = 1,
        pool=None,
        group=None,
    ) -> None:
        self.model, self.sgd, self.split = model, sgd, split
        self.batch_size, self.seed = batch_size, seed
        self.compute_dtype = COMPUTE_DTYPES[precision]
        self.augment, self.grad_accum = augment, grad_accum
        self.group = group
        world = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        self.rows = rank_rows(batch_size, grad_accum, world, rank)
        local = len(self.rows)
        self.ring = split if isinstance(split, StagingRing) else None
        if self.ring is None:
            self.steps = split.steps_per_epoch(batch_size)
            if self.steps == 0:
                raise ValueError(f"{len(split)} examples make no whole batch of {batch_size}")
            dev = split.labels.device
            self.perm = torch.zeros((self.steps, local), dtype=torch.int64, device=dev)
        else:
            if self.ring.batch_size != local:
                raise ValueError(f"a ring of batches of {self.ring.batch_size} for this "
                                 f"process's {local} rows of {batch_size}")
            self.steps, dev = self.ring.steps, self.ring.device
        flatten_(_running_statistics(model))
        self.offsets = torch.zeros((self.steps, local, 2), dtype=torch.int64, device=dev)
        self.flips = torch.zeros((self.steps, local), dtype=torch.bool, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)  # the step of the epoch
        self.k = 0  # the same count on the host, for the ring's chunk boundaries
        self.keys: list[str] | None = None
        self.metrics: torch.Tensor | None = None
        self.program = CapturedStep(
            self._body, dev, counters=counted_wrappers, pool=pool,
            capture_error_mode="global" if group is None else "thread_local",
        )

    def _batch(self, i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.ring is not None:
            return self.ring.batch(i)
        idx = self.perm.index_select(0, i).view(-1)
        return self.split.images.index_select(0, idx), self.split.labels.index_select(0, idx)

    def _body(self) -> None:
        i = torch.remainder(self.i, self.steps).view(1)
        images, labels = self._batch(i)
        draws = None
        if self.augment:
            draws = (self.offsets.index_select(0, i)[0], self.flips.index_select(0, i)[0])
        m = guarded_step(
            self.model, self.sgd, images, labels, draws,
            compute_dtype=self.compute_dtype, grad_accum=self.grad_accum, group=self.group,
        )
        if self.keys is None:  # the first step is eager: the buffer is static from then on
            self.keys = [*STEP_METRICS, *sorted(k for k in m if k.startswith("moe_"))]
            self.metrics = torch.zeros((self.steps, len(self.keys)), device=self.i.device)
        row = torch.stack([m[k].float() for k in self.keys])
        self.metrics.index_copy_(0, i, row[None])
        self.i.add_(1)

    def start_epoch(self, epoch: int) -> None:
        """Upload ``epoch``'s draws (and its batch order over a
        ``DeviceSplit``; a ring starts staging the epoch); the next step is
        its first."""
        rows = torch.from_numpy(self.rows)
        if self.ring is None:
            n = self.steps * self.batch_size
            perm = epoch_permutation(len(self.split), self.seed, epoch)[:n]
            perm = torch.from_numpy(np.asarray(perm, dtype=np.int64)).view(self.steps, -1)
            self.perm.copy_(perm[:, rows])
        else:
            self.ring.start_epoch(epoch)
        if self.augment:
            offsets, flips = draw_epoch_crop_flip(self.batch_size, self.steps, self.seed, epoch)
            self.offsets.copy_(offsets[:, rows])
            self.flips.copy_(flips[:, rows])
        self.i.zero_()
        self.k = 0

    def step(self) -> None:
        """The next step of the epoch (after the last, the first again).
        Over a ring: its chunk's copy first, and its slot freed after the
        chunk's last step."""
        if not self.model.training:
            self.model.train()
        if self.ring is None:
            self.program()
        else:
            self.ring.before_step(self.k)
            self.program()
            self.ring.after_step(self.k)
        self.k = (self.k + 1) % self.steps

    def run_epoch(self, epoch: int) -> dict[str, np.ndarray]:
        """Every step of ``epoch``; their metrics by key (``STEP_METRICS``,
        then an MoE model's ``moe_*``), one array each, in one fetch."""
        self.start_epoch(epoch)
        try:
            for _ in range(self.steps):
                self.step()
        finally:
            if self.ring is not None:
                self.ring.end_epoch()
        return dict(zip(self.keys, self.metrics.T.cpu().numpy()))

    def close(self) -> None:
        """Stop a ring's threads (nothing to do over a ``DeviceSplit``)."""
        if self.ring is not None:
            self.ring.close()


def eval_batch_totals(
    model: torch.nn.Module,
    images: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    stats: tuple = (CIFAR100_MEAN, CIFAR100_STD),
) -> torch.Tensor:
    """One padded batch's weighted cross-entropy sum, top-1 and top-5 hits
    and weight total, as an fp32 (4,) device tensor (``_make_eval_core``),
    the images normalized by ``stats`` (mean, std); the model runs in the
    mode it is in."""
    logits = model(normalize_images(images, *stats, dtype=dtype)).float()
    top1, top5 = topk_hits(logits, labels)
    return torch.stack([
        (F.cross_entropy(logits, labels, reduction="none") * weights).sum(),
        (top1 * weights).sum(),
        (top5 * weights).sum(),
        weights.sum(),
    ])


def _totals(t: torch.Tensor) -> dict[str, float]:
    loss_sum, top1_count, top5_count, count = t.tolist()
    return {
        "loss_sum": loss_sum, "top1_count": top1_count,
        "top5_count": top5_count, "count": count,
    }


class EvalRunner:
    """The eval program (JAX ``make_eval_runner``) over one ``split``: its
    padded batches (``split.eval_batches``' order and weights) gathered at
    a batch counter on the device, each batch's totals
    (:func:`eval_batch_totals`) summed on the device, one ``.tolist()`` a
    pass.  The model runs in eval mode and is given back in the mode it
    came in.  On a card the batch is a
    :class:`~..utils.graphs.CapturedStep`: the first pass's first batch
    runs eagerly, the next is captured in eval mode and replayed from then
    on; ``program.body()``, called in eval mode, runs the next batch
    eagerly.

    ``stats`` are the normalization's (mean, std) (the reference's test
    split under ``--legacy-test-stats`` takes ImageNet's).  With a process
    ``group`` each process evaluates its contiguous share of every padded
    batch, and a pass ends with one all-reduce of the totals, outside the
    graph: every example is counted once."""

    def __init__(
        self,
        model: torch.nn.Module,
        split: DeviceSplit,
        batch_size: int,
        *,
        precision: str = "fp32",
        pool=None,
        group=None,
        stats: tuple = (CIFAR100_MEAN, CIFAR100_STD),
    ) -> None:
        if len(split) == 0:
            raise ValueError("eval over an empty split")
        self.model, self.split, self.batch_size = model, split, batch_size
        self.dtype = COMPUTE_DTYPES[precision]
        self.stats, self.group = stats, group
        self.batches = -(-len(split) // batch_size)
        dev = split.labels.device
        self.rows = torch.from_numpy(rank_rows(
            batch_size, 1, 1 if group is None else dist.get_world_size(group),
            0 if group is None else dist.get_rank(group))).to(dev)
        self.j = torch.zeros((), dtype=torch.int64, device=dev)  # the batch of the pass
        self.totals = torch.zeros(4, device=dev)
        self.program = CapturedStep(self._body, dev, counters=counted_wrappers, pool=pool)

    @torch.no_grad()
    def _body(self) -> None:
        n = len(self.split)
        idx = self.j * self.batch_size + self.rows
        weights = (idx < n).float()
        idx = torch.where(idx < n, idx, 0)
        self.totals += eval_batch_totals(
            self.model, self.split.images.index_select(0, idx),
            self.split.labels.index_select(0, idx), weights, self.dtype, self.stats,
        )
        self.j.add_(1)

    def run(self) -> dict[str, float]:
        """The split's totals: ``loss_sum``, ``top1_count``, ``top5_count``
        and ``count``, as ``eval_totals`` gives them."""
        was_training = self.model.training
        self.model.eval()
        try:
            self.totals.zero_()
            self.j.zero_()
            for _ in range(self.batches):
                self.program()
        finally:
            self.model.train(was_training)
        if self.group is not None:
            dist.all_reduce(self.totals, group=self.group)
        return _totals(self.totals)


@torch.inference_mode()
def eval_totals(
    model: torch.nn.Module,
    batches: Iterable[tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    *,
    precision: str = "fp32",
) -> dict[str, float]:
    """Sums over ``(images, labels, weights)`` batches of the weighted
    cross-entropy and top-1/top-5 hits, and the weight total: every real
    example counted once, padding at weight 0.  One host fetch at the end.
    The model runs in eval mode and is given back in the mode it came in."""
    dtype = COMPUTE_DTYPES[precision]
    was_training = model.training
    model.eval()
    totals = None
    try:
        for images, labels, weights in batches:
            batch = eval_batch_totals(model, images, labels, weights, dtype)
            totals = batch if totals is None else totals + batch
    finally:
        model.train(was_training)
    if totals is None:
        raise ValueError("eval over an empty split")
    return _totals(totals)
