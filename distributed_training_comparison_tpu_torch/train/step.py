"""The train and eval steps (``distributed_training_comparison_tpu/train/step.py``).

``TrainStep`` is the JAX package's ``_make_step_core``: crop/flip →
normalize → forward/backward → mean softmax cross-entropy plus an MoE
model's load-balance loss → numerics guard → SGD update, with
``--grad-accum`` micro-batches; an MoE model's routing health
(``moe_dropped_frac``, ``moe_load_max``, as ``_moe_health``) comes back
among the step's metrics.  PyTorch runs it eagerly
and launches each kernel from the host; the JAX package's one compiled
program per epoch would be a CUDA graph here, in a later change.
``eval_totals`` is the exact eval over padded batches (``_make_eval_core``).
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F

from ..data.augment import normalize_images, random_crop_flip
from ..health.guards import global_norm, step_finite
from ..utils.metrics import topk_hits
from .optim import Schedule

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
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """The objective of the uint8 NHWC ``images``, mean cross-entropy plus
    an MoE model's summed load-balance loss, and its gradients, left in each
    parameter's ``.grad`` (which this sets, not adds to).

    ``grad_accum > 1`` splits the batch into that many sequential
    micro-batches, sums their gradients and divides by their number, and
    averages their losses and routing health, as the JAX package's scan
    does.  Returns ``(loss, top1_count, moe health)`` as device scalars
    (the health empty for a dense model)."""
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
    if grad_accum > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad /= grad_accum
    extras = {k: torch.stack([h[k] for h in health]).mean() for k in health[0]}
    return torch.stack(losses).mean(), top1, extras


class TrainStep:
    """One guarded SGD step over a global batch.

    ``applied`` counts the updates applied: the schedule's step count.  A
    step whose loss or gradient norm is not finite applies nothing, so the
    parameters, the momentum buffers and ``applied`` keep their old values.
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
    ) -> None:
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.compute_dtype = COMPUTE_DTYPES[precision]
        self.augment = augment
        self.grad_accum = grad_accum
        self.applied = 0

    def __call__(self, images, labels, draws=None) -> dict[str, torch.Tensor]:
        """``images`` uint8 NHWC and ``labels`` on the model's device;
        ``draws`` the crop offsets and flips (``data.draw_crop_flip``) when
        augmenting.  Returns the step's metrics as device scalars: ``loss``,
        ``top1_count``, ``count``, ``grad_norm``, ``skipped``, and for an
        MoE model ``moe_dropped_frac`` and ``moe_load_max``."""
        if self.augment:
            images = random_crop_flip(images, *draws)
        loss, top1, extras = forward_backward(
            self.model, images, labels, compute_dtype=self.compute_dtype,
            grad_accum=self.grad_accum,
        )
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        grad_norm = global_norm(grads)
        finite = step_finite(loss, grad_norm)
        # the guard reads the finite flag on the host, one device sync per
        # step (the JAX package selects between old and new state on the
        # device instead); a skipped step touches no state at all
        if bool(finite):
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.applied)
            self.optimizer.step()
            self.applied += 1
        return {
            "loss": loss,
            "top1_count": top1,
            "count": labels.shape[0],
            "grad_norm": grad_norm,
            "skipped": (~finite).float(),
            **extras,
        }


@torch.inference_mode()
def eval_totals(
    model: torch.nn.Module,
    batches: Iterable[tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    *,
    precision: str = "fp32",
) -> dict[str, float]:
    """Sums over ``(images, labels, weights)`` batches of the weighted
    cross-entropy and top-1/top-5 hits, and the weight total: every real
    example counted once, padding at weight 0.  One host fetch at the end."""
    dtype = COMPUTE_DTYPES[precision]
    totals = None
    for images, labels, weights in batches:
        logits = model(normalize_images(images, dtype=dtype)).float()
        top1, top5 = topk_hits(logits, labels)
        batch = torch.stack([
            (F.cross_entropy(logits, labels, reduction="none") * weights).sum(),
            (top1 * weights).sum(),
            (top5 * weights).sum(),
            weights.sum(),
        ])
        totals = batch if totals is None else totals + batch
    if totals is None:
        raise ValueError("eval over an empty split")
    loss_sum, top1_count, top5_count, count = totals.tolist()
    return {
        "loss_sum": loss_sum, "top1_count": top1_count,
        "top5_count": top5_count, "count": count,
    }
