"""The trainer (``distributed_training_comparison_tpu/train/trainer.py``).

``Trainer`` builds the model with the JAX package's ``model_kw`` (compute
dtype from ``--precision``/``--amp``, the norms' dtype from ``--bn-dtype``,
``--stem``, ``--remat``, and for a ViT the image and patch size, the MoE
dispatch and the block-fusion policy), the three splits held on the device,
the SGD and its schedule, and runs the epoch loop of ``Trainer.fit``: train
steps, the per-epoch mean of the finite losses, the ``--eval-step`` loss
lines and the per-epoch validation.  ``test`` evaluates the final
in-memory state.

Not ported yet (ROADMAP.md queue 1): checkpoints and ``version-{n}``
directories, TensorBoard, ``experiment.log``, ``hparams.yaml``, resume,
the event bus, the health watchdog (a skipped step is counted and logged,
never rolled back), supervision and the parity rail.
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from .._device import resolve_device
from ..data.augment import draw_crop_flip
from ..data.loader import DeviceSplit, get_datasets
from ..models import get_model
from ..utils.meters import AverageMeter
from ..utils.seed import fix_seed, step_generator
from .optim import configure_optimizers
from .step import COMPUTE_DTYPES, TrainStep, eval_totals

log = logging.getLogger(__name__)


def build_model(hparams, attn_impl: str = "auto") -> torch.nn.Module:
    """The zoo model of ``--model`` with fresh weights seeded by ``--seed``,
    on the CPU; ``attn_impl`` pins the attention implementation."""
    init_generator = fix_seed(hparams.seed)
    compute = COMPUTE_DTYPES[hparams.precision]
    model_kw: dict = {
        "dtype": compute,
        "norm_dtype": compute if hparams.bn_dtype == "compute" else torch.float32,
        "stem": hparams.stem,
        "remat": hparams.remat,
    }
    if hparams.model.startswith("vit"):
        model_kw["image_size"] = hparams.image_size
        if hparams.patch_size:
            model_kw["patch"] = hparams.patch_size
        model_kw["moe_dispatch"] = hparams.moe_dispatch
        model_kw["block_fusion"] = hparams.block_fusion
        model_kw["attn_impl"] = attn_impl
    model = get_model(hparams.model, **model_kw)
    model.init_weights(init_generator)
    return model


class Trainer:
    """Trains one run on one device (``--device``, the card by default).

    ``model`` (the JAX ``Trainer(hparams, model=...)``) is trained in place
    of :func:`build_model`'s, moved to the device: for example a zoo model
    with a pinned ``attn_impl``."""

    def __init__(self, hparams, model: torch.nn.Module | None = None) -> None:
        self.hparams = hparams
        if hparams.batch_size % hparams.grad_accum:
            raise ValueError(
                f"--batch-size {hparams.batch_size} does not split into "
                f"--grad-accum {hparams.grad_accum} micro-batches"
            )
        self.device = resolve_device(hparams.device)
        self.precision = hparams.precision
        self.model = (build_model(hparams) if model is None else model).to(self.device)
        trn, val, tst = get_datasets(hparams)
        self.train_split = DeviceSplit(*trn, self.device)
        self.val_split = DeviceSplit(*val, self.device)
        self.test_split = DeviceSplit(*tst, self.device)
        self.steps_per_epoch = self.train_split.steps_per_epoch(hparams.batch_size)
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"{len(self.train_split)} training examples make no whole batch "
                f"of {hparams.batch_size}"
            )
        self.optimizer, self.lr_schedule = configure_optimizers(
            hparams, self.steps_per_epoch, self.model.parameters()
        )
        self.step = TrainStep(
            self.model, self.optimizer, self.lr_schedule,
            precision=self.precision, grad_accum=hparams.grad_accum,
        )

    def train_epoch(self, epoch: int) -> dict:
        """One epoch of guarded steps; per-step metrics (with an MoE model's
        ``moe_*`` routing health) come back to the host once, at its end."""
        hp = self.hparams
        keys = ["loss", "top1_count", "grad_norm", "skipped"]
        metrics = []
        for i, (images, labels) in enumerate(
            self.train_split.epoch_batches(hp.batch_size, hp.seed, epoch)
        ):
            draws = draw_crop_flip(len(labels), step_generator(hp.seed, epoch, i))
            m = self.step(images, labels, draws)
            if i == 0:
                keys += sorted(k for k in m if k.startswith("moe_"))
            metrics.append(torch.stack([m[k].float() for k in keys]))
        out = dict(zip(keys, torch.stack(metrics).T.cpu().numpy()))
        out["top1"] = out.pop("top1_count")
        return out

    def fit(self) -> dict:
        """The epoch loop.  Returns per-epoch records (train loss over the
        finite steps, train and val accuracy, lr, steps, skipped steps,
        seconds, images/s, and for an MoE model the epoch means of
        ``moe_dropped_frac`` and ``moe_load_max``) under ``epochs``."""
        hp = self.hparams
        log.info(
            f"[TORCH] start training: {hp.epoch} epochs, {self.steps_per_epoch} "
            f"steps/epoch, global batch {hp.batch_size}, {self.device}, {self.precision}"
        )
        history = []
        for epoch in range(hp.epoch):
            t0 = time.perf_counter()
            out = self.train_epoch(epoch)
            epoch_time = time.perf_counter() - t0
            meter = AverageMeter()
            for i, loss in enumerate(out["loss"]):
                gstep = epoch * self.steps_per_epoch + i
                if np.isfinite(loss):
                    meter.update(float(loss))
                if (gstep + 1) % hp.eval_step == 0:
                    log.info(
                        f"[TORCH Epoch {epoch}] global step {gstep + 1}, "
                        f"train loss: {float(loss):.4f}"
                    )
            skipped = int(out["skipped"].sum())
            if skipped:
                log.warning(f"[TORCH Epoch {epoch}] {skipped} non-finite steps skipped")
            val = self.validate()
            # the JAX trainer's moe/* scalars: the epoch's mean routing health
            moe = {k: float(np.mean(v)) for k, v in out.items() if k.startswith("moe_")}
            imgs = len(out["loss"]) * hp.batch_size
            lr_now = self.lr_schedule(epoch * self.steps_per_epoch)
            record = {
                "epoch": epoch,
                "steps": len(out["loss"]),
                "skipped": skipped,
                "nonfinite_losses": int((~np.isfinite(out["loss"])).sum()),
                "train_loss": meter.avg,
                "train_acc": 100.0 * float(out["top1"].sum()) / imgs,
                **val,
                **moe,
                "lr": lr_now,
                "seconds": epoch_time,
                "images_per_s": imgs / epoch_time,
            }
            log.info(
                f"[TORCH Epoch {epoch}] train loss: {meter.avg:.4f}, "
                f"train acc: {record['train_acc']:.2f}%, val loss: {val['val_loss']:.4f}, "
                f"val acc: {val['val_acc']:.2f}%, lr: {lr_now:.4f}, "
                f"{record['images_per_s']:.0f} img/s"
            )
            if moe:
                log.info(
                    f"[TORCH Epoch {epoch}] moe: "
                    + ", ".join(f"{k[len('moe_'):]} {v:.4f}" for k, v in moe.items())
                )
            history.append(record)
        return {"epochs": history, "applied_steps": self.step.applied}

    def _evaluate(self, split: DeviceSplit) -> dict[str, float]:
        t = eval_totals(
            self.model, split.eval_batches(self.hparams.batch_size), precision=self.precision
        )
        count = t["count"] or math.nan
        return {
            "loss": t["loss_sum"] / count,
            "top1": 100.0 * t["top1_count"] / count,
            "top5": 100.0 * t["top5_count"] / count,
        }

    def validate(self) -> dict[str, float]:
        """Whole-validation-split loss and top-1 accuracy (%)."""
        out = self._evaluate(self.val_split)
        return {"val_loss": out["loss"], "val_acc": out["top1"]}

    def test(self) -> dict[str, float]:
        """Test-split loss and top-1/top-5 accuracy (%) of the current
        (final) state: no best checkpoint exists to load yet."""
        out = self._evaluate(self.test_split)
        log.info(
            f"[TORCH] test loss: {out['loss']:.4f}, test top-1 acc: {out['top1']:.2f}%, "
            f"top-5 acc: {out['top5']:.2f}%"
        )
        return {"test_loss": out["loss"], "test_top1": out["top1"], "test_top5": out["top5"]}
