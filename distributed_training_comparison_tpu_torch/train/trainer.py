"""The trainer (``distributed_training_comparison_tpu/train/trainer.py``).

``Trainer`` builds the model with the JAX package's ``model_kw`` (compute
dtype from ``--precision``/``--amp``, the norms' dtype from ``--bn-dtype``,
``--stem``, ``--remat``, and for a ViT the image and patch size, the MoE
dispatch and the block-fusion policy), the three splits (held on the
device; under ``--data-mode host`` the train split stays on the host and
streams through the staging ring of ``data/loader.py``, ``--workers``,
``--host-chunk-steps`` and ``--device-prefetch``), the SGD and its
schedule, and runs the epoch loop of ``Trainer.fit``: train
steps, the per-epoch mean of the finite losses, the ``--eval-step`` loss
lines and the per-epoch validation.  ``test`` evaluates the best
checkpoint.

Its files, as the JAX trainer's (``--ckpt-path``): a ``version-{n}`` run dir
claimed at construction, ``hparams.yaml``, ``experiment.log`` and the
TensorBoard scalars under ``tb/``; each epoch that improves the validation
accuracy a best-only checkpoint, and a resumable ``last.ckpt`` by
``--save-last``, ``--save-last-every`` and ``--save-last-min-secs`` (the
final epoch always saves), written behind the next epoch by
``train/async_ckpt.py`` from a device-side snapshot; ``--resume`` (a fresh
version dir) and ``--auto-resume`` (the newest run's dir, its verified
``last.ckpt``) restore the whole state into the live tensors before the
first capture (``train/state.py``, ``train/checkpoint.py``).

``fit`` trains through the step program (``train/step.py``): each epoch is
``EpochRunner.run_epoch``, each validation or test pass ``EvalRunner.run``;
on a card both replay CUDA graphs captured once, all of a trainer's graphs
in one memory pool, and the host fetches the stacked metrics once an epoch
and the totals once a pass.  The parameters, momentum and running
statistics are views into flat buffers from construction on
(``train/flat.py``).  ``Trainer.step``, the eager ``TrainStep`` on torch's
own SGD, shares the model, its buffers, the momentum and the applied-step
count with them: it is the eager yardstick, not part of ``fit``.

Data parallelism (``--backend dp``/``ddp``, as the JAX trainer on a mesh
whose data axis has several devices): the trainer runs in each process of
a process group (``parallel/dist.py``; a run of one process joins it
here), one card each.  The global batch must split into ``--grad-accum``
micro-batches over the processes, checked before any group work; every
process holds the whole train split (device mode) or streams its shard of
it (host mode), the BatchNorms reduce over the group
(``models/norms.py::sync_batch_norm_``), and the step program all-reduces
the gradients and metrics inside its captured step (``train/step.py``).
Process 0 alone writes the run's files, in the version dir it claims and
broadcasts (``checkpoint.agreed_version_dir``); ``--auto-resume``'s
discovery is broadcast and checked for agreement, ``--resume`` loads the
same file everywhere, and ``fit`` ends at a barrier.  ``vit_moe`` over
several processes raises: its capacity, drops and load-balance loss are
the global batch's in the JAX package (ROADMAP queue 1, item 6).

Not ported yet (ROADMAP.md queue 1): the event bus and its ``writer`` and
``epoch_end`` events, goodput and the ``goodput/*``, ``overlap/*`` and
``health/*`` scalars, the health watchdog (a skipped step is counted and
logged, never rolled back) and its preemption drain, supervision and the
parity rail.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..data.cifar100 import CIFAR100_MEAN, CIFAR100_STD, IMAGENET_MEAN, IMAGENET_STD
from ..data.loader import DeviceSplit, HostLoader, PrefetchLoader, StagingRing, get_datasets
from ..models import get_model, sync_batch_norm_
from ..parallel import dist as pdist
from ..parallel.mesh import make_mesh
from ..parallel.sharding import check_global_batch, host_local_batch_slice
from ..resilience.ckpt_io import read_and_hash, verify_checkpoint
from ..utils.logging import setup_logger
from ..utils.meters import AverageMeter
from ..utils.seed import fix_seed
from ..utils.tensorboard import SummaryWriter
from . import checkpoint as ckpt
from .async_ckpt import AsyncCheckpointer
from .optim import DeviceSGD, configure_optimizers, lr_table
from .state import TrainState
from .step import COMPUTE_DTYPES, EpochRunner, EvalRunner, TrainStep


class _NullWriter:
    """The TensorBoard writer of a process that is not process 0."""

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        pass

    def close(self) -> None:
        pass


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


def check_world(hparams, world: int) -> None:
    """Raise, before any process group work, unless a run of ``hparams``
    can train over ``world`` processes: its global batch splits over them
    (``parallel.sharding.check_global_batch``), and it is not ``vit_moe``
    over several (the JAX package routes over the global batch: capacity,
    drops, load-balance loss; per-process routing would train another
    model, ROADMAP queue 1, item 6)."""
    check_global_batch(hparams.batch_size, hparams.grad_accum, world)
    if world > 1 and hparams.model == "vit_moe":
        raise NotImplementedError(
            f"vit_moe over {world} processes routes over the global batch in the JAX package; "
            "the port's global routing statistics wait for ROADMAP queue 1, item 6")


def _join_group(hparams):
    """The process group of a ``dp``/``ddp`` run: the one this process is
    in, or, for a run of one local process, a new one joined here (local
    process 0), after :func:`check_world`."""
    check_world(hparams, dist.get_world_size() if dist.is_initialized()
                else pdist.world_size_of(hparams))
    if dist.is_initialized():
        return dist.group.WORLD
    if pdist.local_world_size(hparams) > 1:
        raise RuntimeError("a run of several local processes starts them through "
                           "entry.run (python -m distributed_training_comparison_tpu_torch)")
    return pdist.init_distributed(hparams, 0)


class Trainer:
    """Trains one run on one device (``--device``, the card by default),
    or, under ``--backend dp``/``ddp``, this process's part of a run over a
    process group (module docstring).

    ``model`` (the JAX ``Trainer(hparams, model=...)``) is trained in place
    of :func:`build_model`'s, moved to the device: for example a zoo model
    with a pinned ``attn_impl``.  Construction claims the run dir (or, under
    ``--auto-resume``, takes the newest run's) and restores ``--resume``'s
    state; ``close()`` ends the run's writers."""

    def __init__(self, hparams, model: torch.nn.Module | None = None) -> None:
        self.hparams = hparams
        self.backend = getattr(hparams, "backend", "single")
        if hparams.batch_size % hparams.grad_accum:
            raise ValueError(
                f"--batch-size {hparams.batch_size} does not split into "
                f"--grad-accum {hparams.grad_accum} micro-batches"
            )
        self.group = None if self.backend == "single" else _join_group(hparams)
        self.rank, self.world = ((0, 1) if self.group is None
                                 else (pdist.process_index(), pdist.process_count()))
        self.is_main = self.rank == 0
        self.mesh = make_mesh(self.world, getattr(hparams, "model_parallel", 1),
                              getattr(hparams, "pipeline_parallel", 1), backend=self.backend)
        self.device = resolve_device(
            hparams.device, None if self.group is None else pdist.local_rank())
        self.precision = hparams.precision
        self.model = (build_model(hparams) if model is None else model).to(self.device)
        if self.world > 1:
            sync_batch_norm_(self.model, self.group)
        local_batch = host_local_batch_slice(hparams.batch_size, self.mesh.shape["data"])
        trn, val, tst = get_datasets(hparams)
        self.data_mode = getattr(hparams, "data_mode", "device")
        self.steps_per_epoch = len(trn[1]) // hparams.batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"{len(trn[1])} training examples make no whole batch "
                f"of {hparams.batch_size}"
            )
        self.train_split: DeviceSplit | None = None
        self.train_loader = None
        if self.data_mode == "device":
            self.train_split = source = DeviceSplit(*trn, self.device)
        else:
            # the train split streams from the host; --workers 0 assembles
            # batches on the staging thread itself, --device-prefetch 0
            # stages on the caller's
            loader = HostLoader(*trn, local_batch, shuffle=True, drop_last=True,
                                seed=hparams.seed, num_shards=self.world, shard=self.rank)
            workers = getattr(hparams, "workers", 4)
            self.train_loader = PrefetchLoader(loader, depth=workers) if workers > 0 else loader
            source = StagingRing(
                self.train_loader, local_batch, self.steps_per_epoch, trn[0].shape[1:],
                chunk_steps=max(1, getattr(hparams, "host_chunk_steps", 32)),
                depth=int(getattr(hparams, "device_prefetch", 2)), device=self.device,
            )
        self.val_split = DeviceSplit(*val, self.device)
        self.test_split = DeviceSplit(*tst, self.device)
        self.optimizer, self.lr_schedule = configure_optimizers(
            hparams, self.steps_per_epoch, self.model.parameters()
        )
        # the step program: the parameters and momentum in flat buffers, the
        # LR and the applied-step count on the device, one graph memory pool
        # for the train and eval graphs
        self.sgd = DeviceSGD(self.optimizer, lr_table(
            self.lr_schedule, hparams.epoch * self.steps_per_epoch, self.device))
        self.step = TrainStep(
            self.model, self.optimizer, self.lr_schedule, precision=self.precision,
            grad_accum=hparams.grad_accum, counter=self.sgd.applied, group=self.group,
        )
        self.graph_pool = (torch.cuda.graph_pool_handle() if self.device.type == "cuda"
                           else None)
        self.runner = EpochRunner(
            self.model, self.sgd, source, hparams.batch_size, seed=hparams.seed,
            precision=self.precision, grad_accum=hparams.grad_accum, pool=self.graph_pool,
            group=self.group,
        )
        self.eval_runners: dict[str, EvalRunner] = {}
        self.eval_counts: dict[str, int] = {}  # examples the last pass of each split counted
        self.state = TrainState(self.model, self.sgd)
        self._open_run_dir()

    def _open_run_dir(self) -> None:
        """The JAX trainer's run-dir wiring: the writer thread, the version
        dir, TensorBoard, ``hparams.yaml``, the logger, and the restore of
        ``--resume`` (or of the newest run, under ``--auto-resume``)."""
        hp = self.hparams
        self.ckpt_writer = AsyncCheckpointer() if self.is_main else None
        self._last_resume_save = float("-inf")
        # -1 so that the first validation always writes a best checkpoint,
        # even at 0.0% accuracy
        self.best_acc = -1.0
        self.start_epoch = 0
        self.test_checkpoint: Path | None = None
        # --auto-resume continues the newest run in place (its version dir,
        # its verified last.ckpt); an explicit --resume wins, and runs in a
        # fresh version dir, so that it never writes over its source run
        auto_resumed = False
        resume_bytes = None  # one read serves verify and restore
        if hp.auto_resume and not hp.resume:
            hit = ckpt.find_valid_resume_bytes(hp.ckpt_path)
            if hit is not None:
                hp.resume = str(hit[0])
                resume_bytes = hit[1]
                auto_resumed = True
        if self.world > 1:
            # every process must take the same branch: process 0's discovery
            # is broadcast, and another one raises (--ckpt-path is shared)
            mine = [hp.resume if auto_resumed else None]
            first = list(mine)
            dist.broadcast_object_list(first, src=0, group=self.group)
            if first != mine:
                raise RuntimeError(
                    f"--auto-resume discovery disagrees across processes (process 0: "
                    f"{first[0]}, process {self.rank}: {mine[0]}); --ckpt-path must be a "
                    "filesystem every process shares")
        self.version_dir = (Path(hp.resume).parent if auto_resumed
                            else ckpt.agreed_version_dir(hp.ckpt_path, self.group))
        self.version = int(self.version_dir.name.split("-")[1])
        self.writer = SummaryWriter(self.version_dir / "tb") if self.is_main else _NullWriter()
        if self.is_main:
            self._dump_hparams()
        self.logger = setup_logger(self.version_dir if self.is_main else None,
                                   is_main_process=self.is_main)
        if hp.resume:
            if resume_bytes is None:
                resume_bytes, digest = read_and_hash(hp.resume)
                ok, reason = verify_checkpoint(hp.resume, data=resume_bytes, digest=digest)
                if not ok:
                    raise ValueError(f"refusing to resume from {hp.resume}: {reason}")
            _, self.start_epoch, self.best_acc = ckpt.load_resume_state(
                hp.resume, self.state, raw_bytes=resume_bytes)
            self.logger.info(
                f"Resumed from {hp.resume} at epoch {self.start_epoch} "
                f"(best acc {self.best_acc:.4f})"
            )

    def _dump_hparams(self) -> None:
        """``hparams.yaml`` (reference ``src/single/trainer.py:70-73``), as
        the JAX trainer writes it: ``key: value`` lines when ``yaml`` is
        missing."""
        items = sorted(vars(self.hparams).items())
        try:
            import yaml

            text = yaml.safe_dump({k: v for k, v in items})
        except ImportError:
            text = "".join(f"{k}: {v}\n" for k, v in items)
        (self.version_dir / "hparams.yaml").write_text(text)

    def train_epoch(self, epoch: int) -> dict:
        """One epoch of guarded steps through the step program; per-step
        metrics (with an MoE model's ``moe_*`` routing health) come back to
        the host once, at its end."""
        out = self.runner.run_epoch(epoch)
        out["top1"] = out.pop("top1_count")
        return out

    def fit(self) -> dict:
        """The epoch loop, from ``start_epoch``.  Returns per-epoch records
        (train loss over the finite steps, train and val accuracy, lr,
        steps, skipped steps, seconds, images/s, and for an MoE model the
        epoch means of ``moe_dropped_frac`` and ``moe_load_max``) under
        ``epochs``, the applied-step count, the version and the best
        validation accuracy."""
        hp = self.hparams
        tag = f"[{self.backend.upper()} Version {self.version}"
        t_start = time.perf_counter()
        self.logger.info(
            f"{tag}] start training: epochs {self.start_epoch}..{hp.epoch - 1}, "
            f"{self.steps_per_epoch} steps/epoch, global batch {hp.batch_size}, "
            f"{self.device}, {self.precision}, {self.world} process(es)"
        )
        history = []
        for epoch in range(self.start_epoch, hp.epoch):
            t0 = time.perf_counter()
            out = self.train_epoch(epoch)
            epoch_time = time.perf_counter() - t0
            meter = AverageMeter()
            for i, loss in enumerate(out["loss"]):
                gstep = epoch * self.steps_per_epoch + i
                if np.isfinite(loss):
                    meter.update(float(loss))
                if (gstep + 1) % hp.eval_step == 0:
                    self.logger.info(
                        f"{tag} Epoch {epoch}] global step {gstep + 1}, "
                        f"train loss: {float(loss):.4f}"
                    )
                if hp.log_every_step:
                    self.writer.add_scalar("loss/step", float(loss), gstep)
            skipped = int(out["skipped"].sum())
            if skipped:
                self.logger.warning(f"{tag} Epoch {epoch}] {skipped} non-finite steps skipped")
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
            self.logger.info(
                f"{tag} Epoch {epoch}] train loss: {meter.avg:.4f}, "
                f"train acc: {record['train_acc']:.2f}%, val loss: {val['val_loss']:.4f}, "
                f"val acc: {val['val_acc']:.2f}%, lr: {lr_now:.4f}, "
                f"{record['images_per_s']:.0f} img/s"
            )
            self.writer.add_scalar("lr", lr_now, epoch)
            self.writer.add_scalar("loss/epoch/train", meter.avg, epoch)
            self.writer.add_scalar("loss/epoch/val", val["val_loss"], epoch)
            self.writer.add_scalar("acc/epoch/val", val["val_acc"], epoch)
            self.writer.add_scalar("throughput/images_per_sec", record["images_per_s"], epoch)
            for k, v in moe.items():
                self.writer.add_scalar(f"moe/{k[len('moe_'):]}", v, epoch)
            if moe:
                self.logger.info(
                    f"{tag} Epoch {epoch}] moe: "
                    + ", ".join(f"{k[len('moe_'):]} {v:.4f}" for k, v in moe.items())
                )
            record.update(self._save(epoch, val["val_acc"]))
            history.append(record)
        if self.ckpt_writer is not None:
            self.ckpt_writer.wait()
        if self.group is not None:  # no process leaves while another is in a collective
            dist.barrier(group=self.group)
        self.logger.info(
            f"{tag}] done in {time.perf_counter() - t_start:.1f}s, "
            f"best val acc {self.best_acc:.2f}%"
        )
        return {"epochs": history, "applied_steps": int(self.sgd.applied),
                "version": self.version, "best_acc": self.best_acc}

    def _save(self, epoch: int, val_acc: float) -> dict:
        """The JAX trainer's checkpoint decisions at the end of ``epoch``:
        a best file when ``val_acc`` beats the best so far; ``last.ckpt``
        under ``--save-last`` on the final epoch, or on every
        ``--save-last-every``-th epoch unless one was written within
        ``--save-last-min-secs``.  Either takes one device-side snapshot,
        handed to the writer thread.  Returns what was submitted."""
        hp = self.hparams
        want_best = val_acc > self.best_acc
        if want_best:
            self.best_acc = val_acc
        due = (epoch + 1) % hp.save_last_every == 0
        throttled = time.monotonic() - self._last_resume_save < (hp.save_last_min_secs or 0.0)
        want_last = hp.save_last and (epoch == hp.epoch - 1 or (due and not throttled))
        vdir = self.version_dir
        if want_last:
            self._last_resume_save = time.monotonic()
        if not self.is_main:  # the same decisions; process 0 writes
            return {"saved_best": want_best, "saved_last": bool(want_last)}
        if want_best or want_last:
            snap = self.state.snapshot()
        if want_best:
            self.ckpt_writer.submit(
                lambda s=snap, e=epoch, b=self.best_acc: ckpt.save_checkpoint(vdir, s, e, b),
                key="best",
            )
        if want_last:
            self.ckpt_writer.submit(
                lambda s=snap, e=epoch, b=self.best_acc: ckpt.save_resume_state(vdir, s, e, b),
                key="last",
            )
        wstats = self.ckpt_writer.stats()
        self.writer.add_scalar("ckpt/writer_busy_frac", wstats["busy_frac"], epoch)
        self.writer.add_scalar("ckpt/queue_depth", wstats["queue_depth"], epoch)
        return {"saved_best": want_best, "saved_last": bool(want_last)}

    def _evaluate(self, name: str, split: DeviceSplit) -> dict[str, float]:
        if name not in self.eval_runners:
            legacy = name == "test" and getattr(self.hparams, "legacy_test_stats", False)
            self.eval_runners[name] = EvalRunner(
                self.model, split, self.hparams.batch_size, precision=self.precision,
                pool=self.graph_pool, group=self.group,
                stats=(IMAGENET_MEAN, IMAGENET_STD) if legacy else (CIFAR100_MEAN, CIFAR100_STD),
            )
        t = self.eval_runners[name].run()
        self.eval_counts[name] = int(t["count"])
        count = t["count"] or math.nan
        return {
            "loss": t["loss_sum"] / count,
            "top1": 100.0 * t["top1_count"] / count,
            "top5": 100.0 * t["top5_count"] / count,
        }

    def validate(self) -> dict[str, float]:
        """Whole-validation-split loss and top-1 accuracy (%)."""
        out = self._evaluate("val", self.val_split)
        return {"val_loss": out["loss"], "val_acc": out["top1"]}

    def test(self) -> dict[str, float]:
        """Test-split loss and top-1/top-5 accuracy (%) of the run's best
        checkpoint, as the reference's test phase globs and loads it
        (``src/single/main.py:22-28``): pending writes are drained, the best
        file's weights copied into the model (``test_checkpoint`` names it);
        with no best file the in-memory state is tested.  Over several
        processes each loads process 0's best file, once its writes are
        done.  ``--legacy-test-stats`` normalizes by ImageNet's statistics."""
        if self.ckpt_writer is not None:
            self.ckpt_writer.wait()
        best = ckpt.find_best_checkpoint(self.version_dir) if self.is_main else None
        if self.world > 1:  # process 0's pick, after its writes
            pick = [None if best is None else best.name]
            dist.broadcast_object_list(pick, src=0, group=self.group)
            best = None if pick[0] is None else self.version_dir / pick[0]
        if best is not None:
            self.logger.info(f"Loading best checkpoint: {best.name}")
            ckpt.load_checkpoint(best, self.state)
        self.test_checkpoint = best
        out = self._evaluate("test", self.test_split)
        self.logger.info(
            f"[{self.backend.upper()} Version {self.version}] test loss: {out['loss']:.4f}, "
            f"test top-1 acc: {out['top1']:.2f}%, top-5 acc: {out['top5']:.2f}%"
        )
        return {"test_loss": out["loss"], "test_top1": out["top1"], "test_top5": out["top5"]}

    def close(self) -> None:
        """Stop the host loader's threads, drain and stop the checkpoint
        writer (a failed write raises here) and close the TensorBoard file."""
        try:
            if self.ckpt_writer is not None:
                self.ckpt_writer.close()
        finally:
            self.runner.close()
            self.writer.close()
