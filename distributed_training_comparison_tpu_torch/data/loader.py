"""Datasets, the device-resident split and the streaming host loader
(``distributed_training_comparison_tpu/data/loader.py``).

``get_datasets`` builds (train, valid, test) with the reference's 90/10
split; the test split of ``--synthetic-data`` is seeded ``seed + 1`` with
the train split's class anchors.  Both ``--data-mode``s take one batch
order, the host loader's numpy ``(seed, epoch)`` shuffle with
``drop_last``, so the two modes train on the same batches, byte for byte
the JAX package's host data mode's.

- ``--data-mode device``: ``DeviceSplit`` holds a split on the device;
  eval batches cover every example once, the last batch padded with zero
  weights.
- ``--data-mode host``: the train split stays in host memory.
  :class:`HostLoader` yields its numpy batches, :class:`PrefetchLoader`
  assembles them on a background thread ``--workers`` deep,
  :func:`chunked_batches` stacks ``--host-chunk-steps`` of them into a
  chunk, and :class:`StagingRing` copies each chunk into one slot of a
  static device ring of ``--device-prefetch`` slots, on a stream of its
  own from pinned memory on a card, where the step program's captured
  step reads it (``train/step.py::EpochRunner``).  The JAX package's
  ``DevicePrefetcher`` is the ring's counterpart.  Sharding across hosts
  and the quarantine of corrupt examples are not ported yet.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch

from ..utils.graphs import CAPTURE_LOCK
from .cifar100 import load_cifar100
from .sampler import epoch_permutation, train_val_split
from .synthetic import synthetic_dataset


def _raw_split(hparams, split: str) -> tuple[np.ndarray, np.ndarray]:
    limit = hparams.limit_examples
    if hparams.synthetic_data:
        n = 50_000 if split == "train" else 10_000
        if limit:
            n = min(n, limit)
        size = hparams.image_size or 32
        return synthetic_dataset(
            n,
            num_classes=100,
            image_shape=(size, size, 3),
            seed=hparams.seed + (split == "test"),
            anchor_seed=hparams.seed,
            noise=hparams.synthetic_noise,
        )
    if hparams.image_size not in (0, 32):
        raise ValueError(
            "--image-size applies only to --synthetic-data "
            "(CIFAR-100 images are 32x32)"
        )
    if hparams.dset != "cifar100":
        raise ValueError(f"unknown dataset {hparams.dset!r}")
    images, labels = load_cifar100(hparams.dpath, split)
    if limit:
        images, labels = images[:limit], labels[:limit]
    return images, labels


Split = tuple[np.ndarray, np.ndarray]


def get_datasets(hparams) -> tuple[Split, Split, Split]:
    """(train, valid, test) as ``(images u8 NHWC, labels i32)`` pairs."""
    images, labels = _raw_split(hparams, "train")
    trn_idx, val_idx = train_val_split(len(images), valid_size=0.1, seed=hparams.seed)
    return (
        (images[trn_idx], labels[trn_idx]),
        (images[val_idx], labels[val_idx]),
        _raw_split(hparams, "test"),
    )


class DeviceSplit:
    """A split held on ``device``: uint8 NHWC images and int64 labels,
    uploaded once."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, device) -> None:
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        self.labels = torch.from_numpy(np.asarray(labels, dtype=np.int64)).to(device)

    def __len__(self) -> int:
        return len(self.labels)

    def steps_per_epoch(self, batch_size: int) -> int:
        return len(self) // batch_size

    def epoch_batches(
        self, batch_size: int, seed: int, epoch: int
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """The epoch's training batches: the ``(seed, epoch)`` permutation,
        cut into whole batches (the last partial batch is dropped)."""
        steps = self.steps_per_epoch(batch_size)
        perm = epoch_permutation(len(self), seed, epoch)[: steps * batch_size]
        rows = torch.from_numpy(perm).to(self.labels.device).view(steps, batch_size)
        for idx in rows:
            yield self.images[idx], self.labels[idx]

    def eval_batches(
        self, batch_size: int
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Fixed-shape batches covering every example once, in order, with
        per-example weights: the last batch is padded with copies of the
        first example at weight 0 (``train/trainer.py::_pad_batches``)."""
        n = len(self)
        for start in range(0, n, batch_size):
            idx = torch.arange(start, start + batch_size, device=self.labels.device)
            weights = (idx < n).float()
            idx = torch.where(idx < n, idx, 0)
            yield self.images[idx], self.labels[idx], weights


class HostLoader:
    """Streaming numpy batch iterator with an epoch reshuffle (the JAX
    ``HostLoader`` on one host): call ``set_epoch`` before each pass for
    the ``(seed, epoch)`` shuffle (``sampler.epoch_permutation``)."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 42,
    ) -> None:
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if self.shuffle:
            return epoch_permutation(len(self.labels), self.seed, self.epoch)
        return np.arange(len(self.labels))

    def __len__(self) -> int:
        n = len(self.labels)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        end = (len(idx) // self.batch_size) * self.batch_size if self.drop_last else len(idx)
        for start in range(0, end, self.batch_size):
            b = idx[start : start + self.batch_size]
            yield self.images[b], self.labels[b]


_DONE = object()


def _get(q: queue.Queue, thread: threading.Thread | None, what: str):
    """The next item of ``q``, polling ``thread``'s liveness so that a
    producer that died without a word raises instead of hanging."""
    while True:
        try:
            return q.get(timeout=1.0)
        except queue.Empty:
            if thread is not None and not thread.is_alive() and q.empty():
                raise RuntimeError(f"the {what} producer thread died without signaling "
                                   "completion or an exception") from None


def _join(thread: threading.Thread | None, what: str) -> None:
    if thread is not None:
        thread.join(timeout=10.0)
        if thread.is_alive():  # pragma: no cover - diagnostic path
            raise RuntimeError(f"the {what} producer thread failed to stop within 10 s")


class PrefetchLoader:
    """A background thread that assembles an epoch-aware loader's batches
    ``depth`` ahead (the JAX ``PrefetchLoader``, the reference's
    ``DataLoader(num_workers=4)``): the same batches in the same order.  A
    producer exception is raised at the ``next()`` that would have
    received the failed batch; ``close()`` (also the iterator's cleanup)
    signals the producer, drains the queue and joins the thread."""

    def __init__(self, loader, depth: int = 2) -> None:
        self.loader = loader
        self.depth = max(1, depth)
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self._queue: queue.Queue | None = None

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    @staticmethod
    def _shutdown(stop, q, thread) -> None:
        if stop is not None:
            stop.set()
        if q is not None:
            with contextlib.suppress(queue.Empty):
                while True:
                    q.get_nowait()
        _join(thread, "PrefetchLoader")

    def close(self) -> None:
        """Stop the current epoch's producer, if any: signal, drain, join."""
        stop, thread, q = self._stop, self._thread, self._queue
        self._stop = self._thread = self._queue = None
        self._shutdown(stop, q, thread)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        self.close()  # a fresh epoch supersedes an abandoned producer
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for item in self.loader:
                    if not put(item):
                        return
                put(_DONE)
            except BaseException as e:  # raised at the consumer
                put(e)

        thread = threading.Thread(target=produce, name="dtc-prefetch", daemon=True)
        self._stop, self._thread, self._queue = stop, thread, q
        thread.start()
        try:
            while True:
                item = _get(q, thread, "PrefetchLoader")
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            if self._thread is thread:
                self._stop = self._thread = self._queue = None
            self._shutdown(stop, q, thread)


def chunked_batches(
    batches: Iterator[tuple[np.ndarray, np.ndarray]],
    total_steps: int,
    chunk_steps: int,
    start: int = 0,
) -> Iterator[tuple[int, int, dict[str, np.ndarray]]]:
    """Stack a batch iterator into ``(start, take, {"x", "y"})`` chunks of
    at most ``chunk_steps`` steps covering steps ``[start, total_steps)``
    (the JAX ``chunked_batches``); a source that runs dry yields its
    partial chunk and ends."""
    done = start
    while done < total_steps:
        take = min(chunk_steps, total_steps - done)
        xs, ys = [], []
        for _ in range(take):
            try:
                x, y = next(batches)
            except StopIteration:
                break
            xs.append(x)
            ys.append(y)
        if not xs:
            return
        yield done, len(xs), {"x": np.stack(xs), "y": np.stack(ys)}
        done += len(xs)
        if len(xs) < take:
            return


class StagingRing:
    """The host data mode's batch source for the step program: a static
    device ring of ``depth`` slots (one when ``depth`` is 0) of
    ``chunk_steps`` batches each, filled chunk by chunk from ``loader``'s
    epoch (``chunked_batches``), and read by the captured step at a slot
    and row computed on the device from the step of the epoch
    (:meth:`batch`), so that one graph serves every chunk.

    ``depth > 0`` stages on a background thread: each chunk is stacked on
    the host, copied into the slot's pinned buffer, and copied host to
    device on a stream of its own.  Events order each copy after the last
    replay that read its slot (``free``, recorded by :meth:`after_step`) and
    each chunk's first step after its copy (``filled``, waited on by
    :meth:`before_step`); a semaphore of ``depth`` keeps the thread at most
    that many chunks ahead.  ``depth`` 0 stages each chunk on the caller's
    thread before its first step.  On the CPU there is no pinned memory and
    no stream: the same ring is filled by plain copies.

    A producer error is raised at the consumer's :meth:`before_step`;
    :meth:`end_epoch` and :meth:`close` stop and join the thread.  The
    thread's CUDA calls hold ``utils.graphs.CAPTURE_LOCK``, which every
    capture holds (a global-mode capture forbids another thread's unsafe
    CUDA calls)."""

    def __init__(
        self,
        loader,
        batch_size: int,
        steps: int,
        image_shape: tuple[int, ...],
        *,
        chunk_steps: int,
        depth: int,
        device,
    ) -> None:
        if steps < 1 or chunk_steps < 1 or depth < 0:
            raise ValueError(f"a ring of {steps} steps, chunks of {chunk_steps}, depth {depth}")
        self.loader, self.batch_size, self.steps = loader, batch_size, steps
        self.chunk = min(chunk_steps, steps)
        self.slots = max(1, depth)
        self.threaded = depth > 0
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        rows = self.slots * self.chunk
        self.images = torch.zeros((rows, batch_size, *image_shape), dtype=torch.uint8,
                                  device=self.device)
        self.labels = torch.zeros((rows, batch_size), dtype=torch.int64, device=self.device)
        self.chunks_staged = 0
        self.wait_seconds = 0.0  # the consumer's time blocked on a chunk (JAX's h2d_wait)
        if self.cuda:
            self.pinned = [(torch.empty((self.chunk, batch_size, *image_shape), dtype=torch.uint8,
                                        pin_memory=True),
                            torch.empty((self.chunk, batch_size), dtype=torch.int64,
                                        pin_memory=True)) for _ in range(self.slots)]
            self.stream = torch.cuda.Stream(device=self.device)
            self.filled = [torch.cuda.Event() for _ in range(self.slots)]
            self.free = [torch.cuda.Event() for _ in range(self.slots)]
        # (chunks, queue, stop, slot semaphore, thread, batch iterator)
        self._epoch: tuple | None = None

    def nbytes(self) -> int:
        """The ring's device bytes."""
        return (self.images.numel() * self.images.element_size()
                + self.labels.numel() * self.labels.element_size())

    def batch(self, i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Step ``i``'s batch (``i`` a ``(1,)`` int64 device tensor): row
        ``i mod chunk`` of slot ``(i div chunk) mod slots``, gathered on the
        device (capturable)."""
        c = torch.div(i, self.chunk, rounding_mode="floor")
        j = torch.remainder(c, self.slots) * self.chunk + torch.remainder(i, self.chunk)
        return self.images.index_select(0, j)[0], self.labels.index_select(0, j)[0]

    def start_epoch(self, epoch: int) -> None:
        """Begin staging ``epoch``'s chunks (the previous epoch's producer
        is stopped first)."""
        self.end_epoch()
        self.loader.set_epoch(epoch)
        batches = iter(self.loader)
        chunks = chunked_batches(batches, self.steps, self.chunk)
        q: queue.Queue = queue.Queue()
        stop, free = threading.Event(), threading.Semaphore(self.slots)
        thread = None
        if self.threaded:
            thread = threading.Thread(target=self._produce, args=(chunks, q, stop, free),
                                      name="dtc-staging", daemon=True)
        self._epoch = (chunks, q, stop, free, thread, batches)
        if thread is not None:
            thread.start()

    def _produce(self, chunks, q, stop, free) -> None:
        try:
            for start, take, host in chunks:
                if not self._stage(start // self.chunk, take, host, stop, free):
                    return
                q.put((start // self.chunk, take))
        except BaseException as e:  # raised at the consumer
            q.put(e)
        finally:
            chunks.close()

    def _stage(self, c: int, take: int, host: dict, stop, free) -> bool:
        """Copy chunk ``c`` into its slot once the slot is free; False if
        stopped first."""
        while not free.acquire(timeout=0.1):
            if stop.is_set():
                return False
        slot = c % self.slots
        rows = slice(slot * self.chunk, slot * self.chunk + take)
        x, y = torch.from_numpy(host["x"]), torch.from_numpy(host["y"])
        if not self.cuda:
            self.images[rows].copy_(x)
            self.labels[rows].copy_(y)
        else:
            px, py = self.pinned[slot]
            with CAPTURE_LOCK:  # the last copy out of this slot's pinned buffers is done
                self.filled[slot].synchronize()
            px[:take].copy_(x)
            py[:take].copy_(y)
            with CAPTURE_LOCK, torch.cuda.device(self.device), torch.cuda.stream(self.stream):
                self.stream.wait_event(self.free[slot])
                self.images[rows].copy_(px[:take], non_blocking=True)
                self.labels[rows].copy_(py[:take], non_blocking=True)
                self.filled[slot].record(self.stream)
        self.chunks_staged += 1
        return True

    def before_step(self, k: int) -> None:
        """Before step ``k`` of the epoch: at a chunk's first step, wait
        for the chunk (staging it here when unthreaded), and on a card make
        the current stream wait on its copy."""
        if k % self.chunk:
            return
        if self._epoch is None:
            raise RuntimeError("before_step outside an epoch: call start_epoch first")
        chunks, q, stop, free, thread, _ = self._epoch
        t0 = time.perf_counter()
        if thread is None:
            try:
                start, take, host = next(chunks)
            except StopIteration:
                raise RuntimeError(f"the loader ran dry before step {k}") from None
            self._stage(start // self.chunk, take, host, stop, free)
            q.put((start // self.chunk, take))
        item = _get(q, thread, "StagingRing")
        self.wait_seconds += time.perf_counter() - t0
        if isinstance(item, BaseException):
            self.end_epoch()
            raise item
        c, _ = item
        if c != k // self.chunk:
            raise RuntimeError(f"chunk {c} staged for step {k}")
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(self.filled[c % self.slots])

    def after_step(self, k: int) -> None:
        """After step ``k`` was launched: at a chunk's last step, free its
        slot once the device has run it."""
        if (k + 1) % self.chunk and k + 1 != self.steps:
            return
        if self._epoch is None:
            return
        if self.cuda:
            self.free[(k // self.chunk) % self.slots].record(torch.cuda.current_stream(self.device))
        self._epoch[3].release()

    def end_epoch(self) -> None:
        """Stop and join the epoch's producer (it has finished after a
        whole epoch) and close its chunk iterator."""
        if self._epoch is None:
            return
        chunks, q, stop, _, thread, batches = self._epoch
        self._epoch = None
        stop.set()
        _join(thread, "StagingRing")
        chunks.close()
        if hasattr(batches, "close"):  # a PrefetchLoader's epoch joins its thread
            batches.close()
        with contextlib.suppress(queue.Empty):
            while True:
                q.get_nowait()

    def close(self) -> None:
        """End the epoch, the loader's thread, and the copies in flight."""
        self.end_epoch()
        close = getattr(self.loader, "close", None)
        if close is not None:
            close()
        if self.cuda:
            self.stream.synchronize()
