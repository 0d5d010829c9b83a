"""The host data mode (``--data-mode host``), on the CPU.

The port's ``HostLoader``, ``PrefetchLoader`` and ``chunked_batches``
against the JAX package's, a producer's error at the consumer, the
``StagingRing`` that the step program reads, a host-mode ``Trainer.fit``
against a device-mode one bit for bit, and the four flags of the mode
against the JAX parser.  On the CPU the ring is filled by plain copies
(no pinned memory, no stream): the same slots, the same order.
"""

import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.config import load_config as jax_load_config
from distributed_training_comparison_tpu.data.loader import DeviceDataset
from distributed_training_comparison_tpu.data.loader import HostLoader as JaxHostLoader
from distributed_training_comparison_tpu.data.loader import (
    chunked_batches as jax_chunked_batches,
)
from distributed_training_comparison_tpu_torch import config as port_config
from distributed_training_comparison_tpu_torch.data import synthetic_dataset
from distributed_training_comparison_tpu_torch.data.loader import (
    HostLoader,
    PrefetchLoader,
    StagingRing,
    chunked_batches,
)
from distributed_training_comparison_tpu_torch.train import Trainer

FIT = ["--device", "cpu", "--synthetic-data", "--image-size", "16", "--limit-examples", "40",
       "--batch-size", "8", "--epoch", "2", "--lr", "0.01"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One thread for the port's convolutions: the suite runs files in
    parallel worker processes, where a thread per core in each worker
    oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=37, size=8):
    return synthetic_dataset(n, image_shape=(size, size, 3), seed=2)


@pytest.mark.parametrize("drop_last", [True, False])
def test_host_loader_yields_the_jax_batches_byte_for_byte(drop_last):
    """Two epochs of batches of 8 over 37 examples, shuffled by
    ``(seed, epoch)``: the port's loader and the JAX loader (one shard)
    yield the same arrays, dtypes and lengths."""
    images, labels = _data()
    port = HostLoader(images, labels, 8, shuffle=True, drop_last=drop_last, seed=5)
    jax = JaxHostLoader(DeviceDataset(images, labels), 8, shuffle=True, drop_last=drop_last,
                        seed=5, num_shards=1, shard=0)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        got, want = list(port), list(jax)
        assert len(got) == len(want) == len(port) == len(jax)
        for (x, y), (wx, wy) in zip(got, want):
            assert x.dtype == wx.dtype and y.dtype == wy.dtype
            assert x.tobytes() == wx.tobytes() and y.tobytes() == wy.tobytes()
    port.set_epoch(0)
    first = [y for _, y in port]
    port.set_epoch(1)
    assert any(not np.array_equal(a, b) for a, b in zip(first, (y for _, y in port)))


@pytest.mark.parametrize("total,chunk,start", [(9, 4, 0), (9, 3, 0), (9, 4, 2), (12, 32, 0)])
def test_chunked_batches_equal_the_jax_chunks(total, chunk, start):
    """The same batch stream through both ``chunked_batches``: the same
    ``(start, take)`` boundaries, a partial last chunk where ``chunk`` does
    not divide the steps, and the same stacked bytes; a source that runs
    dry (the last case, 12 steps asked of 9 batches) yields its partial
    chunk and ends."""
    images, labels = _data(n=72)
    loader = HostLoader(images, labels, 8, drop_last=True, seed=1)
    port = list(chunked_batches(iter(loader), total, chunk, start))
    want = list(jax_chunked_batches(iter(loader), total, chunk, start))
    assert [(s, t) for s, t, _ in port] == [(s, t) for s, t, _ in want]
    assert port[-1][1] < chunk or (total - start) % chunk == 0
    for (_, _, got), (_, _, ref) in zip(port, want):
        assert got.keys() == ref.keys() == {"x", "y"}
        assert all(got[k].tobytes() == ref[k].tobytes() and got[k].shape == ref[k].shape
                   for k in got)


class _Failing:
    """A loader whose third batch raises."""

    def __init__(self, images, labels) -> None:
        self.inner = HostLoader(images, labels, 4, drop_last=True)

    def set_epoch(self, epoch) -> None:
        self.inner.set_epoch(epoch)

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if i == 2:
                raise OSError("the third batch's read failed")
            yield batch


def test_a_producer_error_is_raised_at_the_consumer_and_close_joins():
    """A loader that fails at its third batch: ``PrefetchLoader`` yields the
    first two batches and raises the loader's own error at the next
    ``next()``; the ring raises it at the chunk that needed the batch.
    ``close()`` joins every thread (none is left alive), and a prefetched
    epoch abandoned halfway is closed as well."""
    images, labels = _data(n=40)
    prefetch = PrefetchLoader(_Failing(images, labels), depth=2)
    it = iter(prefetch)
    next(it), next(it)
    with pytest.raises(OSError, match="third batch"):
        next(it)
    prefetch.close()
    assert prefetch._thread is None

    ring = StagingRing(PrefetchLoader(_Failing(images, labels), depth=1), 4, 10, images.shape[1:],
                       chunk_steps=2, depth=2, device="cpu")
    ring.start_epoch(0)
    thread = ring._epoch[4]
    ring.before_step(0)
    ring.after_step(0)
    ring.after_step(1)
    with pytest.raises(OSError, match="third batch"):
        ring.before_step(2)
    ring.close()
    thread.join(timeout=10)
    assert not thread.is_alive() and ring._epoch is None

    loader = PrefetchLoader(HostLoader(images, labels, 4), depth=2)
    it = iter(loader)
    next(it)
    producer = loader._thread
    loader.close()
    assert not producer.is_alive()


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_the_ring_serves_each_step_its_batch(depth):
    """Ten steps of batches of 4 staged in chunks of 3 (a partial last
    chunk) through a ring of ``depth`` slots, the loader prefetched on a
    thread: step ``i``'s ``batch(i)`` is the loader's ``i``-th batch, byte
    for byte, in two epochs; labels arrive as int64."""
    images, labels = _data(n=43)
    loader = HostLoader(images, labels, 4, drop_last=True, seed=9)
    ring = StagingRing(PrefetchLoader(loader, depth=2), 4, 10, images.shape[1:], chunk_steps=3,
                       depth=depth, device="cpu")
    assert ring.slots == max(1, depth) and ring.images.shape[:2] == (ring.slots * 3, 4)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        want = list(loader)
        ring.start_epoch(epoch)
        for k in range(10):
            ring.before_step(k)
            x, y = ring.batch(torch.tensor([k]))
            assert y.dtype == torch.int64
            assert np.array_equal(x.numpy(), want[k][0]) and np.array_equal(y.numpy(), want[k][1])
            ring.after_step(k)
        ring.end_epoch()
    assert ring.chunks_staged == 8
    ring.close()


@pytest.fixture(scope="module")
def device_fit(tmp_path_factory):
    """The device-mode run every host-mode case is held against."""
    trainer = Trainer(port_config.load_config(
        [*FIT, "--ckpt-path", str(tmp_path_factory.mktemp("device"))]))
    fit = trainer.fit()
    trainer.close()
    return fit, _state(trainer)


def _state(trainer) -> dict:
    out = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for name, p in trainer.model.named_parameters():
        out[f"momentum:{name}"] = trainer.optimizer.state[p]["momentum_buffer"].clone()
    return out


@pytest.mark.parametrize("chunk,prefetch,workers", [
    (3, 2, 2),  # chunks of 3 over 4 steps: each epoch ends on a partial chunk
    (2, 1, 0),  # chunks that divide the epoch, one slot, batches on the staging thread
    (3, 1, 2),
    (2, 2, 0),
    (4, 0, 2),  # staged on the training thread
])
def test_a_host_mode_fit_ends_where_the_device_mode_fit_ends(device_fit, tmp_path, chunk,
                                                             prefetch, workers):
    """ResNet-18 at 16 px, 36 training images in 4 steps of 8, two epochs:
    ``--data-mode host`` trains on the batches of ``--data-mode device`` in
    the same order with the same draws, so every epoch's record (losses,
    accuracies, validation totals) and the whole final state (parameters,
    momentum, running statistics, the applied-step count) are bit for bit
    the device mode's."""
    want_fit, want_state = device_fit
    hp = port_config.load_config([*FIT, "--data-mode", "host", "--host-chunk-steps", str(chunk),
                                  "--device-prefetch", str(prefetch), "--workers", str(workers),
                                  "--ckpt-path", str(tmp_path)])
    trainer = Trainer(hp)
    assert trainer.train_split is None and isinstance(trainer.runner.ring, StagingRing)
    fit = trainer.fit()
    trainer.close()
    assert fit["applied_steps"] == want_fit["applied_steps"] == 8
    keys = ("steps", "skipped", "train_loss", "train_acc", "val_loss", "val_acc", "lr")
    for got, want in zip(fit["epochs"], want_fit["epochs"], strict=True):
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    state = _state(trainer)
    assert state.keys() == want_state.keys()
    for k, v in want_state.items():
        assert torch.equal(state[k], v), k
    assert trainer.runner.ring.chunks_staged == 2 * -(-4 // chunk)


def test_the_host_mode_flags_parse_with_the_jax_defaults():
    """``--workers``, ``--host-chunk-steps``, ``--device-prefetch`` and
    ``--device-chunk-steps`` parse to the JAX package's defaults (4, 32,
    2, 0) and to its values when given; ``--device-prefetch auto`` (the
    planner's) and out-of-range values are refused."""
    names = ("workers", "host_chunk_steps", "device_prefetch", "device_chunk_steps")
    for argv in ([], ["--workers", "0", "--host-chunk-steps", "3", "--device-prefetch", "1",
                      "--device-chunk-steps", "8", "--data-mode", "host"]):
        port = vars(port_config.load_config(argv))
        ref = vars(jax_load_config("single", argv))
        assert {k: port[k] for k in names} == {k: ref[k] for k in names}
    assert [vars(port_config.load_config([]))[k] for k in names] == [4, 32, 2, 0]
    for bad in (["--device-prefetch", "auto"], ["--device-prefetch", "-1"],
                ["--device-prefetch", "two"], ["--host-chunk-steps", "0"],
                ["--device-chunk-steps", "-1"]):
        with pytest.raises(SystemExit):
            port_config.load_config(bad)
    assert {"workers", "device_prefetch", "device_chunk_steps"} <= set(port_config.WRITTEN_DELTAS)
