"""The port trainer's files on the CPU: run dirs, TensorBoard,
``experiment.log``, ``hparams.yaml``, the best and resumable checkpoints,
``--resume`` and ``--auto-resume``, ``--contain-test`` on the best state,
``--serve`` from a checkpoint, the write-behind writer, and the card's
deterministic cuDNN setting.

The JAX package's rules are the reference: its ``SummaryWriter`` bytes, its
best-file names and its checkpoint decisions.  A resumed run is held to
the straight run bit for bit: the epoch order and the augmentation draws are
functions of (seed, epoch), so a resume at an epoch boundary replays
exactly.  Torch is pinned to one thread here, as in every CPU test file that
trains convolutions (several test workers share the cores).
"""

import re
import struct
import threading
import time

import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.utils import tensorboard as jax_tb
from distributed_training_comparison_tpu_torch import _device, entry
from distributed_training_comparison_tpu_torch.config import load_config
from distributed_training_comparison_tpu_torch.serve import ServeEngine, build_engine, serve_main
from distributed_training_comparison_tpu_torch.train import AsyncCheckpointer, Trainer
from distributed_training_comparison_tpu_torch.train import checkpoint as ckpt
from distributed_training_comparison_tpu_torch.utils import tensorboard as port_tb


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ResNet-18 at 16 px: 36 training images (4 steps of 8), 4 validation, 4 test
RESNET = ["--device", "cpu", "--synthetic-data", "--image-size", "16", "--limit-examples", "40",
          "--batch-size", "8", "--lr", "0.02"]
# vit_tiny (dim 192, 12 blocks, 64 tokens): 24 training images (3 steps of 8)
VIT = ["--device", "cpu", "--model", "vit_tiny", "--synthetic-data", "--limit-examples", "28",
       "--batch-size", "8", "--lr", "0.02"]


def _run(argv, root, *extra):
    return entry.run([*argv, "--ckpt-path", str(root), *extra])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_bitwise(a, b):
    a, b = _leaves(a), _leaves(b)
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def read_scalars(tb_dir) -> dict:
    """``{(tag, step): value}`` of every scalar event under ``tb_dir``: the
    TFRecord framing and the ``Event``/``Summary`` fields the writer emits."""

    def varint(buf, i):
        n = shift = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n, i

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            num, wire = key >> 3, key & 7
            if wire == 0:
                val, i = varint(buf, i)
            elif wire == 1:
                val, i = buf[i:i + 8], i + 8
            elif wire == 5:
                val, i = buf[i:i + 4], i + 4
            else:
                n, i = varint(buf, i)
                val, i = buf[i:i + n], i + n
            yield num, val

    out = {}
    for path in sorted(tb_dir.glob("events.out.tfevents.*")):
        data = path.read_bytes()
        i = 0
        while i < len(data):
            (n,) = struct.unpack_from("<Q", data, i)
            event = dict(fields(data[i + 12:i + 12 + n]))
            i += 12 + n + 4
            if 5 in event:
                value = dict(fields(dict(fields(event[5]))[1]))
                tag = value[1].decode()
                out[(tag, event[2])] = struct.unpack("<f", value[2])[0]
    return out


DETERMINISTIC_TAGS = ("lr", "loss/epoch/train", "loss/epoch/val", "acc/epoch/val", "moe/")


def _deterministic(scalars):
    return {k: v for k, v in scalars.items() if k[0].startswith(DETERMINISTIC_TAGS)}


def _best_names(epochs) -> list[str]:
    """The JAX rule's best file after each epoch: the first validation
    always saves (best starts at -1), a later one only when it beats the
    best so far; the file name carries its epoch and accuracy."""
    best, name, names = -1.0, None, []
    for e in epochs:
        if e["val_acc"] > best:
            best, name = e["val_acc"], f"best_model_epoch_{e['epoch']}_acc_{e['val_acc']:.4f}.ckpt"
        names.append(name)
    return names


@pytest.mark.parametrize("argv", [RESNET, VIT], ids=["resnet18", "vit_tiny"])
def test_a_resumed_run_ends_bit_for_bit_where_the_straight_run_ends(argv, tmp_path):
    """Two epochs straight, against one epoch and then the same command for
    two with ``--auto-resume`` (the same version dir) and with ``--resume``
    of the first epoch's ``last.ckpt`` (a fresh version dir): the final
    ``last.ckpt`` payloads (parameters, batch statistics, momentum, step,
    epoch, best accuracy) and every epoch's losses bit for bit, the
    TensorBoard scalars equal but for timing, and the best files named as
    the JAX rule names them."""
    straight = _run(argv, tmp_path / "a", "--epoch", "2")["fit"]["epochs"]
    first = _run(argv, tmp_path / "b", "--epoch", "1")["fit"]["epochs"]
    source = tmp_path / "b" / "version-0" / "last.ckpt"
    explicit = _run(argv, tmp_path / "c", "--epoch", "2", "--resume", str(source))["fit"]
    auto = _run(argv, tmp_path / "b", "--epoch", "2", "--auto-resume")["fit"]
    assert auto["version"] == 0 and explicit["version"] == 0
    assert [e["epoch"] for e in auto["epochs"]] == [e["epoch"] for e in explicit["epochs"]] == [1]
    want = torch.load(tmp_path / "a" / "version-0" / "last.ckpt", weights_only=True)
    assert want["epoch"] == 1 and int(want["state"]["step"]) == auto["applied_steps"]
    for root in ("b", "c"):
        _assert_bitwise(torch.load(tmp_path / root / "version-0" / "last.ckpt", weights_only=True),
                        want)
    for key in ("train_loss", "val_loss", "val_acc", "train_acc", "lr"):
        assert [e[key] for e in straight] == [e[key] for e in first + auto["epochs"]]
        assert [e[key] for e in straight[1:]] == [e[key] for e in explicit["epochs"]]
    scalars = _deterministic(read_scalars(tmp_path / "a" / "version-0" / "tb"))
    assert {t for t, _ in scalars} >= {"lr", "loss/epoch/train", "acc/epoch/val"}
    assert _deterministic(read_scalars(tmp_path / "b" / "version-0" / "tb")) == scalars
    assert _deterministic(read_scalars(tmp_path / "c" / "version-0" / "tb")) == {
        k: v for k, v in scalars.items() if k[1] == 1}
    names = _best_names(straight)
    for root in ("a", "b"):
        assert [p.name for p in (tmp_path / root / "version-0").glob("best_model_*")] == [names[-1]]
    # --resume restores the best accuracy: a best file only if epoch 1 beat epoch 0
    fresh = [p.name for p in (tmp_path / "c" / "version-0").glob("best_model_*")]
    assert fresh == ([names[-1]] if names[-1] != names[0] else [])


def test_contain_test_tests_the_best_checkpoint(tmp_path):
    """``test()`` drains the writer and loads the run's best file into the
    model: a model perturbed after ``fit`` tests as the best state did, and
    as an eval of the best file's weights loaded afresh."""
    hp = load_config([*RESNET, "--epoch", "2", "--ckpt-path", str(tmp_path)])
    trainer = Trainer(hp)
    trainer.fit()
    want = trainer.test()
    assert trainer.test_checkpoint == ckpt.find_best_checkpoint(trainer.version_dir)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
    moved = trainer._evaluate("test", trainer.test_split)["loss"]
    assert moved != want["test_loss"]
    assert trainer.test() == want
    other = Trainer(load_config([*RESNET, "--epoch", "2", "--ckpt-path", str(tmp_path / "x")]))
    ckpt.load_checkpoint(trainer.test_checkpoint, other.state)
    assert other._evaluate("test", other.test_split) == {
        "loss": want["test_loss"], "top1": want["test_top1"], "top5": want["test_top5"]}
    trainer.close()
    other.close()
    results = _run(RESNET, tmp_path / "entry", "--epoch", "1", "--contain-test")
    assert results["test_checkpoint"].endswith(".ckpt") and "best_model_epoch_0" in \
        results["test_checkpoint"]


def test_save_last_flags_follow_the_jax_rules(tmp_path):
    """``--no-save-last`` writes the best file only; ``--save-last-every 2``
    (no throttle) skips epoch 0 and saves epochs 1 and 2 (the last epoch
    always saves); the default throttle of 20 s lets the first epoch's and
    the final epoch's saves through and holds the one between."""
    epochs = _run(RESNET, tmp_path / "best", "--epoch", "2", "--no-save-last")["fit"]["epochs"]
    assert [e["saved_last"] for e in epochs] == [False, False]
    names = sorted(p.name for p in (tmp_path / "best" / "version-0").iterdir())
    assert [n for n in names if n.endswith(".ckpt")] == [_best_names(epochs)[-1]]
    every = _run(RESNET, tmp_path / "every", "--epoch", "3", "--save-last-every", "2",
                 "--save-last-min-secs", "0")["fit"]["epochs"]
    assert [e["saved_last"] for e in every] == [False, True, True]
    throttled = _run(RESNET, tmp_path / "throttle", "--epoch", "3")["fit"]["epochs"]
    assert [e["saved_last"] for e in throttled] == [True, False, True]
    last = torch.load(tmp_path / "throttle" / "version-0" / "last.ckpt", weights_only=True)
    assert last["epoch"] == 2


def test_run_dir_holds_hparams_log_and_tensorboard(tmp_path):
    """A run dir under ``--ckpt-path``: ``hparams.yaml`` with every flag,
    ``experiment.log`` with the JAX trainer's epoch line, TensorBoard's
    per-epoch scalars, ``loss/step`` under ``--log-every-step``, and the
    writer's gauges."""
    hp = load_config([*RESNET, "--epoch", "1", "--log-every-step", "--eval-step", "2",
                      "--ckpt-path", str(tmp_path)])
    trainer = Trainer(hp)
    trainer.fit()
    trainer.close()
    vdir = tmp_path / "version-0"
    text = (vdir / "hparams.yaml").read_text()
    assert "batch_size: 8\n" in text and f"ckpt_path: {tmp_path}\n" in text
    log = (vdir / "experiment.log").read_text()
    assert re.search(r"\d\d:\d\d:\d\d,\d+ > \[SINGLE Version 0 Epoch 0\] train loss: [\d.]+, "
                     r"train acc: [\d.]+%, val loss: [\d.]+, val acc: [\d.]+%, lr: 0\.0200, "
                     r"\d+ img/s", log)
    assert "[SINGLE Version 0 Epoch 0] global step 2, train loss:" in log
    tags = {t for t, _ in read_scalars(vdir / "tb")}
    assert tags == {"lr", "loss/epoch/train", "loss/epoch/val", "acc/epoch/val",
                    "throughput/images_per_sec", "ckpt/writer_busy_frac", "ckpt/queue_depth",
                    "loss/step"}
    assert {s for t, s in read_scalars(vdir / "tb") if t == "loss/step"} == {0, 1, 2, 3}


def test_moe_scalars_reach_tensorboard(tmp_path):
    """A ``vit_moe`` run logs the JAX trainer's ``moe/dropped_frac`` and
    ``moe/load_max`` once an epoch."""
    argv = ["--device", "cpu", "--model", "vit_moe", "--synthetic-data", "--limit-examples",
            "20", "--batch-size", "8", "--epoch", "1"]
    epoch = _run(argv, tmp_path)["fit"]["epochs"][0]
    scalars = read_scalars(tmp_path / "version-0" / "tb")
    assert scalars[("moe/load_max", 0)] == pytest.approx(epoch["moe_load_max"], rel=1e-7)
    assert ("moe/dropped_frac", 0) in scalars


def test_summary_writer_bytes_are_the_jax_writers(tmp_path, monkeypatch):
    """The same scalars at a fixed wall time (and one host and process):
    the event files are byte-identical."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    files = []
    for name, tb in (("port", port_tb), ("jax", jax_tb)):
        with tb.SummaryWriter(tmp_path / name) as w:
            for step, (tag, value) in enumerate([("lr", 0.1), ("loss/epoch/val", 4.25),
                                                 ("acc/epoch/val", -1e-3), ("x", float("nan"))]):
                w.add_scalar(tag, value, step * 7)
        (path,) = (tmp_path / name).iterdir()
        files.append((path.name, path.read_bytes()))
    assert files[0] == files[1]


def test_async_checkpointer_coalesces_and_reraises(tmp_path):
    """Jobs queued under one key while the worker is busy collapse to the
    newest; a failed job surfaces on ``wait()`` (and only once)."""
    writer = AsyncCheckpointer()
    done, gate = [], threading.Event()
    writer.submit(lambda: gate.wait(10), key="block")
    for i in range(5):
        writer.submit(lambda i=i: done.append(i), key="last")
    gate.set()
    writer.wait()
    assert done == [4] and writer.stats()["queue_depth"] == 0

    def fail():
        raise OSError("disk full")

    writer.submit(fail, key="best")
    with pytest.raises(RuntimeError, match="disk full"):
        writer.wait()
    writer.wait()
    writer.close()
    assert not writer._thread.is_alive()


def test_serve_main_serves_the_checkpoint_or_fresh_weights(tmp_path):
    """``--serve --serve-ckpt <best>`` serves those weights (bucket logits
    equal an engine built on the trainer's weights), discovery under
    ``--ckpt-path`` finds the same file, and an empty ``--ckpt-path`` serves
    fresh weights with the JAX package's warning."""
    trainer = Trainer(load_config([*RESNET, "--epoch", "1", "--ckpt-path", str(tmp_path)]))
    trainer.fit()
    best = ckpt.find_best_checkpoint(trainer.version_dir)
    serve = ["--serve", "--device", "cpu", "--image-size", "16", "--serve-buckets", "1,4",
             "--serve-requests", "8"]
    images = np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    reference = ServeEngine(model=trainer.model, buckets=(4,), precision="fp32",
                            image_size=16, device="cpu")
    want = reference.predict_logits(images)
    for extra in (["--serve-ckpt", str(best)], []):
        hp = load_config([*serve, "--ckpt-path", str(tmp_path), *extra])
        engine = build_engine(hp)
        assert engine.checkpoint_meta == {"path": str(best), "epoch": 0,
                                          "acc": pytest.approx(trainer.best_acc)}
        np.testing.assert_array_equal(engine.predict_logits(images), want)
    report = serve_main(load_config([*serve, "--ckpt-path", str(tmp_path)]))
    assert report["completed"] == 8 and report["checkpoint"]["path"] == str(best)
    with pytest.warns(UserWarning, match="serving fresh-initialized weights"):
        report = serve_main(load_config([*serve, "--ckpt-path", str(tmp_path / "empty")]))
    assert report["completed"] == 8 and report["checkpoint"] is None
    trainer.close()


def test_a_card_holds_cudnn_to_deterministic_algorithms(monkeypatch):
    """Resolving a Hopper card (the check monkeypatched here) sets cuDNN's
    ``deterministic`` and clears its ``benchmark``, read back; the CPU
    changes neither."""
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    for knob in _device.fp32_precision_knobs().values():
        monkeypatch.setattr(knob, "fp32_precision", "tf32")
    _device.resolve_device("cpu")
    assert _device.cudnn_determinism() == {"deterministic": False, "benchmark": True}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda dev=None: _device.HOPPER)
    assert _device.resolve_device("cuda").type == "cuda"
    assert _device.cudnn_determinism() == {"deterministic": True, "benchmark": False}
    assert cudnn.deterministic is True and cudnn.benchmark is False
