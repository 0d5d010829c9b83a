"""The entry point under ``--backend ddp`` with two processes on the CPU
(gloo), against one process.

``python -m distributed_training_comparison_tpu_torch --backend ddp
--device cpu --num-devices 2`` spawns two processes that train ResNet-18
at 16 px for one epoch and ``--contain-test`` the best file; the same
command with ``--epoch 2 --auto-resume`` continues the run.  Rendezvous
goes through a file under the test's ``tmp_path``, each process runs one
thread, and the wait for the processes is bounded.
"""

import math

import pytest
import torch

from distributed_training_comparison_tpu_torch import entry
from distributed_training_comparison_tpu_torch.config import load_config
from distributed_training_comparison_tpu_torch.train import Trainer
from distributed_training_comparison_tpu_torch.train import checkpoint as ckpt

# ResNet-18 at 16 px: 36 training images (4 steps of 8), 4 validation, 40 test
RESNET = ["--device", "cpu", "--synthetic-data", "--image-size", "16", "--limit-examples", "40",
          "--batch-size", "8", "--lr", "0.02"]
DDP = ["--backend", "ddp", "--num-devices", "2"]
JOIN_TIMEOUT = 120.0


def _ddp(tmp_path, *extra):
    return entry.run([*RESNET, *DDP, "--ckpt-path", str(tmp_path / "runs"),
                      "--dist-url", f"file://{tmp_path / 'store'}", *extra],
                     join_timeout=JOIN_TIMEOUT)


@pytest.fixture
def one_thread_processes(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_two_processes_train_test_and_resume_one_run(tmp_path, one_thread_processes):
    """One epoch of 4 steps over two processes, then ``--contain-test``:
    one version dir, written by process 0 alone (one TensorBoard file, one
    start line in the log); the test counts each of the 40 test examples
    once, and its accuracies are one process's on the same best file.
    Relaunched with ``--epoch 2 --auto-resume``, the run continues in the
    same version dir from epoch 1."""
    first = _ddp(tmp_path, "--epoch", "1", "--contain-test")
    (epoch,) = first["fit"]["epochs"]
    assert first["fit"]["applied_steps"] == epoch["steps"] == 4
    assert epoch["skipped"] == epoch["nonfinite_losses"] == 0 and math.isfinite(epoch["train_loss"])
    runs = tmp_path / "runs"
    assert [d.name for d in runs.iterdir()] == ["version-0"]
    vdir = runs / "version-0"
    assert len(list((vdir / "tb").iterdir())) == 1
    log = (vdir / "experiment.log").read_text()
    assert log.count("start training") == 1 and "[DDP Version 0]" in log
    assert "2 process(es)" in log and (vdir / "hparams.yaml").is_file()
    assert (vdir / "last.ckpt").is_file()
    best = ckpt.find_best_checkpoint(vdir)
    assert first["test_checkpoint"] == str(best) and first["test_examples"] == 40
    alone = Trainer(load_config([*RESNET, "--ckpt-path", str(tmp_path / "alone")]))
    ckpt.load_checkpoint(best, alone.state)
    want = alone._evaluate("test", alone.test_split)
    alone.close()
    assert alone.eval_counts["test"] == 40
    assert (first["test_top1"], first["test_top5"]) == (want["top1"], want["top5"])
    assert first["test_loss"] == pytest.approx(want["loss"], rel=1e-6)  # two partial sums

    resumed = _ddp(tmp_path, "--epoch", "2", "--auto-resume")
    assert [e["epoch"] for e in resumed["fit"]["epochs"]] == [1]
    assert resumed["fit"]["applied_steps"] == 8 and resumed["fit"]["version"] == 0
    assert [d.name for d in runs.iterdir()] == ["version-0"]
    assert "Resumed from" in (vdir / "experiment.log").read_text()
    assert torch.load(vdir / "last.ckpt", weights_only=True)["epoch"] == 1
