"""The trainer's checkpoints on the card (``gpu`` marker): the device choice
holds cuDNN to its deterministic algorithms, so that one seed reproduces
its run and a run resumed from ``last.ckpt`` continues bit for bit.

Each test skips inside its fixture where ``torch.cuda.is_available()`` is
false.  The file imports no JAX, so it also runs where JAX is not
installed; there, skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_checkpoint_gpu.py
"""

import pytest
import torch

from distributed_training_comparison_tpu_torch import _device, entry

# fp32 ResNet-18 (the entry point with no --model and no --amp): 3 steps of
# 64 an epoch and one eval batch
RESNET = ["--synthetic-data", "--limit-examples", "220", "--batch-size", "64",
          "--lr-decay-step-size", "1"]


@pytest.fixture
def cuda_device(monkeypatch):
    """The card, with cuDNN preset to benchmark its algorithms with no
    determinism (restored after the test): the product must pin it back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (cuDNN's algorithms are the card's)")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    return torch.device("cuda")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def _assert_same_payload(got_path, want_path):
    got = _leaves(torch.load(got_path, weights_only=True))
    want = _leaves(torch.load(want_path, weights_only=True))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


@pytest.mark.gpu
def test_two_fresh_fp32_resnet_runs_end_in_the_same_state(cuda_device, tmp_path):
    """Two fresh entry runs of fp32 ResNet-18 from one seed, cuDNN preset
    non-deterministic before each and the product's setting not patched:
    the final ``last.ckpt`` payloads (parameters, batch statistics,
    momentum, step) and the losses bit for bit, and cuDNN read back
    deterministic."""
    runs = []
    for name in ("a", "b"):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        runs.append(entry.run([*RESNET, "--epoch", "2", "--ckpt-path", str(tmp_path / name)]))
        assert _device.cudnn_determinism() == {"deterministic": True, "benchmark": False}
    assert [e["train_loss"] for e in runs[0]["fit"]["epochs"]] == [
        e["train_loss"] for e in runs[1]["fit"]["epochs"]]
    _assert_same_payload(tmp_path / "b" / "version-0" / "last.ckpt",
                         tmp_path / "a" / "version-0" / "last.ckpt")


@pytest.mark.gpu
@pytest.mark.parametrize("argv", [
    RESNET,
    ["--model", "vit_tiny", "--patch-size", "2", "--amp", "--synthetic-data",
     "--limit-examples", "220", "--batch-size", "64", "--lr-decay-step-size", "1"],
], ids=["resnet18_fp32", "vit_tiny_p2_bf16"])
def test_a_resume_on_the_card_is_bit_for_bit(cuda_device, tmp_path, argv):
    """Two epochs straight against one epoch, then two by ``--auto-resume``:
    the resumed run's graphs are captured on the restored tensors, and its
    final ``last.ckpt`` is the straight run's bit for bit (``vit_tiny`` p2
    through K5 and K6)."""
    straight = entry.run([*argv, "--epoch", "2", "--ckpt-path", str(tmp_path / "a")])
    first = entry.run([*argv, "--epoch", "1", "--ckpt-path", str(tmp_path / "b")])
    resumed = entry.run([*argv, "--epoch", "2", "--auto-resume",
                         "--ckpt-path", str(tmp_path / "b")])
    assert [e["epoch"] for e in resumed["fit"]["epochs"]] == [1]
    assert [e["train_loss"] for e in straight["fit"]["epochs"]] == [
        e["train_loss"] for e in first["fit"]["epochs"] + resumed["fit"]["epochs"]]
    _assert_same_payload(tmp_path / "b" / "version-0" / "last.ckpt",
                         tmp_path / "a" / "version-0" / "last.ckpt")
