"""The step program on the card (``gpu`` marker): CUDA graphs of the train
step, the eval batch and the serve buckets against the same bodies run
eagerly.

Each test skips inside its fixture where ``torch.cuda.is_available()`` is
false.  The file imports no JAX, so it also runs where JAX is not
installed; there, skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_step_program_gpu.py
"""

import importlib

import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu_torch import ops
from distributed_training_comparison_tpu_torch._device import pin_fp32_math
from distributed_training_comparison_tpu_torch.config import load_config
from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool
from distributed_training_comparison_tpu_torch.train import EvalRunner, Trainer
from distributed_training_comparison_tpu_torch.utils.graphs import CapturedStep

vb = importlib.import_module("distributed_training_comparison_tpu_torch.ops.vit_block")

DATA = ["--synthetic-data", "--limit-examples", "200", "--batch-size", "32", "--epoch", "1"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs capture only on the card)")
    pin_fp32_math()
    return torch.device("cuda")


def _state(trainer) -> dict:
    out = dict(trainer.model.state_dict())
    for name, p in trainer.model.named_parameters():
        out[f"momentum:{name}"] = trainer.optimizer.state[p]["momentum_buffer"]
    return out


def _counts() -> list[int]:
    return [c.launches for c in ops.counted_wrappers()]


def _eager_step(runner) -> None:
    """The runner's next step by its body, run eagerly in train mode."""
    runner.model.train()
    runner.program.body()


def _eager_logits(engine, images: np.ndarray) -> np.ndarray:
    """``images`` padded to their bucket and run by the engine's eager
    forward, as a dispatch pads them."""
    n, bucket = len(images), engine.bucket_for(len(images))
    padded = np.concatenate([images, np.zeros((bucket - n, *images.shape[1:]), np.uint8)])
    return engine._forward(torch.from_numpy(padded).to(engine.device))[:n].cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("argv", [
    ["--model", "resnet18", "--amp"],
    ["--model", "resnet18"],
    ["--model", "vit_tiny", "--patch-size", "2", "--amp"],
])
def test_replayed_steps_equal_eager_steps(cuda_device, monkeypatch, argv, tmp_path):
    """Two trainers on the same seeded weights: one's ``EpochRunner`` takes
    a warm-up step and replays the captured step three times, the other
    runs its runner's body eagerly four times.  The same kernels on the same
    inputs: losses, parameters, momentum and running statistics bit for
    bit, and the launch counters move as much under the replays as under
    the eager steps (``vit_tiny`` p2: its K5 and K6 kernels in every block).
    cuDNN is held to its deterministic algorithms: its default fp32
    weight-gradient convolution sums with atomics, and two eager fp32
    ResNet steps differ as well."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    hp = load_config(argv + DATA + ["--ckpt-path", str(tmp_path)])
    graphed, eager = Trainer(hp), Trainer(hp)
    launches = []
    for runner, step in ((eager.runner, lambda: _eager_step(eager.runner)),
                         (graphed.runner, graphed.runner.step)):
        before = _counts()
        runner.start_epoch(0)
        for _ in range(4):
            step()
        torch.cuda.synchronize()
        launches.append([n - b for n, b in zip(_counts(), before)])
    assert graphed.runner.program.captured and not eager.runner.program.captured
    assert launches[0] == launches[1]
    if "vit_tiny" in argv:
        assert launches[1][ops.counted_wrappers().index(vb.block_gemm)] > 0
    losses = graphed.runner.metrics[:4, 0]
    assert bool(torch.isfinite(losses).all())
    assert torch.equal(losses, eager.runner.metrics[:4, 0])
    assert int(graphed.sgd.applied) == int(eager.sgd.applied) == 4
    want = _state(eager)
    for name, got in _state(graphed).items():
        assert torch.equal(got, want[name]), name


@pytest.mark.gpu
def test_eval_graph_totals_equal_the_eager_pass(cuda_device, tmp_path):
    """``Trainer.validate`` through the captured eval batch (three passes:
    a warm-up batch, then replays) against the same split evaluated by the
    eval body run eagerly: the totals bit for bit, in eval mode."""
    hp = load_config(["--model", "resnet18", "--amp", *DATA, "--ckpt-path", str(tmp_path)])
    trainer = Trainer(hp)
    trainer.runner.start_epoch(0)
    for _ in range(2):  # the running statistics move
        trainer.runner.step()
    runner = EvalRunner(trainer.model, trainer.val_split, hp.batch_size, precision=hp.precision)
    trainer.model.eval()
    for _ in range(runner.batches):
        runner.program.body()
    trainer.model.train()
    assert not runner.program.captured
    eager = dict(zip(("loss_sum", "top1_count", "top5_count", "count"), runner.totals.tolist()))
    for _ in range(3):
        assert trainer.validate() == {
            "val_loss": eager["loss_sum"] / eager["count"],
            "val_acc": 100.0 * eager["top1_count"] / eager["count"],
        }
    assert trainer.eval_runners["val"].program.captured and trainer.model.training


@pytest.mark.gpu
@pytest.mark.parametrize("argv", [
    ["--serve", "--model", "resnet18", "--amp"],
    ["--serve", "--model", "vit_tiny", "--patch-size", "2", "--amp"],
])
def test_bucket_graph_logits_equal_the_eager_forward(cuda_device, argv, tmp_path):
    """A bucket's graph (``warmup`` captures every bucket, largest first)
    against the engine's eager forward: the logits of a padded batch of 3
    in bucket 4 and of a full bucket 32, bit for bit."""
    hp = load_config(argv + ["--serve-buckets", "1,4,32", "--ckpt-path", str(tmp_path)])
    engine = build_engine(hp)
    engine.warmup()
    assert engine.stats()["captured_buckets"] == [1, 4, 32]
    for n in (3, 32):
        images = request_pool(n, image_size=hp.image_size, seed=1, fold=("check", n))
        for _ in range(2):
            np.testing.assert_array_equal(engine.predict_logits(images),
                                          _eager_logits(engine, images))


@pytest.mark.gpu
def test_a_graph_replays_what_its_capture_called(cuda_device, tmp_path):
    """A bucket's graph holds the wrappers its capture called: with
    ``block_attention`` rebound after the capture (a planted fault that
    zeroes its output) the graph replays the first logits bit for bit,
    while the eager forward and a new engine, captured under the fault,
    both give the fault's logits."""
    hp = load_config(["--serve", "--model", "vit_tiny", "--patch-size", "2", "--amp",
                      "--serve-buckets", "4", "--ckpt-path", str(tmp_path)])
    engine = build_engine(hp)
    images = request_pool(4, image_size=hp.image_size, seed=2, fold=("check", 4))
    first = [engine.predict_logits(images) for _ in range(3)][-1]
    real = vb.block_attention

    def zeroed(*args, **kw):
        return real(*args, **kw) * 0

    zeroed.launches = 0
    vb.block_attention = zeroed
    try:
        replayed = engine.predict_logits(images)
        eager = _eager_logits(engine, images)
        fresh = build_engine(hp)
        captured = [fresh.predict_logits(images) for _ in range(3)]
    finally:
        vb.block_attention = real
    np.testing.assert_array_equal(replayed, first)
    assert np.abs(eager - first).max() > 0
    assert fresh.stats()["captured_buckets"] == [4]
    for logits in captured:
        np.testing.assert_array_equal(logits, eager)


@pytest.mark.gpu
def test_a_host_sync_in_a_captured_body_raises(cuda_device):
    """A body that reads a device value on the host runs eagerly at its
    warm-up call and raises at its capture, every time: nothing falls back
    to eager, and the counters are as they were."""
    x = torch.ones(8, device=cuda_device)
    counter = ops.counted_wrappers()[0]
    calls = []

    def body():
        counter.launches += 1
        calls.append(float(x.sum().item()))
        return x * 2

    step = CapturedStep(body, cuda_device, counters=ops.counted_wrappers)
    assert torch.equal(step(), x * 2) and calls == [8.0]
    before = counter.launches
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step()
        assert counter.launches == before and not step.captured
    torch.cuda.synchronize()
    assert torch.equal(x + 1, torch.full_like(x, 2.0))
