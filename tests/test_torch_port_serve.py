"""The port's serving slice against the JAX package's, on the CPU.

The JAX ``ServeEngine`` (built as ``tests/test_serve.py`` builds one) and
the port's ``ServeEngine(device="cpu")`` serve the same weights, carried
across with ``vit_from_jax``, on the same ragged uint8 batch; the port's
batcher, load generator, flag surface and ``serve_main`` run end to end;
and a fresh interpreter importing every port module holds no JAX.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.config import load_config as jax_load_config
from distributed_training_comparison_tpu.models import ViT as JaxViT
from distributed_training_comparison_tpu.serve import ServeEngine as JaxServeEngine
from distributed_training_comparison_tpu.serve import request_pool as jax_request_pool
from distributed_training_comparison_tpu_torch import _device
from distributed_training_comparison_tpu_torch.config import load_config
from distributed_training_comparison_tpu_torch.models import ViT, vit_from_jax
from distributed_training_comparison_tpu_torch.serve import (
    MicroBatcher,
    QueueOverflow,
    ServeEngine,
    closed_loop,
    open_loop,
    request_pool,
    serve_main,
)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(depth=2, dim=64, heads=2, image_size=32)


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxServeEngine(
        model=JaxViT(**SMALL), buckets=(1, 2, 4), precision="fp32", image_size=32
    )
    params = jax.device_get(jax_engine.variables["params"])
    port_engine = ServeEngine(
        model=ViT(**SMALL), state_dict=vit_from_jax(params),
        buckets=(1, 2, 4), precision="fp32", image_size=32, device="cpu",
    )
    return jax_engine, port_engine


def test_engine_matches_jax_engine_on_ragged_batch(engines):
    """7 images over buckets (1, 2, 4): chunks 4 + 3, the 3 padded to 4.
    Bound 1e-5: fp32 through two blocks, summation order only."""
    jax_engine, port_engine = engines
    images = request_pool(7, image_size=32, seed=5)
    with jax.default_matmul_precision("highest"):
        want = jax_engine.predict_logits(images)
    before = dict(port_engine.stats()["bucket_counts"])
    got = port_engine.predict_logits(images)
    assert got.shape == (7, 100) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    after = port_engine.stats()["bucket_counts"]
    assert after[4] - before[4] == 2 and after[1] == before[1] and after[2] == before[2]


def test_engine_buckets_and_empty_batch(engines):
    _, eng = engines
    assert [eng.bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    with pytest.raises(ValueError, match="largest bucket"):
        eng.bucket_for(5)
    assert eng.predict_logits(np.zeros((0, 32, 32, 3), np.uint8)).shape == (0, 100)


def test_request_pool_is_byte_identical_to_jax():
    a = request_pool(5, image_size=16, seed=7, fold=("serve", 0))
    b = jax_request_pool(5, image_size=16, seed=7, fold=("serve", 0))
    assert a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["continuous", "bucketed"])
def test_batcher_closed_loop_completes_every_request(engines, mode):
    _, eng = engines
    images = request_pool(8, image_size=32, seed=1)
    with MicroBatcher(eng, mode=mode, max_wait_ms=1.0) as batcher:
        report = closed_loop(batcher, images, num_requests=24, concurrency=4)
    assert report["completed"] == 24 and report["failed"] == 0 and report["shed"] == 0
    summary = batcher.metrics.summary()
    assert summary["completed"] == 24 and 1 <= summary["mean_batch_size"] <= 4


def test_open_loop_and_typed_shedding():
    class SlowEngine:
        max_bucket = 2

        def predict_logits(self, images):
            import time

            time.sleep(0.02)
            return np.zeros((len(images), 3), np.float32)

    images = np.zeros((4, 2, 2, 3), np.uint8)
    with MicroBatcher(SlowEngine(), queue_limit=2, mode="continuous") as batcher:
        report = open_loop(batcher, images, rate_rps=2000.0, num_requests=40, seed=0)
        with pytest.raises(QueueOverflow):
            for _ in range(10):
                batcher.submit(images[0])
    assert report["completed"] + report["shed"] == 40 and report["shed"] > 0


def test_serve_main_from_argv_returns_the_report(tmp_path):
    hp = load_config([
        "--serve", "--device", "cpu", "--model", "vit_tiny",
        "--serve-requests", "16", "--serve-buckets", "1,2,4", "--ckpt-path", str(tmp_path),
    ])
    report = serve_main(hp)
    keys = {"offered", "completed", "shed", "expired", "failed", "duration_s",
            "throughput_rps", "latency_ms", "mode", "concurrency", "engine"}
    assert keys <= set(report)
    assert report["completed"] == 16 and report["failed"] == 0
    assert report["engine"]["device"] == "cpu"
    # warmup runs each bucket once; serving dispatches more on top
    assert sum(report["engine"]["bucket_counts"].values()) >= 3 + report["batcher"]["batches"]


def test_flags_share_names_and_defaults_with_jax():
    port, ref = load_config([]), jax_load_config("single", [])
    shared = [
        "model", "amp", "precision", "image_size", "patch_size", "block_fusion",
        "seed", "serve", "serve_buckets", "serve_mode", "max_wait_ms", "queue_limit",
        "serve_rate", "serve_requests", "serve_concurrency", "deadline_ms",
        "serve_shape", "serve_replicas",
    ]
    assert {k: getattr(port, k) for k in shared} == {k: getattr(ref, k) for k in shared}
    assert port.device == "cuda"
    amp = load_config(["--amp"])
    assert amp.precision == "bf16" == jax_load_config("single", ["--amp"]).precision
    with pytest.raises(SystemExit):
        load_config(["--serve-replicas", "2"])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model=ViT(**SMALL), image_size=32, device="cuda")
    assert _device.resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port and holds no
    jax, jaxlib, flax or JAX-package module afterwards.  The check compares
    top-level names exactly: the port's own name starts with the JAX
    package's."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import distributed_training_comparison_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = {'jax', 'jaxlib', 'flax', 'optax', 'distributed_training_comparison_tpu'}\n"
        "found = sorted({n.split('.')[0] for n in sys.modules} & bad)\n"
        "n = sum(n.startswith(pkg.__name__) for n in sys.modules)\n"
        "new = all(f'{pkg.__name__}.models.{m}' in sys.modules for m in ('resnet', 'remat'))\n"
        "print(found, n, new)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split()
    assert out[0] == "[]", out
    assert int(out[1]) >= 15  # every module of the port was imported
    assert out[2] == "True"  # the ResNet's modules among them
