"""The port's training slice against the JAX package's, on the CPU.

Data (synthetic images, the 90/10 split, the epoch order, crop and flip),
the optimizer and its schedule, and whole train steps of a small ViT go
through both packages on the same numpy inputs; the JAX side runs on the
test suite's 8-device CPU mesh at ``highest`` matmul precision.  Each
tolerance is stated beside its comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_comparison_tpu.config import load_config as jax_load_config
from distributed_training_comparison_tpu.data.augment import random_crop_flip as jax_crop_flip
from distributed_training_comparison_tpu.data.loader import DeviceDataset, HostLoader
from distributed_training_comparison_tpu.data.loader import get_datasets as jax_get_datasets
from distributed_training_comparison_tpu.data.sampler import train_val_split as jax_split
from distributed_training_comparison_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from distributed_training_comparison_tpu.models import ViT as JaxViT
from distributed_training_comparison_tpu.parallel import make_mesh, replicated_sharding
from distributed_training_comparison_tpu.train import (
    configure_optimizers as jax_configure_optimizers,
)
from distributed_training_comparison_tpu.train import create_train_state, make_train_step
from distributed_training_comparison_tpu_torch import config as port_config
from distributed_training_comparison_tpu_torch import entry
from distributed_training_comparison_tpu_torch.data import (
    DeviceSplit,
    draw_crop_flip,
    get_datasets,
    random_crop_flip,
    synthetic_dataset,
    train_val_split,
)
from distributed_training_comparison_tpu_torch.models import ViT, vit_from_jax
from distributed_training_comparison_tpu_torch.train import (
    TrainStep,
    build_model,
    configure_optimizers,
)
from distributed_training_comparison_tpu_torch.utils import step_generator

SMALL = dict(depth=2, dim=64, heads=2, image_size=32)
TRAIN_ARGV = [
    "--model", "vit_long", "--image-size", "256", "--amp", "--synthetic-data",
    "--limit-examples", "160", "--batch-size", "16", "--epoch", "2",
    "--lr-decay-step-size", "1",
]


class HP:
    """Two steps per LR level at one step per epoch: three steps cross the
    StepLR boundary (0.1, 0.1, then 0.01)."""

    lr = 0.1
    weight_decay = 1e-4
    lr_decay_step_size = 2
    lr_decay_gamma = 0.1


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(backend="ddp")


@pytest.mark.parametrize(
    "argv",
    [[], TRAIN_ARGV, ["--serve", "--model", "vit_long", "--serve-buckets", "1,2,4,8"],
     ["--grad-accum", "4", "--contain-test", "--data-mode", "host", "--lr", "0.05"]],
)
def test_parsers_agree_but_for_the_written_deltas(argv):
    """Every flag both parsers know parses to the same value; the port's
    only extra flag is a written delta, and every written delta names a
    flag the port parses."""
    port = vars(port_config.load_config(argv))
    ref = vars(jax_load_config("single", argv))
    shared = set(port) & set(ref)
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    assert set(port) - set(ref) == {"device"}
    assert set(port_config.WRITTEN_DELTAS) <= set(port)
    if not argv:
        assert port["epoch"] == 200  # the JAX single backend's default


def test_synthetic_data_split_and_datasets_are_byte_identical():
    a = synthetic_dataset(40, image_shape=(8, 8, 3), seed=3, anchor_seed=1)
    b = jax_synthetic(40, image_shape=(8, 8, 3), seed=3, anchor_seed=1)
    assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
    for got, want in zip(train_val_split(57, seed=9), jax_split(57, seed=9)):
        assert np.array_equal(got, want)
    argv = ["--synthetic-data", "--limit-examples", "50", "--image-size", "16", "--seed", "5"]
    ported = get_datasets(port_config.load_config(argv))
    ref = jax_get_datasets(jax_load_config("single", argv))
    for (images, labels), want in zip(ported, ref):
        assert np.array_equal(images, want.images) and np.array_equal(labels, want.labels)


def test_epoch_batches_follow_the_jax_host_loader_order():
    """The device-resident split's batches, epoch by epoch, are the JAX
    host loader's (numpy ``(seed, epoch)`` shuffle, ``drop_last``)."""
    images, labels = synthetic_dataset(23, image_shape=(4, 4, 3), seed=1)
    loader = HostLoader(DeviceDataset(images, labels), 4, shuffle=True, drop_last=True, seed=7)
    split = DeviceSplit(images, labels, "cpu")
    for epoch in range(3):
        loader.set_epoch(epoch)
        want = list(loader)
        got = list(split.epoch_batches(4, seed=7, epoch=epoch))
        assert len(got) == len(want) == 5
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx.numpy(), wx) and np.array_equal(gy.numpy(), wy)


def test_eval_batches_cover_every_example_once():
    images, labels = synthetic_dataset(10, image_shape=(4, 4, 3), seed=2)
    batches = list(DeviceSplit(images, labels, "cpu").eval_batches(4))
    assert [len(y) for _, y, _ in batches] == [4, 4, 4]
    weights = torch.cat([w for _, _, w in batches])
    assert weights.tolist() == [1.0] * 10 + [0.0] * 2
    got = torch.cat([x for x, _, _ in batches])[:10]
    assert np.array_equal(got.numpy(), images)


def test_random_crop_flip_is_byte_identical_for_jax_draws():
    """JAX's threefry draws (its split, randint and bernoulli, as
    ``random_crop_flip`` makes them) fed to the port give the same uint8
    batch the JAX function gives for that key."""
    images = synthetic_dataset(12, image_shape=(10, 12, 3), seed=4)[0]
    key = jax.random.key(11)
    want = np.asarray(jax_crop_flip(jnp.asarray(images), key))
    crop_key, flip_key = jax.random.split(key)
    offsets = np.array(jax.random.randint(crop_key, (12, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(flip_key, 0.5, (12,)))
    assert flips.any() and not flips.all()
    got = random_crop_flip(torch.from_numpy(images), torch.from_numpy(offsets), torch.from_numpy(flips))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_crop_flip_draws_are_seeded_per_step():
    a = draw_crop_flip(64, step_generator(3, 1, 2))
    b = draw_crop_flip(64, step_generator(3, 1, 2))
    c = draw_crop_flip(64, step_generator(3, 1, 3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert int(a[0].min()) >= 0 and int(a[0].max()) <= 8 and a[1].dtype == torch.bool


def test_sgd_and_step_lr_follow_the_optax_chain_across_a_decay():
    """Six updates at two steps per epoch and a decay every epoch (LR 0.1,
    0.1, 0.01, 0.01, 0.001, 0.001): torch's SGD against the optax chain on
    the same gradients.  Bound 1e-6 relative: fp32, the same operations in
    another order."""
    hp = type("HP", (), dict(lr=0.1, weight_decay=1e-3, lr_decay_step_size=1,
                             lr_decay_gamma=0.1))
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(6)]
    tx, jax_schedule = jax_configure_optimizers(hp, steps_per_epoch=2)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = tx.init(params)
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, schedule = configure_optimizers(hp, 2, torch_params.values())
    for i, g in enumerate(grads):
        assert schedule(i) == pytest.approx(float(jax_schedule(i)), rel=1e-6)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.step()
        for k, p in torch_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6, atol=1e-7)


def _jax_start(mesh, grad_accum=1):
    tx, _ = jax_configure_optimizers(HP, steps_per_epoch=1)
    state = create_train_state(JaxViT(**SMALL), jax.random.key(3), tx)
    state = jax.device_put(state, replicated_sharding(mesh))
    step = make_train_step(mesh, augment=False, grad_accum=grad_accum)
    return state, step


def _port_start(state, grad_accum=1):
    model = ViT(**SMALL)
    model.load_state_dict(vit_from_jax(jax.device_get(state.params)))
    opt, schedule = configure_optimizers(HP, 1, model.parameters())
    return model, TrainStep(model, opt, schedule, augment=False, grad_accum=grad_accum)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_jax_make_train_step(mesh, grad_accum):
    """A depth-2 ViT (dim 64, 2 heads, 32 px) carried across with
    ``vit_from_jax``: three steps on the same batch through JAX's
    ``make_train_step(mesh, augment=False)`` and the port's ``TrainStep``,
    fp32, across the LR decay after step 2.  Loss, grad norm and top-1
    count agree after each step, and every parameter; bounds 1e-5 (loss,
    grad norm relative) and 2e-6 absolute on parameters (of size ~0.1-1):
    fp32 summation order through two blocks, compounded over three
    updates."""
    state, step = _jax_start(mesh, grad_accum)
    model, port_step = _port_start(state, grad_accum)
    images, labels = synthetic_dataset(16, seed=0)
    for i in range(3):
        with jax.default_matmul_precision("highest"):
            state, m = step(state, jnp.asarray(images), jnp.asarray(labels), jax.random.key(i))
        got = port_step(torch.from_numpy(images), torch.from_numpy(labels).long())
        assert float(got["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
        assert float(got["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=1e-5)
        assert int(got["top1_count"]) == int(m["top1_count"])
        assert float(got["skipped"]) == float(m["skipped"]) == 0.0
        want = vit_from_jax(jax.device_get(state.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-6, rtol=0, err_msg=name)
    assert port_step.applied == int(state.step) == 3


def test_nan_step_is_skipped_on_both_sides(mesh):
    """A NaN in the head's bias makes the loss and every gradient NaN: both
    guards skip the update, keeping params, momentum and the step count."""
    state, step = _jax_start(mesh)
    params = jax.device_get(state.params)
    params["head"]["bias"] = np.full_like(params["head"]["bias"], np.nan)
    state = jax.device_put(state.replace(params=params), replicated_sharding(mesh))
    model, port_step = _port_start(state)
    images, labels = synthetic_dataset(16, seed=1)
    new_state, m = step(state, jnp.asarray(images), jnp.asarray(labels), jax.random.key(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = port_step(torch.from_numpy(images), torch.from_numpy(labels).long())
    assert float(m["skipped"]) == float(got["skipped"]) == 1.0
    assert int(new_state.step) == 0 and port_step.applied == 0
    assert not port_step.optimizer.state  # no momentum buffer was touched
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, before[name], rtol=0, atol=0, equal_nan=True)


def test_train_step_rejects_an_unsplittable_batch(mesh):
    _, port_step = _port_start(_jax_start(mesh)[0], grad_accum=3)
    images, labels = synthetic_dataset(16, seed=0)
    with pytest.raises(ValueError, match="micro-batches"):
        port_step(torch.from_numpy(images), torch.from_numpy(labels).long())


def test_entry_trains_and_tests_on_the_cpu(tmp_path):
    """The port's entry point without ``--serve``: fit then test, on the
    CPU, with augmentation on; every metric finite."""
    results = entry.run([
        "--device", "cpu", "--model", "vit_tiny", "--synthetic-data",
        "--limit-examples", "48", "--batch-size", "16", "--epoch", "2",
        "--contain-test", "--eval-step", "2", "--ckpt-path", str(tmp_path),
    ])
    epochs = results["fit"]["epochs"]
    assert [e["steps"] for e in epochs] == [2, 2] and results["fit"]["applied_steps"] == 4
    assert all(e["skipped"] == 0 and e["nonfinite_losses"] == 0 for e in epochs)
    assert epochs[1]["lr"] == 0.1
    for value in (*[e[k] for e in epochs for k in ("train_loss", "val_loss", "val_acc")],
                  results["test_loss"], results["test_top1"], results["test_top5"]):
        assert np.isfinite(value)
    assert 0.0 <= results["test_top1"] <= results["test_top5"] <= 100.0


def test_models_without_a_port_raise_in_the_trainer(tmp_path):
    """Every model is ported now: no zoo name raises in the trainer's
    ``build_model`` (built on the meta device, no weights drawn), and the
    entry point's default, ``resnet18``, trains with no ``--model`` flag on
    the CPU."""
    for name in port_config.MODELS:
        with torch.device("meta"):
            model = build_model(port_config.load_config(["--device", "cpu", "--model", name]))
        assert model.num_classes == 100, name
    results = entry.run(["--device", "cpu", "--synthetic-data", "--limit-examples", "32",
                         "--batch-size", "16", "--epoch", "1", "--ckpt-path", str(tmp_path)])
    (epoch,) = results["fit"]["epochs"]
    assert results["fit"]["applied_steps"] == 1 and np.isfinite(epoch["train_loss"])
