"""The port's step program against its eager step and the JAX package's
programs, on the CPU.

``EpochRunner`` and ``EvalRunner`` (``train/step.py``) run their step
bodies eagerly here, as they run on the CPU in the product: a card captures
the same bodies as CUDA graphs (``tests/test_torch_port_step_program_gpu.py``
holds replays against eager steps there).  An epoch of the runner against
the eager ``TrainStep`` loop over the same batches and draws; its steps
against JAX ``make_train_step``; a non-finite step in mid-epoch; the LR
table; the eval runner against ``eval_totals`` and JAX ``make_eval_runner``;
the epoch's draws; and the launch counters' accounting across a capture.
Models: a depth-2 ViT (dim 64) and ResNet-18 at 16 px (its JAX
comparisons at one block a stage, the widths of ResNet-18, as
``tests/test_torch_port_resnet_train.py`` runs them).  JAX runs on the test
suite's 8-device CPU mesh at ``highest`` matmul precision; each tolerance
is stated beside its comparison.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.models import BasicBlock as JaxBasicBlock
from distributed_training_comparison_tpu.models import ResNet as JaxResNet
from distributed_training_comparison_tpu.models import ViT as JaxViT
from distributed_training_comparison_tpu.parallel import make_mesh, replicated_sharding
from distributed_training_comparison_tpu.train import (
    configure_optimizers as jax_configure_optimizers,
)
from distributed_training_comparison_tpu.train import (
    create_train_state,
    make_eval_runner,
    make_train_step,
)
from distributed_training_comparison_tpu_torch import ops
from distributed_training_comparison_tpu_torch.data import (
    DeviceSplit,
    draw_crop_flip,
    draw_epoch_crop_flip,
    synthetic_dataset,
)
from distributed_training_comparison_tpu_torch.health import select_tree
from distributed_training_comparison_tpu_torch.models import (
    BasicBlock,
    BatchNorm2d,
    ResNet,
    ViT,
    get_model,
    resnet_from_jax,
    vit_from_jax,
)
from distributed_training_comparison_tpu_torch.train import (
    DeviceSGD,
    EpochRunner,
    EvalRunner,
    TrainStep,
    configure_optimizers,
    eval_totals,
    lr_table,
)
from distributed_training_comparison_tpu_torch.utils import step_generator
from distributed_training_comparison_tpu_torch.utils.graphs import CapturedStep, LaunchLedger

SMALL_VIT = dict(depth=2, dim=64, heads=2, image_size=32)
BLOCKS = (1, 1, 1, 1)
SEED = 3


class HP:
    """Two steps an epoch and a decay every epoch: the third step runs at a
    tenth of the first two's learning rate."""

    lr = 0.01
    weight_decay = 1e-4
    lr_decay_step_size = 1
    lr_decay_gamma = 0.1


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(backend="ddp")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one thread: the suite runs files in parallel
    worker processes, where each worker's default of a thread per core
    oversubscribes the CPU and slows these ResNet steps ~40x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(kind: str) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(7)
    model = ViT(**SMALL_VIT) if kind == "vit" else get_model("resnet18")
    model.init_weights(gen)
    return model


def _split(kind: str, n: int = 16, seed: int = 0) -> DeviceSplit:
    size = 32 if kind == "vit" else 16
    images, labels = synthetic_dataset(n, image_shape=(size, size, 3), seed=seed)
    return DeviceSplit(images, labels, "cpu")


def _runner(model, split, batch, epochs, grad_accum=1, augment=True):
    opt, schedule = configure_optimizers(HP, split.steps_per_epoch(batch), model.parameters())
    sgd = DeviceSGD(opt, lr_table(schedule, epochs * split.steps_per_epoch(batch), "cpu"))
    runner = EpochRunner(model, sgd, split, batch, seed=SEED, augment=augment,
                         grad_accum=grad_accum)
    return runner, sgd


def _state(model, optimizer) -> dict[str, torch.Tensor]:
    """Every tensor of a step's state: parameters, buffers (the running
    statistics), momentum buffers (zero where none exists yet)."""
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        out[f"momentum:{name}"] = torch.zeros_like(p) if buf is None else buf.clone()
    return out


def _assert_bitwise(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, equal_nan=True, msg=k)


@pytest.mark.parametrize("kind,grad_accum", [("vit", 1), ("resnet", 1), ("resnet", 2)])
def test_epochs_through_the_runner_equal_the_eager_train_step_bit_for_bit(kind, grad_accum):
    """Two epochs of two steps (16 images, batch 8, augmented, a decay
    after the first epoch) through ``EpochRunner`` and through the eager
    ``TrainStep`` over ``split.epoch_batches`` with each step's
    ``draw_crop_flip`` draws, from the same weights: every per-step metric,
    parameter, momentum buffer and running statistic bit for bit.  The
    runner's update (``DeviceSGD``: foreach ops, ``addcmul`` by the device
    LR, ``where`` by the finite flag) rounds where torch's SGD rounds."""
    split, batch, epochs = _split(kind), 8, 2
    model = _build(kind)
    eager = _build(kind)
    eager.load_state_dict(model.state_dict())
    runner, sgd = _runner(model, split, batch, epochs, grad_accum)
    opt, schedule = configure_optimizers(HP, split.steps_per_epoch(batch), eager.parameters())
    step = TrainStep(eager, opt, schedule, grad_accum=grad_accum)
    for epoch in range(epochs):
        got = runner.run_epoch(epoch)
        want = {k: [] for k in got}
        for i, (images, labels) in enumerate(split.epoch_batches(batch, SEED, epoch)):
            m = step(images, labels, draw_crop_flip(batch, step_generator(SEED, epoch, i)))
            for k in want:
                want[k].append(float(m[k]))
        for k in got:
            np.testing.assert_array_equal(got[k], np.float32(want[k]), err_msg=k)
        _assert_bitwise(_state(model, sgd.optimizer), _state(eager, opt))
    assert int(sgd.applied) == step.applied == epochs * runner.steps
    assert float(sgd.lr) == np.float32(schedule(step.applied - 1))


def _jax_state(kind, mesh, steps_per_epoch):
    tx, _ = jax_configure_optimizers(HP, steps_per_epoch=steps_per_epoch)
    module = JaxViT(**SMALL_VIT) if kind == "vit" else JaxResNet(block=JaxBasicBlock,
                                                                num_blocks=BLOCKS)
    state = create_train_state(module, jax.random.key(4), tx)
    return jax.device_put(state, replicated_sharding(mesh))


def _port_from_jax(kind, state) -> torch.nn.Module:
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    if kind == "vit":
        model = ViT(**SMALL_VIT)
        model.load_state_dict(vit_from_jax(variables["params"]))
    else:
        model = ResNet(BasicBlock, BLOCKS)
        model.load_state_dict(resnet_from_jax(variables))
    return model


def _from_jax(kind, state) -> dict:
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    return vit_from_jax(variables["params"]) if kind == "vit" else resnet_from_jax(variables)


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_runner_steps_match_jax_make_train_step(mesh, kind):
    """Three runner steps (an epoch of two at batch 8 over 16 images, then
    the first of the next epoch at a tenth of the LR), unaugmented, against
    JAX ``make_train_step(mesh, augment=False)`` on the same batches, in
    fp32, one step at a time.  The bounds are those of the eager step's
    tests: the ViT's of ``test_three_train_steps_match_jax_make_train_step``
    (loss and grad norm 1e-5 relative, parameters 2e-6 absolute: fp32
    summation order through two blocks over three updates); the ResNet's of
    ``test_two_guarded_steps_match_jax_make_train_step`` (loss 1e-5, grad
    norm 1e-3 relative: BatchNorm's cancelling sums; parameters 2e-5
    absolute; running statistics 1e-4 absolute and 1e-5 relative)."""
    split, batch = _split(kind), 8
    state = _jax_state(kind, mesh, split.steps_per_epoch(batch))
    step = make_train_step(mesh, augment=False)
    model = _port_from_jax(kind, state)
    runner, sgd = _runner(model, split, batch, epochs=2, augment=False)
    for epoch, steps in ((0, 2), (1, 1)):
        runner.start_epoch(epoch)
        batches = split.epoch_batches(batch, SEED, epoch)
        for i in range(steps):
            images, labels = next(batches)
            with jax.default_matmul_precision("highest"):
                state, m = step(state, jnp.asarray(images.numpy()),
                                jnp.asarray(labels.numpy().astype(np.int32)), jax.random.key(i))
            runner.step()
            got = dict(zip(runner.keys, runner.metrics[i].tolist()))
            assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
            assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                                     rel=1e-5 if kind == "vit" else 1e-3)
            assert got["top1_count"] == int(m["top1_count"])
            assert got["skipped"] == float(m["skipped"]) == 0.0
            want = _from_jax(kind, state)
            for name, p in model.state_dict().items():
                if name.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-4,
                                               rtol=1e-5, err_msg=name)
                elif not name.endswith("num_batches_tracked"):
                    atol = 2e-6 if kind == "vit" else 2e-5
                    np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol, rtol=0,
                                               err_msg=name)
    assert int(sgd.applied) == int(state.step) == 3


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_a_nan_step_in_mid_epoch_keeps_the_whole_state(kind):
    """The second of four steps (32 images, batch 8) sees a NaN head
    output: that step keeps every parameter, momentum buffer, running
    statistic, the applied-step count and the device LR bit for bit, as
    JAX's ``select_tree`` keeps the entire old state; it is counted as
    skipped and the steps after it apply.  The NaN step sits at the LR
    boundary of a two-step epoch schedule, so the LR of the step after it
    is still the undecayed one (the schedule counts applied steps)."""
    split, batch = _split(kind, n=32), 8
    model = _build(kind)
    opt, schedule = configure_optimizers(HP, 2, model.parameters())
    sgd = DeviceSGD(opt, lr_table(schedule, 4, "cpu"))
    runner = EpochRunner(model, sgd, split, batch, seed=SEED)
    head = model.head if kind == "vit" else model.linear
    calls = {"n": 0}

    def poison(module, inputs, out):
        calls["n"] += 1
        return out * float("nan") if calls["n"] == 2 else out

    head.register_forward_hook(poison)
    runner.start_epoch(0)
    runner.step()
    before = _state(model, opt)
    before_lr, before_applied = sgd.lr.clone(), int(sgd.applied)
    runner.step()
    _assert_bitwise(_state(model, opt), before)
    assert torch.equal(sgd.lr, before_lr) and int(sgd.applied) == before_applied == 1
    if kind == "resnet":
        assert any(isinstance(m, BatchNorm2d) for m in model.modules())
    runner.step()
    runner.step()
    metrics = dict(zip(runner.keys, runner.metrics.T.numpy()))
    assert metrics["skipped"].tolist() == [0.0, 1.0, 0.0, 0.0]
    assert np.isnan(metrics["loss"][1]) and np.isfinite(np.delete(metrics["loss"], 1)).all()
    assert int(sgd.applied) == 3
    # the step after the skip ran at applied count 1 (undecayed), the last at 2
    assert float(sgd.lr) == np.float32(schedule(2)) == np.float32(HP.lr * HP.lr_decay_gamma)


def test_select_tree_keeps_the_side_not_taken_out_of_the_result():
    new = [torch.tensor([1.0, float("nan")]), torch.tensor([float("inf")])]
    old = [torch.tensor([2.0, 3.0]), torch.tensor([4.0])]
    out = [t.clone() for t in old]
    select_tree(torch.tensor(False), new, old, out)
    assert all(torch.equal(o, t) for o, t in zip(out, old))
    select_tree(torch.tensor(True), new, old, out)
    assert out[0][0].item() == 1.0 and torch.isnan(out[0][1]) and out[1].item() == float("inf")
    with pytest.raises(ValueError, match="select_tree"):
        select_tree(torch.tensor(True), new, old[:1], out)


def test_lr_table_crosses_a_decay_as_the_schedules_do():
    """Two steps an epoch, a decay every epoch, three decays: the device
    table holds ``float32(step_lr_schedule(k))`` at every applied count, bit
    for bit (the value torch's SGD rounds its float LR to), and changes at
    exactly the counts where optax's staircase changes; optax computes the
    power in fp32 and lands within an ulp (1e-6 relative, the bound of
    ``test_sgd_and_step_lr_follow_the_optax_chain_across_a_decay``).  A
    count past the table reads its last entry."""
    for lr, gamma in ((0.1, 0.1), (0.05, 0.2), (0.1, 0.5)):
        hp = type("HP", (), dict(lr=lr, weight_decay=1e-4, lr_decay_step_size=1,
                                 lr_decay_gamma=gamma))
        _, jax_schedule = jax_configure_optimizers(hp, steps_per_epoch=2)
        opt, schedule = configure_optimizers(hp, 2, [torch.nn.Parameter(torch.zeros(3))])
        table = lr_table(schedule, 6, "cpu")
        assert table.dtype == torch.float32 and table.shape == (7,)
        want = np.array([schedule(k) for k in range(7)], dtype=np.float32)
        np.testing.assert_array_equal(table.numpy(), want)
        optax_values = np.array([float(jax_schedule(k)) for k in range(7)])
        np.testing.assert_allclose(table.numpy(), optax_values, rtol=1e-6, atol=0)
        changes = lambda v: [k for k in range(1, 7) if v[k] != v[k - 1]]  # noqa: E731
        assert changes(table.numpy()) == changes(optax_values) == [2, 4, 6]
        sgd = DeviceSGD(opt, table)
        sgd.applied.fill_(9)
        opt.param_groups[0]["params"][0].grad = torch.ones(3)
        sgd.step(torch.tensor(True))
        assert float(sgd.lr) == want[-1] and int(sgd.applied) == 10


def test_device_sgd_momentum_starts_at_zero_where_torch_keeps_it():
    """The buffers are ``optimizer.state[p]["momentum_buffer"]``, zero at the
    start; the first update equals torch's SGD (whose first step copies d)
    bit for bit, and an existing buffer is taken as it is."""
    torch.manual_seed(0)
    a = [torch.nn.Parameter(torch.randn(5, 3)), torch.nn.Parameter(torch.randn(3))]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    opt_a, schedule = configure_optimizers(HP, 2, a)
    opt_b, _ = configure_optimizers(HP, 2, b)
    sgd = DeviceSGD(opt_b, lr_table(schedule, 4, "cpu"))
    assert all(torch.equal(opt_b.state[p]["momentum_buffer"], torch.zeros_like(p)) for p in b)
    for i in range(3):
        grads = [torch.randn_like(p) for p in a]
        for p, q, g in zip(a, b, grads):
            p.grad, q.grad = g.clone(), g.clone()
        for group in opt_a.param_groups:
            group["lr"] = schedule(i)
        opt_a.step()
        sgd.step(torch.tensor(True))
        for p, q in zip(a, b):
            assert torch.equal(p, q)
            assert torch.equal(opt_a.state[p]["momentum_buffer"], opt_b.state[q]["momentum_buffer"])
    kept = opt_b.state[b[0]]["momentum_buffer"]
    assert DeviceSGD(opt_b, sgd.table).optimizer.state[b[0]]["momentum_buffer"] is kept


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_eval_runner_totals_equal_eval_totals_and_jax_make_eval_runner(mesh, kind):
    """A split of 20 in batches of 8 (the last padded with 4 copies of the
    first example at weight 0), after one JAX train step (the ResNet's
    running statistics moved), with the model left in train mode by the
    caller: ``EvalRunner.run`` equals ``eval_totals`` over
    ``split.eval_batches`` bit for bit, twice in a row (the totals start
    anew each pass), and gives the train mode back; against JAX
    ``make_eval_runner`` on the same padded arrays: the loss sum within
    1e-5 relative, the hit counts and the weight total exactly."""
    split_train = _split(kind, n=8, seed=2)
    state = _jax_state(kind, mesh, 1)
    images, labels = split_train.images.numpy(), split_train.labels.numpy().astype(np.int32)
    state, _ = make_train_step(mesh, augment=False)(state, jnp.asarray(images),
                                                    jnp.asarray(labels), jax.random.key(0))
    model = _port_from_jax(kind, state).train()
    split = _split(kind, n=20, seed=3)
    runner = EvalRunner(model, split, 8)
    want = eval_totals(model, split.eval_batches(8))
    assert runner.run() == want and runner.run() == want
    assert model.training
    idx = np.r_[np.arange(20), np.zeros(4, dtype=int)]
    weights = np.r_[np.ones(20), np.zeros(4)].astype(np.float32)
    x, y = split.images.numpy()[idx], split.labels.numpy()[idx].astype(np.int32)
    with jax.default_matmul_precision("highest"):
        ref = jax.device_get(make_eval_runner(mesh, 8)(state, jnp.asarray(x), jnp.asarray(y),
                                                       jnp.asarray(weights)))
    assert want["loss_sum"] == pytest.approx(float(ref["loss_sum"]), rel=1e-5)
    for key in ("top1_count", "top5_count", "count"):
        assert want[key] == float(ref[key])


def test_epoch_draws_equal_the_per_step_draws_byte_for_byte():
    offsets, flips = draw_epoch_crop_flip(12, 5, seed=3, epoch=2)
    assert offsets.shape == (5, 12, 2) and flips.shape == (5, 12)
    assert offsets.dtype == torch.int64 and flips.dtype == torch.bool
    for i in range(5):
        o, f = draw_crop_flip(12, step_generator(3, 2, i))
        assert torch.equal(offsets[i], o) and torch.equal(flips[i], f)
    # the runner uploads the epoch's draws and permutation once
    split = _split("vit", n=40)
    runner, _ = _runner(_build("vit"), split, 8, epochs=1)
    runner.start_epoch(1)
    offsets, flips = draw_epoch_crop_flip(8, 5, seed=SEED, epoch=1)
    assert torch.equal(runner.offsets, offsets) and torch.equal(runner.flips, flips)
    rows = [labels for _, labels in split.epoch_batches(8, SEED, 1)]
    assert torch.equal(split.labels[runner.perm], torch.stack(rows))


class _Counter:
    """A stand-in for a counted wrapper: a plain-int ``launches``."""

    def __init__(self) -> None:
        self.launches = 0


def test_launch_ledger_takes_a_capture_back_and_counts_each_replay():
    """A capture calls the wrappers (their counters move) but launches
    nothing: the ledger takes the movement back off and adds it once per
    replay; a capture that raises leaves the counters as they were."""
    a, b = _Counter(), _Counter()
    a.launches = 5
    ledger = LaunchLedger([a, b])
    with ledger.capturing():
        a.launches += 4
        b.launches += 1
    assert (a.launches, b.launches) == (5, 0) and ledger.deltas == [4, 1]
    for _ in range(3):
        ledger.replayed()
    assert (a.launches, b.launches) == (17, 3)
    failed = LaunchLedger([a])
    with pytest.raises(RuntimeError), failed.capturing():
        a.launches += 2
        raise RuntimeError("capture refused")
    assert a.launches == 17


def test_captured_step_runs_eagerly_on_the_cpu():
    """On the CPU the step body runs at every call and returns what it
    returns; no graph is held and the counters move as the body moves
    them."""
    counter = _Counter()
    calls = []

    def body():
        counter.launches += 1
        calls.append(len(calls))
        return torch.tensor(float(len(calls)))

    step = CapturedStep(body, "cpu", counters=lambda: [counter], pool=None)
    assert [float(step()) for _ in range(3)] == [1.0, 2.0, 3.0]
    assert counter.launches == 3 and not step.prepare() and not step.captured


def test_the_registry_lists_every_counted_wrapper():
    """``ops.COUNTED_WRAPPERS`` names every module-level function of the
    port's ops that counts launches (a ``launches`` attribute), and
    ``counted_wrappers`` gives each as its module holds it now."""
    found = set()
    for module in ("attention", "attention_small", "moe_gmm", "vit_block"):
        mod = importlib.import_module(f"{ops.__name__}.{module}")
        for name, obj in vars(mod).items():
            if inspect.isfunction(obj) and hasattr(obj, "launches") and obj.__module__ == mod.__name__:
                found.add((module, name))
    listed = {(m, n) for m, names in ops.COUNTED_WRAPPERS.items() for n in names}
    assert listed == found
    wrappers = ops.counted_wrappers()
    assert len(wrappers) == len(listed) and all(hasattr(w, "launches") for w in wrappers)
    mod = importlib.import_module(f"{ops.__name__}.attention")
    real = mod.flash_attention

    def planted(*args, **kw):
        return real(*args, **kw)

    planted.launches = 0
    mod.flash_attention = planted
    try:
        assert planted in ops.counted_wrappers() and real not in ops.counted_wrappers()
    finally:
        mod.flash_attention = real
    assert ops.counted_wrappers() == wrappers


def test_trainer_fit_runs_the_step_program_on_the_cpu(tmp_path):
    """``Trainer.fit`` trains through ``EpochRunner`` and validates through
    ``EvalRunner``: the epoch records equal an eager ``TrainStep`` loop's
    and ``eval_totals``' on the same start (ResNet-18, 16 px, 32 images,
    batch 8), and ``applied_steps`` is the device count."""
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.train import Trainer

    hp = load_config(["--device", "cpu", "--synthetic-data", "--image-size", "16",
                      "--limit-examples", "40", "--batch-size", "8", "--epoch", "2",
                      "--lr", "0.01", "--ckpt-path", str(tmp_path)])
    trainer = Trainer(hp)
    reference = Trainer(hp)
    fit = trainer.fit()
    assert fit["applied_steps"] == 2 * trainer.steps_per_epoch == 8
    assert set(trainer.eval_runners) == {"val"}
    for epoch, record in enumerate(fit["epochs"]):
        losses = []
        for i, (images, labels) in enumerate(
                reference.train_split.epoch_batches(hp.batch_size, hp.seed, epoch)):
            draws = draw_crop_flip(len(labels), step_generator(hp.seed, epoch, i))
            losses.append(float(reference.step(images, labels, draws)["loss"]))
        assert record["train_loss"] == pytest.approx(np.mean(np.float32(losses)), rel=1e-6)
        val = eval_totals(reference.model, reference.val_split.eval_batches(hp.batch_size))
        assert record["val_loss"] == val["loss_sum"] / val["count"]
    _assert_bitwise(_state(trainer.model, trainer.optimizer),
                    _state(reference.model, reference.optimizer))
