"""The step's state in flat buffers (``train/flat.py``), on the CPU.

``DeviceSGD`` holds the parameters and their momentum buffers, and
``EpochRunner`` BatchNorm's running statistics, as views into one flat
buffer per dtype; the guarded update runs a few launches over those
buffers.  Held here: the flat update against ``torch.optim.SGD`` bit for
bit (ResNet-18 at 16 px in ``channels_last``, a 2-block ``vit_tiny``), a
non-finite step that changes nothing, the tensors' identity, storage,
alignment and memory format, a parameter without a gradient, the flat
gradient norm against the JAX ``global_norm``, a restore into the views,
and one ``where`` a flat buffer under the profiler.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distributed_training_comparison_tpu.health.guards import global_norm as jax_global_norm
from distributed_training_comparison_tpu_torch.data import DeviceSplit, synthetic_dataset
from distributed_training_comparison_tpu_torch.health import global_norm
from distributed_training_comparison_tpu_torch.models import BatchNorm2d, ViT, get_model
from distributed_training_comparison_tpu_torch.train import (
    DeviceSGD,
    EpochRunner,
    TrainState,
    configure_optimizers,
    forward_backward,
    lr_table,
)
from distributed_training_comparison_tpu_torch.train.flat import ALIGN_BYTES, flat_buffers

SEED = 3


class HP:
    """A decay after every two steps: the third step runs at a tenth of
    the first two's learning rate."""

    lr = 0.05
    weight_decay = 1e-4
    lr_decay_step_size = 1
    lr_decay_gamma = 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One thread for the port's convolutions: the suite runs files in
    parallel worker processes, where a thread per core in each worker
    oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _build(kind: str) -> torch.nn.Module:
    model = (ViT(depth=2, dim=192, heads=3, image_size=32) if kind == "vit_tiny"
             else get_model("resnet18"))
    model.init_weights(torch.Generator().manual_seed(7))
    return model


def _pair(kind: str):
    """Two copies of one model: one under torch's SGD, one under
    ``DeviceSGD`` (its parameters and momentum then in flat buffers)."""
    ref, flat = _build(kind), _build(kind)
    flat.load_state_dict(ref.state_dict())
    opt, schedule = configure_optimizers(HP, 2, ref.parameters())
    opt_flat, _ = configure_optimizers(HP, 2, flat.parameters())
    sgd = DeviceSGD(opt_flat, lr_table(schedule, 6, "cpu"))
    return ref, opt, schedule, flat, sgd


def _batch(kind: str, seed: int):
    size = 16 if kind == "resnet" else 32
    images, labels = synthetic_dataset(8, image_shape=(size, size, 3), seed=seed)
    return torch.from_numpy(images), torch.from_numpy(labels).long()


@pytest.mark.parametrize("kind", ["resnet", "vit_tiny"])
def test_the_flat_update_equals_torch_sgd_bit_for_bit(kind):
    """Three steps from one start, the third across the LR decay: each
    step's gradients computed once (on the torch side) and given to both;
    torch's SGD (nesterov, momentum 0.9, coupled weight decay) updates one
    copy a tensor at a time, ``DeviceSGD`` the other over its flat
    buffers.  Every parameter and momentum buffer bit for bit: each op of
    the flat update rounds as torch's per-tensor op does."""
    ref, opt, schedule, flat, sgd = _pair(kind)
    for step in range(3):
        images, labels = _batch(kind, step)
        forward_backward(ref, images, labels)
        for p, q in zip(ref.parameters(), flat.parameters()):
            q.grad = p.grad.clone()
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        sgd.step(torch.tensor(True))
        for (name, p), q in zip(ref.named_parameters(), flat.parameters()):
            assert torch.equal(p, q), (step, name)
            assert torch.equal(opt.state[p]["momentum_buffer"],
                               sgd.optimizer.state[q]["momentum_buffer"]), (step, name)
    assert int(sgd.applied) == 3 and float(sgd.lr) == np.float32(schedule(2))


def _live_state(model, sgd) -> dict[str, torch.Tensor]:
    out = {k: v.clone() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        out[f"momentum:{name}"] = sgd.optimizer.state[p]["momentum_buffer"].clone()
    return out


def _runner(model, n=16, batch=8, augment=True):
    opt, schedule = configure_optimizers(HP, n // batch, model.parameters())
    sgd = DeviceSGD(opt, lr_table(schedule, 8, "cpu"))
    images, labels = synthetic_dataset(n, image_shape=(16, 16, 3), seed=0)
    runner = EpochRunner(model, sgd, DeviceSplit(images, labels, "cpu"), batch, seed=SEED,
                         augment=augment)
    return runner, sgd


def test_a_nan_gradient_in_one_tensor_changes_nothing():
    """ResNet-18 at 16 px through ``EpochRunner``: a finite step, then a
    step whose gradient is NaN in one parameter only (a hook on
    ``layer2.0.conv1.weight``), the loss finite.  The norm is NaN, so the
    step keeps every parameter, momentum buffer, running statistic (which
    the forward did move), ``applied`` and ``lr`` bit for bit, and no NaN
    reaches the state; the step is counted as skipped."""
    model = _build("resnet")
    runner, sgd = _runner(model)
    runner.start_epoch(0)
    runner.step()
    before = _live_state(model, sgd)
    lr, applied = sgd.lr.clone(), int(sgd.applied)
    target = model.layer2[0].conv1.weight
    handle = target.register_hook(lambda g: g * float("nan"))
    runner.step()
    handle.remove()
    after = _live_state(model, sgd)
    assert after.keys() == before.keys()
    for k in before:
        assert torch.equal(after[k], before[k]), k
        assert not torch.isnan(after[k].float()).any(), k
    assert torch.equal(sgd.lr, lr) and int(sgd.applied) == applied == 1
    assert torch.isnan(sgd.grads.flats[0]).any()  # the NaN reached the gradient buffer only
    metrics = dict(zip(runner.keys, runner.metrics[1].tolist()))
    assert metrics["skipped"] == 1.0 and np.isfinite(metrics["loss"])
    assert np.isnan(metrics["grad_norm"])


@pytest.mark.parametrize("kind", ["resnet", "vit_tiny"])
def test_identity_storage_alignment_and_memory_format_are_kept(kind):
    """After ``DeviceSGD`` and ``EpochRunner``: every parameter and
    momentum buffer is the object it was, a view into its kind's one flat
    buffer (one storage for all parameters, one for all momentum, one for
    all running statistics), each at an offset aligned to ``ALIGN_BYTES``,
    with its strides kept (a ResNet's convolution weights stay
    ``channels_last``); the values are the ones they had.  A second
    ``DeviceSGD`` on the same optimizer moves nothing."""
    model = _build(kind)
    params = list(model.parameters())
    values = {k: v.clone() for k, v in model.state_dict().items()}
    strides = [p.stride() for p in params]
    opt, schedule = configure_optimizers(HP, 2, params)
    buf = torch.randn_like(params[0])
    buf_values = buf.clone()
    opt.state[params[0]]["momentum_buffer"] = buf
    sgd = DeviceSGD(opt, lr_table(schedule, 4, "cpu"))
    if kind == "resnet":
        _runner_over(model, sgd)
    assert all(a is b for a, b in zip(model.parameters(), params, strict=True))
    assert opt.state[params[0]]["momentum_buffer"] is buf
    assert all(p.stride() == s for p, s in zip(params, strides))
    if kind == "resnet":
        convs = [m.weight for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
        assert convs and all(w.is_contiguous(memory_format=torch.channels_last) for w in convs)
    for k, v in model.state_dict().items():
        assert torch.equal(v, values[k]), k
    momentum = [opt.state[p]["momentum_buffer"] for p in params]
    stats = [b for m in model.modules() if isinstance(m, BatchNorm2d)
             for b in (m.running_mean, m.running_var)]
    for kind_tensors, flats in ((params, sgd.flat_params), (momentum, sgd.flat_momentum)):
        assert len(flats) == 1
        base = flats[0].data_ptr()
        for t in kind_tensors:
            assert t.untyped_storage().data_ptr() == flats[0].untyped_storage().data_ptr()
            assert (t.data_ptr() - base) % ALIGN_BYTES == 0
    assert torch.equal(momentum[0], buf_values) and not any(m.any() for m in momentum[1:])
    if kind == "resnet":
        flats = flat_buffers(stats)
        assert flats is not None and len(flats) == 1
    ptrs = [p.data_ptr() for p in params]
    DeviceSGD(opt, sgd.table)
    assert [p.data_ptr() for p in params] == ptrs


def _runner_over(model, sgd):
    images, labels = synthetic_dataset(16, image_shape=(16, 16, 3), seed=0)
    return EpochRunner(model, sgd, DeviceSplit(images, labels, "cpu"), 8, seed=SEED)


def test_a_parameter_without_a_gradient_is_left_alone():
    """Parameters 0..k without a gradient among those with one: the flat
    update leaves them and their momentum as torch's SGD does (no weight
    decay, no momentum), equals torch's SGD bit for bit on the others, and
    the set is held from the first step: a parameter that gains a
    gradient later raises."""
    torch.manual_seed(0)
    shapes = [(5, 3), (7,), (4, 4, 3, 3), (3,), (11,)]
    a = [torch.nn.Parameter(torch.randn(s)) for s in shapes]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    opt_a, schedule = configure_optimizers(HP, 2, a)
    opt_b, _ = configure_optimizers(HP, 2, b)
    sgd = DeviceSGD(opt_b, lr_table(schedule, 4, "cpu"))
    missing = {1, 3}
    for step in range(2):
        for i, (p, q) in enumerate(zip(a, b)):
            g = None if i in missing else torch.randn(shapes[i])
            p.grad, q.grad = g, None if g is None else g.clone()
        for group in opt_a.param_groups:
            group["lr"] = schedule(step)
        opt_a.step()
        sgd.step(torch.tensor(True))
        for i, (p, q) in enumerate(zip(a, b)):
            assert torch.equal(p, q), i
            if i in missing:
                assert torch.equal(q, a[i]) and not opt_b.state[q]["momentum_buffer"].any()
            else:
                assert torch.equal(opt_a.state[p]["momentum_buffer"],
                                   opt_b.state[q]["momentum_buffer"]), i
    b[1].grad = torch.ones(7)
    with pytest.raises(RuntimeError, match="static"):
        sgd.step(torch.tensor(True))


@pytest.mark.parametrize("scales", [(1e-3, 1.0, 1e-2, 3.0, 0.1), (1e4, 1e-6, 2.0, 0.5, 7.0)])
def test_global_norm_agrees_with_jax_global_norm(scales):
    """The port's norm (fp64 accumulation over each tensor, here the
    leaves one at a time and their flat concatenation) against the JAX
    ``global_norm`` (fp32 sums of squares, leaf by leaf) on the same
    leaves: within 1e-6 relative (a few fp32 ulps of the JAX sums'
    rounding); the flat form and the per-leaf form of the port agree to
    1e-7.  NaN and Inf anywhere give a non-finite norm on both sides."""
    rng = np.random.default_rng(4)
    sizes = (100_000, 4096, 30_000, 64, 50_000)
    leaves = [(rng.standard_normal(n) * s).astype(np.float32) for n, s in zip(sizes, scales)]
    want = float(jax_global_norm([jnp.asarray(x) for x in leaves]))
    per_leaf = float(global_norm([torch.from_numpy(x) for x in leaves]))
    flat = float(global_norm([torch.from_numpy(np.concatenate(leaves))]))
    assert per_leaf == pytest.approx(want, rel=1e-6)
    assert flat == pytest.approx(want, rel=1e-6)
    assert flat == pytest.approx(per_leaf, rel=1e-7)
    for bad in (np.nan, np.inf):
        leaves[2][17] = bad
        assert not np.isfinite(float(jax_global_norm([jnp.asarray(x) for x in leaves])))
        assert not torch.isfinite(global_norm([torch.from_numpy(np.concatenate(leaves))]))


def test_a_restore_into_the_views_is_bit_for_bit():
    """A ResNet-18 state after two runner steps, snapshotted (one copy of
    its three flat buffers) and restored into a fresh trainer's views:
    every tensor bit for bit, each still the view it was (same object,
    same address), and the snapshot's host tensors are the live tensors,
    in their layout (strides kept)."""
    model = _build("resnet")
    runner, sgd = _runner(model)
    runner.start_epoch(0)
    runner.step()
    runner.step()
    state = TrainState(model, sgd)
    snap = state.snapshot()
    assert snap.flat.numel() == sum(f.numel() for f in
                                    (*sgd.flat_params, *sgd.flat_momentum,
                                     *flat_buffers([b for m in model.modules()
                                                    if isinstance(m, BatchNorm2d)
                                                    for b in (m.running_mean, m.running_var)])))
    host, step = snap.host_tensors()
    live = state.tensors()
    assert step == 2 and host.keys() == live.keys()
    for k, v in live.items():
        assert host[k].stride() == v.stride() and torch.equal(host[k], v), k
    fresh_model = _build("resnet")
    _, fresh_sgd = _runner(fresh_model)
    fresh = TrainState(fresh_model, fresh_sgd)
    ptrs = {k: v.data_ptr() for k, v in fresh.tensors().items()}
    fresh.load_state_dict(snap.state_dict())
    assert {k: v.data_ptr() for k, v in fresh.tensors().items()} == ptrs
    for k, v in fresh.tensors().items():
        assert torch.equal(v, live[k]), k
    assert int(fresh_sgd.applied) == 2


@pytest.mark.parametrize("kind,wheres", [("resnet", 3), ("vit_tiny", 2)])
def test_one_where_for_each_flat_buffer(kind, wheres):
    """One ``guarded_step`` (a runner step, unaugmented: the crop/flip has a
    ``where`` of its own) under ``torch.profiler`` on the CPU runs one
    ``aten::where`` for each flat buffer: the parameters, the momentum and,
    for the ResNet, the running statistics, all fp32 (one dtype), not one
    a tensor (the ResNet has 62 parameters and 40 statistics)."""
    model = _build(kind)
    opt, schedule = configure_optimizers(HP, 2, model.parameters())
    sgd = DeviceSGD(opt, lr_table(schedule, 4, "cpu"))
    size = 16 if kind == "resnet" else 32
    images, labels = synthetic_dataset(16, image_shape=(size, size, 3), seed=0)
    runner = EpochRunner(model, sgd, DeviceSplit(images, labels, "cpu"), 8, seed=SEED,
                         augment=False)
    runner.start_epoch(0)
    runner.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.step()
    names = [e.name for e in prof.events()]
    assert names.count("aten::where") == wheres
    assert wheres <= 3 * len(sgd.flat_params)
    assert len(list(model.parameters())) > 10 * wheres
