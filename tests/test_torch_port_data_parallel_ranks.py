"""Two processes of the port's data-parallel step program over gloo, on the
CPU, against one process on the same global batch and against the JAX
package's step on a 2-device mesh.

One spawn of two ranks (``_rank_worker``, torch pinned to one thread) runs
every case: three steps of the ResNet at one block a stage (ResNet-18's
widths, 16 px, fp32, global batch 8) through ``EpochRunner`` without and
with the crop/flip draws and under ``--grad-accum 2``; three steps with a
NaN planted in rank 1's rows; both eval passes over a padded split; and
one synced ``BatchNorm2d`` alone.  Rank 0 also runs the three cases as one
process whose BatchNorms take the synced path over a group of one: the
same statistics formula (flax's ``mean(x²) - mean(x)²``) on the whole
batch.  This module imports no JAX at its top, so that the ranks start on
torch alone; the JAX steps run in a fixture.  Each tolerance is stated
beside its comparison.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_training_comparison_tpu_torch.data import DeviceSplit, synthetic_dataset
from distributed_training_comparison_tpu_torch.data.sampler import epoch_permutation
from distributed_training_comparison_tpu_torch.models import (
    BasicBlock,
    BatchNorm2d,
    ResNet,
    resnet_from_jax,
    resnet_to_jax,
    sync_batch_norm_,
)
from distributed_training_comparison_tpu_torch.train import (
    DeviceSGD,
    EpochRunner,
    EvalRunner,
    configure_optimizers,
    lr_table,
)

BLOCKS = (1, 1, 1, 1)
BATCH, STEPS, IMAGE = 8, 3, 16
JOIN_TIMEOUT = 120.0
SCENARIOS = {
    "plain": {"grad_accum": 1, "augment": False},
    "draws": {"grad_accum": 1, "augment": True},
    "accum": {"grad_accum": 2, "augment": False},
    "nan": {"grad_accum": 1, "augment": False, "nan_on_rank": 1},
}


class HP:
    """Three steps at 0.01: the StepLR decay comes after them."""

    lr = 0.01
    weight_decay = 1e-4
    lr_decay_step_size = 1
    lr_decay_gamma = 0.1


def _train_data():
    return synthetic_dataset(BATCH * STEPS, image_shape=(IMAGE, IMAGE, 3), seed=0)


def _val_data():  # 13 examples: the second padded batch holds 5
    return synthetic_dataset(13, image_shape=(IMAGE, IMAGE, 3), seed=1)


def _start():
    model = ResNet(BasicBlock, BLOCKS)
    model.init_weights(torch.Generator().manual_seed(4))
    opt, schedule = configure_optimizers(HP, STEPS, model.parameters())
    return model, opt, DeviceSGD(opt, lr_table(schedule, STEPS, "cpu"))


def _state(model, opt) -> dict:
    out = {k: v.clone() for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        out[f"momentum:{name}"] = opt.state[p]["momentum_buffer"].clone()
    return out


def _run(group, *, grad_accum, augment, nan_on_rank=None, bn_group=None) -> dict:
    """Three steps of the step program over ``group`` (None: one process,
    whose BatchNorms sync over ``bn_group`` if given), then, for
    ``plain``, the eval passes."""
    model, opt, sgd = _start()
    if group is not None or bn_group is not None:
        sync_batch_norm_(model, group or bn_group)
    if group is not None:
        if dist.get_rank(group) == nan_on_rank:
            model.conv1.register_forward_pre_hook(lambda m, args: (args[0] * float("nan"),))
    before = _state(model, opt)
    runner = EpochRunner(model, sgd, DeviceSplit(*_train_data(), "cpu"), BATCH, seed=0,
                         augment=augment, grad_accum=grad_accum, group=group)
    out = {"metrics": runner.run_epoch(0), "state": _state(model, opt),
           "applied": int(sgd.applied), "before": before}
    if not augment and grad_accum == 1 and nan_on_rank is None:
        val = DeviceSplit(*_val_data(), "cpu")
        out["eval"] = EvalRunner(model, val, BATCH, group=group).run()
        out["eval_one_process"] = EvalRunner(model, val, BATCH).run()
    return out


def _batch_norm_case():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 4, 5, 5, generator=g) * 3 + 1
    dy = torch.randn(8, 4, 5, 5, generator=g)
    bn = BatchNorm2d(4)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(4, generator=g))
        bn.bias.copy_(torch.randn(4, generator=g))
    return bn, x, dy


def _batch_norm(bn, x, dy) -> dict:
    x = x.clone().requires_grad_()
    bn.train()
    y = bn(x)
    (y * dy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def _rank_worker(rank: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank)
    try:
        group = dist.group.WORLD
        alone = [dist.new_group([r]) for r in range(2)]  # every rank makes every group
        res = {name: _run(group, **kw) for name, kw in SCENARIOS.items()}
        if rank == 0:
            res["one_process"] = {name: _run(None, bn_group=alone[0], **kw)
                                  for name, kw in SCENARIOS.items() if name != "nan"}
        bn, x, dy = _batch_norm_case()
        sync_batch_norm_(bn, group)
        rows = slice(4 * rank, 4 * rank + 4)
        res["batch_norm"] = _batch_norm(bn, x[rows], dy[rows])
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(worker, directory, nprocs: int = 2) -> None:
    """Run ``worker(rank, store, directory)`` in ``nprocs`` spawned
    processes that rendezvous through a file under ``directory``; kill
    them and fail past ``JOIN_TIMEOUT`` seconds."""
    ctx = mp.start_processes(worker, args=(str(directory / "store"), str(directory)),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish within {JOIN_TIMEOUT} s")


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ranks")
    spawn_ranks(_rank_worker, directory)
    return [torch.load(directory / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def one_process(one_thread):
    """The ``plain`` case through the one-process port as it runs
    (``native_batch_norm``'s statistics)."""
    return _run(None, **SCENARIOS["plain"])


@pytest.fixture(scope="module")
def jax_runs(one_thread):
    """The JAX ``make_train_step(mesh, augment=False)`` on
    ``make_mesh(num_devices=2, backend="ddp")`` from the port's initial
    weights, on the port's batches (the numpy ``(seed, epoch)`` order), at
    ``highest`` matmul precision: each step's metrics and the final
    variables in the port's names."""
    import jax
    import jax.numpy as jnp

    from distributed_training_comparison_tpu.models import BasicBlock as JaxBasicBlock
    from distributed_training_comparison_tpu.models import ResNet as JaxResNet
    from distributed_training_comparison_tpu.parallel import make_mesh, replicated_sharding
    from distributed_training_comparison_tpu.train import configure_optimizers as jax_optimizers
    from distributed_training_comparison_tpu.train import create_train_state, make_train_step

    mesh = make_mesh(num_devices=2, backend="ddp")
    images, labels = _train_data()
    perm = epoch_permutation(len(labels), 0, 0)
    out = {}
    for name in ("plain", "accum"):
        model, _, _ = _start()
        tx, _ = jax_optimizers(HP, steps_per_epoch=STEPS)
        state = create_train_state(JaxResNet(block=JaxBasicBlock, num_blocks=BLOCKS),
                                   jax.random.key(4), tx, input_shape=(1, IMAGE, IMAGE, 3))
        start = resnet_to_jax(model.state_dict())
        state = jax.device_put(state.replace(params=start["params"],
                                             batch_stats=start["batch_stats"]),
                               replicated_sharding(mesh))
        step = make_train_step(mesh, augment=False, grad_accum=SCENARIOS[name]["grad_accum"])
        metrics = []
        with jax.default_matmul_precision("highest"):
            for s in range(STEPS):
                rows = perm[s * BATCH : (s + 1) * BATCH]
                state, m = step(state, jnp.asarray(images[rows]), jnp.asarray(labels[rows]),
                                jax.random.key(0))
                metrics.append(jax.device_get(m))
        variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        out[name] = (metrics, resnet_from_jax(variables))
    return out


def test_both_ranks_end_bit_for_bit_equal(ranks):
    """The all-reduced gradients and metrics are the same bits on both
    ranks, so the parameters, momentum, running statistics, step count and
    every metric stay equal bit for bit, in every case."""
    for name in SCENARIOS:
        a, b = ranks[0][name], ranks[1][name]
        assert a["applied"] == b["applied"]
        for k, v in a["metrics"].items():
            assert np.array_equal(v, b["metrics"][k], equal_nan=True), (name, k)
        for k, v in a["state"].items():
            assert torch.equal(v, b["state"][k]), (name, k)


def _is_running(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def _assert_same_steps(got: dict, want: dict, rtol: float) -> None:
    assert got["applied"] == want["applied"] == STEPS
    assert np.array_equal(got["metrics"]["skipped"], np.zeros(STEPS))
    np.testing.assert_array_equal(got["metrics"]["top1_count"], want["metrics"]["top1_count"])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=rtol, err_msg=k)
    for k, v in want["state"].items():
        if v.is_floating_point():
            torch.testing.assert_close(got["state"][k], v, rtol=rtol, atol=rtol * 0.1, msg=k)


@pytest.mark.parametrize("name", ["plain", "draws", "accum"])
def test_two_ranks_train_as_one_process_on_the_global_batch(ranks, name):
    """Each rank steps on its rows of the global batch (and of its draws),
    BatchNorm reduces over the global (micro-)batch and the gradients are
    the global batch's: the three steps are the one-process run's on the
    same global batches, with the same statistics formula.  They differ
    in rounding only (each rank sums half the rows): the loss, ``grad_norm``
    and every parameter, momentum and running statistic to 1e-5 relative
    (read up to ~3e-6), the top-1 counts exactly."""
    _assert_same_steps(ranks[0][name], ranks[0]["one_process"][name], 1e-5)


def test_two_ranks_train_as_the_one_process_port_on_a_plain_batch(ranks, one_process):
    """The same three plain steps against the one-process port as it runs,
    whose BatchNorm takes ``native_batch_norm``'s statistics, not flax's
    ``mean(x²) - mean(x)²``: on these well-conditioned batches the two
    formulas agree to ~1e-7, and the runs to 1e-5 relative.  (Where a
    channel's variance is small against its mean, as behind the crop's
    zero padding or in a micro-batch of two images a rank, the formulas
    part by more, and so do three steps; the JAX package computes flax's.)"""
    _assert_same_steps(ranks[0]["plain"], one_process, 1e-5)


@pytest.mark.parametrize("name", ["plain", "accum"])
def test_two_ranks_train_as_the_jax_two_device_mesh(ranks, jax_runs, name):
    """Against JAX's step on a 2-device data axis (the same global batches,
    no augmentation, fp32): under ``--grad-accum 2`` each global
    micro-batch of 4 is normalized as one, by both.  Bounds as the
    single-process comparison of ``test_torch_port_resnet_train.py``: the
    loss to 1e-5 relative, ``grad_norm`` to 1e-3 (BatchNorm's cancelling
    fp32 gradients differ from fp64 by up to 0.1-0.3% in either package),
    top-1 counts exactly, the parameters to 2e-5 absolute and the running
    statistics to 1e-4 absolute and 1e-5 relative."""
    metrics, variables = jax_runs[name]
    got = ranks[0][name]
    for s, m in enumerate(metrics):
        assert got["metrics"]["loss"][s] == pytest.approx(float(m["loss"]), rel=1e-5)
        assert got["metrics"]["grad_norm"][s] == pytest.approx(float(m["grad_norm"]), rel=1e-3)
        assert got["metrics"]["top1_count"][s] == int(m["top1_count"])
        assert got["metrics"]["skipped"][s] == float(m["skipped"]) == 0.0
    for k, v in variables.items():
        if k.endswith("num_batches_tracked"):
            continue
        if _is_running(k):
            torch.testing.assert_close(got["state"][k], v, atol=1e-4, rtol=1e-5, msg=k)
        else:
            torch.testing.assert_close(got["state"][k], v, atol=2e-5, rtol=0, msg=k)


def test_a_nan_on_one_ranks_rows_makes_both_ranks_skip(ranks):
    """A NaN planted in rank 1's rows reaches rank 0 through the all-reduced
    loss (and the synced BatchNorm): both ranks' guards skip every step,
    and on both the parameters, momentum, running statistics and step
    count stay bit for bit where they began."""
    for r in range(2):
        run = ranks[r]["nan"]
        assert run["applied"] == 0
        assert np.array_equal(run["metrics"]["skipped"], np.ones(STEPS))
        assert not np.isfinite(run["metrics"]["loss"]).any()
        for k, v in run["before"].items():
            assert torch.equal(run["state"][k], v), (r, k)


def test_the_eval_totals_of_two_ranks_count_every_example_once(ranks):
    """Over 13 examples in two padded batches of 8, each rank evaluates its
    4 rows of each batch and the totals are summed across the ranks: the
    counts equal one process's over the whole split exactly (the same
    weights), the loss sum to 1e-6 relative (two partial sums)."""
    for r in range(2):
        got, want = ranks[r]["plain"]["eval"], ranks[r]["plain"]["eval_one_process"]
        assert got["count"] == want["count"] == 13.0
        assert got["top1_count"] == want["top1_count"]
        assert got["top5_count"] == want["top5_count"]
        assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-6)
    assert ranks[0]["plain"]["eval"] == ranks[1]["plain"]["eval"]


def test_a_synced_batch_norm_is_one_batch_norm_over_both_ranks_rows(ranks, one_thread):
    """Two ranks of four rows each against one ``BatchNorm2d`` over the
    eight: the output and dx (each rank's rows), dγ and dβ (the ranks'
    local parts, summed, as the gradient all-reduce sums them) and the
    running statistics.  Bounds 2e-6 absolute on values of size ~1-10
    (the output, dx, the running statistics):
    ``mean(x²) - mean(x)²`` and two partial sums against one pass (read
    ~5e-7 apart); dγ and dβ (sums of up to ~36) to 1e-6 relative."""
    want = _batch_norm(*_batch_norm_case())
    got = [ranks[r]["batch_norm"] for r in range(2)]
    for k in ("y", "dx"):
        torch.testing.assert_close(torch.cat([g[k] for g in got]), want[k], atol=2e-6, rtol=0)
    for k in ("dw", "db"):
        torch.testing.assert_close(got[0][k] + got[1][k], want[k], atol=1e-6, rtol=1e-6)
    for k in ("running_mean", "running_var"):
        assert torch.equal(got[0][k], got[1][k])
        torch.testing.assert_close(got[0][k], want[k], atol=2e-6, rtol=0)
