"""The port's data-parallel flags and arithmetic against the JAX package's,
on the CPU.

Every JAX flag parses in the port, under ``single``, ``dp`` and ``ddp``, to
the JAX default; each is driven by the port, a written delta, or a flag of
a module not ported yet that fails at the command line when set.  The
mesh's axis arithmetic, ``shard_indices``, the host loader's per-process
batches and each process's rows of a global batch are held against the
JAX functions exactly.  No process group is started here
(``test_torch_port_data_parallel_ranks.py`` runs two).
"""

import argparse

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributed_training_comparison_tpu.config import build_parser as jax_build_parser
from distributed_training_comparison_tpu.config import load_config as jax_load_config
from distributed_training_comparison_tpu.data.loader import DeviceDataset
from distributed_training_comparison_tpu.data.loader import HostLoader as JaxHostLoader
from distributed_training_comparison_tpu.data.sampler import shard_indices as jax_shard_indices
from distributed_training_comparison_tpu.parallel import make_mesh as jax_make_mesh
from distributed_training_comparison_tpu.parallel.mesh import (
    elastic_mesh_shape as jax_elastic_mesh_shape,
)
from distributed_training_comparison_tpu.parallel.mesh import (
    mesh_shape_for_backend as jax_mesh_shape_for_backend,
)
from distributed_training_comparison_tpu_torch import config as port_config
from distributed_training_comparison_tpu_torch import entry
from distributed_training_comparison_tpu_torch.data import synthetic_dataset
from distributed_training_comparison_tpu_torch.data.loader import HostLoader
from distributed_training_comparison_tpu_torch.data.sampler import shard_indices
from distributed_training_comparison_tpu_torch.parallel import (
    check_global_batch,
    elastic_mesh_shape,
    local_world_size,
    make_mesh,
    mesh_shape_for_backend,
    rank_rows,
)

# the flags the port drives (neither a written delta nor unported)
LIVE = {
    "dset", "dpath", "seed", "eval_step", "amp", "contain_test", "rank", "dist_url",
    "epoch", "batch_size", "model", "lr", "weight_decay", "lr_decay_step_size",
    "lr_decay_gamma", "num_devices", "patch_size", "moe_dispatch", "block_fusion",
    "precision", "bn_dtype", "synthetic_data", "synthetic_noise", "remat", "grad_accum",
    "image_size", "stem", "limit_examples", "auto_resume", "log_every_step",
    "save_last_every", "save_last_min_secs", "host_chunk_steps", "serve", "serve_ckpt",
    "serve_buckets", "max_wait_ms", "serve_mode", "queue_limit", "serve_rate",
    "serve_requests", "serve_concurrency", "deadline_ms", "legacy_test_stats",
}


def _jax_dests() -> dict[str, argparse.Action]:
    return {a.dest: a for a in jax_build_parser("single")._actions if a.dest != "help"}


@pytest.mark.parametrize("backend", ["single", "dp", "ddp"])
def test_every_jax_flag_parses_to_the_jax_default(backend):
    """With no flags, the backend given to ``load_config`` or named by
    ``--backend`` gives the JAX ``load_config(backend, [])`` namespace,
    value for value (``--epoch`` 200 or 100, ``--ckpt-path
    src/{backend}/checkpoints/``, ``backend``), plus the port's
    ``device``."""
    ref = vars(jax_load_config(backend, []))
    for port in (vars(port_config.load_config([], backend=backend)),
                 vars(port_config.load_config(["--backend", backend]))):
        assert set(port) - set(ref) == {"device"}
        assert {k: port[k] for k in ref} == ref
    assert len(_jax_dests()) == 114


def test_every_jax_flag_is_live_a_written_delta_or_unported():
    """The three kinds cover the JAX package's 114 flags, and no flag is
    unported and a delta, or unported and live."""
    jax_flags = set(_jax_dests())
    deltas, unported = set(port_config.WRITTEN_DELTAS), set(port_config.UNPORTED)
    assert LIVE | (deltas & jax_flags) | unported == jax_flags
    assert not unported & deltas and not unported & LIVE and not LIVE & deltas
    assert deltas - jax_flags == {"device", "backend"}  # new flags (JAX sets backend itself)
    assert {"workers", "backend", "dist_backend", "world_size"} <= deltas
    assert all(item.startswith("ROADMAP queue 1, item ")
               for item in port_config.UNPORTED.values())


def _off_default(action: argparse.Action) -> list[str]:
    """An argv that sets ``action``'s flag to a value other than its
    default."""
    flag = action.option_strings[0]
    if isinstance(action, argparse.BooleanOptionalAction):
        return [f"--no-{flag[2:]}"] if action.default else [flag]
    if action.nargs == 0:  # store_true
        return [flag]
    if action.choices:
        return [flag, next(c for c in action.choices if c != action.default)]
    if isinstance(action, argparse._AppendAction) or not isinstance(action.default, (int, float)):
        return [flag, "x:y"]
    return [flag, str(action.default + 1)]


@pytest.mark.parametrize("dest", sorted(port_config.UNPORTED))
def test_an_unported_flag_set_off_its_default_exits_naming_its_item(dest, capsys):
    """Any other value than the JAX default of a flag whose module is not
    ported yet stops the command line with the ROADMAP item that ports it;
    the default itself parses."""
    argv = _off_default(_jax_dests()[dest])
    with pytest.raises(SystemExit):
        port_config.load_config(argv)
    err = capsys.readouterr().err
    assert argv[0] in err and port_config.UNPORTED[dest] in err


BAD_ARGVS = [
    ["--model", "resnet9"], ["--epoch", "ten"], ["--precision", "fp16"],
    ["--bn-dtype", "fp16"], ["--limit-examples", "-1"], ["--device-prefetch", "-1"],
    ["--device-prefetch", "two"], ["--device-chunk-steps", "-1"], ["--serve-buckets", "0,2"],
    ["--serve-buckets", "a"], ["--serve-replicas", "-1"], ["--serve-shape", "spiky"],
    ["--parallel-style", "ring"], ["--grad-comms", "fp8"], ["--pipeline-parallel", "0"],
    ["--pipeline-virtual-stages", "-1"], ["--health-window", "2"], ["--max-restarts", "-1"],
    ["--metrics-port", "70000"], ["--serve-trace-sample", "2"], ["--serve-max-replicas", "0"],
    ["--serve-warm-buckets", "64"], ["--fleet-poll-secs", "0"], ["--policy-max-actions", "0"],
    ["--flight-recorder-size", "0"], ["--fleet-hosts", "2"], ["--parity-check", "-1"],
]


@pytest.mark.parametrize("argv", BAD_ARGVS, ids=[" ".join(a) for a in BAD_ARGVS])
def test_an_argv_the_jax_parser_rejects_the_port_rejects(argv):
    with pytest.raises(SystemExit):
        jax_load_config("ddp", argv)
    with pytest.raises(SystemExit):
        port_config.load_config(argv, backend="ddp")


@pytest.mark.parametrize("argv", [
    ["--dist-backend", "nccl", "--device", "cpu"],  # nccl runs on the card
    ["--dist-backend", "gloo"],  # the card's captured step joins nccl only
    ["--dist-backend", "mpi", "--device", "cpu"],
    ["--world-size", "2"],  # hosts of a data-parallel run, not of single
    ["--backend", "ddp", "--world-size", "2", "--rank", "2"],
    ["--backend", "ddp", "--world-size", "0"],
    ["--backend", "dp", "--num-devices", "-1"],
    ["--backend", "tpu"],
])
def test_the_distributed_flags_refuse_what_the_port_cannot_run(argv):
    with pytest.raises(SystemExit):
        port_config.load_config(argv)


def test_the_distributed_flags_parse_as_the_jax_ones():
    """The hosts, the rendezvous and the fabric's name keep the JAX
    meaning and values; the port resolves ``xla`` to its fabric at run
    time."""
    argv = ["--world-size", "2", "--rank", "1", "--dist-url", "10.0.0.1:29500",
            "--num-devices", "4", "--dist-backend", "xla"]
    port = vars(port_config.load_config(["--backend", "ddp", *argv]))
    ref = vars(jax_load_config("ddp", argv))
    assert {k: port[k] for k in ref} == ref
    hp = port_config.load_config(["--backend", "ddp", "--device", "cpu", *argv])
    assert local_world_size(hp) == 4
    assert local_world_size(port_config.load_config(["--backend", "dp", "--device", "cpu"])) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no card here: never the CPU
        local_world_size(port_config.load_config(["--backend", "ddp", "--num-devices", "2"]))


MESH_CASES = [(b, n, m, p) for b in ("single", "dp", "ddp", "tpu") for n in (1, 2, 4, 6, 8)
              for m in (1, 2, 3) for p in (1, 2)]


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return "ValueError"


def test_the_mesh_arithmetic_is_the_jax_arithmetic():
    """``mesh_shape_for_backend`` and ``elastic_mesh_shape`` over a table
    of backends, device counts and model/pipe degrees: the same shape, or
    the same refusal, as the JAX functions."""
    for case in MESH_CASES:
        want = _outcome(jax_mesh_shape_for_backend, *case)
        assert _outcome(mesh_shape_for_backend, *case) == want
    for n in range(0, 10):
        for m in (0, 1, 2, 3):
            for p in (0, 1, 2):
                assert elastic_mesh_shape(n, m, p) == jax_elastic_mesh_shape(n, m, p)
    assert make_mesh(2, backend="ddp").shape == dict(jax_make_mesh(2, backend="ddp").shape)
    assert make_mesh(8, backend="single").shape == {"data": 1, "model": 1, "pipe": 1}
    with pytest.raises(NotImplementedError, match="item 6"):
        make_mesh(4, 2, backend="ddp")


@pytest.mark.parametrize("n,shards,even", [(10, 2, True), (11, 2, True), (11, 3, True),
                                           (5, 4, True), (11, 3, False), (7, 2, False)])
def test_shard_indices_are_the_jax_ones(n, shards, even):
    idx = np.random.default_rng(n).permutation(n)
    for shard in range(shards):
        got = shard_indices(idx, shards, shard, even=even)
        assert np.array_equal(got, jax_shard_indices(idx, shards, shard, even=even))
    with pytest.raises(ValueError):
        shard_indices(idx, shards, shards)


def test_a_process_streams_the_jax_host_loaders_batches_for_its_shard():
    """``HostLoader(num_shards=2, shard=r)`` at the local batch yields the
    JAX ``HostLoader``'s batches for shard ``r``, byte for byte, epoch by
    epoch, over a split that does not divide evenly (the last shard is
    padded by wrapping)."""
    images, labels = synthetic_dataset(27, image_shape=(4, 4, 3), seed=5)
    for shard in range(2):
        port = HostLoader(images, labels, 4, shuffle=True, drop_last=True, seed=3,
                          num_shards=2, shard=shard)
        ref = JaxHostLoader(DeviceDataset(images, labels), 4, shuffle=True, drop_last=True,
                            seed=3, num_shards=2, shard=shard)
        for epoch in range(3):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port) == 3
            for (gx, gy), (wx, wy) in zip(got, want):
                assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


@pytest.mark.parametrize("batch,accum,world", [(8, 1, 2), (8, 2, 2), (12, 3, 2), (16, 2, 4)])
def test_the_processes_rows_make_up_the_jax_micro_batches(batch, accum, world):
    """Process ``r``'s local micro-batch ``i`` is the part of the JAX global
    micro-batch ``i`` that device ``r`` of the data axis holds (the step's
    ``(a, B/a)`` layout sharded on axis 1), so the processes in rank order
    make up each micro-batch exactly."""
    mesh = jax_make_mesh(num_devices=world, backend="ddp")
    rows = np.arange(batch)
    sharded = jax.device_put(rows.reshape(accum, batch // accum),
                             NamedSharding(mesh, P(None, "data")))
    by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    per_micro = batch // (accum * world)
    for rank, device in enumerate(mesh.devices.reshape(-1)):
        got = rank_rows(batch, accum, world, rank).reshape(accum, per_micro)
        assert np.array_equal(got, by_device[device])
    assert np.array_equal(rank_rows(batch, accum, 1, 0), rows)


def test_a_batch_that_does_not_split_over_the_processes_raises_before_they_start():
    """The check names the numbers; the entry makes it before it starts a
    process or joins a group."""
    with pytest.raises(ValueError, match=r"global batch 12 .* 4 processes x 2 micro-batches"):
        check_global_batch(12, 2, 4)
    check_global_batch(12, 2, 3)
    with pytest.raises(ValueError, match="global batch 10 does not split over 4 processes"):
        entry.run(["--backend", "ddp", "--device", "cpu", "--num-devices", "4",
                   "--batch-size", "10", "--synthetic-data", "--ckpt-path", "/nonexistent"])


def test_vit_moe_over_several_processes_raises_before_they_start():
    """The JAX package's capacity, drops and load-balance loss are the
    global batch's; per-process routing would train another model, so
    ``vit_moe`` over two processes stops before any process starts."""
    with pytest.raises(NotImplementedError, match="item 6"):
        entry.run(["--backend", "ddp", "--device", "cpu", "--num-devices", "2", "--model",
                   "vit_moe", "--synthetic-data", "--ckpt-path", "/nonexistent"])


def test_legacy_test_stats_normalize_the_test_split_by_imagenets(tmp_path):
    """``--legacy-test-stats`` (the reference's test-time quirk, live in the
    JAX trainer) normalizes the test split by ImageNet's statistics and
    leaves validation on CIFAR-100's; without it both take CIFAR-100's."""
    from distributed_training_comparison_tpu.data.cifar100 import IMAGENET_MEAN, IMAGENET_STD
    from distributed_training_comparison_tpu_torch.data import CIFAR100_MEAN, CIFAR100_STD
    from distributed_training_comparison_tpu_torch.train import Trainer

    argv = ["--device", "cpu", "--synthetic-data", "--image-size", "16", "--limit-examples",
            "24", "--batch-size", "8", "--epoch", "1"]
    losses = {}
    for legacy in (False, True):
        flags = ["--legacy-test-stats"] if legacy else []
        trainer = Trainer(port_config.load_config(
            [*argv, *flags, "--ckpt-path", str(tmp_path / str(legacy))]))
        trainer.validate()
        losses[legacy] = trainer.test()["test_loss"]
        trainer.close()
        test_stats = (IMAGENET_MEAN, IMAGENET_STD) if legacy else (CIFAR100_MEAN, CIFAR100_STD)
        assert trainer.eval_runners["test"].stats == test_stats
        assert trainer.eval_runners["val"].stats == (CIFAR100_MEAN, CIFAR100_STD)
    assert losses[True] != losses[False]
