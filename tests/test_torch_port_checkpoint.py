"""The port's checkpoints against the JAX package's, on the CPU.

Run-dir claims and checkpoint discovery through both packages on the same
directory trees, the integrity manifest and the torn-``last.ckpt``
fallback, and the contents: a depth-2 ViT's, a small ResNet's (batch
statistics) and a small ``vit_moe``'s (expert leaves) train state carried
from JAX into the port and written back, the best and last payloads laid
out as the JAX ``TrainState``'s state dict, the JAX model reading a port
checkpoint and the port reading a JAX ``last.ckpt``.  Each tolerance is
stated beside its comparison; where only the layout moves, the comparison
is bit for bit.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from distributed_training_comparison_tpu.models import BasicBlock as JaxBasicBlock
from distributed_training_comparison_tpu.models import ResNet as JaxResNet
from distributed_training_comparison_tpu.models import ViT as JaxViT
from distributed_training_comparison_tpu.resilience import ckpt_io as jax_io
from distributed_training_comparison_tpu.train import checkpoint as jax_ckpt
from distributed_training_comparison_tpu.train import (
    configure_optimizers as jax_configure_optimizers,
)
from distributed_training_comparison_tpu.train import create_train_state
from distributed_training_comparison_tpu_torch.data import normalize_images
from distributed_training_comparison_tpu_torch.models import BasicBlock, ResNet, ViT
from distributed_training_comparison_tpu_torch.resilience import ckpt_io as port_io
from distributed_training_comparison_tpu_torch.train import (
    DeviceSGD,
    TrainState,
    configure_optimizers,
    lr_table,
)
from distributed_training_comparison_tpu_torch.train import checkpoint as port_ckpt

SMALL_VIT = dict(depth=2, dim=64, heads=2, image_size=32)
SMALL_MOE = dict(depth=2, dim=64, heads=2, image_size=32, num_experts=4)
BLOCKS = (1, 1, 1, 1)

# (label, the JAX model, the port model) of each small zoo shape
MODELS = {
    "vit": (lambda: JaxViT(**SMALL_VIT), lambda: ViT(**SMALL_VIT)),
    "resnet": (lambda: JaxResNet(block=JaxBasicBlock, num_blocks=BLOCKS),
               lambda: ResNet(BasicBlock, BLOCKS)),
    "vit_moe": (lambda: JaxViT(**SMALL_MOE), lambda: ViT(**SMALL_MOE)),
}


class HP:
    lr = 0.1
    weight_decay = 1e-4
    lr_decay_step_size = 60
    lr_decay_gamma = 0.1


# ------------------------------------------------------- run dirs, discovery


def _tree(root):
    """A ckpt root as a long run leaves it: version-0 with two best files
    of a crash window (epoch 9 and epoch 10) and a manifested last.ckpt,
    version-2 with a last.ckpt only, version-10 with a best file only, a
    stray non-numeric version dir and a stray file."""
    v0, v2, v10 = (root / f"version-{n}" for n in (0, 2, 10))
    for d in (v0, v2, v10, root / "version-x"):
        d.mkdir(parents=True)
    (root / "notes.txt").write_text("x")
    for name in ("best_model_epoch_9_acc_40.0000.ckpt", "best_model_epoch_10_acc_35.5000.ckpt",
                 "best_model_backup.ckpt"):
        (v0 / name).write_bytes(name.encode())
    for d, payload in ((v0, b"v0 last"), (v2, b"v2 last")):
        port_io.atomic_write_bytes(d / "last.ckpt", payload)
        port_io.write_manifest(d / "last.ckpt", payload, meta={"epoch": 3})
    (v10 / "best_model_epoch_1_acc_2.0000.ckpt").write_bytes(b"v10 best")


def _discovery(pkg, root):
    return {
        "version_dir": pkg.find_version_dir(root, create=False),
        "best_v0": pkg.find_best_checkpoint(root / "version-0"),
        "best_v2": pkg.find_best_checkpoint(root / "version-2"),
        "latest_resume": pkg.find_latest_resume(root),
        "serving": pkg.find_serving_checkpoint(root),
        "valid_v0": pkg.valid_resume_bytes_in(root / "version-0"),
        "valid_v10": pkg.valid_resume_bytes_in(root / "version-10"),
        "valid_newest": pkg.find_valid_resume_bytes(root),
    }


def test_run_dirs_and_discovery_agree_with_jax(tmp_path):
    """Both packages' discovery over one tree gives the same paths:
    ``epoch_10`` beats ``epoch_9`` (numeric, not string order), the newest
    version dir is ``version-10`` (not ``version-2``), which has no
    ``last.ckpt`` (so auto-resume starts fresh) and serves its best file.
    Two claims in a row take the first free slots, in both."""
    _tree(tmp_path / "tree")
    port = _discovery(port_ckpt, tmp_path / "tree")
    assert port == _discovery(jax_ckpt, tmp_path / "tree")
    assert port["best_v0"].name == "best_model_epoch_10_acc_35.5000.ckpt"
    assert port["serving"].name == "best_model_epoch_1_acc_2.0000.ckpt"
    assert port["latest_resume"] is None and port["valid_newest"] is None
    assert port["valid_v0"] == (tmp_path / "tree/version-0/last.ckpt", b"v0 last")
    claims = {}
    for name, pkg in (("port", port_ckpt), ("jax", jax_ckpt)):
        root = tmp_path / name
        shutil.copytree(tmp_path / "tree", root)
        claims[name] = [pkg.find_version_dir(root).relative_to(root) for _ in range(2)]
    assert claims["port"] == claims["jax"] == [Path("version-1"), Path("version-3")]


def test_cleanup_drops_only_the_stale_best_files_in_both(tmp_path):
    for name, pkg in (("port", port_ckpt), ("jax", jax_ckpt)):
        _tree(tmp_path / name)
        best = pkg.find_best_checkpoint(tmp_path / name / "version-0", cleanup=True)
        assert best.name == "best_model_epoch_10_acc_35.5000.ckpt"
    left = [sorted(p.name for p in (tmp_path / n / "version-0").iterdir()) for n in ("port", "jax")]
    assert left[0] == left[1] and "best_model_backup.ckpt" in left[0]


def test_manifest_json_is_the_jax_one_for_the_same_bytes(tmp_path):
    """The sidecar manifest of the same payload bytes and metadata is the
    JAX package's, byte for byte."""
    data = bytes(range(256)) * 9
    meta = {"kind": "resume_state", "fmt": 3, "step": 12, "epoch": 2, "best_acc": 41.25}
    paths = {}
    for name, io in (("port", port_io), ("jax", jax_io)):
        path = tmp_path / name / "last.ckpt"
        path.parent.mkdir()
        io.atomic_write_bytes(path, data)
        paths[name] = io.write_manifest(path, data, meta=meta)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    assert json.loads(paths["port"].read_bytes())["sha256"] == port_io.read_manifest(
        tmp_path / "port" / "last.ckpt")["sha256"]


def test_a_torn_last_ckpt_falls_back_to_prev_in_both(tmp_path):
    """A ``last.ckpt`` rotated once and then torn (its bytes changed under
    its manifest): both packages reject it and hand back the verified
    ``prev-last.ckpt`` and its bytes; a size-invalid file is not rotated
    over the good one."""
    v = tmp_path / "version-0"
    v.mkdir()
    last = v / "last.ckpt"
    for payload in (b"A" * 100, b"B" * 100):
        port_io.rotate_previous(last)
        port_io.atomic_write_bytes(last, payload)
        port_io.write_manifest(last, payload)
    last.write_bytes(b"C" * 100)  # same size, wrong checksum
    want = (v / "prev-last.ckpt", b"A" * 100)
    assert port_ckpt.valid_resume_bytes_in(v) == jax_ckpt.valid_resume_bytes_in(v) == want
    assert port_ckpt.find_valid_resume_bytes(tmp_path) == want
    last.write_bytes(b"short")  # size-invalid: not rotated
    assert port_io.rotate_previous(last) is None and (v / "prev-last.ckpt").exists()


# ------------------------------------------------------------------ contents


def _jax_state(label: str, seed: int = 4):
    """A JAX ``TrainState`` of the small ``label`` model with non-trivial
    values in every field: the momentum trace drawn from numpy, the running
    statistics moved off their init, step and count 3."""
    tx, _ = jax_configure_optimizers(HP, steps_per_epoch=1)
    state = create_train_state(MODELS[label][0](), jax.random.key(seed), tx)
    sd = serialization.to_state_dict(jax.device_get(jax_ckpt._state_dict(state)))
    rng = np.random.default_rng(seed)

    def draw(tree, positive=False):
        return jax.tree_util.tree_map(
            lambda a: (np.abs(rng.standard_normal(a.shape)) + 0.5 if positive
                       else rng.standard_normal(a.shape)).astype(a.dtype), tree)

    sd["opt_state"]["1"]["0"]["trace"] = draw(sd["opt_state"]["1"]["0"]["trace"])
    sd["opt_state"]["1"]["1"]["count"] = np.asarray(3, np.int32)
    sd["step"] = np.asarray(3, np.int32)
    for stats in sd["batch_stats"].values():
        for bn in ([stats] if "mean" in stats else stats.values()):
            bn["mean"] = draw(bn["mean"])
            bn["var"] = draw(bn["var"], positive=True)
    restored = serialization.from_state_dict(jax_ckpt._state_dict(state), sd)
    return state.replace(**restored), sd


def _port_state(label: str) -> TrainState:
    model = MODELS[label][1]()
    model.init_weights(torch.Generator().manual_seed(0))
    opt, schedule = configure_optimizers(HP, 1, model.parameters())
    return TrainState(model, DeviceSGD(opt, lr_table(schedule, 8, "cpu")))


def _leaves(tree, prefix=""):
    """``{path: leaf}`` of a nested dict, tensors as numpy."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.numpy() if isinstance(tree, torch.Tensor) else tree}


def _assert_same_tree(got, want):
    """The same key paths; at each, the same shape, dtype and bits (numpy
    leaves), or the same value and type (numbers)."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), path
            assert (g.shape, g.dtype) == (w.shape, w.dtype), path
            assert g.tobytes() == w.tobytes(), path
        else:
            assert type(g) is type(w) and g == w, path


@pytest.mark.parametrize("label", list(MODELS))
def test_payloads_are_the_jax_train_states_bit_for_bit(label, tmp_path):
    """A JAX train state carried into the port (``load_state_dict``) and
    written back by the port's ``save_resume_state`` and
    ``save_checkpoint``: the payloads have the key paths, shapes, dtypes
    and (only the layout moved) the bits of the JAX package's own
    ``save_resume_state`` and ``save_checkpoint`` payloads of that state,
    ``fmt``, ``epoch`` and the accuracies included."""
    jstate, sd = _jax_state(label)
    state = _port_state(label)
    state.load_state_dict(sd)
    assert int(state.sgd.applied) == 3
    _assert_same_tree(state.state_dict(), sd)
    for name, pkg in (("port", port_ckpt), ("jax", jax_ckpt)):
        (tmp_path / name).mkdir()
        src = state if name == "port" else jstate
        pkg.save_resume_state(tmp_path / name, src, 4, 12.5)
        pkg.save_checkpoint(tmp_path / name, src, 4, 12.5)
    best = "best_model_epoch_4_acc_12.5000.ckpt"
    for file in ("last.ckpt", best):
        got = torch.load(tmp_path / "port" / file, weights_only=True)
        want = serialization.msgpack_restore((tmp_path / "jax" / file).read_bytes())
        _assert_same_tree(got, want)
    manifests = [json.loads((tmp_path / n / "last.ckpt.manifest.json").read_text())
                 for n in ("port", "jax")]
    for m in manifests:
        m.pop("sha256"), m.pop("bytes")  # torch's bytes are not msgpack's
    assert manifests[0] == manifests[1]


@pytest.mark.parametrize("label", ["vit", "resnet"])
def test_jax_reads_a_port_checkpoint(label, tmp_path):
    """A port best checkpoint (the port's own seeded weights, running
    statistics moved by a train-mode forward) through the JAX model's
    ``apply``: its eval logits are the port's within the model-parity
    tests' fp32 bounds (ViT 1e-5 absolute, ResNet 1e-5 absolute and
    relative: summation order and flax's one-pass variance)."""
    state = _port_state(label)
    x = np.random.default_rng(2).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    xn = normalize_images(torch.from_numpy(x))
    with torch.no_grad():
        state.model.train()(xn)  # a ResNet's running statistics move
        got = state.model.eval()(xn).numpy()
    path = port_ckpt.save_checkpoint(tmp_path, state, 0, 1.0)
    raw = torch.load(path, weights_only=True)
    variables = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                       {"params": raw["params"], "batch_stats": raw["batch_stats"]})
    if not variables["batch_stats"]:
        variables.pop("batch_stats")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(MODELS[label][0]().apply(variables, jnp.asarray(xn.numpy()), train=False))
    rtol = 1e-5 if label == "resnet" else 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("label", list(MODELS))
def test_the_port_reads_a_jax_last_ckpt(label, tmp_path):
    """A ``last.ckpt`` written by the JAX package, read with flax and handed
    to the port's restore: the port's state is the JAX state exactly; the
    port's own loader refuses the msgpack file with a clear error."""
    jstate, sd = _jax_state(label, seed=5)
    path = jax_ckpt.save_resume_state(tmp_path, jstate, 2, 7.0)
    raw = serialization.msgpack_restore(path.read_bytes())
    state = _port_state(label)
    state.load_state_dict(raw["state"])
    _assert_same_tree(state.state_dict(), sd)
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        port_ckpt.load_resume_state(path, _port_state(label))


def test_a_restore_copies_into_the_live_tensors():
    """A restore writes into the tensors the step program's graphs were
    captured on: no parameter, buffer, momentum buffer or the step count
    is rebound."""
    _, sd = _jax_state("resnet")
    state = _port_state("resnet")
    before = {k: v.data_ptr() for k, v in state.tensors().items()}
    applied = state.sgd.applied
    state.load_state_dict(sd)
    assert {k: v.data_ptr() for k, v in state.tensors().items()} == before
    assert state.sgd.applied is applied and int(applied) == 3
    assert all(int(b) == 0 for n, b in state.model.named_buffers()
               if n.endswith("num_batches_tracked"))
