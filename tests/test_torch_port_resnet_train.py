"""The port's ResNet training and serving slice against the JAX package's,
on the CPU.

Guarded SGD steps of a ResNet at one block a stage (the widths of
ResNet-18) through both packages' train steps, a skipped non-finite step,
the exact eval on the running statistics, ``--remat``'s single statistics
update, the entry point with no ``--model`` (ResNet-18), and the repair that
keeps fp32 convolutions in fp32 on a card.  JAX runs on the test suite's
8-device CPU mesh at ``highest`` matmul precision; each tolerance is stated
beside its comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.models import BasicBlock as JaxBasicBlock
from distributed_training_comparison_tpu.models import ResNet as JaxResNet
from distributed_training_comparison_tpu.parallel import make_mesh, replicated_sharding
from distributed_training_comparison_tpu.train import (
    configure_optimizers as jax_configure_optimizers,
)
from distributed_training_comparison_tpu.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from distributed_training_comparison_tpu_torch import _device, entry
from distributed_training_comparison_tpu_torch.config import load_config
from distributed_training_comparison_tpu_torch.data import synthetic_dataset
from distributed_training_comparison_tpu_torch.models import (
    BasicBlock,
    ResNet,
    ViT,
    resnet_from_jax,
)
from distributed_training_comparison_tpu_torch.serve import serve_main
from distributed_training_comparison_tpu_torch.train import (
    TrainStep,
    build_model,
    configure_optimizers,
    eval_totals,
    forward_backward,
)

BLOCKS = (1, 1, 1, 1)


class HP:
    """One step per epoch and a decay every epoch: the second step runs at
    a tenth of the first's learning rate."""

    lr = 0.01
    weight_decay = 1e-4
    lr_decay_step_size = 1
    lr_decay_gamma = 0.1


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(backend="ddp")


def _variables(state) -> dict:
    return jax.device_get({"params": state.params, "batch_stats": state.batch_stats})


def _jax_start(mesh, grad_accum=1):
    tx, _ = jax_configure_optimizers(HP, steps_per_epoch=1)
    state = create_train_state(JaxResNet(block=JaxBasicBlock, num_blocks=BLOCKS),
                               jax.random.key(4), tx)
    state = jax.device_put(state, replicated_sharding(mesh))
    return state, make_train_step(mesh, augment=False, grad_accum=grad_accum)


def _port_start(state, grad_accum=1):
    model = ResNet(BasicBlock, BLOCKS)
    model.load_state_dict(resnet_from_jax(_variables(state)))
    opt, schedule = configure_optimizers(HP, 1, model.parameters())
    return model, TrainStep(model, opt, schedule, augment=False, grad_accum=grad_accum)


def _step_both(state, step, port_step, images, labels, key=0):
    with jax.default_matmul_precision("highest"):
        state, m = step(state, jnp.asarray(images), jnp.asarray(labels), jax.random.key(key))
    got = port_step(torch.from_numpy(images), torch.from_numpy(labels).long())
    return state, m, got


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_two_guarded_steps_match_jax_make_train_step(mesh, grad_accum):
    """Two steps on one batch of 16 through JAX's ``make_train_step(mesh,
    augment=False)`` and the port's ``TrainStep``, fp32, the second at a
    tenth of the learning rate.  Under ``--grad-accum 2`` each micro-batch
    of 8 normalizes by its own statistics and advances the running ones in
    order.  BatchNorm makes fp32 gradients ill-conditioned: the gradients of
    its bias and of the layers before it are sums over N*H*W that cancel,
    and both packages' fp32 gradients differ from an fp64 one by up to
    0.1-0.3% there (the port's less).  So the loss agrees to 1e-5 relative
    and the grad norm to 1e-3 (the second step's reads ~1e-4); the
    parameters (size ~0.01-1) to 2e-5 absolute, the updates at lr 0.01
    having moved them apart by up to ~8e-6; the running statistics (size
    ~0.1-5) to 1e-4 absolute and 1e-5 relative, the second step's batch
    statistics coming from those parameters (they read up to ~3e-5 apart;
    a missed update would be ~1e-2)."""
    state, step = _jax_start(mesh, grad_accum)
    model, port_step = _port_start(state, grad_accum)
    model.eval()  # the step puts the model in train mode itself
    images, labels = synthetic_dataset(16, seed=0)
    for _ in range(2):
        state, m, got = _step_both(state, step, port_step, images, labels)
        assert float(got["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
        assert float(got["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=1e-3)
        assert int(got["top1_count"]) == int(m["top1_count"])
        assert float(got["skipped"]) == float(m["skipped"]) == 0.0
        want = resnet_from_jax(_variables(state))
        for name, p in model.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-5,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-5, rtol=0,
                                           err_msg=name)
    assert model.training
    assert port_step.applied == int(state.step) == 2


def test_nan_step_is_skipped_with_the_running_statistics(mesh):
    """A NaN in the head's bias makes the loss and every gradient NaN, while
    the BatchNorms in front of the head still see finite batches: both
    guards skip the update, keeping the parameters, the momentum, the step
    count and every running statistic bit for bit."""
    state, step = _jax_start(mesh)
    variables = _variables(state)
    variables["params"]["head"]["bias"] = np.full_like(variables["params"]["head"]["bias"], np.nan)
    state = jax.device_put(state.replace(params=variables["params"]), replicated_sharding(mesh))
    model, port_step = _port_start(state)
    images, labels = synthetic_dataset(16, seed=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    new_state, m, got = _step_both(state, step, port_step, images, labels)
    assert float(m["skipped"]) == float(got["skipped"]) == 1.0
    assert int(new_state.step) == 0 and port_step.applied == 0
    assert not port_step.optimizer.state  # no momentum buffer was touched
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, before[name], rtol=0, atol=0, equal_nan=True, msg=name)
    old, new = _variables(state)["batch_stats"], _variables(new_state)["batch_stats"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, new, old)


def test_eval_totals_use_the_running_statistics(mesh):
    """``eval_totals`` against JAX's compiled eval step (``train=False``) on
    a padded split, with the model left in train mode by the caller: it
    evaluates in eval mode, leaves the running statistics alone and gives
    the train mode back.  Bounds: loss sum 1e-5 relative; the hit counts
    and weight total exactly."""
    state, step = _jax_start(mesh)
    images, labels = synthetic_dataset(16, seed=2)
    state, _ = step(state, jnp.asarray(images), jnp.asarray(labels), jax.random.key(0))
    model, _ = _port_start(state)  # running statistics moved once
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x, y = synthetic_dataset(24, seed=3)
    weights = np.r_[np.ones(20), np.zeros(4)].astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(make_eval_step(mesh)(state, jnp.asarray(x), jnp.asarray(y),
                                                   jnp.asarray(weights)))
    got = eval_totals(model, [(torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(weights))])
    assert got["loss_sum"] == pytest.approx(float(want["loss_sum"]), rel=1e-5)
    for key in ("top1_count", "top5_count", "count"):
        assert got[key] == float(want[key])
    assert model.training
    for name, v in model.state_dict().items():
        torch.testing.assert_close(v, before[name], rtol=0, atol=0, msg=name)
    model.train()  # the same weights on batch statistics give another loss
    with torch.no_grad():
        train_logits = model(torch.from_numpy(x[:8]).float() / 255)
    model.eval()
    with torch.no_grad():
        eval_logits = model(torch.from_numpy(x[:8]).float() / 255)
    assert (train_logits - eval_logits).abs().max() > 1e-2


def _remat_pair(build):
    """Gradients, losses and buffers of one forward and backward of
    ``build(remat)`` with and without ``remat`` on the same weights."""
    images, labels = synthetic_dataset(8, seed=4)
    out = {}
    state = build(False).state_dict()
    for remat in (False, True):
        model = build(remat)
        model.load_state_dict(state)
        model.train()
        loss, _, extras = forward_backward(model, torch.from_numpy(images),
                                           torch.from_numpy(labels).long())
        aux = model.moe_aux_loss() if hasattr(model, "moe_aux_loss") else None
        out[remat] = {
            "loss": loss.detach(), "aux": aux, "extras": extras,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
        }
    return out[False], out[True]


REMAT_MODELS = {
    "resnet": lambda remat: ResNet(BasicBlock, BLOCKS, remat=remat),
    "vit": lambda remat: ViT(depth=2, dim=64, heads=2, remat=remat),
    "vit_moe": lambda remat: ViT(depth=2, dim=64, heads=2, num_experts=4, remat=remat),
    # 256 tokens through the fused block's plain versions (K5, and K6 under
    # autograd), the recompute running K5 again
    "vit_fused": lambda remat: ViT(depth=2, dim=64, heads=2, patch=2, block_fusion="force",
                                   remat=remat),
}


@pytest.mark.parametrize("name", sorted(REMAT_MODELS))
def test_remat_gives_the_same_step_and_one_statistics_update(name):
    """``--remat`` recomputes each block in the backward: the loss (with
    ``vit_moe``'s load-balance loss), every gradient and every buffer equal
    the plain run's.  BatchNorm's running statistics advance once, not
    again in the recompute.  Bound 1e-6 relative on the gradients: the
    recompute runs the same operations, though the CPU's convolutions may
    pick another summation order for it."""
    plain, remat = _remat_pair(REMAT_MODELS[name])
    assert remat["loss"].item() == plain["loss"].item()
    if plain["aux"] is not None:
        assert remat["aux"].item() == plain["aux"].item() > 0
        assert remat["extras"].keys() == plain["extras"].keys() != set()
    for n, g in plain["grads"].items():
        torch.testing.assert_close(remat["grads"][n], g, rtol=1e-6, atol=1e-9, msg=n)
    for n, b in plain["buffers"].items():
        torch.testing.assert_close(remat["buffers"][n], b, rtol=0, atol=0, msg=n)


def test_build_model_maps_bn_dtype_stem_and_remat():
    """The trainer's ``model_kw`` as the JAX trainer's: the norms' dtype is
    the compute dtype under ``--bn-dtype compute`` and fp32 otherwise (a
    ViT's LayerNorm statistics stay fp32 either way), ``--stem`` and
    ``--remat`` reach the model."""
    hp = load_config(["--amp", "--bn-dtype", "compute", "--stem", "imagenet", "--remat",
                      "--model", "resnet34"])
    model = build_model(hp)
    assert model.stem == "imagenet" and model.remat and len(model.layer3) == 6
    assert model.bn1.norm_dtype == torch.bfloat16 and model.conv1.dtype == torch.bfloat16
    assert build_model(load_config(["--amp"])).bn1.norm_dtype == torch.float32
    vit = build_model(load_config(["--amp", "--bn-dtype", "compute", "--model", "vit_tiny"]))
    assert vit.remat is False and vit.blocks[0].norm_f32
    assert vit.blocks[0].ln_attn.norm_dtype == torch.bfloat16


def test_entry_trains_resnet18_with_no_model_flag():
    """The entry point's default model, ResNet-18, trained and tested on the
    CPU (augmentation on, train and eval modes in turn): every metric
    finite, no step skipped."""
    results = entry.run([
        "--device", "cpu", "--synthetic-data", "--limit-examples", "48",
        "--batch-size", "16", "--epoch", "1", "--contain-test",
    ])
    (epoch,) = results["fit"]["epochs"]
    assert epoch["steps"] == 2 and epoch["skipped"] == epoch["nonfinite_losses"] == 0
    for key in ("train_loss", "val_loss", "val_acc"):
        assert np.isfinite(epoch[key])
    assert np.isfinite(results["test_loss"]) and 0 <= results["test_top1"] <= 100


def test_serve_resnet18_on_the_cpu():
    """``--serve`` with no ``--model`` serves ResNet-18 (eval mode) through
    the micro-batcher: every request completes."""
    hp = load_config(["--serve", "--device", "cpu", "--serve-requests", "16",
                      "--serve-buckets", "1,2,4"])
    report = serve_main(hp)
    assert report["completed"] == 16 and report["failed"] == 0
    assert report["engine"]["device"] == "cpu" and report["engine"]["dtype"] == "float32"


def test_a_card_pins_fp32_convolutions_and_matmuls_off_tf32(monkeypatch):
    """PyTorch lets cuDNN run fp32 convolutions as TF32 by default.
    Resolving a Hopper card (the check monkeypatched here) pins cuDNN
    convolutions and cuBLAS matmuls to full fp32 through torch's settings
    (``fp32_precision``), and the settings read back as ``ieee``; the CPU
    changes nothing."""
    for knob in _device.fp32_precision_knobs().values():
        monkeypatch.setattr(knob, "fp32_precision", "tf32")
    assert set(_device.fp32_math_settings().values()) == {"tf32"}
    _device.resolve_device("cpu")
    assert set(_device.fp32_math_settings().values()) == {"tf32"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda dev=None: _device.HOPPER)
    assert _device.resolve_device("cuda").type == "cuda"
    assert _device.fp32_math_settings() == {
        "cudnn.conv": "ieee", "cudnn.rnn": "ieee", "cuda.matmul": "ieee"}
