"""The port's ResNet-18 against the JAX package's, on the CPU.

Weights go across both ways: a JAX-initialised ResNet-18 through the port's
``resnet_from_jax``, and a port-initialised one through the JAX package's
``from_torch_resnet``.  Every BatchNorm's scale, bias and running statistics
are drawn away from their initial values first (the statistics around a
calibration batch's, as a trained net's), so that eval mode tests the
statistics' carry.  JAX runs at ``highest`` matmul precision.
Tolerances are ``tests/test_torch_parity.py``'s for the same comparison of
a torch reference net: eval 1e-5 (absolute and relative); train 1e-5
absolute and 1e-4 relative, where flax's one-pass variance (E[x^2] -
E[x]^2) and torch's two-pass one differ in the last bits.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu import models as jax_models
from distributed_training_comparison_tpu.models.torch_port import from_torch_resnet
from distributed_training_comparison_tpu_torch import models as port_models
from distributed_training_comparison_tpu_torch.models import ResNetPortError, resnet_from_jax
from distributed_training_comparison_tpu_torch.models.resnet import TRUNC_NORMAL_STD

# bf16 logits against JAX's bf16, as a share of the largest |logit|: the
# convolutions' bf16 products summed in another order flip a bf16 rounding
# of an activation now and then, and each of 20 convolutions adds such
# flips; one bf16 ulp of the largest logit is 2^-8 to 2^-7 of it, and the
# bound is two ulps (seed 0 reads up to ~1%)
BF16_SHARE = 2**-6


def _images(n=4, seed=1, size=32):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _draw(rng, kind: str, n: int, batch_mean=None, batch_var=None) -> np.ndarray:
    """A BatchNorm leaf: scale in [0.5, 1.5], bias ~ N(0, 0.1); the running
    statistics drawn around a calibration batch's (mean off by ~0.1 of its
    std, var scaled by [0.8, 1.25]), as a trained net's would be, so that
    eval mode stays normalized."""
    if kind == "scale":
        return rng.uniform(0.5, 1.5, n).astype(np.float32)
    if kind == "bias":
        return (0.1 * rng.standard_normal(n)).astype(np.float32)
    if kind == "mean":
        return (batch_mean + 0.1 * np.sqrt(batch_var) * rng.standard_normal(n)).astype(np.float32)
    return (batch_var * rng.uniform(0.8, 1.25, n)).astype(np.float32)


def _calibrated(model, variables: dict, seed: int, size: int = 32) -> dict:
    """JAX ``variables`` with every BatchNorm's scale and bias drawn, then
    its running statistics drawn around the batch statistics of one
    train-mode forward on a calibration batch (read back from flax's update
    of fresh statistics: mean = 10 m', var = 10 (v' - 0.9))."""
    rng = np.random.default_rng(seed)

    def params(tree):
        return {k: params(v) if isinstance(v, dict) else
                _draw(rng, k, v.shape[0]) if k in ("scale", "bias") and v.ndim == 1
                else np.asarray(v) for k, v in tree.items()}

    def fresh(tree):
        return {k: fresh(v) if isinstance(v, dict) else
                np.zeros_like(v) if k == "mean" else np.ones_like(v) for k, v in tree.items()}

    def stats(tree):
        if "mean" not in tree:
            return {k: stats(v) for k, v in tree.items()}
        mean, var = 10 * np.asarray(tree["mean"]), 10 * (np.asarray(tree["var"]) - 0.9)
        n = mean.shape[0]
        return {"mean": _draw(rng, "mean", n, mean, var), "var": _draw(rng, "var", n, mean, var)}

    drawn = {"params": params(variables["params"]), "batch_stats": fresh(variables["batch_stats"])}
    _, moved = _jax_logits(model, drawn, _images(16, seed, size), train=True)
    return {"params": drawn["params"], "batch_stats": stats(moved)}


@torch.no_grad()
def _calibrate_port(port, seed: int) -> None:
    """``_calibrated``'s draws, into the port model's BatchNorms."""
    rng = np.random.default_rng(seed)
    norms = [m for m in port.modules() if isinstance(m, port_models.BatchNorm2d)]
    for m in norms:
        m.weight.copy_(torch.from_numpy(_draw(rng, "scale", m.weight.numel())))
        m.bias.copy_(torch.from_numpy(_draw(rng, "bias", m.weight.numel())))
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
    _port_logits(port, _images(16, seed=seed), train=True)
    for m in norms:
        mean, var = 10 * m.running_mean.numpy(), 10 * (m.running_var.numpy() - 0.9)
        n = mean.shape[0]
        m.running_mean.copy_(torch.from_numpy(_draw(rng, "mean", n, mean, var)))
        m.running_var.copy_(torch.from_numpy(_draw(rng, "var", n, mean, var)))


@pytest.fixture(scope="module")
def jax_resnet18():
    """The JAX ResNet-18 and its seeded variables with drawn BatchNorm
    leaves."""
    model = jax_models.get_model("resnet18")
    init = jax.jit(partial(model.init, train=False))
    variables = jax.device_get(init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    return model, _calibrated(model, variables, seed=2)


def _jax_logits(model, variables, x, train: bool):
    with jax.default_matmul_precision("highest"):
        if train:
            out, mutated = model.apply(variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
            return np.asarray(out), jax.device_get(mutated["batch_stats"])
        return np.asarray(model.apply(variables, jnp.asarray(x), train=False)), None


def _port_logits(model, x, train: bool):
    model.train(train)
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _template(model):
    return jax.eval_shape(partial(model.init, train=False), jax.random.key(0),
                          jnp.zeros((1, 32, 32, 3)))


@pytest.mark.parametrize("carry", ["resnet_from_jax", "from_torch_resnet"])
def test_resnet18_logits_match_jax_in_eval_and_train_mode(jax_resnet18, carry):
    """ResNet-18, batch 4, 32 px, fp32, in eval mode (running statistics)
    and train mode (batch statistics), with the weights carried either
    way (a strict ``load_state_dict``, or ``from_torch_resnet`` consuming
    every entry but ``num_batches_tracked``)."""
    model, variables = jax_resnet18
    port = port_models.get_model("resnet18")
    if carry == "resnet_from_jax":
        port.load_state_dict(resnet_from_jax(variables))
    else:
        port.init_weights(torch.Generator().manual_seed(5))
        _calibrate_port(port, seed=3)
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        variables = from_torch_resnet(sd, _template(model))
    x = _images()
    want, _ = _jax_logits(model, variables, x, train=False)
    got = _port_logits(port, x, train=False)
    assert got.dtype == np.float32 and got.shape == (4, 100)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    want, _ = _jax_logits(model, variables, x, train=True)
    np.testing.assert_allclose(_port_logits(port, x, train=True), want, atol=1e-5, rtol=1e-4)


def test_running_statistics_after_one_train_forward_match_jax(jax_resnet18):
    """One train-mode forward advances every running mean and variance as
    flax does: decay 0.9 towards the batch mean and the *biased* batch
    variance.  Bound 1e-6 absolute and relative (statistics of size 0.1-2;
    fp32 reductions in another order).  An unbiased variance would miss it
    by var / (n - 1) x 0.1: ~1e-3 at layer4's 4 x 4 maps of 4 images."""
    model, variables = jax_resnet18
    port = port_models.get_model("resnet18")
    port.load_state_dict(resnet_from_jax(variables))
    x = _images(seed=4)
    _, stats = _jax_logits(model, variables, x, train=True)
    _port_logits(port, x, train=True)
    want = resnet_from_jax({"params": variables["params"], "batch_stats": stats})
    got = port.state_dict()
    running = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 2 * 20
    for key in running:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=key)
    assert all(int(v) == 0 for k, v in got.items() if k.endswith("num_batches_tracked"))
    moved = got["layer4.1.bn2.running_var"] - torch.from_numpy(
        variables["batch_stats"]["stage4_block1"]["BatchNorm_1"]["var"])
    assert moved.abs().max() > 1e-2


@pytest.mark.parametrize("bn_dtype", ["fp32", "compute"])
def test_bf16_logits_match_jax_in_both_bn_dtypes(jax_resnet18, bn_dtype):
    """bf16 compute, BatchNorm's output fp32 (``--bn-dtype fp32``: the
    residual stream stays fp32) or bf16 (``compute``), against JAX's model
    with the same ``norm_dtype``, in eval and train mode: within
    ``BF16_SHARE`` of the largest logit, which a planted fault (one
    BatchNorm's running variance zeroed) exceeds."""
    _, variables = jax_resnet18
    norm = {"fp32": (jnp.float32, torch.float32), "compute": (jnp.bfloat16, torch.bfloat16)}
    model = jax_models.get_model("resnet18", dtype=jnp.bfloat16, norm_dtype=norm[bn_dtype][0])
    port = port_models.get_model("resnet18", dtype=torch.bfloat16, norm_dtype=norm[bn_dtype][1])
    port.load_state_dict(resnet_from_jax(variables))
    x = _images(seed=5)
    for train in (False, True):
        want, _ = _jax_logits(model, variables, x, train=train)
        got = _port_logits(port, x, train=train)
        assert got.dtype == np.float32
        tol = BF16_SHARE * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, (train, np.abs(got - want).max(), tol)
    with torch.no_grad():
        port.layer2[1].bn1.running_var.zero_()
    fault = _port_logits(port, x, train=False)
    want, _ = _jax_logits(model, variables, x, train=False)
    assert np.abs(fault - want).max() > BF16_SHARE * np.abs(want).max()


def test_resnet_from_jax_inverts_from_torch_resnet():
    """``from_torch_resnet`` then ``resnet_from_jax`` gives back every entry
    of the port's ``state_dict`` bit for bit, ``num_batches_tracked`` as 0."""
    port = port_models.get_model("resnet18")
    port.init_weights(torch.Generator().manual_seed(1))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = resnet_from_jax(from_torch_resnet(sd, _template(jax_models.get_model("resnet18"))))
    assert set(back) == set(sd)
    for key, val in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), val, err_msg=key)


def test_resnet_from_jax_rejects_structural_mismatch(jax_resnet18):
    _, variables = jax_resnet18

    def edited(edit):
        v = jax.tree_util.tree_map(lambda a: a, variables)
        edit(v)
        return v

    with pytest.raises(ResNetPortError, match="missing"):
        resnet_from_jax(edited(lambda v: v["params"]["stage2_block1"].pop("Conv_1")))
    with pytest.raises(ResNetPortError, match="no port counterpart"):
        resnet_from_jax(edited(lambda v: v["params"]["stage1_block1"].update(
            Conv_2={"kernel": np.zeros((1, 1, 64, 64), np.float32)})))
    with pytest.raises(ResNetPortError, match="shape"):
        resnet_from_jax(edited(lambda v: v["params"]["head"].update(
            bias=np.zeros(10, np.float32))))
    with pytest.raises(ResNetPortError, match="unrecognized"):
        resnet_from_jax(edited(lambda v: v["batch_stats"]["stem_bn"].update(
            scale=np.ones(64, np.float32))))
    with pytest.raises(ResNetPortError, match="collections"):
        resnet_from_jax({"params": variables["params"]})


def test_he_normal_init_matches_flax():
    """flax ``he_normal``: each convolution and the head kernel drawn from a
    normal truncated at 2 sigma, sigma = sqrt(2 / fan_in) / 0.8796, so that
    the draws' standard deviation is sqrt(2 / fan_in).  Bound on the
    measured standard deviation: 6 standard errors of the estimate (1/sqrt(2n)
    relative for n draws; the truncation only narrows it), and no draw past
    2 sigma.  The head bias is zero, every BatchNorm scale 1 and bias 0."""
    port = port_models.get_model("resnet18")
    port.init_weights(torch.Generator().manual_seed(0))
    layers = [m for m in port.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    assert len(layers) == 21
    for m in layers:
        w = m.weight.detach().double()
        target = (2.0 / w[0].numel()) ** 0.5
        assert abs(w.std().item() / target - 1) < 6 / (2 * w.numel()) ** 0.5
        assert w.abs().max().item() <= 2 * target / TRUNC_NORMAL_STD
    # against flax's own draws of the same layer (conv of fan-in 3*3*256)
    jax_w = np.asarray(jax.nn.initializers.he_normal()(jax.random.key(0), (3, 3, 256, 512)))
    port_w = port.layer4[0].conv1.weight.detach().numpy()
    assert jax_w.std() == pytest.approx(port_w.std(), rel=0.01)
    assert np.abs(jax_w).max() <= np.abs(port_w).max() * 1.01
    assert not port.linear.bias.any()
    for m in port.modules():
        if isinstance(m, port_models.BatchNorm2d):
            assert bool((m.weight == 1).all() and (m.bias == 0).all())


VARIANTS = {
    # name: (JAX block, port block, stem, image size)
    "bottleneck": (jax_models.Bottleneck, port_models.Bottleneck, "cifar", 32),
    "imagenet_stem": (jax_models.BasicBlock, port_models.BasicBlock, "imagenet", 64),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_logits_match_jax_in_eval_and_train_mode(variant):
    """A ``Bottleneck`` net (1x1, 3x3, 1x1 x4, a projection in every stage)
    at 32 px, and the ``imagenet`` stem (7x7/2 convolution, 3x3/2 max-pool)
    at 64 px, one block a stage, batch 4, fp32, carried with
    ``resnet_from_jax`` (strict), BatchNorm leaves drawn as ResNet-18's;
    ResNet-18's bounds."""
    jax_block, port_block, stem, size = VARIANTS[variant]
    model = jax_models.ResNet(block=jax_block, num_blocks=(1, 1, 1, 1), stem=stem)
    init = jax.jit(partial(model.init, train=False))
    variables = jax.device_get(init(jax.random.key(1), jnp.zeros((1, size, size, 3))))
    variables = _calibrated(model, variables, seed=6, size=size)
    port = port_models.ResNet(port_block, (1, 1, 1, 1), stem=stem)
    port.load_state_dict(resnet_from_jax(variables))
    x = _images(4, 7, size)
    for train, rtol in ((False, 1e-5), (True, 1e-4)):
        want, _ = _jax_logits(model, variables, x, train=train)
        np.testing.assert_allclose(_port_logits(port, x, train=train), want, atol=1e-5, rtol=rtol,
                                   err_msg=f"train={train}")
