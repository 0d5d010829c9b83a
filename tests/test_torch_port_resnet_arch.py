"""The port's ResNet zoo and its BatchNorm against the JAX package's, on
the CPU.

The widths of every zoo depth, and ``BatchNorm2d`` alone against flax's
``nn.BatchNorm`` under the zoo's ``norm_policy``.  JAX runs at ``highest``
matmul precision; each tolerance is stated beside its comparison.
"""

from functools import partial

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu import models as jax_models
from distributed_training_comparison_tpu.models.norms import norm_policy
from distributed_training_comparison_tpu.models.resnet import BN_EPS, BN_MOMENTUM
from distributed_training_comparison_tpu_torch import models as port_models
from distributed_training_comparison_tpu_torch.models import resnet_from_jax


@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"])
def test_zoo_depths_match_jax(name):
    """Every zoo depth has the JAX model's parameters and statistics, leaf
    for leaf in shape (through ``resnet_from_jax``'s structural checks on
    zeros of the JAX shapes), and takes ``stem`` and ``remat``."""
    model = jax_models.get_model(name)
    shapes = jax.eval_shape(partial(model.init, train=False), jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    with torch.device("meta"):
        port = port_models.get_model(name, stem="imagenet", remat=True)
    sd = resnet_from_jax(dict(zeros))  # raises on any missing, extra or misshapen leaf
    assert {k: tuple(v.shape) for k, v in sd.items() if k != "conv1.weight"} == {
        k: tuple(v.shape) for k, v in port.state_dict().items() if k != "conv1.weight"
    }
    assert port.conv1.weight.shape == (64, 3, 7, 7) and port.remat


# BatchNorm2d against flax nn.BatchNorm: (compute dtype, norm_dtype) for
# torch and JAX; output dtype; bound on the output (relative to its largest
# value) and on the running statistics (absolute, of size ~1).  fp32: the
# reduction orders differ, 1e-6.  bf16 input: the same fp32 statistics of
# the same bf16 values; a bf16 output differs by at most one rounding, 2^-8.
BN_CASES = {
    "fp32": ((torch.float32, torch.float32), (jnp.float32, jnp.float32), torch.float32, 1e-6),
    "bf16_fp32": ((torch.bfloat16, torch.float32), (jnp.bfloat16, jnp.float32), torch.float32,
                  1e-6),
    "bf16_compute": ((torch.bfloat16, torch.bfloat16), (jnp.bfloat16, jnp.bfloat16),
                     torch.bfloat16, 2**-8),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_matches_flax_batchnorm(case):
    """One train-mode call and one eval-mode call of ``BatchNorm2d`` against
    flax's, on an input with a per-channel offset and scale, N*H*W = 16
    values a channel.  The running variance takes the biased batch
    variance: ``torch.nn.BatchNorm2d``'s unbiased one misses it by
    var / 15 x 0.1.  Eval mode leaves the running buffers alone."""
    (t_dtype, t_norm), (j_dtype, j_norm), out_dtype, tol = BN_CASES[case]
    rng = np.random.default_rng(0)
    c = 8
    x = (rng.standard_normal((4, 2, 2, c)) * rng.uniform(0.5, 3, c) + rng.standard_normal(c))
    x = x.astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.standard_normal(c).astype(np.float32)
    flax_bn = norm_policy(nn.BatchNorm, j_norm, j_dtype, momentum=BN_MOMENTUM, epsilon=BN_EPS)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}}
    xj = jnp.asarray(x).astype(j_dtype)
    want, mutated = flax_bn(use_running_average=False).apply(
        variables, xj, mutable=["batch_stats"])
    port = port_models.BatchNorm2d(c, t_dtype, t_norm)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(t_dtype).permute(0, 3, 1, 2)  # NHWC seen as NCHW
    with torch.no_grad():
        got = port.train()(xt)
    assert got.dtype == out_dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    for ours, theirs in ((port.running_mean, "mean"), (port.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(mutated["batch_stats"][theirs]),
                                   atol=1e-6, rtol=0, err_msg=theirs)
    unbiased = torch.nn.BatchNorm2d(c, eps=BN_EPS, momentum=1 - BN_MOMENTUM)
    unbiased(xt.float())
    miss = np.abs(unbiased.running_var.detach().numpy() - port.running_var.numpy()).max()
    assert miss > 1e-3

    stats = {"mean": port.running_mean.numpy().copy(), "var": port.running_var.numpy().copy()}
    want = flax_bn(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": stats}, xj)
    with torch.no_grad():
        got = port.eval()(xt).float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    np.testing.assert_array_equal(port.running_mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(port.running_var.numpy(), stats["var"])
    assert int(port.num_batches_tracked) == 0


def test_vit_bn_dtype_compute_matches_jax():
    """``--bn-dtype compute`` on the ViT (``norm_dtype`` bf16 under bf16
    compute): flax's LayerNorm still reduces and applies its affine in fp32
    (``norm_policy`` forces the reductions) and rounds the result to bf16,
    and so does the port's, so the port's logits equal its ``--bn-dtype
    fp32`` ones bit for bit; against JAX's bf16 ViT in both modes, within
    2^-6 of the largest logit (one bf16 ulp of it reads at seed 0)."""
    small = dict(depth=2, dim=64, heads=2, image_size=32)
    params = jax.device_get(
        jax_models.ViT(**small).init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))["params"])
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    got = {}
    for name, (j_norm, t_norm) in {"fp32": (jnp.float32, torch.float32),
                                   "compute": (jnp.bfloat16, torch.bfloat16)}.items():
        model = jax_models.ViT(**small, dtype=jnp.bfloat16, norm_dtype=j_norm)
        want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
        port = port_models.ViT(**small, dtype=torch.bfloat16, norm_dtype=t_norm)
        port.load_state_dict(port_models.vit_from_jax(params))
        with torch.no_grad():
            got[name] = port(torch.from_numpy(x)).numpy()
        assert np.abs(got[name] - want).max() <= 2**-6 * np.abs(want).max(), name
    np.testing.assert_array_equal(got["compute"], got["fp32"])
