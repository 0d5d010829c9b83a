"""The port's ViT against the JAX package's, on the CPU.

A JAX-initialised ``ViT`` is carried across with ``vit_from_jax`` and both
run the same numpy images in fp32 (JAX at ``highest`` matmul precision).
The logits bound, 1e-5 (logits of magnitude ~2), covers fp32 summation
order through two blocks and flax's one-pass LayerNorm variance against
torch's two-pass one.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu import models as jax_models
from distributed_training_comparison_tpu.data.augment import (
    normalize_images as jax_normalize,
)
from distributed_training_comparison_tpu_torch import models as port_models
from distributed_training_comparison_tpu_torch.data import normalize_images
from distributed_training_comparison_tpu_torch.models import VitPortError, vit_from_jax

SMALL = dict(depth=2, dim=64, heads=2, image_size=32)


@pytest.fixture(scope="module")
def small_jax():
    model = jax_models.ViT(**SMALL)
    variables = model.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))
    return model, jax.device_get(variables["params"])


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def test_logits_match_jax_through_vit_from_jax(small_jax):
    model, params = small_jax
    x = _images(4)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    port = port_models.ViT(**SMALL)
    port.load_state_dict(vit_from_jax(params))  # strict: every key matches
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 100)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_bf16_policy_keeps_logits_fp32_and_residual_in_compute_dtype(small_jax):
    _, params = small_jax
    port = port_models.ViT(**SMALL, dtype=torch.bfloat16)
    port.load_state_dict(vit_from_jax(params))
    x = torch.from_numpy(_images(2))
    with torch.no_grad():
        tokens = port.embed(x)
        assert tokens.dtype == torch.bfloat16
        assert port.trunk(tokens).dtype == torch.bfloat16
        logits = port(x)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_converter_rejects_missing_leaf(small_jax):
    _, params = small_jax
    broken = jax.tree_util.tree_map(lambda a: a, params)
    del broken["blocks"]["mlp_down"]["bias"]
    with pytest.raises(VitPortError, match="blocks/mlp_down/bias"):
        vit_from_jax(broken)


def test_converter_rejects_leftover_leaf(small_jax):
    _, params = small_jax
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["blocks"]["gate"] = {"kernel": np.zeros((2, 64, 8), np.float32)}
    with pytest.raises(VitPortError, match="blocks/gate/kernel"):
        vit_from_jax(extra)


def test_converter_rejects_wrong_shape(small_jax):
    _, params = small_jax
    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["blocks"]["q_proj"]["kernel"] = np.zeros((2, 64, 32), np.float32)
    with pytest.raises(VitPortError, match="q_proj/kernel"):
        vit_from_jax(bad)


@pytest.mark.parametrize(
    "name,image_size",
    [("vit_tiny", 32), ("vit_small", 32), ("vit_long", 256), ("vit_moe", 32)],
)
def test_full_width_param_shapes_match_jax(name, image_size):
    """Every leaf of the JAX model's init, by ``jax.eval_shape`` (no JAX
    weights materialised), converts to the port model's parameter of the
    same name and shape; the port model is built on the meta device."""
    jax_model = jax_models.get_model(name, image_size=image_size)
    abstract = jax.eval_shape(
        jax_model.init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, image_size, image_size, 3), jnp.float32),
    )["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), abstract)
    converted = vit_from_jax(zeros)
    with torch.device("meta"):
        port = port_models.get_model(name, image_size=image_size)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in converted.items()} == want


def test_vit_long_widths_match_jax():
    jax_long = jax_models.ViTLong()
    with torch.device("meta"):
        port = port_models.ViTLong()
    assert (jax_long.depth, jax_long.dim, jax_long.heads, jax_long.image_size) == (
        len(port.blocks), port.dim, port.blocks[0].heads, port.image_size
    )
    assert port.pos_emb.shape == (1, 4096, 512)  # 256 px at patch 4
    assert port.blocks[0].q_proj.weight.shape[0] // port.blocks[0].heads == 128


def test_vit_moe_widths_match_jax():
    """``vit_moe`` has the JAX ``ViTMoE``'s widths: 8 blocks of dim 192 and
    3 heads, each with 8 experts of hidden 768 behind a router, no dense
    MLP, and capacity factor 1.25."""
    jax_moe = jax_models.ViTMoE()
    with torch.device("meta"):
        port = port_models.get_model("vit_moe")
    assert (jax_moe.depth, jax_moe.dim, jax_moe.heads, jax_moe.num_experts) == (
        len(port.blocks), port.dim, port.blocks[0].heads, port.blocks[0].moe.num_experts
    )
    blk = port.blocks[0]
    assert blk.moe.w_up.shape == (8, 192, 768) and blk.moe.w_down.shape == (8, 768, 192)
    assert blk.moe.router.weight.shape == (8, 192)
    assert not hasattr(blk, "mlp_up") and blk.moe.capacity_factor == jax_moe.capacity_factor
    assert blk.moe.dispatch == "auto"


def test_zoo_names_and_unported_models():
    """Every zoo name builds, the ResNets included (no model is left
    unported); an unknown name raises ``ValueError``."""
    for name, block in (("resnet18", port_models.BasicBlock), ("resnet50", port_models.Bottleneck)):
        with torch.device("meta"):
            model = port_models.get_model(name)
        assert isinstance(model, port_models.ResNet) and isinstance(model.layer1[0], block)
    with pytest.raises(ValueError, match="unknown model"):
        port_models.get_model("vit_huge")


def test_block_fusion_force_runs_the_fused_plain_version_on_cpu(monkeypatch):
    """At patch 2 (256 tokens, inside the gate's window) ``force`` runs every
    block through ``fused_vit_block``, which on the CPU is its plain
    version, and gives the composed model's logits on the same weights
    (fp32: the two differ by LayerNorm's variance formula and summation
    order, 1e-5 on logits ~1); ``auto`` and ``off`` compose on the CPU."""
    vit_mod = importlib.import_module("distributed_training_comparison_tpu_torch.models.vit")
    seen = []
    real = vit_mod.fused_vit_block

    def spy(x, params, **kw):
        seen.append(tuple(x.shape))
        return real(x, params, **kw)

    monkeypatch.setattr(vit_mod, "fused_vit_block", spy)
    kw = dict(SMALL, patch=2)
    fused = port_models.ViT(**kw, block_fusion="force")
    x = torch.from_numpy(_images(2))
    with torch.no_grad():
        got = fused(x)
        assert seen == [(2, 256, 64)] * 2
        for mode in ("auto", "off"):
            composed = port_models.ViT(**kw, block_fusion=mode)
            composed.load_state_dict(fused.state_dict())
            torch.testing.assert_close(composed(x), got, atol=1e-5, rtol=0)
    assert seen == [(2, 256, 64)] * 2
    with pytest.raises(ValueError, match="unknown block_fusion"):
        port_models.ViT(**SMALL, block_fusion="always")


def test_normalize_images_matches_jax():
    u8 = np.random.default_rng(1).integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    want = np.asarray(jax_normalize(jnp.asarray(u8)))
    got = normalize_images(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)  # fp32 rounding only
    assert normalize_images(torch.from_numpy(u8), dtype=torch.bfloat16).dtype == torch.bfloat16


def test_port_attention_module_is_the_vit_dispatch(monkeypatch):
    """The blocks reach attention through ops.attention with the bshd layout:
    a monkeypatched dispatcher sees every block's call."""
    vit_mod = importlib.import_module("distributed_training_comparison_tpu_torch.models.vit")
    seen = []
    real = vit_mod.attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), kw["layout"], kw["impl"]))
        return real(q, k, v, **kw)

    port = port_models.ViT(**SMALL)
    monkeypatch.setattr(vit_mod, "attention", spy)
    with torch.no_grad():
        port(torch.from_numpy(_images(1)))
    assert seen == [((1, 64, 2, 32), "bshd", "auto")] * 2
