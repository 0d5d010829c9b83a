"""The port's fused ViT block backward (K6) against the JAX package's, on the CPU.

Inputs and parameters are made from a seed with numpy and handed to both.
The JAX side runs its Pallas block kernels in interpret mode, as
``tests/test_vit_block.py`` does; the port runs its plain versions
(``fused_vit_block_bwd`` and ``_FusedViTBlock`` take them for a CPU
tensor).  fp32 runs at JAX's ``highest`` matmul precision.  Tolerances,
with their reasons, sit beside each comparison.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu import models as jax_models
from distributed_training_comparison_tpu.ops.attention_small import _head_probs
from distributed_training_comparison_tpu.ops.attention_small import head_bwd as jax_head_bwd
from distributed_training_comparison_tpu.ops.attention_small import pick_block_items
from distributed_training_comparison_tpu.ops.vit_block import _block_call
from distributed_training_comparison_tpu.ops.vit_block import fused_vit_block as jax_fused_vit_block
from distributed_training_comparison_tpu.parallel import make_mesh, replicated_sharding
from distributed_training_comparison_tpu.train import (
    configure_optimizers as jax_configure_optimizers,
)
from distributed_training_comparison_tpu.train import create_train_state, make_train_step
from distributed_training_comparison_tpu_torch import models as port_models
from distributed_training_comparison_tpu_torch.data import synthetic_dataset
from distributed_training_comparison_tpu_torch.models import vit_from_jax
from distributed_training_comparison_tpu_torch.ops.attention_small import (
    head_bwd,
    packed_attention_bwd_reference,
)
from distributed_training_comparison_tpu_torch.train import TrainStep, configure_optimizers

vb = importlib.import_module("distributed_training_comparison_tpu_torch.ops.vit_block")

B, S, DIM, HEADS = 4, 256, 64, 2  # JAX's row grid: tb 2, two steps
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DENSE = ("q_proj", "k_proj", "v_proj", "proj", "mlp_up", "mlp_down")
COUNTERS = ("fused_vit_block", "fused_vit_block_bwd", "block_gemm", "block_attention",
            "block_ln", "block_gemm_dgrad", "block_ln_bwd", "block_attention_bwd",
            "block_gemm_wgrad", "block_grad_reduce")


def _jax_block_params(seed=0, dim=DIM, mlp_ratio=4):
    """A flax ViTBlock parameter tree from numpy: xavier-scale weights and
    non-trivial LayerNorm scales and biases, so every term is exercised."""
    rng = np.random.default_rng(seed)
    hidden = mlp_ratio * dim
    fan = {"mlp_up": (dim, hidden), "mlp_down": (hidden, dim)}
    params = {}
    for name in DENSE:
        fin, fout = fan.get(name, (dim, dim))
        limit = np.sqrt(6.0 / (fin + fout))
        params[name] = {
            "kernel": rng.uniform(-limit, limit, (fin, fout)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(fout)).astype(np.float32),
        }
    for name in ("ln_attn", "ln_mlp"):
        params[name] = {
            "scale": (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(dim)).astype(np.float32),
        }
    return params


def _port_params(jax_params):
    """The port ViTBlock's parameters by name from a flax block tree."""
    out = {}
    for name, leaves in jax_params.items():
        if "kernel" in leaves:
            out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(leaves["kernel"].T))
        else:
            out[f"{name}.weight"] = torch.from_numpy(leaves["scale"])
        out[f"{name}.bias"] = torch.from_numpy(leaves["bias"])
    return out


def _x(seed=1, shape=(B, S, DIM)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _row_share(got, want, rtol):
    """The least share of each row's rms under which ``got`` holds against
    ``want`` elementwise with ``rtol`` (a row: one token's dim values)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt((want**2).mean(-1, keepdims=True))
    return float(((np.abs(got - want) - rtol * np.abs(want)) / rms).max())


def _launches():
    return [getattr(vb, name).launches for name in COUNTERS]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _leaf_error(got, want, scale):
    """max |got - want| / max |scale|."""
    got, want, scale = (np.asarray(t, np.float64) for t in (got, want, scale))
    return float(np.abs(got - want).max() / max(np.abs(scale).max(), 1e-30))


def _port_grads_as_jax(grads):
    """The port's gradients (numpy) by parameter name → the JAX kernel's twelve
    raw gradients in its order and layout: (in, out) kernels, q/k/v packed."""
    t = lambda name: grads[name].T  # noqa: E731
    return [
        grads["ln_attn.weight"], grads["ln_attn.bias"],
        np.concatenate([t(f"{n}.weight") for n in ("q_proj", "k_proj", "v_proj")], axis=1),
        np.concatenate([grads[f"{n}.bias"] for n in ("q_proj", "k_proj", "v_proj")]),
        t("proj.weight"), grads["proj.bias"], grads["ln_mlp.weight"], grads["ln_mlp.bias"],
        t("mlp_up.weight"), grads["mlp_up.bias"], t("mlp_down.weight"), grads["mlp_down.bias"],
    ]


def _jax_raw_params(jp, cd, norm_f32):
    """The twelve primals ``fused_vit_block`` hands ``_block_core``: Dense
    leaves cast to the compute dtype, q/k/v packed; LayerNorm leaves fp32
    (``norm_f32``) or cast."""
    ln_dt = jnp.float32 if norm_f32 else cd
    c = lambda a, dt=cd: jnp.asarray(a).astype(dt)  # noqa: E731
    return [
        c(jp["ln_attn"]["scale"], ln_dt), c(jp["ln_attn"]["bias"], ln_dt),
        jnp.concatenate([c(jp[n]["kernel"]) for n in ("q_proj", "k_proj", "v_proj")], axis=1),
        jnp.concatenate([c(jp[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]),
        c(jp["proj"]["kernel"]), c(jp["proj"]["bias"]),
        c(jp["ln_mlp"]["scale"], ln_dt), c(jp["ln_mlp"]["bias"], ln_dt),
        c(jp["mlp_up"]["kernel"]), c(jp["mlp_up"]["bias"]),
        c(jp["mlp_down"]["kernel"]), c(jp["mlp_down"]["bias"]),
    ]


# the k_proj bias gradient is exactly zero in exact arithmetic (Σ_j ds_ij = 0
# by softmax shift invariance): both sides hold rounding noise there, so it
# is measured against its weight's scale, i.e. absolutely
_SCALE_OF = {3: 2}  # JAX order: packed qkv bias → packed qkv kernel


# (B, S, dim, heads) of the attention backward: the first case, then the
# shapes the card's bf16 kernels take (head dim 64): the vit_tiny p2 paths
# (S 256, 3 heads), a ragged S (136, 2 heads) and the gate's window top (S 512)
ATTENTION_SHAPES = [
    pytest.param(B, S, DIM, HEADS, id="s256-hd32"),
    pytest.param(2, 256, 192, 3, id="s256-hd64"),
    pytest.param(2, 136, 128, 2, id="s136-hd64"),
    pytest.param(2, 512, 192, 3, id="s512-hd64"),
]


@pytest.mark.parametrize("b,s,dim,heads", ATTENTION_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bwd_matches_jax_head_bwd(dtype, b, s, dim, heads):
    """The port's ``head_bwd`` (per head) and ``packed_attention_bwd_reference``
    against JAX ``head_bwd`` given its ``_head_probs`` (the stacked
    block-diagonal form, all ``b`` items in one tile), at each shape the
    card's kernels take.  fp32 at ``highest``: summation order only, 1e-5 of
    each gradient's scale.  bf16: both round ds·scale, P and each gradient
    to bf16 at the same points; a one-ulp flip (2^-8) of one ds or P term
    moves a gradient by 2^-8 of one term among S, and the gradient's own
    rounding differs by at most one ulp: 2^-6 of its scale."""
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((b * s, 3 * dim)).astype(np.float32)
    do = rng.standard_normal((b * s, dim)).astype(np.float32)
    d = dim // heads
    scale = d**-0.5
    qkv_t, do_t = torch.from_numpy(qkv).to(dtype), torch.from_numpy(do).to(dtype)
    qkv_j, do_j = jnp.asarray(qkv).astype(JNP[dtype]), jnp.asarray(do).astype(JNP[dtype])
    packed = packed_attention_bwd_reference(qkv_t, do_t, seq=s, heads=heads)
    assert packed.dtype == dtype and packed.shape == (b * s, 3 * dim)
    tol = 1e-5 if dtype == torch.float32 else 2**-6
    for h in range(heads):
        cols = [slice(j * dim + h * d, j * dim + (h + 1) * d) for j in range(3)]
        hs = slice(h * d, (h + 1) * d)
        with jax.default_matmul_precision("highest"):
            qh, kh, vh = (qkv_j[:, c] for c in cols)
            pf = _head_probs(qh, kh, b, s, scale, False)
            want = jax_head_bwd(qh, kh, vh, do_j[:, hs], pf, b, s, scale)
        got = head_bwd(*(qkv_t[:, c] for c in cols), do_t[:, hs], s, scale)
        for j, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(packed[:, cols[j]].float().numpy(), g.float().numpy())
            w = _np(w)
            assert _leaf_error(g.float().numpy(), w, w) <= tol, (h, "qkv"[j])


@pytest.mark.parametrize("norm_f32", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raw_backward_matches_jax_block_call(dtype, norm_f32):
    """``fused_vit_block_bwd_reference`` against the JAX backward kernel
    ``_block_call(x2, dy2, ...)`` in interpret mode, whose two-step row grid
    accumulates the gradients across tiles: dx and the twelve raw fp32
    gradients.  fp32 at ``highest``: summation order only, 2e-5 of each
    leaf's scale (dx per row as the forward's test).  bf16: the same
    rounding points, but XLA on the CPU may keep an intermediate (the gelu
    and its derivative, LayerNorm's bf16 statistics under ``norm_f32``
    False) in fp32 where torch rounds it, and a one-ulp flip of an
    intermediate moves a gradient by 2^-8 of one term of its sum: 2^-5 of
    each leaf's scale, dx 2^-5 of its row's rms plus 2^-6·|dx|."""
    cd = JNP[dtype]
    jp = _jax_block_params(seed=11)
    x, dy = _x(12), _x(13)
    d = DIM // HEADS
    tb = pick_block_items(B, S)
    assert B * S // (tb * S) == 2  # two grid steps
    with jax.default_matmul_precision("highest"):
        dx_j, grads_j = _block_call(
            jnp.asarray(x.reshape(B * S, DIM)).astype(cd), jnp.asarray(dy.reshape(B * S, DIM)).astype(cd),
            _jax_raw_params(jp, cd, norm_f32), tb, S, HEADS, d, d**-0.5, norm_f32, True,
        )
    dx, grads = vb.fused_vit_block_bwd_reference(
        torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype), _port_params(jp),
        heads=HEADS, norm_f32=norm_f32,
    )
    assert dx.dtype == dtype and all(g.dtype == torch.float32 for g in grads.values())
    got = _port_grads_as_jax({k: v.numpy() for k, v in grads.items()})
    fp32 = dtype == torch.float32
    tol = 2e-5 if fp32 else 2**-5
    for i, (g, w) in enumerate(zip(got, grads_j)):
        w = _np(w)
        scale = _np(grads_j[_SCALE_OF.get(i, i)])
        assert _leaf_error(np.asarray(g), w, scale) <= tol, i
    dx_np, want_dx = dx.float().numpy().reshape(B * S, DIM), _np(dx_j)
    if fp32:
        assert _row_share(dx_np, want_dx, 0.0) <= 2e-5
    else:
        assert _row_share(dx_np, want_dx, 2**-6) <= 2**-5


def test_cpu_chain_of_the_kernel_wrappers_matches_the_plain_backward():
    """The K6 chain as the card runs it (``_bwd_chain``: the recompute, the
    data-gradient GEMMs, the LayerNorm backward rows, the per-chunk partials
    and their reduction) over the wrappers' plain versions, on a ragged row
    count (408 rows: a partial last chunk of both reductions), equals the
    plain backward up to fp32 summation order: 1e-6 of each leaf's scale,
    dx exactly (the same rounded operations in the same order)."""
    jp = _jax_block_params(seed=3)
    params = _port_params(jp)
    b, s = 3, 136
    x = torch.from_numpy(_x(4, (b, s, DIM)))
    dy = torch.from_numpy(_x(5, (b, s, DIM)))
    before = _launches()
    dx, grads = vb._bwd_chain(x.reshape(b * s, DIM), dy.reshape(b * s, DIM), params, s, HEADS)
    assert _launches() == before  # the CPU launches nothing
    want_dx, want = vb.fused_vit_block_bwd_reference(x, dy, params, heads=HEADS)
    torch.testing.assert_close(dx.view(b, s, DIM), want_dx, rtol=0, atol=0)
    for name, w in want.items():
        assert grads[name].shape == w.shape, name
        scale = want["k_proj.weight" if name == "k_proj.bias" else name]
        assert _leaf_error(grads[name], w, scale) <= 1e-6, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_matches_jax_vjp(dtype):
    """``fused_vit_block`` with parameters that require grad records
    ``_FusedViTBlock``; its backward (the plain one on the CPU, no launch)
    against ``jax.vjp`` of the JAX ``fused_vit_block`` (interpret mode) in
    x and the flax parameters.  The JAX cotangents of the Dense leaves pass
    through their compute-dtype casts, so under bf16 every Dense gradient is
    bf16-representable, and so is the port's.  Tolerances as the raw
    backward's."""
    cd = JNP[dtype]
    jp = _jax_block_params(seed=21)
    x, dy = _x(22), _x(23)
    xj, dyj = jnp.asarray(x).astype(cd), jnp.asarray(dy).astype(cd)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(
            lambda xx, pp: jax_fused_vit_block(xx, pp, heads=HEADS, interpret=True), xj, jp
        )
        dx_j, grads_j = vjp(dyj)
    params = {k: v.clone().requires_grad_() for k, v in _port_params(jp).items()}
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    before = _launches()
    out = vb.fused_vit_block(xt, params, heads=HEADS)
    assert type(out.grad_fn).__name__ == "_FusedViTBlockBackward"
    out.backward(torch.from_numpy(dy).to(dtype))
    assert _launches() == before
    fp32 = dtype == torch.float32
    tol = 2e-5 if fp32 else 2**-5
    port_j = {}
    for name in DENSE + ("ln_attn", "ln_mlp"):
        w_key = "kernel" if name in DENSE else "scale"
        port_j[(name, w_key)] = params[f"{name}.weight"].grad.numpy()
        port_j[(name, "bias")] = params[f"{name}.bias"].grad.numpy()
        if name in DENSE:
            port_j[(name, w_key)] = port_j[(name, w_key)].T
    for (name, leaf), g in port_j.items():
        want = _np(grads_j[name][leaf])
        scale = _np(grads_j["k_proj"]["kernel"]) if (name, leaf) == ("k_proj", "bias") else want
        assert g.dtype == np.float32
        assert _leaf_error(g, want, scale) <= tol, (name, leaf)
        if not fp32 and name in DENSE:
            np.testing.assert_array_equal(g, torch.from_numpy(g).to(torch.bfloat16).float().numpy())
    dx = xt.grad.float().numpy().reshape(B * S, DIM)
    want_dx = _np(dx_j).reshape(B * S, DIM)
    assert _row_share(dx, want_dx, 0.0 if fp32 else 2**-6) <= (2e-5 if fp32 else 2**-5)


def _ce(logits, labels):
    return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(len(labels)), labels])


def test_force_vit_patch2_loss_and_grads_match_jax():
    """A ``block_fusion="force"`` ViT at patch 2 (32 px, 256 tokens, depth
    2, dim 64): its cross-entropy and every parameter gradient against the
    JAX ``force`` model's ``jax.value_and_grad`` (its blocks the Pallas
    kernels in interpret mode), carried across by ``vit_from_jax``.  fp32
    at ``highest``: summation order through two blocks, 1e-5 on the loss
    and 2e-5 of each leaf's scale."""
    kw = dict(depth=2, dim=64, heads=2, patch=2, image_size=32)
    model = jax_models.ViT(block_fusion="force", **kw)
    x = _x(31, (4, 32, 32, 3))
    labels = np.array([3, 17, 0, 99])
    params = jax.device_get(model.init(jax.random.key(6), jnp.zeros((1, 32, 32, 3)))["params"])
    with jax.default_matmul_precision("highest"):
        loss_j, grads_j = jax.value_and_grad(
            lambda p: _ce(model.apply({"params": p}, jnp.asarray(x)), jnp.asarray(labels))
        )(params)
    want = vit_from_jax(jax.device_get(grads_j))
    port = port_models.ViT(block_fusion="force", **kw)
    port.load_state_dict(vit_from_jax(params))
    before = _launches()
    loss = torch.nn.functional.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(labels))
    loss.backward()
    assert _launches() == before
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    for name, p in port.named_parameters():
        scale = want[name.replace("k_proj.bias", "k_proj.weight")]
        assert _leaf_error(p.grad.numpy(), want[name].numpy(), scale.numpy()) <= 2e-5, name


def test_three_force_train_steps_match_jax_make_train_step():
    """Three steps of a ``force`` patch-2 ViT (depth 2, dim 64, 32 px: every
    block fused, forward and backward) on the same batch through JAX's
    ``make_train_step(mesh, augment=False)`` and the port's ``TrainStep``,
    fp32, across the LR decay after step 2; as
    ``tests/test_torch_port_train.py``'s composed three steps, with the same
    bounds: 1e-5 relative on loss and grad norm, 2e-6 absolute on the
    parameters (of size ~0.1-1)."""
    kw = dict(depth=2, dim=64, heads=2, image_size=32, patch=2, block_fusion="force")

    class HP:
        lr, weight_decay, lr_decay_step_size, lr_decay_gamma = 0.1, 1e-4, 2, 0.1

    mesh = make_mesh(backend="ddp")
    tx, _ = jax_configure_optimizers(HP, steps_per_epoch=1)
    state = create_train_state(jax_models.ViT(**kw), jax.random.key(3), tx)
    state = jax.device_put(state, replicated_sharding(mesh))
    step = make_train_step(mesh, augment=False)
    model = port_models.ViT(**kw)
    model.load_state_dict(vit_from_jax(jax.device_get(state.params)))
    opt, schedule = configure_optimizers(HP, 1, model.parameters())
    port_step = TrainStep(model, opt, schedule, augment=False)
    images, labels = synthetic_dataset(8, seed=0)
    for i in range(3):
        with jax.default_matmul_precision("highest"):
            state, m = step(state, jnp.asarray(images), jnp.asarray(labels), jax.random.key(i))
        got = port_step(torch.from_numpy(images), torch.from_numpy(labels).long())
        assert float(got["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
        assert float(got["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=1e-5)
        want = vit_from_jax(jax.device_get(state.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-6, rtol=0, err_msg=name)
    assert port_step.applied == int(state.step) == 3
