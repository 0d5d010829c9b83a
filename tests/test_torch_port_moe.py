"""The port's mixture-of-experts slice against the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function and
its port counterpart:

- the grouped expert FFN (K7) and its dx (K8) and weight-gradient (K9)
  plain versions against the JAX ``grouped_ffn`` in Pallas interpret mode
  and its ``jax.vjp``;
- ``SwitchFFN`` under all three dispatches (the JAX ``gmm`` in interpret
  mode, as ``tests/test_moe.py`` runs it): output, aux loss, routing
  health and every gradient, the router's included;
- the dispatch rule, a 2-block ``vit_moe`` carried across with
  ``vit_from_jax``, and train steps of a small ``vit_moe``;
- the fused-block gate declining MoE blocks.

Everything compares in fp32 (JAX at ``highest`` matmul precision), where
the two sides differ only by summation order: 2e-5 of each output's scale
unless a test says otherwise.  Routing is compared for equality, and every
test asserts at its seed that each token's top-2 router probabilities are
more than 1e-4 apart, so an argmax flip between torch's and XLA's fp32
router sums would show as a bad seed, not hide under a tolerance.
"""

import dataclasses
import importlib
import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu import models as jax_models
from distributed_training_comparison_tpu.models.moe import SwitchFFN as JaxSwitchFFN
from distributed_training_comparison_tpu.ops import vmem as jax_vmem
from distributed_training_comparison_tpu.ops.moe_gmm import grouped_ffn as jax_grouped_ffn
from distributed_training_comparison_tpu.parallel import make_mesh, replicated_sharding
from distributed_training_comparison_tpu.train import (
    configure_optimizers as jax_configure_optimizers,
)
from distributed_training_comparison_tpu.train import create_train_state, make_train_step
from distributed_training_comparison_tpu_torch import models as port_models
from distributed_training_comparison_tpu_torch.data import normalize_images, synthetic_dataset
from distributed_training_comparison_tpu_torch.models import vit_from_jax
from distributed_training_comparison_tpu_torch.models.moe import SwitchFFN, capacity
from distributed_training_comparison_tpu_torch.ops import moe_gmm, vmem
from distributed_training_comparison_tpu_torch.train import (
    TrainStep,
    configure_optimizers,
    forward_backward,
)

vit_mod = importlib.import_module("distributed_training_comparison_tpu_torch.models.vit")

GAP = 1e-4  # least top-2 router probability gap asserted at every seed


def _close(got, want, rel=2e-5, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale, err_msg=name)


# ------------------------------------------------------- grouped_ffn (K7-K9)

# (label, E, d, h, group counts (their sum is n unless padding follows), cap,
#  padding rows past starts[E]): n 67, 200 and 200
GROUPED_CASES = [
    ("drops, an empty group, ragged n", 4, 16, 64, (30, 0, 21, 13), 24, 3),
    ("group ending at n over capacity", 4, 32, 128, (40, 50, 10, 100), 48, 0),
    ("n 200, every group kept", 4, 24, 96, (60, 40, 50, 50), 64, 0),
]


def _grouped_inputs(seed, ne, d, h, counts, pad):
    rng = np.random.default_rng(seed)
    n = sum(counts) + pad
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    xs = rng.standard_normal((n, d)).astype(np.float32)
    xs[sum(counts):] = 0.0  # padding rows are zero, as the scatter leaves them
    w1 = (rng.standard_normal((ne, d, h)) / np.sqrt(d)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((ne, h))).astype(np.float32)
    w2 = (rng.standard_normal((ne, h, d)) / np.sqrt(h)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((ne, d))).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    return xs, w1, b1, w2, b2, starts, dy


@pytest.mark.parametrize("label,ne,d,h,counts,cap,pad", GROUPED_CASES)
def test_grouped_ffn_and_its_gradients_match_jax_interpret(label, ne, d, h, counts, cap, pad):
    """K7's plain version against the JAX kernel in interpret mode, then
    the port's autograd Function (K8's and K9's plain versions on the CPU)
    against ``jax.vjp`` of it: dx and the four weight gradients.  Rows no
    expert keeps are exactly 0 in the output and in dx on both sides."""
    xs, w1, b1, w2, b2, starts, dy = _grouped_inputs(len(label), ne, d, h, counts, pad)
    n = xs.shape[0]

    def jax_fn(*args):
        return jax_grouped_ffn(*args, jnp.asarray(starts), cap, interpret=True)

    with jax.default_matmul_precision("highest"):
        want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (xs, w1, b1, w2, b2)))
        want_grads = vjp(jnp.asarray(dy))
    params = [torch.tensor(a, requires_grad=True) for a in (xs, w1, b1, w2, b2)]
    got = moe_gmm.grouped_ffn(*params, torch.from_numpy(starts), cap)
    got.backward(torch.from_numpy(dy))
    _close(got.detach(), want, name="out")
    for name, p, g in zip(("dx", "dw1", "db1", "dw2", "db2"), params, want_grads):
        _close(p.grad, g, name=name)
    kept = moe_gmm.kept_mask(torch.from_numpy(starts), cap, n).numpy()
    assert int(kept.sum()) == sum(min(c, cap) for c in counts)
    for t in (got.detach().numpy(), np.asarray(want), params[0].grad.numpy(), np.asarray(want_grads[0])):
        assert (t[~kept] == 0).all()
    # the wrappers on the CPU are the plain versions, and count no launch
    launches = [f.launches for f in (moe_gmm.grouped_ffn_fwd, moe_gmm.grouped_ffn_dx, moe_gmm.grouped_ffn_dw)]
    dx = moe_gmm.grouped_ffn_dx(*[torch.from_numpy(a) for a in (xs, dy, w1, b1, w2, starts)], cap)
    torch.testing.assert_close(dx, params[0].grad, rtol=0, atol=0)
    assert launches == [f.launches for f in (moe_gmm.grouped_ffn_fwd, moe_gmm.grouped_ffn_dx, moe_gmm.grouped_ffn_dw)]


def test_grouped_ffn_empty_groups_at_n_read_nothing():
    """Router collapse: every token on the last expert, so the earlier
    groups are empty and the later ones start at n (``moe_gmm.py:218-229``).
    The plain versions keep exactly the first ``cap`` rows, and the other
    experts' weight gradients are exactly 0, as in the JAX kernel."""
    ne, d, h, n, cap = 4, 16, 64, 40, 16
    xs, w1, b1, w2, b2, _, dy = _grouped_inputs(7, ne, d, h, (n,), 0)
    w1, b1, w2, b2 = (np.repeat(a[:1], ne, 0) for a in (w1, b1, w2, b2))
    starts = np.array([0, 0, 0, 0, n], np.int32)
    with jax.default_matmul_precision("highest"):
        want, vjp = jax.vjp(
            lambda *a: jax_grouped_ffn(*a, jnp.asarray(starts), cap, interpret=True),
            *map(jnp.asarray, (xs, w1, b1, w2, b2)),
        )
        want_grads = vjp(jnp.asarray(dy))
    t = [torch.from_numpy(a) for a in (xs, w1, b1, w2, b2, starts, dy)]
    got = moe_gmm.grouped_ffn_reference(*t[:6], cap)
    _close(got, want, name="out")
    assert (got[cap:] == 0).all() and (got[:cap].abs().sum(-1) > 0).all()
    grads = moe_gmm.grouped_ffn_dw_reference(t[0], t[6], t[1], t[2], t[3], t[5], cap)
    for name, g, w in zip(("dw1", "db1", "dw2", "db2"), grads, want_grads[1:]):
        _close(g, w, name=name)
        assert (g[:3] == 0).all()


# ------------------------------------------------------------- SwitchFFN


def _router_gap(probs: np.ndarray) -> float:
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _port_ffn_from_jax(params, ffn: JaxSwitchFFN, dispatch: str) -> SwitchFFN:
    port = SwitchFFN(ffn.dim, ffn.num_experts, ffn.mlp_ratio, ffn.capacity_factor,
                     dispatch=dispatch)
    port.load_state_dict({
        "router.weight": torch.from_numpy(np.array(params["router"]["kernel"]).T.copy()),
        "router.bias": torch.from_numpy(np.array(params["router"]["bias"])),
        **{k: torch.from_numpy(np.array(params[k])) for k in ("w_up", "b_up", "w_down", "b_down")},
    })
    return port


@pytest.mark.parametrize("dispatch", ["gmm", "gather", "onehot"])
def test_switch_ffn_matches_jax_under_each_dispatch(dispatch):
    """E 4, dim 16, mlp ratio 2, capacity factor 0.5 (so tokens drop), 128
    tokens: the output, the aux loss, ``dropped_frac`` and ``expert_load``,
    and the gradient of ``sum(y²) + aux`` for every parameter (the router's
    included) and for x, against the JAX layer under the same dispatch."""
    base = JaxSwitchFFN(dim=16, num_experts=4, mlp_ratio=2, capacity_factor=0.5,
                        dispatch=dispatch)
    rng = np.random.default_rng(19)  # its least top-2 router gap is 5e-4
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    variables = base.init(jax.random.key(6), jnp.asarray(x))
    params = jax.device_get(variables["params"])

    def jax_loss(p, xin):
        y, mut = base.apply({"params": p}, xin, mutable=["losses", "moe_metrics"])
        aux = sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(mut["losses"]))
        return jnp.sum(y ** 2) + aux, (y, aux, mut["moe_metrics"])

    with jax.default_matmul_precision("highest"):
        (_, (want, want_aux, metrics)), (gp, gx) = jax.value_and_grad(
            jax_loss, argnums=(0, 1), has_aux=True
        )(params, jnp.asarray(x))
    port = _port_ffn_from_jax(params, base, dispatch)
    xt = torch.tensor(x, requires_grad=True)
    y = port(xt)
    (y.pow(2).sum() + port.aux_loss).backward()

    probs = torch.softmax(port.router(xt.detach().reshape(-1, 16)), -1).detach().numpy()
    assert _router_gap(probs) > GAP
    _close(y.detach(), want, name="y")
    assert float(port.aux_loss.detach()) == pytest.approx(float(want_aux), rel=1e-6)
    assert float(port.dropped_frac) == float(np.asarray(metrics["dropped_frac"][0])) > 0
    np.testing.assert_array_equal(port.expert_load.numpy(), np.asarray(metrics["expert_load"][0]))
    _close(xt.grad, gx, name="x")
    _close(port.router.weight.grad.T, gp["router"]["kernel"], name="router.kernel")
    _close(port.router.bias.grad, gp["router"]["bias"], name="router.bias")
    for k in ("w_up", "b_up", "w_down", "b_down"):
        _close(getattr(port, k).grad, gp[k], name=k)


def test_switch_ffn_dispatches_agree_in_bf16():
    """Under bf16 the port's three dispatches keep the same tokens (the
    same routing, by construction) and round at the same points.  gmm's
    plain version forms its products in fp32 and gather's batched GEMMs in
    bf16 with fp32 sums in another order, so a product that lies near a
    rounding boundary may round the other way: one bf16 ulp of an element
    (rtol 2^-7), carried by the down product (atol 2^-9 of the output's
    scale)."""
    torch.manual_seed(0)
    ffn = SwitchFFN(32, 4, 2, 0.5, dtype=torch.bfloat16, dispatch="gather")
    x = torch.randn(2, 48, 32).to(torch.bfloat16)
    out = {}
    for d in ("gather", "gmm", "onehot"):
        ffn.dispatch = d
        with torch.no_grad():
            out[d] = ffn(x).float()
    assert float(ffn.dropped_frac) > 0
    scale = float(out["gather"].abs().max())
    for d in ("gmm", "onehot"):
        torch.testing.assert_close(out[d], out["gather"], rtol=2**-7, atol=2**-9 * scale)


def test_gmm_weight_bytes_and_auto_dispatch_follow_jax():
    """The footprint and the budget are the JAX package's; ``auto`` takes
    gmm on the card exactly where the JAX rule takes it on a TPU (bf16
    ``vit_moe`` fits, fp32 does not) and gather on the CPU, as the JAX rule
    does off a TPU; an explicit dispatch is taken as given."""
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        for shape in ((8, 192, 768), (4, 64, 256), (16, 384, 1536)):
            got = vmem.gmm_weight_bytes(*shape, dt)
            assert got == jax_vmem.gmm_weight_bytes(*shape, jdt)
            assert vmem.fits_weight_budget(got) == jax_vmem.fits_weight_budget(got)
    ffn32 = SwitchFFN(192, 8, dtype=torch.float32)
    ffn16 = SwitchFFN(192, 8, dtype=torch.bfloat16)
    assert ffn16.resolved_dispatch(torch.device("cuda")) == "gmm"
    assert ffn32.resolved_dispatch(torch.device("cuda")) == "gather"
    assert ffn16.resolved_dispatch(torch.device("cpu")) == "gather"
    for d in ("gmm", "gather", "onehot"):
        explicit = SwitchFFN(192, 8, dtype=torch.float32, dispatch=d)
        assert explicit.resolved_dispatch(torch.device("cpu")) == d
        assert explicit.resolved_dispatch(torch.device("cuda")) == d
    # the capacity: the compute dtype's tile, then the padded batch's tokens
    for n, cf, e in ((128, 0.5, 4), (2048, 1.25, 8), (16384, 1.25, 8), (7, 1.0, 8)):
        for dt in (torch.bfloat16, torch.float32):
            tile = 16 if dt == torch.bfloat16 else 8
            want = max(tile, int(np.ceil(np.ceil(n * cf / e) / tile) * tile))
            assert capacity(n, e, cf, dt) == want
    assert capacity(2048, 8, 1.25, torch.bfloat16) == 320
    assert capacity(16384, 8, 1.25, torch.bfloat16) == 2560


# ----------------------------------------------------------- ViT and train

MOE_SMALL = dict(depth=2, dim=64, heads=2, image_size=32, num_experts=4)
ROUTER_SCALE = 20.0


def _decisive_router(params):
    """``params`` with every router kernel scaled by ``ROUTER_SCALE`` (std
    0.4 in place of 0.02): at the init's std a batch of hundreds of tokens
    over nearly uniform router probabilities always holds some top-2 gap
    below 1e-4, so the routing of these seeds is made decisive instead."""
    params = jax.tree_util.tree_map(np.array, params)
    params["blocks"]["moe"]["router"]["kernel"] *= ROUTER_SCALE
    return params


def _block_gaps(model, x) -> float:
    """The least top-2 router gap over every MoE block of a forward of x."""
    gaps = []

    def hook(mod, args):
        xt = args[0].reshape(-1, args[0].shape[-1]).float()
        gaps.append(_router_gap(torch.softmax(mod.router(xt), -1).detach().numpy()))

    handles = [blk.moe.register_forward_pre_hook(hook) for blk in model.blocks]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return min(gaps)


@pytest.mark.parametrize("dispatch", ["gmm", "gather"])
def test_vit_moe_logits_match_jax_through_vit_from_jax(dispatch):
    """A 2-block ``vit_moe`` (full width: dim 192, 3 heads, 8 experts of
    hidden 768) initialised by JAX (routers made decisive), carried across
    and run on the same
    images: fp32 logits within 1e-5 (magnitude ~1-2: summation order
    through two blocks and flax's one-pass LayerNorm variance)."""
    jax_model = jax_models.ViTMoE(depth=2)
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    params = jax.device_get(jax_model.init(jax.random.key(4), jnp.zeros((1, 32, 32, 3)))["params"])
    params = _decisive_router(params)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    port = port_models.get_model("vit_moe", depth=2, moe_dispatch=dispatch)
    port.load_state_dict(vit_from_jax(params))  # strict: every key matches
    xt = torch.from_numpy(x)
    assert _block_gaps(port, xt) > GAP
    with torch.no_grad():
        got = port(xt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_vit_moe_converter_checks_expert_leaves():
    jax_model = jax_models.ViT(**MOE_SMALL)
    params = jax.device_get(jax_model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])
    assert "mlp_up" not in params["blocks"]
    broken = jax.tree_util.tree_map(lambda a: a, params)
    broken["blocks"]["moe"]["w_down"] = broken["blocks"]["moe"]["w_down"][:, :, :-1]
    with pytest.raises(port_models.VitPortError, match="blocks/moe/w_down"):
        vit_from_jax(broken)
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["blocks"]["moe"]["router"]["bias"]
    with pytest.raises(port_models.VitPortError, match="blocks/moe/router/bias"):
        vit_from_jax(missing)


class HP:
    lr = 0.1
    weight_decay = 1e-4
    lr_decay_step_size = 2
    lr_decay_gamma = 0.1


@pytest.mark.parametrize("dispatch", ["gmm", "gather"])
def test_three_vit_moe_train_steps_match_jax(dispatch):
    """A depth-2 MoE ViT (dim 64, 2 heads, 4 experts) carried across with
    ``vit_from_jax`` (routers made decisive): three steps on one batch
    through JAX's
    ``make_train_step`` (its ``gather`` dispatch, as ``auto`` resolves on
    the CPU) and the port's ``TrainStep`` under ``gmm`` and ``gather``,
    fp32.  The loss (cross-entropy plus the summed aux loss), grad norm,
    top-1 count, the routing health and every parameter agree after each
    step; bounds as the dense ViT's steps (1e-5 relative, 2e-6 absolute on
    parameters), with the routing health exact."""
    mesh = make_mesh(backend="ddp")
    tx, _ = jax_configure_optimizers(HP, steps_per_epoch=1)
    state = create_train_state(jax_models.ViT(**MOE_SMALL), jax.random.key(3), tx)
    state = state.replace(params=_decisive_router(jax.device_get(state.params)))
    state = jax.device_put(state, replicated_sharding(mesh))
    step = make_train_step(mesh, augment=False)
    model = port_models.ViT(**MOE_SMALL, moe_dispatch=dispatch)
    model.load_state_dict(vit_from_jax(jax.device_get(state.params)))
    opt, schedule = configure_optimizers(HP, 1, model.parameters())
    port_step = TrainStep(model, opt, schedule, augment=False)
    images, labels = synthetic_dataset(16, seed=0)
    assert _block_gaps(model, normalize_images(torch.from_numpy(images))) > GAP
    for i in range(3):
        with jax.default_matmul_precision("highest"):
            state, m = step(state, jnp.asarray(images), jnp.asarray(labels), jax.random.key(i))
        got = port_step(torch.from_numpy(images), torch.from_numpy(labels).long())
        assert float(got["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
        assert float(got["grad_norm"]) == pytest.approx(float(m["grad_norm"]), rel=1e-5)
        assert int(got["top1_count"]) == int(m["top1_count"])
        assert float(got["moe_dropped_frac"]) == pytest.approx(float(m["moe_dropped_frac"]), abs=1e-7)
        assert float(got["moe_load_max"]) == pytest.approx(float(m["moe_load_max"]), abs=1e-7)
        want = vit_from_jax(jax.device_get(state.params))
        for name, p in model.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2e-6, rtol=0, err_msg=name)


def test_grad_accum_averages_the_routing_health():
    """Under ``--grad-accum`` the step's routing health is the mean of the
    micro-batches' (``step.py:337-341``), and its loss their mean objective."""
    torch.manual_seed(0)
    model = port_models.ViT(**MOE_SMALL)
    images, labels = synthetic_dataset(8, seed=2)
    images, labels = torch.from_numpy(images), torch.from_numpy(labels).long()
    whole = []
    for half in (slice(0, 4), slice(4, 8)):
        loss, _, extras = forward_backward(model, images[half], labels[half])
        whole.append((float(loss), {k: float(v) for k, v in extras.items()}))
    loss, _, extras = forward_backward(model, images, labels, grad_accum=2)
    assert float(loss) == pytest.approx(np.mean([w[0] for w in whole]), rel=1e-6)
    for k in ("moe_dropped_frac", "moe_load_max"):
        assert float(extras[k]) == pytest.approx(np.mean([w[1][k] for w in whole]), rel=1e-6)


# ------------------------------------------------------------ fusion gate


def test_fusion_gate_declines_moe_blocks_with_the_jax_reason(monkeypatch):
    """At 256 tokens (patch 2), inside the fused block's window, an MoE
    block is declined first, with the JAX gate's own reason, under
    ``auto`` and ``force``; ``force`` warns with it, as the JAX block does,
    and no block reaches ``fused_vit_block``."""
    reason = "MoE block (the kernel has no expert FFN form)"
    for fusion in ("auto", "force"):
        for device in ("cuda", "cpu"):
            assert vit_mod.block_fusion_path(
                fusion, device, 256, 192, 3, 4, torch.bfloat16, "auto", 8
            ) == ("composed", reason)
    assert vit_mod.block_fusion_path("force", "cpu", 256, 192, 3, 4, torch.bfloat16, "auto")[0] == "fused"
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter("always")
        jax_block = jax_models.ViTBlock(dim=64, heads=2, num_experts=2, block_fusion="force")
        jax_block.init(jax.random.key(0), jnp.zeros((1, 256, 64)))
    assert any(reason in str(w.message) for w in jax_warned)

    def no_fusion(*a, **k):
        raise AssertionError("an MoE block reached the fused block")

    monkeypatch.setattr(vit_mod, "fused_vit_block", no_fusion)
    vit_mod._FUSION_FORCE_WARNED.clear()
    model = port_models.get_model("vit_moe", depth=1, patch=2, block_fusion="force")
    with pytest.warns(UserWarning, match=r"MoE block \(the kernel has no expert FFN form\)"):
        with torch.no_grad():
            logits = model(torch.zeros(1, 32, 32, 3))
    assert logits.shape == (1, 100)


def test_switch_ffn_rejects_an_unknown_dispatch():
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        SwitchFFN(16, 2, dispatch="nope")
    ffn = SwitchFFN(16, 2)
    ffn.dispatch = "nope"
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        ffn(torch.zeros(1, 4, 16))


def test_jax_ffn_fields_cover_the_port_signature():
    """The port's ``SwitchFFN`` takes the JAX layer's fields and defaults."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxSwitchFFN)
                  if f.name in ("mlp_ratio", "capacity_factor", "aux_weight", "dispatch")}
    port_defaults = {k: v.default for k, v in inspect.signature(SwitchFFN).parameters.items()
                     if k in jax_fields}
    assert port_defaults == jax_fields
