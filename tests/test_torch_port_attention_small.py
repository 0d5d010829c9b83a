"""The port's short-sequence attention (K10, K11) against the JAX package's,
on the CPU.

The same numpy inputs (fixed seed) go through the JAX ``small_mha`` with its
Pallas kernels in interpret mode, as ``tests/test_vit_block.py`` runs it,
and through the port's ``small_mha``, whose CPU path is the plain version
(``small_mha_reference`` forward, ``small_mha_bwd_reference`` backward,
behind the autograd Function).  fp32 runs JAX at ``highest`` matmul
precision.  Tolerances, with their reasons, sit beside each comparison.

The CUDA kernels run only on the card: ``test_torch_port_gpu.py`` and
``chip_smoke.py`` hold them against the plain versions there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu import models as jax_models
from distributed_training_comparison_tpu.ops.attention_small import (
    _head_probs,
)
from distributed_training_comparison_tpu.ops.attention_small import head_bwd as jax_head_bwd
from distributed_training_comparison_tpu.ops.attention_small import head_fwd as jax_head_fwd
from distributed_training_comparison_tpu.ops.attention_small import small_mha as jax_small_mha
from distributed_training_comparison_tpu_torch import models as port_models
from distributed_training_comparison_tpu_torch.config import load_config
from distributed_training_comparison_tpu_torch.models import vit_from_jax
from distributed_training_comparison_tpu_torch.ops import small_mha
from distributed_training_comparison_tpu_torch.train import Trainer, build_model

small = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention_small")
port_attention = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention")

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# The JAX test's shapes (tests/test_vit_block.py): vit_tiny's 64 tokens, a
# 256-token item, small odd-ish dims with a ragged S of 24, and a batch with
# no power-of-two stacking factor; each causal and not
SHAPES = [(8, 64, 3, 64), (4, 256, 3, 64), (6, 24, 2, 16), (5, 64, 3, 64)]


def _row_share(got, want, rtol):
    """The least share of each row's rms under which ``got`` holds against
    ``want`` elementwise with ``rtol`` (a row: one token's D values of one
    head)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.maximum(np.sqrt((want**2).mean(-1, keepdims=True)), 1e-30)
    return float(((np.abs(got - want) - rtol * np.abs(want)) / rms).max())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _inputs(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_mha_and_its_vjp_match_jax_interpret(dtype, shape, causal):
    """The port's ``small_mha`` output and its Function's dq, dk, dv against
    JAX ``small_mha(interpret=True)`` and ``jax.vjp`` of it, on the same
    unit-normal q, k, v and output cotangent.

    fp32 at ``highest``: the same fp32 arithmetic in another summation
    order, 2e-6 on the outputs and 5e-5 on the gradients, the JAX test's
    bounds.  bf16: both sides round P, ds·scale and each result to bf16 at
    the same points; a summation-order difference can flip one rounding of a
    P or ds term (2^-8 of one term of S), and a result's own rounding then
    differs by at most one bf16 ulp (2^-7 relative).  So each row of D
    values holds within 2^-5 of the row's rms plus 2^-6 of the element:
    a dropped key tile or a missing mask breaks it by a whole term."""
    q, k, v, do = _inputs(sum(shape) + causal, shape)
    jd = JNP[dtype]
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(
            lambda q, k, v: jax_small_mha(q, k, v, causal=causal, interpret=True),
            *(jnp.asarray(x).astype(jd) for x in (q, k, v)),
        )
        grads_j = vjp(jnp.asarray(do).astype(jd))
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    before = (small.small_mha_fwd.launches, small.small_mha_bwd.launches)
    out = small_mha(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    assert (small.small_mha_fwd.launches, small.small_mha_bwd.launches) == before  # no kernel
    assert out.dtype == dtype and out.shape == shape
    pairs = [("out", out.detach(), out_j)] + [
        (f"d{n}", t.grad, g) for n, t, g in zip("qkv", (qt, kt, vt), grads_j)
    ]
    for name, got, want in pairs:
        assert got.dtype == dtype and got.shape == shape, name
        got, want = got.float().numpy(), _np(want)
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=2e-6 if name == "out" else 5e-5,
                                       rtol=0, err_msg=name)
        else:
            assert _row_share(got, want, 2**-6) <= 2**-5, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_head_fwd_and_bwd_match_jax_at_one_item_a_tile(dtype):
    """The port's per-head plain versions under ``causal`` against JAX
    ``head_fwd`` and ``head_bwd`` at ``tb = 1`` (one item a tile, so no
    block-diagonal stacking on the JAX side), item by item.  fp32 at
    ``highest``: summation order only, 1e-6 on outputs up to ~3 and 1e-5 on
    the gradients.  bf16: the rounding points agree, so the row bound of
    the test above."""
    b, s, d = 3, 24, 16
    scale = d**-0.5
    qh, kh, vh, doh = (x.reshape(b * s, d) for x in _inputs(5, (b, s, d)))
    t = [torch.from_numpy(x).to(dtype) for x in (qh, kh, vh, doh)]
    got = [small.head_fwd(*t[:3], s, scale, causal=True),
           *small.head_bwd(*t, s, scale, causal=True)]
    want = [[] for _ in got]
    for i in range(b):
        rows = [jnp.asarray(x[i * s:(i + 1) * s]).astype(JNP[dtype]) for x in (qh, kh, vh, doh)]
        with jax.default_matmul_precision("highest"):
            o, _ = jax_head_fwd(*rows[:3], 1, s, scale, True)
            pf = _head_probs(rows[0], rows[1], 1, s, scale, True)
            grads = jax_head_bwd(*rows, pf, 1, s, scale)
        for acc, w in zip(want, (o, *grads)):
            acc.append(_np(w))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        g, w = g.float().numpy(), np.concatenate(w)
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, atol=1e-6 if name == "out" else 1e-5, rtol=0,
                                       err_msg=name)
        else:
            assert _row_share(g, w, 2**-6) <= 2**-5, name
    # the first query of every item sees only its own key: out is exactly its v row
    np.testing.assert_array_equal(got[0][::s].float().numpy(), t[2][::s].float().numpy())


def test_block_items_has_no_effect_on_the_result():
    """``block_items`` is the TPU's stacking factor: per-item attention is
    the same function for every ``tb``, so the port accepts it and computes
    the same bits."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(9, (4, 64, 3, 64), 3))
    want = small_mha(q, k, v, causal=True)
    for tb in (1, 2, 4):
        assert torch.equal(small_mha(q, k, v, causal=True, block_items=tb), want)


ONE_TILE_KERNELS = ("attn_small_fwd_onetile",), ("attn_small_bwd_onetile",)
TILED_BF16_KERNELS = ("attn_small_fwd_bf16",), ("attn_small_dq_bf16", "attn_small_dkv_bf16")
F32_KERNELS = ("attn_small_fwd_f32",), ("attn_small_dq_f32", "attn_small_dkv_f32")


@pytest.mark.parametrize(
    "dtype,seq,kernels",
    [(torch.bfloat16, 64, ONE_TILE_KERNELS), (torch.bfloat16, 8, ONE_TILE_KERNELS),
     (torch.bfloat16, 40, ONE_TILE_KERNELS), (torch.bfloat16, 72, TILED_BF16_KERNELS),
     (torch.bfloat16, 256, TILED_BF16_KERNELS), (torch.float32, 64, F32_KERNELS),
     (torch.float32, 256, F32_KERNELS)],
)
def test_the_rule_on_s_picks_the_kernels_and_the_scratch(dtype, seq, kernels):
    """The wrappers' rule: bf16 items of at most 64 tokens run one kernel
    each way and allocate no statistics scratch; longer bf16 items and fp32
    run a forward kernel and a dq, dk/dv pair that passes each query row's
    (max, sum, Σ dp·P) through an fp32 scratch of (rows, heads, 3)."""
    fwd, bwd = kernels
    assert small.kernel_symbols(dtype, seq) == {"fwd": fwd, "bwd": bwd}
    want = None if len(bwd) == 1 else (5 * seq, 3, 3)
    assert small.row_stats_shape(dtype, 5 * seq, 3, seq) == want


def test_the_c_entry_points_apply_the_same_rule_on_s():
    """The C source holds the same bound on S and defines every kernel the
    rule names (the card's launches are checked by name on the card)."""
    import re
    from pathlib import Path

    src = (Path(small.__file__).parent / "csrc" / "attention_small.cu").read_text()
    assert int(re.search(r"constexpr int kOneTile = (\d+);", src).group(1)) == small.ONE_TILE
    assert "return is_bf16 && p.seq <= kOneTile;" in src
    for dtype in (torch.bfloat16, torch.float32):
        for seq in (small.ONE_TILE, small.ONE_TILE + 8):
            for names in small.kernel_symbols(dtype, seq).values():
                for name in names:
                    assert re.search(rf"__global__ void __launch_bounds__\([^)]*\) {name}\(", src), name


def test_small_mha_and_the_dispatch_raise_as_the_jax_package_does():
    q = torch.zeros(2, 64, 3, 64)
    with pytest.raises(ValueError, match="self-attention only"):
        small_mha(q, torch.zeros(2, 72, 3, 64), q)
    with pytest.raises(ValueError, match="needs S, D multiples of 8; got 60, 64"):
        small_mha(*(torch.zeros(2, 60, 3, 64),) * 3)
    with pytest.raises(ValueError, match="needs S, D multiples of 8; got 64, 20"):
        small_mha(*(torch.zeros(2, 64, 3, 20),) * 3)
    with pytest.raises(ValueError, match="does not return lse"):
        port_attention.attention(q, q, q, impl="fused_small", layout="bshd", return_lse=True)
    with pytest.raises(ValueError, match="requires layout='bshd'"):
        port_attention.attention(q, q, q, impl="fused_small", layout="bhsd")
    # auto never selects it (as in the JAX package): at 64 tokens it is the reference
    assert port_attention.auto_impl("cuda", 64, 64, 64, False) == "reference"
    got = port_attention.attention(q + 1, q, q, impl="fused_small", layout="bshd")
    assert torch.equal(got, small_mha(q + 1, q, q))


def _ce(logits, labels):
    return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(len(labels)), labels])


def test_vit_tiny_pinned_to_fused_small_matches_jax(monkeypatch):
    """A reduced ``vit_tiny`` (depth 2 of 12; dim 192, 3 heads of 64, 64
    tokens at 32 px: the full width) pinned to ``attn_impl="fused_small"``,
    its weights carried across from a JAX ViT by ``vit_from_jax`` unchanged
    (``fused_small`` uses the same parameters): the logits, and one step's
    cross-entropy and every parameter gradient.

    The JAX side runs ``attn_impl="reference"``: the JAX model's pinned
    path cannot run off a TPU, because the dispatch needs ``interpret=True``
    and the model does not pass it.  The op-level test above holds the
    interpret-mode kernel itself.  Both compute the same function in fp32:
    at ``highest``, 2e-5 absolute on logits up to ~1.5 and the loss to
    1e-5 relative; gradients within 2e-5 of each leaf's largest value."""
    kw = dict(depth=2, dim=192, heads=3, patch=4, image_size=32)
    model = jax_models.ViT(attn_impl="reference", **kw)
    x = _inputs(21, (4, 32, 32, 3), 1)[0]
    labels = np.array([3, 17, 0, 99])
    params = jax.device_get(model.init(jax.random.key(7), jnp.zeros((1, 32, 32, 3)))["params"])
    with jax.default_matmul_precision("highest"):
        logits_j = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
        loss_j, grads_j = jax.value_and_grad(
            lambda p: _ce(model.apply({"params": p}, jnp.asarray(x)), jnp.asarray(labels))
        )(params)
    port = port_models.ViT(attn_impl="fused_small", **kw)
    port.load_state_dict(vit_from_jax(params))  # strict: every key matches
    calls = []
    real = small._SmallMHA.apply

    def counted(*args):
        calls.append(args[3:6])  # (seq, heads, causal)
        return real(*args)

    monkeypatch.setattr(small._SmallMHA, "apply", counted)
    with torch.no_grad():
        logits = port(torch.from_numpy(x)).numpy()
    loss = torch.nn.functional.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(labels))
    loss.backward()
    assert calls == [(64, 3, False)] * 4  # every block, both passes, through fused_small
    np.testing.assert_allclose(logits, logits_j, atol=2e-5, rtol=0)
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    want = vit_from_jax(jax.device_get(grads_j))
    for name, p in port.named_parameters():
        # the k bias's true gradient is 0 (softmax is shift invariant), so
        # both sides hold rounding noise there: held against k's weight's scale
        scale = want[name.replace("k_proj.bias", "k_proj.weight")].numpy()
        err = np.abs(p.grad.numpy() - want[name].numpy()).max() / np.abs(scale).max()
        assert err <= 2e-5, (name, err)


def test_trainer_takes_the_given_model_on_the_cpu(monkeypatch, tmp_path):
    """``Trainer(hparams, model=...)`` (the JAX keyword) trains the model it
    is given: a ``vit_tiny`` pinned to ``fused_small``, whose every block's
    forward and backward go through the short-sequence attention's plain
    versions on the CPU (counted by wrapping them)."""
    hp = load_config(["--device", "cpu", "--model", "vit_tiny", "--synthetic-data",
                      "--limit-examples", "40", "--batch-size", "8", "--epoch", "1",
                      "--ckpt-path", str(tmp_path)])
    model = build_model(hp, attn_impl="fused_small")
    counts = {"fwd": 0, "bwd": 0}
    for kind in counts:
        real = getattr(small, f"small_mha_{kind}")

        def counted(*args, _real=real, _kind=kind, **kw):
            counts[_kind] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(small, f"small_mha_{kind}", counted)
    trainer = Trainer(hp, model=model)
    assert trainer.model is model
    record = trainer.fit()["epochs"][0]
    depth, steps = len(model.blocks), record["steps"]
    assert record["skipped"] == 0 and record["nonfinite_losses"] == 0
    assert np.isfinite(record["train_loss"]) and np.isfinite(record["val_loss"])
    val_batches = -(-len(trainer.val_split) // hp.batch_size)
    assert counts == {"fwd": depth * (steps + val_batches), "bwd": depth * steps}
    # without a model the Trainer builds the configured one, unpinned
    assert all(b.attn_impl == "auto" for b in Trainer(hp).model.blocks)
