"""The port's fused ViT block (K5) against the JAX package's, on the CPU.

Inputs and parameters are made from a seed with numpy and handed to both.
The JAX side runs its Pallas block kernel in interpret mode, as
``tests/test_vit_block.py`` does, and its composed flax block; the port
runs its plain versions (``fused_vit_block`` takes them for a CPU tensor).
fp32 runs at JAX's ``highest`` matmul precision.  Tolerances, with their
reasons, sit beside each comparison.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu import models as jax_models
from distributed_training_comparison_tpu.models.vit import ViTBlock as JaxViTBlock
from distributed_training_comparison_tpu.ops import vmem as jax_vmem
from distributed_training_comparison_tpu.ops.attention_small import head_fwd as jax_head_fwd
from distributed_training_comparison_tpu.ops.vit_block import fused_vit_block as jax_fused_vit_block
from distributed_training_comparison_tpu_torch import models as port_models
from distributed_training_comparison_tpu_torch.models import vit_from_jax
from distributed_training_comparison_tpu_torch.models.vit import block_fusion_path
from distributed_training_comparison_tpu_torch.ops import vmem
from distributed_training_comparison_tpu_torch.ops.attention_small import (
    head_fwd,
    packed_attention_reference,
)

vb = importlib.import_module("distributed_training_comparison_tpu_torch.ops.vit_block")
vit_mod = importlib.import_module("distributed_training_comparison_tpu_torch.models.vit")

B, S, DIM, HEADS = 4, 256, 64, 2
DENSE = ("q_proj", "k_proj", "v_proj", "proj", "mlp_up", "mlp_down")
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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


def _as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("norm_f32", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_matches_jax_fused_and_composed(dtype, norm_f32):
    """The port's fused block on the CPU against the JAX fused block kernel
    (interpret mode) and the JAX composed block on the same numpy inputs,
    with ``norm_f32`` True and False (``norm_dtype=None``).

    fp32: the same arithmetic in another summation order, outputs up to
    ~5, where an fp32 ulp is 4.8e-7: 5e-6 absolute, about ten ulps.  bf16:
    both sides round at the same points (LayerNorm output, each GEMM, bias
    add, P, gelu, residual), but XLA on the CPU may keep an intermediate in
    fp32 where torch rounds it (its excess-precision default), and a
    one-ulp flip (2^-8) of one intermediate moves the output by 2^-8 of one
    term of a sum; each output's own rounding differs by at most one ulp.
    So per row |Δ| <= 2^-5 rms(row) + 2^-6 |out| (four bf16 ulps of the
    row's scale), the bound chip_smoke.py holds the kernels to; measured
    0.015-0.023 of the rms."""
    jp = _jax_block_params()
    x = _x()
    xj = jnp.asarray(x).astype(JNP[dtype])
    with jax.default_matmul_precision("highest"):
        fused_jax = jax_fused_vit_block(xj, jp, heads=HEADS, norm_f32=norm_f32, interpret=True)
        block = JaxViTBlock(
            dim=DIM, heads=HEADS, dtype=JNP[dtype],
            norm_dtype=jnp.float32 if norm_f32 else None, block_fusion="off",
        )
        composed_jax, _ = block.apply({"params": jp}, xj, None)
    got = vb.fused_vit_block(
        torch.from_numpy(x).to(dtype), _port_params(jp), heads=HEADS, norm_f32=norm_f32
    )
    assert got.dtype == dtype and got.shape == (B, S, DIM)
    got = got.float().numpy()
    for want in (_as_np(fused_jax), _as_np(composed_jax)):
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
        else:
            assert _row_share(got, want, 2**-6) <= 2**-5


def test_vit_patch2_force_matches_jax_through_vit_from_jax():
    """A ``block_fusion="force"`` JAX ViT at patch 2 (32 px, 256 tokens),
    carried across by ``vit_from_jax`` unchanged (the fused block has the
    composed block's parameter tree): the port's ``force`` model runs every
    block through the fused plain version and its logits match the JAX
    model's, whose blocks run the Pallas kernel in interpret mode.  fp32
    at ``highest``; logits up to ~1.3, where an fp32 ulp is 1.2e-7: 2e-6
    absolute covers summation order through two blocks."""
    kw = dict(depth=2, dim=64, heads=2, patch=2, image_size=32)
    model = jax_models.ViT(block_fusion="force", **kw)
    x = _x(2, (4, 32, 32, 3))
    params = jax.device_get(model.init(jax.random.key(5), jnp.zeros((1, 32, 32, 3)))["params"])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    port = port_models.ViT(block_fusion="force", **kw)
    port.load_state_dict(vit_from_jax(params))  # strict: every key matches
    before = vb.fused_vit_block.launches
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert vb.fused_vit_block.launches == before  # the CPU runs no kernel
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


# (B, S, dim, heads) of the attention stage: the first case, then the shapes
# the card's bf16 kernels take (head dim 64): the vit_tiny p2 paths (S 256,
# 3 heads), a ragged S (136, 2 heads) and the gate's window top (S 512)
ATTENTION_SHAPES = [
    pytest.param(B, S, DIM, HEADS, id="s256-hd32"),
    pytest.param(2, 256, 192, 3, id="s256-hd64"),
    pytest.param(2, 136, 128, 2, id="s136-hd64"),
    pytest.param(2, 512, 192, 3, id="s512-hd64"),
]


@pytest.mark.parametrize("b,s,dim,heads", ATTENTION_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_stage_matches_jax_head_fwd(dtype, b, s, dim, heads):
    """The port's attention stage against JAX ``head_fwd`` (the stacked
    block-diagonal form, all ``b`` items in one tile) per head, and the
    packed multi-head form against the heads side by side, at each shape the
    card's kernels take, so that kernel, plain version and JAX hold as a
    chain.  fp32 at ``highest``: 1e-6 on outputs up to ~0.7 (summation
    order).  bf16: P and the output each round to bf16 on both sides; a
    one-ulp flip of P moves an output by 2^-8 of one term of S, and the
    output's own rounding differs by at most one ulp: 2^-5 of the row's rms
    plus 2^-6 |out|."""
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((b * s, 3 * dim)).astype(np.float32)
    d = dim // heads
    scale = d**-0.5
    qkv_t = torch.from_numpy(qkv).to(dtype)
    qkv_j = jnp.asarray(qkv).astype(JNP[dtype])
    packed = packed_attention_reference(qkv_t, seq=s, heads=heads)
    assert packed.dtype == dtype and packed.shape == (b * s, dim)
    for h in range(heads):
        cols = [slice(j * dim + h * d, j * dim + (h + 1) * d) for j in range(3)]
        with jax.default_matmul_precision("highest"):
            want, _ = jax_head_fwd(*(qkv_j[:, c] for c in cols), b, s, scale, False)
        want = _as_np(want)
        got = head_fwd(*(qkv_t[:, c] for c in cols), s, scale).float().numpy()
        np.testing.assert_array_equal(packed[:, h * d:(h + 1) * d].float().numpy(), got)
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        else:
            assert _row_share(got, want, 2**-6) <= 2**-5


def test_block_wrappers_take_the_plain_versions_on_cpu():
    """On a CPU tensor the kernel wrappers run their plain versions and
    count no launch."""
    params = _port_params(_jax_block_params())
    x = torch.from_numpy(_x())
    counters = (vb.fused_vit_block, vb.block_gemm, vb.block_attention)
    before = [c.launches for c in counters]
    got = vb.fused_vit_block(x, params, heads=HEADS)
    torch.testing.assert_close(got, vb.fused_vit_block_reference(x, params, heads=HEADS),
                               rtol=0, atol=0)
    qkv = torch.from_numpy(_x(4, (B * S, 3 * DIM)))
    torch.testing.assert_close(
        vb.block_attention(qkv, seq=S, heads=HEADS),
        packed_attention_reference(qkv, seq=S, heads=HEADS), rtol=0, atol=0,
    )
    assert [c.launches for c in counters] == before


def test_fused_block_rejects_what_the_jax_block_rejects():
    params = _port_params(_jax_block_params())
    with pytest.raises(ValueError, match="multiples of 8"):
        vb.fused_vit_block(torch.zeros(1, 252, DIM), params, heads=HEADS)
    with pytest.raises(ValueError, match="not divisible"):
        vb.fused_vit_block(torch.zeros(1, 256, DIM), params, heads=3)


@pytest.mark.parametrize(
    "dim,mlp_ratio,dtype",
    [(192, 4, torch.bfloat16), (192, 4, torch.float32), (384, 4, torch.bfloat16),
     (512, 4, torch.bfloat16), (64, 2, torch.float32)],
)
def test_weight_bytes_equal_the_jax_gate(dim, mlp_ratio, dtype):
    nbytes = vmem.fused_block_weight_bytes(dim, mlp_ratio, dtype)
    assert nbytes == jax_vmem.fused_block_weight_bytes(dim, mlp_ratio, JNP[dtype])
    assert vmem.fits_weight_budget(nbytes) == jax_vmem.fits_weight_budget(nbytes)
    assert vmem.WEIGHT_BUDGET_BYTES == jax_vmem.WEIGHT_BUDGET_BYTES


def _path(block_fusion="auto", device="cuda", seq=256, dim=192, heads=3, mlp_ratio=4,
          dtype=torch.bfloat16, attn_impl="auto", grad=False):
    """The gate's answer, asked with autograd recording (``grad``) or not:
    like the JAX gate it reads no autograd state, so a block that trains
    takes the path it takes when it serves."""
    with torch.set_grad_enabled(grad):
        return block_fusion_path(block_fusion, device, seq, dim, heads, mlp_ratio, dtype,
                                 attn_impl)


@pytest.mark.parametrize(
    "kw,want,reason",
    [
        ({}, "fused", None),  # vit_tiny p2 served on the card
        (dict(dtype=torch.float32), "fused", None),
        (dict(seq=128), "fused", None),
        (dict(seq=512), "fused", None),
        (dict(seq=64), "composed", "outside the measured 128-512 window"),
        (dict(seq=1024), "composed", "outside the measured 128-512 window"),
        (dict(seq=260), "composed", "multiples of 8"),
        (dict(attn_impl="reference"), "composed", "pins attention"),
        (dict(dim=384, heads=6), "composed", "weight footprint 10.2 MiB"),  # vit_small
        (dict(device="cpu"), "composed", None),
        (dict(block_fusion="force", device="cpu"), "fused", None),
        (dict(block_fusion="force", device="cpu", grad=True), "fused", None),
        (dict(block_fusion="force", seq=64), "composed", "outside the measured"),
        (dict(grad=True), "fused", None),  # auto under autograd on the card: K5 + K6
        (dict(block_fusion="off"), "composed", None),
    ],
)
def test_gate_regimes(kw, want, reason):
    path, declined = _path(**kw)
    assert path == want
    assert (declined is None) if reason is None else (reason in declined), declined


def test_gate_ignores_autograd_as_the_jax_gate_does():
    """Under autograd the gate answers as it does without it, on the card
    (``auto`` and ``force`` fuse) and on the CPU (``auto`` composes,
    ``force`` fuses); a ``force`` block whose parameters require grad
    records the fused block's autograd Function on the CPU."""
    for kw in (dict(), dict(block_fusion="force"), dict(device="cpu"),
               dict(device="cpu", block_fusion="force")):
        assert _path(grad=True, **kw) == _path(grad=False, **kw), kw
    block = port_models.ViTBlock(DIM, HEADS, block_fusion="force")
    out = block(torch.zeros(1, 128, DIM))
    assert type(out.grad_fn).__name__ == "_FusedViTBlockBackward"
    with pytest.raises(ValueError, match="unknown block_fusion"):
        _path(block_fusion="always")


def test_gate_matches_the_jax_gate_at_model_level():
    """Where the JAX ``force`` block declines (S 64) the port's composes
    too, with one warning per reason; where it fuses (S 256) the port's
    ``force`` block runs ``fused_vit_block``."""
    vit_mod._FUSION_FORCE_WARNED.clear()
    block = port_models.ViTBlock(DIM, HEADS, block_fusion="force")
    with torch.no_grad(), warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        block(torch.zeros(1, 64, DIM))
        block(torch.zeros(2, 64, DIM))
    assert len(seen) == 1 and "128-512 window" in str(seen[0].message)
    jax_block = JaxViTBlock(dim=DIM, heads=HEADS, block_fusion="force")
    jax_vars = jax_block.init(jax.random.key(0), jnp.zeros((1, 64, DIM)))
    assert "q_proj" in jax_vars["params"]  # composed there too: same leaves either way


# The bf16 GEMM kernels' tile widths on the card (``csrc/block_gemm.cuh``),
# pure Python: block_gemm and block_gemm_dgrad hold a bf16 slab of all of K
# by a slab width of output columns, at most SLAB_BYTES; block_gemm_wgrad
# takes tiles of 64, 128 or 192 input columns.
@pytest.mark.parametrize(
    "k,n,want",
    [
        (192, 576, 64),  # vit_tiny's qkv: nine slabs of 64
        (192, 768, 64),  # its up, and dy·W_dn
        (768, 192, 64),  # its down and dup·W_up: a 768-deep slab of 64 is the largest, 96 KB
        (576, 192, 64),  # dqkv·W_qkv
        (128, 144, 16),  # three segments of 48 rows: 16 pads least (64 would pad to 192)
        (1024, 512, 32),  # a 1024-deep slab of 64 is 128 KB
        (3072, 1024, 16),  # dim 1024's dqkv·W_qkv
        (4096, 1024, 8),  # dim 1024's down: only the narrowest slab fits
    ],
)
def test_slab_width_fits_and_pads_least(k, n, want):
    got = vb.slab_width(k, n)
    assert got == want
    kpad = -(-k // 64) * 64
    assert kpad * got * 2 <= vb.SLAB_BYTES
    fitting = [w for w in vb.SLAB_WIDTHS if kpad * w * 2 <= vb.SLAB_BYTES]
    assert -(-n // got) * got == min(-(-n // w) * w for w in fitting)


def test_every_gemm_the_wrappers_take_has_a_slab():
    """K and N multiples of 16, dim up to 1024 (MLP ratio 4): K and N up to
    4096.  Each has a slab width that fits."""
    widths = set()
    for k in range(16, 4097, 16):
        for n in (16, 48, 192, 576, 1024, 3072, 4096):
            w = vb.slab_width(k, n)
            assert -(-k // 64) * 64 * w * 2 <= vb.SLAB_BYTES, (k, n, w)
            widths.add(w)
    assert widths == set(vb.SLAB_WIDTHS)


@pytest.mark.parametrize(
    "n_in,want", [(192, 192), (768, 192), (576, 192), (128, 128), (512, 128), (48, 64), (80, 128)]
)
def test_wgrad_width_pads_least(n_in, want):
    assert vb.wgrad_width(n_in) == want


def test_wgrad_partials_are_whole_64_row_steps():
    """The weight-gradient kernel walks a chunk in 64-row steps, so the chunk
    is a multiple of 64; the plain version's partials are one a chunk, the
    last ragged."""
    assert vb.WGRAD_CHUNK_ROWS % 64 == 0
    m = 2 * vb.WGRAD_CHUNK_ROWS + 52
    g, a = torch.randn(m, 32), torch.randn(m, 48)
    part_w, part_b = vb.block_gemm_wgrad(g, a, g)
    assert part_w.shape == (3, 32, 48) and part_b.shape == (3, 32)
    torch.testing.assert_close(part_w.sum(0), g.T @ a, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(part_b.sum(0), g.sum(0), rtol=1e-5, atol=1e-4)
