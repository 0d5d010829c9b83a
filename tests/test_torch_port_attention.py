"""The port's attention against the JAX package's, on the CPU.

The same numpy inputs (fixed seed) go through the JAX package's
``mha_reference`` and its Pallas ``flash_attention`` in interpret mode
(as ``tests/test_ops.py`` runs it), and through the port's
``mha_reference`` and ``flash_attention`` (whose CPU path is the plain
version).  fp32 comparisons run the JAX side at ``highest`` matmul
precision; the tolerance is 1e-5, summation order only.

The CUDA kernel itself runs only on the card: ``test_torch_port_gpu.py``
holds it against the plain version there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.ops import attention as jax_attention
from distributed_training_comparison_tpu.ops import flash_attention as jax_flash
from distributed_training_comparison_tpu.ops import mha_reference as jax_mha

port = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention")

FP32_TOL = 1e-5  # same fp32 arithmetic, different summation order


def _qkv(seed, b, h, sq, skv, d, layout="bhsd"):
    rng = np.random.default_rng(seed)

    def one(s):
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        return rng.standard_normal(shape).astype(np.float32)

    return one(sq), one(skv), one(skv)


def _jax(fn, *arrays, **kw):
    with jax.default_matmul_precision("highest"):
        out = fn(*(jnp.asarray(a) for a in arrays), **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def _port(fn, *arrays, **kw):
    out = fn(*(torch.from_numpy(a) for a in arrays), **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


# (b, h, sq, skv, d, causal): ragged lengths (40, 130), cross-attention,
# causal and not, head dims 16 and 32, bh <= 4; lengths that straddle the
# CUDA kernel's 128-row tiles (129 non-causal, 200 causal) at head dim 64
CASES = [
    (1, 2, 40, 40, 16, False),
    (1, 2, 40, 40, 16, True),
    (2, 2, 130, 130, 32, True),
    (2, 1, 64, 130, 32, False),
    (1, 2, 129, 129, 64, False),
    (1, 1, 200, 200, 64, True),
]


@pytest.mark.parametrize("b,h,sq,skv,d,causal", CASES)
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_reference_matches_jax_reference(b, h, sq, skv, d, causal, layout):
    q, k, v = _qkv(sq + skv + d + causal, b, h, sq, skv, d, layout)
    kw = dict(causal=causal, return_lse=True, layout=layout)
    out_j, lse_j = _jax(jax_mha, q, k, v, **kw)
    out_p, lse_p = _port(port.mha_reference, q, k, v, **kw)
    assert out_p.shape == out_j.shape and lse_p.shape == (b, h, sq)
    np.testing.assert_allclose(out_p, out_j, atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(lse_p, lse_j, atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("b,h,sq,skv,d,causal", [c for c in CASES if c[2] == c[3] or not c[5]])
def test_flash_cpu_path_matches_jax_pallas_kernel(b, h, sq, skv, d, causal):
    """The port's flash_attention on CPU tensors against the JAX package's
    Pallas kernels run through the interpreter (its padding, masking and
    online softmax), with lse."""
    q, k, v = _qkv(3 * sq + d + causal, b, h, sq, skv, d)
    out_j, lse_j = _jax(jax_flash, q, k, v, causal=causal, return_lse=True, interpret=True)
    before = port.flash_attention.launches
    out_p, lse_p = _port(port.flash_attention, q, k, v, causal=causal, return_lse=True)
    assert port.flash_attention.launches == before  # the CPU never launches
    np.testing.assert_allclose(out_p, out_j, atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(lse_p, lse_j, atol=FP32_TOL, rtol=0)


def test_dispatcher_bshd_matches_jax_dispatcher():
    q, k, v = _qkv(11, 2, 2, 130, 130, 32, layout="bshd")
    for impl in ("auto", "reference", "kernel", "pallas"):
        out_p = _port(port.attention, q, k, v, causal=True, impl=impl, layout="bshd")
        out_j = _jax(jax_attention, q, k, v, causal=True, impl="reference", layout="bshd")
        np.testing.assert_allclose(out_p, out_j, atol=FP32_TOL, rtol=0)


def test_bf16_reference_matches_jax_bf16():
    """bf16 inputs: both compute fp32 scores from the bf16 values and round
    P and the output to bf16; the bound is 2 bf16 ulps at |out| <= 2
    (2 x 2^-7), the rounding points differing between XLA and torch."""
    q, k, v = _qkv(5, 1, 2, 130, 130, 32)
    to_bf16 = lambda a: a.astype(jnp.bfloat16)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        out_j = jax_mha(*(to_bf16(jnp.asarray(a)) for a in (q, k, v)), causal=True)
    out_j = np.asarray(out_j.astype(jnp.float32))
    out_p = port.mha_reference(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=True
    )
    assert out_p.dtype == torch.bfloat16
    np.testing.assert_allclose(out_p.float().numpy(), out_j, atol=2 * 2**-7, rtol=0)


def _bshd_view(b, s, h, d):
    """A (B, H, S, D) view of a (B, S, H·D) projection, as the ViT hands it over."""
    return torch.empty(b, s, h * d, dtype=torch.bfloat16).view(b, s, h, d).transpose(1, 2)


def _tma_ready(x: torch.Tensor) -> bool:
    """What the bf16 forward's TMA maps (and the kernels' vector copies)
    take: unit stride over D, the B, H and S strides whole 16-byte rows
    where the dimension is stepped (size above 1), a 16-byte aligned base."""
    item = x.element_size()
    return (
        x.stride(-1) == 1
        and all(s * item % 16 == 0 for n, s in zip(x.shape[:3], x.stride()[:3]) if n > 1)
        and x.data_ptr() % 16 == 0
    )


@pytest.mark.parametrize(
    "make",
    [
        # vit_long's bucket 8: (8, 4096, 4 heads of 128) read in place
        lambda: _bshd_view(8, 4096, 4, 128),
        # head dim 64 at chip_smoke.py's ragged causal length
        lambda: _bshd_view(2, 1030, 4, 64),
        # contiguous (B, H, S, D)
        lambda: torch.empty(2, 4, 1000, 128, dtype=torch.bfloat16),
        # the K2 case: one batch, two heads of 16384 keys
        lambda: torch.empty(1, 2, 16384, 128, dtype=torch.bfloat16),
        # a size-1 batch dimension whose stride (3 elements) is no whole row:
        # never stepped, so the kernel's TMA map gives it a row's stride
        lambda: torch.empty(2, 100, 64, dtype=torch.bfloat16).as_strided(
            (1, 2, 100, 64), (3, 6400, 64, 1)),
    ],
)
def test_kernel_operand_reads_aligned_views_in_place(make):
    """The views the ViT and the K2 case hand over reach the kernels as
    they are, strides and storage kept."""
    x = make()
    y = port._kernel_operand(x)
    assert y is x and _tma_ready(x)


def test_kernel_operand_copies_what_tma_refuses():
    """A row stride of 68 bf16 (136 bytes, not a multiple of 16), D not
    unit-stride, and a base 2 bytes past 16-byte alignment: each is copied
    into a contiguous tensor with the same values."""
    padded = torch.randn(1, 2, 10, 68).to(torch.bfloat16)[..., :64]
    strided_d = torch.randn(1, 2, 64, 64).to(torch.bfloat16).transpose(2, 3)
    unaligned = torch.randn(1 + 2 * 10 * 64).to(torch.bfloat16)[1:].view(1, 2, 10, 64)
    for x in (padded, strided_d, unaligned):
        assert not _tma_ready(x)
        y = port._kernel_operand(x)
        assert y.is_contiguous() and _tma_ready(y) and torch.equal(y, x)


@pytest.mark.parametrize(
    "device,q_len,kv_len,head_dim,causal,want",
    [
        ("cuda", 4096, 4096, 128, False, "kernel"),  # vit_long's blocks
        ("cuda", 512, 512, 128, True, "kernel"),
        ("cuda", 511, 511, 128, False, "reference"),  # under the D>=128 minimum
        ("cuda", 1024, 1024, 64, False, "kernel"),
        ("cuda", 1023, 1023, 64, False, "reference"),  # under the D<128 minimum
        ("cuda", 64, 64, 64, False, "reference"),  # vit_tiny's 64 tokens
        ("cuda", 2048, 4096, 128, True, "reference"),  # offset-causal
        ("cuda", 2048, 4096, 128, False, "kernel"),  # cross-attention
        ("cuda", 4096, 4096, 32, False, "kernel"),  # the kernel raises on it
        ("cpu", 4096, 4096, 128, False, "reference"),
    ],
)
def test_auto_dispatch_choice(device, q_len, kv_len, head_dim, causal, want):
    assert port.auto_impl(device, q_len, kv_len, head_dim, causal) == want


def test_unported_impls_and_bad_arguments_raise():
    q = torch.zeros(1, 1, 8, 16)
    for impl in ("ring", "ulysses:model"):
        with pytest.raises(NotImplementedError):
            port.attention(q, q, q, impl=impl)
    with pytest.raises(ValueError, match="unknown attention impl"):
        port.attention(q, q, q, impl="nope")
    with pytest.raises(ValueError, match="layout"):
        port.attention(q, q, q, layout="hbsd")
    with pytest.raises(ValueError, match="q_len == kv_len"):
        port.flash_attention(q, torch.zeros(1, 1, 9, 16), torch.zeros(1, 1, 9, 16), causal=True)


def test_kernel_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    """An edited kernel source maps to a new library path, so a stale build
    is never loaded; the path lives under the gitignored build directory."""
    build = importlib.import_module("distributed_training_comparison_tpu_torch.ops._build")
    src = build.CSRC / "flash_attention_fwd.cu"
    first = build.library_path("flash_attention_fwd")
    assert first.parent == build.BUILD_DIR and first.name.startswith("libflash_attention_fwd-")
    assert build.library_path("flash_attention_fwd") == first
    (tmp_path / src.name).write_text(src.read_text() + "\n// edited\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path("flash_attention_fwd") != first
