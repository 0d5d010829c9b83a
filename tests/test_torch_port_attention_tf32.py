"""The fp32 flash-attention backward's 3xTF32 arithmetic, on the CPU.

On the card the fp32 dq (K3) and dk/dv (K4) kernels,
``flash_bwd_dq_tf32x3`` and ``flash_bwd_dkv_tf32x3`` in
``ops/csrc/flash_attention_bwd.cu``, run every fp32 product on the tensor
cores as three tf32 products: each operand x splits into
``big = tf32(x)`` and ``small = tf32(x - big)`` (round to nearest, ties
away, as ``cvt.rna.tf32.f32``), and a·b is small_a·big_b + big_a·small_b +
big_a·big_b in fp32, the small·small term dropped.  Those kernels run only
on the card (``tests/test_torch_port_gpu.py``); here a plain emulation of
that arithmetic in numpy and torch is held against the port's plain
backward ``_bwd_plain`` and against the JAX package's Pallas backward
(``_flash_bwd``, its ``_dq_kernel`` and ``_dkv_kernel`` in interpret mode,
at ``highest`` matmul precision), on seeded numpy inputs.

Tolerance: ``chip_smoke.py``'s fp32 bound for the kernels, per row (one
query's dq, one key's dk or dv) 2^-10 of the row's rms, rtol 0.  The
emulation differs from fp32 by the dropped small·small term and the
rounding of small, at most 2^-22 relative per operand, and by summation
order (~1e-6 relative), far inside it.  The card's tensor cores also
round each accumulation toward zero, which this emulation leaves out;
``chip_smoke.py`` gives the kernels' readings against the bound.  A single tf32 product per fp32
product keeps only about 2^-11 per operand; the last test shows that the
tolerance rejects such a kernel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.ops import flash_attention as jax_flash

port = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention")

ROW_SHARE = 2**-10  # of each row's rms, rtol 0: chip_smoke.py's fp32 tolerance


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` for finite x, as the kernels' ``to_tf32`` does
    it: fp32 rounded to 10 mantissa bits, to nearest with ties away from
    zero, by an integer add and mask; the low 13 bits of the result are
    zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernels' ``split_tf32``: big = tf32(x) + x·0 (exact for finite
    x, NaN for a NaN or an inf), small = tf32(x - big)."""
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        big = (tf32(x) + x * np.float32(0)).astype(np.float32)
        return big, tf32((x - big).astype(np.float32))


def mm3(a: torch.Tensor, b: torch.Tensor, *, passes: int = 3) -> torch.Tensor:
    """``a @ b`` over the last two axes with each fp32 product as three tf32
    products (``passes=1``: big·big alone, one tf32 product), fp32 sums.
    A product of two tf32 values is exact in fp32."""
    ab, as_ = (torch.from_numpy(t) for t in split(a.numpy()))
    bb, bs = (torch.from_numpy(t) for t in split(b.numpy()))
    if passes == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def bwd_3xtf32(q, k, v, do, lse, adj, *, causal, scale, passes=3):
    """``_bwd_plain``'s fp32 backward with its five products (s, dp, dq,
    dv, dk) as ``mm3``: the kernels' arithmetic."""
    sq, skv = q.shape[2], k.shape[2]
    s = mm3(q, k.transpose(-1, -2), passes=passes) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        rows = torch.arange(sq)[:, None] + (skv - sq)
        p = torch.where(rows >= torch.arange(skv)[None, :], p, 0.0)
    dp = mm3(do, v.transpose(-1, -2), passes=passes)
    ds = p * (dp + adj[..., None]) * scale
    dq = mm3(ds, k, passes=passes)
    dv = mm3(p.transpose(-1, -2).contiguous(), do, passes=passes)
    dk = mm3(ds.transpose(-1, -2).contiguous(), q, passes=passes)
    return dq, dk, dv


def row_share(got, want) -> float:
    """The least share of each row's rms under which ``got`` holds against
    ``want`` elementwise with rtol 0."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt((want**2).mean(-1, keepdims=True)).clip(1e-30)
    return float((np.abs(got - want) / rms).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_leaves_fp32_accuracy(seed):
    """big and small are tf32 values (low 13 mantissa bits zero) and
    |x - big - small| <= 2^-22 |x|, across magnitudes 2^-60 .. 2^60."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1 << 16) * np.exp2(rng.integers(-60, 60, 1 << 16))).astype(np.float32)
    big, small = split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    rest = np.abs(x.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    assert (rest <= 2.0**-22 * np.abs(x.astype(np.float64))).all()
    # one tf32 value alone is 2^-11 relative at most, and reaches it
    one = np.abs(x.astype(np.float64) - big) / np.abs(x.astype(np.float64))
    assert one.max() <= 2.0**-11 and one.max() > 2.0**-12


# (b, h, s, d, causal, with_dlse): the fp32 cases the card's kernel tests
# take, causal S 200 at D 128 with an lse cotangent and S 77 at D 64
CASES = [(1, 2, 200, 128, True, True), (2, 2, 77, 64, False, False)]


def _case(b, h, s, d, causal, with_dlse):
    rng = np.random.default_rng(s + d)
    q, k, v, do = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    dlse = rng.standard_normal((b, h, s)).astype(np.float32) if with_dlse else None
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out, lse = port.mha_reference(*t[:3], causal=causal, return_lse=True)
    adj = port._row_adjustment(out, t[3], None if dlse is None else torch.from_numpy(dlse))
    return (q, k, v, do, dlse), t, out, lse, adj


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001, 0x7FC00000])
def test_split_keeps_a_nan(bits):
    """A NaN's big is NaN, so the products it enters are NaN: the add that
    rounds would carry these payloads into the exponent or the sign, and
    the operand would become an inf or a zero and drop out of them."""
    x = np.array([bits], dtype=np.uint32).view(np.float32)
    assert np.isnan(split(x)[0][0])
    assert np.isnan(mm3(torch.from_numpy(x[None]), torch.ones(1, 1)).item())


@pytest.mark.parametrize("b,h,s,d,causal,with_dlse", CASES)
def test_3xtf32_backward_matches_plain_backward(b, h, s, d, causal, with_dlse):
    _, (q, k, v, do), _, lse, adj = _case(b, h, s, d, causal, with_dlse)
    kw = dict(causal=causal, scale=d**-0.5)
    got = bwd_3xtf32(q, k, v, do, lse, adj, **kw)
    want = port._bwd_plain(q, k, v, do, lse, adj, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert row_share(g.numpy(), w.numpy()) <= ROW_SHARE, name


@pytest.mark.parametrize("b,h,s,d,causal,with_dlse", CASES)
def test_3xtf32_backward_matches_jax_pallas_backward(b, h, s, d, causal, with_dlse):
    (qn, kn, vn, don, dlse), (q, k, v, do), _, lse, adj = _case(b, h, s, d, causal, with_dlse)

    def jax_fn(q, k, v):
        return jax_flash(q, k, v, causal=causal, return_lse=True, interpret=True)

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (qn, kn, vn)))
        cot = np.zeros_like(lse.numpy()) if dlse is None else dlse
        want = vjp((jnp.asarray(don), jnp.asarray(cot)))
    got = bwd_3xtf32(q, k, v, do, lse, adj, causal=causal, scale=d**-0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert row_share(g.numpy(), np.asarray(w)) <= ROW_SHARE, name


def test_one_tf32_product_fails_the_fp32_tolerance():
    """Against the plain fp32 backward a single tf32 product per fp32
    product (big·big alone) exceeds the tolerance in every gradient, where
    the three products hold within it: the tolerance tells a 1xTF32 kernel
    from a 3xTF32 one."""
    _, (q, k, v, do), _, lse, adj = _case(*CASES[0])
    kw = dict(causal=True, scale=128**-0.5)
    want = port._bwd_plain(q, k, v, do, lse, adj, **kw)
    three = bwd_3xtf32(q, k, v, do, lse, adj, **kw)
    one = bwd_3xtf32(q, k, v, do, lse, adj, passes=1, **kw)
    for name, g3, g1, w in zip(("dq", "dk", "dv"), three, one, want):
        assert row_share(g3.numpy(), w.numpy()) <= ROW_SHARE < row_share(g1.numpy(), w.numpy()), name
