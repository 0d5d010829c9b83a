"""The fp32 flash-attention forward's 3xTF32 arithmetic, on the CPU.

On the card the fp32 forward (K1/K2), ``flash_fwd_tf32x3`` in
``ops/csrc/flash_attention_fwd.cu`` on ``ops/csrc/tf32x3.cuh``, runs every
fp32 product on the tensor cores as three tf32 products: each operand x
splits into ``big = tf32(x)`` and ``small = tf32(x - big)`` (round to
nearest, ties away, as ``cvt.rna.tf32.f32``), and a·b is small_a·big_b +
big_a·small_b + big_a·big_b in fp32, the small·small term dropped.  A
block walks the keys in 64-key tiles with an online softmax (exp2 with
scale·log2e folded into one multiply-add), and each tile's P·V goes to a
fresh fp32 sum that is added to the rescaled output.  That kernel runs
only on the card (``tests/test_torch_port_gpu.py``); here a numpy and
torch emulation of its arithmetic is held against the port's plain
forward ``mha_reference`` and against the JAX package's Pallas forward
(``flash_attention``, its ``_fwd_kernel`` in interpret mode, at
``highest`` matmul precision), on seeded numpy inputs.

Tolerance: ``chip_smoke.py``'s fp32 bound for the forward, per row (one
query's D outputs) 2^-10 of the row's rms, rtol 0, and lse within 1e-4.
The emulation differs from fp32 by the dropped small·small term and the
rounding of small, at most 2^-22 relative per operand, and by summation
order, far inside it.  The card's tensor cores also round each
accumulation toward zero, which this emulation leaves out; the per-tile
sums keep that from growing with S, and ``chip_smoke.py`` gives the
kernel's readings against the bound.  A single tf32 product per fp32
product keeps only about 2^-11 per operand; a test shows that the
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
LSE_TOL = 1e-4
KEYS = 64  # keys per streamed tile (flash_attention_fwd.cu, kTf32Keys)
NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` for finite x, as the kernels' ``to_tf32`` does
    it: fp32 rounded to 10 mantissa bits, to nearest with ties away from
    zero, by an integer add and mask."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernels' ``split_tf32``: big = tf32(x) + x·0 (exact for finite
    x, NaN for a NaN or an inf), small = tf32(x - big)."""
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        big = (tf32(x) + x * np.float32(0)).astype(np.float32)
        return big, tf32((x - big).astype(np.float32))


def mm3(a: np.ndarray, b: np.ndarray, *, passes: int = 3) -> np.ndarray:
    """``a @ b`` over the last two axes with each fp32 product as three tf32
    products (``passes=1``: big·big alone), fp32 sums.  A product of two
    tf32 values is exact in fp32."""
    ab, as_ = (torch.from_numpy(t) for t in split(a))
    bb, bs = (torch.from_numpy(t) for t in split(b))
    if passes == 1:
        return (ab @ bb).numpy()
    return (as_ @ bb + ab @ bs + ab @ bb).numpy()


def fwd_3xtf32(q, k, v, *, causal, scale, passes=3):
    """The kernel's forward over (B, H, S, D) fp32 numpy arrays: 64-key
    tiles, S = Q·K_jᵀ as ``mm3``, the masks, the running max ``m`` (in
    units of scale·log2e) and row sum ``l``, P = exp2(S·scale·log2e - m),
    O rescaled by exp2(m_old - m) and each tile's P·V_j (``mm3``) added in
    fp32; out = O · (1 / max(l, 1e-30)), lse = (m + log2 l)·ln 2.  A causal
    block skips the tiles wholly above its rows, whose P would be 0 and
    whose rescale 1: here every tile runs, with the same result."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    sl2 = np.float32(scale) * LOG2E
    rows = np.arange(sq)[:, None]
    o = np.zeros((b, h, sq, d), np.float32)
    m = np.full((b, h, sq, 1), NEG_INF, np.float32)
    l = np.zeros((b, h, sq, 1), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for n0 in range(0, skv, KEYS):
            cols = np.arange(n0, min(n0 + KEYS, skv))[None, :]
            s = mm3(q, k[:, :, cols[0]].swapaxes(-1, -2), passes=passes)
            if causal:
                s = np.where(cols <= rows, s, NEG_INF).astype(np.float32)
            m_new = np.maximum(m, s.max(-1, keepdims=True) * sl2)
            alpha = np.exp2(m - m_new)
            p = np.exp2((s * sl2 - m_new).astype(np.float32)).astype(np.float32)
            l = (l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)).astype(np.float32)
            o = (o * alpha + mm3(p, v[:, :, cols[0]], passes=passes)).astype(np.float32)
            m = m_new
        l = np.maximum(l, np.float32(1e-30))
        out = o * (np.float32(1) / l)
        lse = ((m + np.log2(l)) * LN2)[..., 0]
    return out.astype(np.float32), lse.astype(np.float32)


def row_share(got, want) -> float:
    """The least share of each row's rms under which ``got`` holds against
    ``want`` elementwise with rtol 0."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt((want**2).mean(-1, keepdims=True)).clip(1e-30)
    return float((np.abs(got - want) / rms).max())


# (b, h, s, d, causal): causal S 200 at D 64 (a 128-row block and a 64-key
# tile both end inside it) and S 77 at D 128 (one key past a tile)
CASES = [(1, 2, 200, 64, True), (2, 2, 77, 128, False)]


def _case(b, h, s, d, causal):
    rng = np.random.default_rng(3 * s + d)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("b,h,s,d,causal", CASES)
def test_3xtf32_forward_matches_plain_forward(b, h, s, d, causal):
    q, k, v = _case(b, h, s, d, causal)
    got, got_lse = fwd_3xtf32(q, k, v, causal=causal, scale=d**-0.5)
    want, want_lse = port.mha_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal, return_lse=True
    )
    assert row_share(got, want.numpy()) <= ROW_SHARE
    assert np.abs(got_lse - want_lse.numpy()).max() <= LSE_TOL


@pytest.mark.parametrize("b,h,s,d,causal", CASES)
def test_3xtf32_forward_matches_jax_pallas_forward(b, h, s, d, causal):
    q, k, v = _case(b, h, s, d, causal)
    with jax.default_matmul_precision("highest"):
        want, want_lse = jax_flash(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal, return_lse=True, interpret=True
        )
    got, got_lse = fwd_3xtf32(q, k, v, causal=causal, scale=d**-0.5)
    assert row_share(got, np.asarray(want)) <= ROW_SHARE
    assert np.abs(got_lse - np.asarray(want_lse)).max() <= LSE_TOL


def test_one_tf32_product_fails_the_fp32_tolerance():
    """Against the plain fp32 forward a single tf32 product per fp32
    product (big·big alone) exceeds the tolerance, where the three products
    hold within it: the tolerance tells a 1xTF32 kernel from a 3xTF32 one."""
    b, h, s, d, causal = CASES[1]
    q, k, v = _case(b, h, s, d, causal)
    want = port.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal).numpy()
    three, _ = fwd_3xtf32(q, k, v, causal=causal, scale=d**-0.5)
    one, _ = fwd_3xtf32(q, k, v, causal=causal, scale=d**-0.5, passes=1)
    assert row_share(three, want) <= ROW_SHARE < row_share(one, want)


@pytest.mark.parametrize("bits", [0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001], ids=hex)
def test_a_nan_in_v_reaches_its_rows(bits):
    """A NaN in one V element reaches the outputs as in the plain version:
    that column of every row of its head comes out NaN (P·V multiplies it
    by every row's p, and 0·NaN is NaN), the rest stays finite, and the
    lse, which V does not enter, stays finite.  The split's big carries the
    NaN (an integer add alone would carry its payload into the exponent or
    the sign and make it an inf or a zero)."""
    b, h, s, d, causal = CASES[1]
    q, k, v = _case(b, h, s, d, causal)
    v.view(np.uint32)[1, 0, 45, 17] = bits
    assert np.isnan(v[1, 0, 45, 17])
    got, got_lse = fwd_3xtf32(q, k, v, causal=causal, scale=d**-0.5)
    want = port.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal).numpy()
    assert np.isnan(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1, 0, :, 17]).all() and np.isfinite(got[~np.isnan(want)]).all()
    assert np.isfinite(got_lse).all()


def test_permuted_keys_turn_the_accumulator_into_a_fragments():
    """P goes from the score accumulator to the A fragments of P·V with no
    shuffle: the accumulator holds, for a thread (g, t) of a warp, columns
    2t and 2t + 1 of rows g and g + 8 of each 8-key group, where the tf32 A
    fragment takes positions t and t + 4 (``acc_frags``), so the transposed
    V slots store each group's keys in the order 0, 2, 4, 6, 1, 3, 5, 7
    (``slot_split``).  Played out on one warp's 16 rows: the products of
    those fragments with the permuted V are P·V."""
    rng = np.random.default_rng(5)
    p = rng.standard_normal((16, 64)).astype(np.float64)
    v = rng.standard_normal((64, 32)).astype(np.float64)
    # slot_split: key `key` of a 32-key chunk lands at position kp
    kp = [(key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2) for key in range(32)]
    vt = np.empty_like(v)
    for chunk in (0, 32):
        for key in range(32):
            vt[chunk + kp[key]] = v[chunk + key]
    got = np.zeros((16, 32))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        # the thread's score accumulator: x[4n + 2i + e] is row g + 8i, column 8n + 2t + e
        x = {4 * n + 2 * i + e: p[g + 8 * i, 8 * n + 2 * t + e]
             for n in range(8) for i in range(2) for e in range(2)}
        for n in range(8):  # k-step n: 8 keys
            for e in range(4):  # fragment element e: row g + 8·(e & 1), position t + 4·(e >> 1)
                fr, fc = e & 1, e >> 1
                a = x[4 * n + 2 * fr + fc]
                got[g + 8 * fr] += a * vt[8 * n + t + 4 * fc]
    np.testing.assert_allclose(got, p @ v, rtol=1e-12, atol=1e-12)
