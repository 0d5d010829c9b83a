"""The fp32 short-sequence attention's 3xTF32 arithmetic (K10, K11), on the CPU.

On the card fp32 K10 and K11 run as ``attn_small_fwd_f32``, then
``attn_small_dq_f32`` and ``attn_small_dkv_f32`` in
``ops/csrc/attention_small.cu``: every fp32 product on the tensor cores as
three tf32 products.  Each operand x splits into ``big = tf32(x) + x·0``
and ``small = tf32(x - big)`` (``cvt.rna``'s rounding, as the kernels'
``to_tf32`` computes it), and a·b is small_a·big_b + big_a·small_b +
big_a·big_b in fp32.  The forward takes 64-key tiles, its softmax in
registers (at one tile the row max and sum; past one tile online, with a
fresh accumulator for each tile's P·V).  The dq kernel takes the row
statistics from its registers at one tile, from a first pass over the key
tiles past one, writes each row's max, sum and Σ P·dP to the scratch, and
the dk/dv kernel reads them back for 32-query tiles.  Those kernels run
only on the card (``tests/test_torch_port_gpu.py``, ``chip_smoke.py``);
here a torch emulation of that arithmetic, with the tile constants read
from the source, is held against the JAX package's ``head_fwd`` and
``head_bwd`` (at ``highest`` matmul precision), against its ``small_mha``
with the Pallas kernels in interpret mode, and against the port's plain
versions, on seeded numpy inputs.

Tolerance: ``chip_smoke.py``'s fp32 bound for these kernels, per row (one
token's D values of one head) 2^-10 of the row's rms, rtol 0.  The
emulation differs from fp32 by the dropped small·small term and the
rounding of small (at most 2^-22 relative an operand), by summation order
and by exp2 against exp (~1e-6 relative), far inside it.  A single tf32
product per fp32 product keeps only about 2^-11 an operand, which the
bound rejects (the last tests).
"""

import importlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.ops.attention_small import _head_probs
from distributed_training_comparison_tpu.ops.attention_small import head_bwd as jax_head_bwd
from distributed_training_comparison_tpu.ops.attention_small import head_fwd as jax_head_fwd
from distributed_training_comparison_tpu.ops.attention_small import small_mha as jax_small_mha

small = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention_small")
CSRC = Path(small.__file__).parent / "csrc"

ROW_SHARE = 2**-10  # of each row's rms, rtol 0: chip_smoke.py's fp32 tolerance
NEG_INF = -1e30
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _eval_const(text: str, name: str) -> int:
    """The value of ``constexpr int name = expr;`` in a CUDA source, its
    expression of integers and earlier such constants."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    for other in re.findall(r"\bk[A-Z]\w*", expr):
        expr = re.sub(rf"\b{other}\b", str(_eval_const(text, other)), expr)
    return int(eval(expr, {"__builtins__": {}}))  # integers and + - * / only


SRC = (CSRC / "attention_small.cu").read_text()
# the kernels' tiles, read from the source: rows a block, keys a forward
# and dq tile, queries a dk/dv tile
ROWS, KEYS, QUERIES = (_eval_const(SRC, n) for n in ("kF32Rows", "kF32Keys", "kF32Queries"))

# (B, S, H, D), causal: vit_tiny at 64 tokens, a ragged causal item (one
# partial tile), a ragged S of 40, four key tiles causal, one tile at head
# dim 128, and 200 tokens at head dim 128 (a partial last tile)
SHAPES = [
    ((2, 64, 3, 64), False),
    ((3, 24, 2, 64), True),
    ((2, 40, 3, 64), False),
    ((2, 256, 2, 64), True),
    ((2, 64, 2, 128), True),
    ((1, 200, 2, 128), False),
]


def tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` for finite x, as the kernels' ``to_tf32``: an
    integer add of half the dropped range and a mask of the low 13 bits."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32``: big = tf32(x) + x·0, small = tf32(x - big)."""
    a = x.numpy().astype(np.float32)
    with np.errstate(invalid="ignore"):
        big = (tf32(a) + a * np.float32(0)).astype(np.float32)
        return torch.from_numpy(big), torch.from_numpy(tf32((a - big).astype(np.float32)))


def mm3(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` with each fp32 product as three tf32 products (``passes=1``:
    big·big alone), sums in fp32; a product of tf32 values is exact."""
    ab, as_ = split(a.contiguous())
    bb, bs = split(b.contiguous())
    if passes == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def _seen(rows: torch.Tensor, cols: torch.Tensor, causal: bool) -> torch.Tensor:
    return cols[None, :] <= rows[:, None] if causal else torch.ones(len(rows), len(cols), dtype=torch.bool)


def fwd_3xtf32(q, k, v, *, causal, scale, passes=3, keys=KEYS):
    """``attn_small_fwd_f32`` on (N, S, D) fp32 items: a block per ``ROWS``
    query rows, ``keys``-key tiles (under causal up to the block's last
    row), scores in units of scale·log2e, the online softmax (at one tile:
    nothing to rescale), P·V a fresh product a tile."""
    n, s, _ = q.shape
    out = torch.empty_like(q)
    sl2 = scale * LOG2E
    for m0 in range(0, s, ROWS):
        rows = torch.arange(m0, min(m0 + ROWS, s))
        qb = q[:, m0:m0 + ROWS]
        m_run = torch.full((n, len(rows)), NEG_INF)
        l_run = torch.zeros(n, len(rows))
        o = torch.zeros_like(qb)
        for n0 in range(0, min(s, m0 + ROWS) if causal else s, keys):
            kt, vt = k[:, n0:n0 + keys], v[:, n0:n0 + keys]
            sc = mm3(qb, kt.transpose(1, 2), passes) * sl2
            sc = torch.where(_seen(rows, torch.arange(n0, n0 + kt.shape[1]), causal), sc, NEG_INF)
            m_new = torch.maximum(m_run, sc.amax(-1))
            alpha = torch.exp2(m_run - m_new)
            e = torch.exp2(sc - m_new[..., None])
            l_run = l_run * alpha + e.sum(-1)
            o = o * alpha[..., None] + mm3(e, vt, passes)
            m_run = m_new
        out[:, m0:m0 + ROWS] = o * (1.0 / l_run)[..., None]
    return out


def dq_3xtf32(q, k, v, do, *, causal, scale, passes=3, keys=KEYS):
    """``attn_small_dq_f32``: dq and the scratch (N, S, 3) of each row's max
    of scale·S, sum of exp(scale·S - max) and delta = Σ P·dP.  At one key
    tile the statistics come from the tile; past one, from an online first
    pass.  dQ = dS·K a fresh product a tile."""
    n, s, _ = q.shape
    dq = torch.empty_like(q)
    stats = torch.empty(n, s, 3)
    sl2 = scale * LOG2E
    for m0 in range(0, s, ROWS):
        rows = torch.arange(m0, min(m0 + ROWS, s))
        qb, dob = q[:, m0:m0 + ROWS], do[:, m0:m0 + ROWS]
        tiles = list(range(0, min(s, m0 + ROWS) if causal else s, keys))

        def scores_dp(n0):
            kt, vt = k[:, n0:n0 + keys], v[:, n0:n0 + keys]
            sc = mm3(qb, kt.transpose(1, 2), passes) * sl2
            sc = torch.where(_seen(rows, torch.arange(n0, n0 + kt.shape[1]), causal), sc, NEG_INF)
            return sc, mm3(dob, vt.transpose(1, 2), passes), kt

        if len(tiles) > 1:
            m2 = torch.full((n, len(rows)), NEG_INF)
            total, w = torch.zeros(n, len(rows)), torch.zeros(n, len(rows))
            for n0 in tiles:
                sc, dp, _ = scores_dp(n0)
                m_new = torch.maximum(m2, sc.amax(-1))
                alpha = torch.exp2(m2 - m_new)
                e = torch.exp2(sc - m_new[..., None])
                total = total * alpha + e.sum(-1)
                w = w * alpha + (e * dp).sum(-1)
                m2 = m_new
            delta = w / total
        acc = torch.zeros_like(qb)
        for n0 in tiles:
            sc, dp, kt = scores_dp(n0)
            if len(tiles) == 1:
                m2 = sc.amax(-1)
            e = torch.exp2(sc - m2[..., None])
            if len(tiles) == 1:
                total = e.sum(-1)
            p = e * (1.0 / total)[..., None]
            if len(tiles) == 1:
                delta = (p * dp).sum(-1)
            ds = p * (dp - delta[..., None]) * scale
            acc = acc + mm3(ds, kt, passes)
        dq[:, m0:m0 + ROWS] = acc
        stats[:, m0:m0 + ROWS] = torch.stack([m2 * LN2, total, delta], -1)
    return dq, stats


def dkv_3xtf32(q, k, v, do, stats, *, causal, scale, passes=3):
    """``attn_small_dkv_f32``: a block per ``ROWS`` keys walks ``QUERIES``
    query tiles (under causal from its first key); P^T and dS^T from the
    scratch by column; dV += P^T·dO and dK += dS^T·Q fresh products a tile."""
    s, tile = q.shape[1], QUERIES
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lse = stats[..., 0] + torch.log(stats[..., 1])
    delta = stats[..., 2]
    for n0 in range(0, s, ROWS):
        keys = torch.arange(n0, min(n0 + ROWS, s))
        kb, vb = k[:, n0:n0 + ROWS], v[:, n0:n0 + ROWS]
        dk_acc, dv_acc = torch.zeros_like(kb), torch.zeros_like(vb)
        for q0 in range(n0 if causal else 0, s, tile):
            qt, dot = q[:, q0:q0 + tile], do[:, q0:q0 + tile]
            queries = torch.arange(q0, q0 + qt.shape[1])
            st = mm3(kb, qt.transpose(1, 2), passes)
            dpt = mm3(vb, dot.transpose(1, 2), passes)
            pt = torch.exp(st * scale - lse[:, None, q0:q0 + tile])
            pt = torch.where(_seen(queries, keys, causal).T, pt, 0.0)
            dst = pt * (dpt - delta[:, None, q0:q0 + tile]) * scale
            dv_acc = dv_acc + mm3(pt, dot, passes)
            dk_acc = dk_acc + mm3(dst, qt, passes)
        dk[:, n0:n0 + ROWS], dv[:, n0:n0 + ROWS] = dk_acc, dv_acc
    return dk, dv


def bwd_3xtf32(q, k, v, do, *, causal, scale, passes=3, keys=KEYS):
    """K11: the dq kernel, then the dk/dv kernel on its scratch."""
    dq, stats = dq_3xtf32(q, k, v, do, causal=causal, scale=scale, passes=passes, keys=keys)
    return (dq, *dkv_3xtf32(q, k, v, do, stats, causal=causal, scale=scale, passes=passes))


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _items(x: np.ndarray) -> torch.Tensor:
    """(B, S, H, D) → (B·H, S, D), each item and head one (S, D) item."""
    b, s, h, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d)))


def _bshd(t: torch.Tensor, shape) -> np.ndarray:
    b, s, h, d = shape
    return t.reshape(b, h, s, d).permute(0, 2, 1, 3).numpy()


def _row_share(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.maximum(np.sqrt((want**2).mean(-1, keepdims=True)), 1e-30)
    return float((np.abs(got - want) / rms).max())


def _emulated(shape, causal, seed, passes=3, keys=KEYS):
    """The emulated kernels' (out, dq, dk, dv) in (B, S, H, D) and the inputs."""
    q, k, v, do = _inputs(seed, shape)
    scale = shape[-1] ** -0.5
    items = [_items(x) for x in (q, k, v, do)]
    out = fwd_3xtf32(*items[:3], causal=causal, scale=scale, passes=passes, keys=keys)
    grads = bwd_3xtf32(*items, causal=causal, scale=scale, passes=passes, keys=keys)
    return [_bshd(t, shape) for t in (out, *grads)], (q, k, v, do)


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_emulated_kernels_match_jax_head_fwd_and_bwd(shape, causal):
    """The emulation against the JAX ``head_fwd`` and ``head_bwd`` (the
    Pallas kernels' per-head bodies) item by item at ``tb = 1``, fp32 at
    ``highest``, within 2^-10 of each row's rms."""
    got, (q, k, v, do) = _emulated(shape, causal, seed=sum(shape) + causal)
    b, s, h, d = shape
    want = [np.empty(shape, np.float32) for _ in range(4)]
    with jax.default_matmul_precision("highest"):
        for i in range(b):
            for j in range(h):
                rows = [jnp.asarray(x[i, :, j]) for x in (q, k, v, do)]
                o, _ = jax_head_fwd(*rows[:3], 1, s, d**-0.5, causal)
                pf = _head_probs(rows[0], rows[1], 1, s, d**-0.5, causal)
                grads = jax_head_bwd(*rows, pf, 1, s, d**-0.5)
                for acc, w in zip(want, (o, *grads)):
                    acc[i, :, j] = np.asarray(w)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _row_share(g, w) <= ROW_SHARE, (name, _row_share(g, w))


@pytest.mark.parametrize("shape,causal", [SHAPES[0], SHAPES[1], SHAPES[3]])
def test_emulated_kernels_match_jax_small_mha_interpret(shape, causal):
    """The emulation against the JAX ``small_mha`` (its Pallas kernels in
    interpret mode, items stacked block-diagonally) and ``jax.vjp`` of it,
    fp32 at ``highest``, within 2^-10 of each row's rms."""
    got, (q, k, v, do) = _emulated(shape, causal, seed=2 * sum(shape) + causal)
    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(lambda q, k, v: jax_small_mha(q, k, v, causal=causal, interpret=True),
                             *(jnp.asarray(x) for x in (q, k, v)))
        grads_j = vjp(jnp.asarray(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, (out_j, *grads_j)):
        assert _row_share(g, np.asarray(w)) <= ROW_SHARE, (name, _row_share(g, np.asarray(w)))


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_emulated_kernels_match_the_plain_versions(shape, causal):
    """The emulation against the port's plain versions, the card's yardstick
    of correctness (``small_mha_reference``, ``small_mha_bwd_reference``)."""
    got, (q, k, v, do) = _emulated(shape, causal, seed=3 * sum(shape) + causal)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    want = [small.small_mha_reference(*t[:3], causal=causal),
            *small.small_mha_bwd_reference(*t, causal=causal)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _row_share(g, w.numpy()) <= ROW_SHARE, (name, _row_share(g, w.numpy()))


@pytest.mark.parametrize("shape,causal", [SHAPES[0], SHAPES[3]])
def test_one_xtf32_is_rejected_by_the_tolerance(shape, causal):
    """A kernel with one tf32 product per fp32 product (big·big alone) is
    held to the same bound and fails it: the bound tells 3xTF32 from TF32."""
    got, (q, k, v, do) = _emulated(shape, causal, seed=4 * sum(shape) + causal, passes=1)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    want = [small.small_mha_reference(*t[:3], causal=causal),
            *small.small_mha_bwd_reference(*t, causal=causal)]
    worst = max(_row_share(g, w.numpy()) for g, w in zip(got, want))
    assert worst > ROW_SHARE, worst


@pytest.mark.parametrize("causal", [False, True])
def test_the_scratch_holds_each_rows_max_sum_and_delta(causal):
    """What the dq kernel writes for the dk/dv kernel, at one key tile (from
    its registers) and past one (its online first pass): each query row's
    max of scale·S over the keys it sees, its sum of exp(scale·S - max), and
    delta = Σ P·dP, against the same from the plain fp64 scores."""
    for s in (64, 192):
        q, k, v, do = (torch.from_numpy(x[0]).double() for x in _inputs(s + causal, (1, 3, s, 64)))
        scale = 64**-0.5
        _, stats = dq_3xtf32(*(x.float() for x in (q, k, v, do)), causal=causal, scale=scale)
        sc = q @ k.transpose(1, 2) * scale
        if causal:
            sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -math.inf)
        mx = sc.amax(-1)
        e = torch.exp(sc - mx[..., None])
        total = e.sum(-1)
        delta = ((e / total[..., None]) * (do @ v.transpose(1, 2))).sum(-1)
        np.testing.assert_allclose(stats[..., 0].numpy(), mx.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(stats[..., 1].numpy(), total.numpy(), rtol=1e-5)
        np.testing.assert_allclose(stats[..., 2].numpy(), delta.numpy(), rtol=1e-4, atol=1e-5)


def test_the_online_softmax_agrees_with_the_one_tile_one():
    """At 64 tokens the kernels take one key tile; the same items cut into
    two 32-key tiles run the online forward and the dq kernel's first pass
    instead.  Both agree with the plain versions and with each other within
    the bound: the one-tile shortcut computes the same function."""
    shape = (2, 64, 3, 64)
    one, _ = _emulated(shape, False, seed=11)
    two, _ = _emulated(shape, False, seed=11, keys=32)
    for name, a, b in zip(("out", "dq", "dk", "dv"), one, two):
        assert _row_share(a, b) <= ROW_SHARE, name


def test_the_emulation_constants_follow_the_source():
    """The emulation's tiles, read from the source (``kF32Rows``,
    ``kF32Keys``, ``kF32Queries``), are the ones the kernels' layouts
    assume: 64 rows (one warpgroup's wgmma M), 64 keys (one tile holds a
    64-token item), 32 queries (Q and dO rows sharing a 64-row slot); and
    the kernels' shared memory, computed from the source's constants, fits
    the card: under 227 KB a block at head dims 64 and 128, and at 64
    (vit_tiny's) three forward or dk/dv blocks an SM and two dq blocks."""
    src = SRC
    tf = (CSRC / "tf32x3.cuh").read_text()
    const = _eval_const
    assert (ROWS, KEYS, QUERIES) == (64, 64, 32)
    assert KEYS == small.ONE_TILE == const(src, "kOneTile")
    slot, frag = const(tf, "kSlotBytes"), const(tf, "kFrag")
    assert (slot, frag) == (16384, 2048)
    for d in (64, 128):
        layouts = {  # slots, own tensors: FwdF32, DqF32, DkvF32
            "fwd": (d // 32, 1),
            "dq": (2 * (d // 32), 2),
            "dkv": (d // 32, 2),
        }
        for name, (slots, own) in layouts.items():
            nbytes = slots * slot + own * d // 8 * frag + 1024
            assert nbytes <= 227 * 1024, (name, d, nbytes)
            if d == 64:  # three forward or dk/dv blocks an SM, two dq blocks
                assert (2 if name == "dq" else 3) * nbytes <= 228 * 1024, (name, nbytes)
    assert re.search(r"using FwdF32 = F32Layout<D, D / 32, 1>;", src)
    assert re.search(r"using DqF32 = F32Layout<D, 2 \* \(D / 32\), 2>;", src)
    assert re.search(r"using DkvF32 = F32Layout<D, D / 32, 2>;", src)

