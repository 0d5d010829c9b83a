"""The fused block backward's LayerNorm kernels (``block_ln``, ``block_ln_bwd``) on the CPU.

On the card ``block_ln`` and ``block_ln_bwd`` are the CUDA kernels
``ln_rows`` and ``ln_bwd`` (``csrc/vit_block_bwd.cu``); on the CPU the
wrappers take their plain versions.  These tests hold the plain versions
against the JAX package's ``_ln_fwd`` and ``_ln_bwd`` (the TPU kernel K6's
LayerNorm pieces) on numpy-seeded inputs, the chunk partials against jnp
sums over each chunk's rows, and a Python mirror of the kernels' schedule
(rows to blocks and row groups, the rows in flight, the lanes' vectors, the
order in which a chunk's rows enter its partials), its constants read from
the CUDA source, without a card.
"""

import functools
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.ops.vit_block import _ln_bwd as jax_ln_bwd
from distributed_training_comparison_tpu.ops.vit_block import _ln_fwd as jax_ln_fwd

vb = importlib.import_module("distributed_training_comparison_tpu_torch.ops.vit_block")

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
WIDTHS = (16, 128, 192, 1024)  # the narrowest, the zoo's 128 and 192, the widest the kernels take
ROWS = (1, 127, 128, 408, 1000)  # one row, one short of a chunk, a chunk, ragged last chunks
CASES = [(dtype, n, m) for dtype in (torch.bfloat16, torch.float32) for n in WIDTHS for m in ROWS]
IDS = [f"{'bf16' if d == torch.bfloat16 else 'fp32'}-n{n}-m{m}" for d, n, m in CASES]


def _inputs(n: int, m: int):
    """x (a mean and scale off 0 and 1, so the statistics matter), γ, β,
    dln and a base, fp32 numpy from a seed."""
    rng = np.random.default_rng(m * 4099 + n)
    x = (1.5 * rng.standard_normal((m, n)) + 0.3).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(n)).astype(np.float32)
    dln = rng.standard_normal((m, n)).astype(np.float32)
    base = rng.standard_normal((m, n)).astype(np.float32)
    return x, gamma, beta, dln, base


def _rms(want: np.ndarray) -> np.ndarray:
    return np.sqrt((np.asarray(want, np.float64) ** 2).mean(-1, keepdims=True))


def _np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


@pytest.mark.parametrize("dtype,n,m", CASES, ids=IDS)
def test_block_ln_reference_is_jax_ln_fwd(dtype, n, m):
    """``block_ln_reference`` against JAX ``_ln_fwd`` with fp32 statistics
    on the same rows.  Both take the mean and E[x²] of n ≤ 1024 fp32 terms,
    in other orders (each within ~n·2^-24 relative of the exact sum, far
    less in practice), so the fp32 outputs agree within 2^-16 of the row's
    rms (they read ~2^-19).  In bf16 both round that fp32 value once, so
    an element differs by at most one bf16 ulp (2^-7 of its size) beyond
    the fp32 difference: within 2^-7·|y| + 2^-16 of the rms."""
    x, gamma, beta, _, _ = _inputs(n, m)
    got = vb.block_ln_reference(torch.from_numpy(x).to(dtype), torch.from_numpy(gamma), torch.from_numpy(beta))
    want, _, _ = jax_ln_fwd(jnp.asarray(x, JNP[dtype]), jnp.asarray(gamma), jnp.asarray(beta), True)
    assert got.dtype == dtype and got.shape == (m, n)
    got, want = got.double().numpy(), _np(want)
    rtol = 2**-7 if dtype == torch.bfloat16 else 0.0
    share = ((np.abs(got - want) - rtol * np.abs(want)) / _rms(want)).max()
    assert np.isfinite(got).all() and share <= 2**-16, share


def _chunk_sums_jnp(t, chunk: int) -> np.ndarray:
    m, n = t.shape
    c = -(-m // chunk)
    return _np(jnp.sum(jnp.pad(t, ((0, c * chunk - m), (0, 0))).reshape(c, chunk, n), axis=1))


def _abs_chunk_sums(t: np.ndarray, chunk: int) -> np.ndarray:
    m, n = t.shape
    c = -(-m // chunk)
    return np.abs(np.pad(np.asarray(t, np.float64), ((0, c * chunk - m), (0, 0)))).reshape(c, chunk, n).sum(1)


@pytest.mark.parametrize("dtype,n,m", CASES, ids=IDS)
def test_block_ln_bwd_reference_is_jax_ln_bwd(dtype, n, m):
    """``block_ln_bwd_reference`` against JAX ``_ln_fwd`` (its xhat and
    1/σ) and ``_ln_bwd`` plus the base, and the chunk partials against jnp
    sums over each LN_CHUNK_ROWS chunk's rows.  An even m takes an fp32
    base (the chain's dr1), an odd m one in the compute dtype (dy).
    - The fp32 sum: the statistics as in the forward, then two means of n
      products; within 2^-16 of the row's rms (reads ~2^-20).
    - The rounded sum: one bf16 ulp (2^-7 of its size) beyond that.
    - dβ = Σ dln: the same fp32 terms summed in two orders over a chunk of
      c rows, so within 2 (c − 1) 2^-24 Σ|dln| of each other.
    - dγ = Σ dln·xhat: the terms themselves differ by xhat's fp32
      difference; within 2^-14 Σ|dln·xhat| (reads ~2^-18)."""
    x, gamma, _, dln, base = _inputs(n, m)
    xin = torch.from_numpy(x).to(dtype)
    base_t = torch.from_numpy(base) if m % 2 == 0 else torch.from_numpy(base).to(dtype)
    out, outc, part_g, part_b = vb.block_ln_bwd_reference(torch.from_numpy(dln), xin, torch.from_numpy(gamma), base_t)
    _, xhat, inv = jax_ln_fwd(jnp.asarray(x, JNP[dtype]), jnp.asarray(gamma), 0.0, True)
    want = jnp.asarray(base_t.float().numpy()) + jax_ln_bwd(jnp.asarray(dln), xhat, inv, jnp.asarray(gamma))
    want_c = want.astype(JNP[dtype])
    chunk = vb.LN_CHUNK_ROWS
    chunks = -(-m // chunk)
    assert out.dtype == torch.float32 and outc.dtype == dtype
    assert part_g.shape == part_b.shape == (chunks, n)
    rms = _rms(_np(want))
    assert (np.abs(out.double().numpy() - _np(want)) / rms).max() <= 2**-16
    share = (np.abs(outc.double().numpy() - _np(want_c)) - 2**-7 * np.abs(_np(want_c))) / rms
    assert share.max() <= 2**-16, share.max()
    terms_g = _np(jnp.asarray(dln) * xhat)
    err_g = np.abs(part_g.double().numpy() - _chunk_sums_jnp(jnp.asarray(dln) * xhat, chunk))
    assert (err_g <= 2**-14 * _abs_chunk_sums(terms_g, chunk)).all()
    err_b = np.abs(part_b.double().numpy() - _chunk_sums_jnp(jnp.asarray(dln), chunk))
    assert (err_b <= 2 * (chunk - 1) * 2.0**-24 * _abs_chunk_sums(dln, chunk)).all()


# ------------------------------------------------------------ the schedule

_CU = (Path(vb.__file__).parent / "csrc" / "vit_block_bwd.cu").read_text()


def _const(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", _CU)
    assert len(found) == 1, (name, found)
    return int(found[0])


THREADS = _const("kLnThreads")
NARROW_MAX_N = _const("kLnNarrowMaxN")
NARROW = (_const("kLnNarrowLanes"), _const("kLnNarrowInFlight"))
WIDE = (_const("kLnWideLanes"), _const("kLnWideInFlight"))
ROWS_BLOCKS_PER_SM = _const("kLnRowsBlocksPerSM")
H100_SMS = 132


def schedule(n: int) -> tuple[int, int, int]:
    """(lanes a row G, vectors a lane NV, rows in flight a row group RIF)
    for rows of n columns, as ``with_ln_schedule`` picks them."""
    lanes, in_flight = NARROW if n <= NARROW_MAX_N else WIDE
    return lanes, -(-n // (4 * lanes)), in_flight


def lane_columns(n: int) -> list[list[int]]:
    """Each lane's columns: vector v of lane l holds 4 (l + G v) to + 3,
    where it lies inside the row."""
    g, nv, _ = schedule(n)
    cols = [[] for _ in range(g)]
    for lane in range(g):
        for v in range(nv):
            c = 4 * (lane + g * v)
            if c < n:
                cols[lane] += range(c, c + 4)
    return cols


def block_rows(lo: int, hi: int, n: int) -> list[list[list[int]]]:
    """The rows [lo, hi) of one block of either kernel: [row group][step] →
    the rows in flight, in the order they enter ``ln_bwd``'s partials.  Row
    group g of the block's THREADS / G takes rows lo + (t groups + g) RIF
    + k, k < RIF, for the same count of steps t in every group."""
    g, _, rif = schedule(n)
    groups = THREADS // g
    steps = -(-(hi - lo) // (groups * rif))
    return [[[r for k in range(rif) if (r := lo + (t * groups + grp) * rif + k) < hi]
             for t in range(steps)] for grp in range(groups)]


def ln_bwd_rows(m: int, n: int, chunk: int) -> list[list[list[list[int]]]]:
    """``ln_bwd``'s rows by block: block b takes chunk b, rows [b chunk,
    min((b + 1) chunk, m))."""
    return [block_rows(b * chunk, min((b + 1) * chunk, m), n) for b in range(-(-m // chunk))]


def ln_rows_rows(m: int, n: int, sms: int = H100_SMS) -> list[list[list[list[int]]]]:
    """``ln_rows``' rows by block: a persistent grid of B blocks, a block a
    THREADS / G · RIF rows up to ROWS_BLOCKS_PER_SM blocks an SM (fewer
    only where the occupancy is lower); block b takes rows [b m / B,
    (b + 1) m / B)."""
    g, _, rif = schedule(n)
    blocks = min(-(-m // (THREADS // g * rif)), ROWS_BLOCKS_PER_SM * sms)
    return [block_rows(b * m // blocks, (b + 1) * m // blocks, n) for b in range(blocks)]


def in_order_part_b(dln: torch.Tensor, chunk: int) -> torch.Tensor:
    """dβ partials in ``ln_bwd``'s order: per column, each row group's rows
    added one at a time in the schedule's order from 0, then the groups'
    sums added in group order from 0, all in fp32."""
    m, n = dln.shape
    out = []
    for groups in ln_bwd_rows(m, n, chunk):
        sums = [functools.reduce(torch.add, [dln[r] for step in steps for r in step], torch.zeros(n))
                for steps in groups]
        out.append(functools.reduce(torch.add, sums, torch.zeros(n)))
    return torch.stack(out) if out else torch.zeros(0, n)


@pytest.mark.parametrize("n", range(16, vb.MAX_DIM + 1, 16))
def test_the_lanes_vectors_cover_each_column_once(n):
    """For every width the kernels take (multiples of 16 up to MAX_DIM), the
    G lanes' four-column vectors cover each column of a row exactly once,
    and ``with_ln_schedule`` instantiates that (G, NV, RIF)."""
    cols = sorted(c for lane in lane_columns(n) for c in lane)
    assert cols == list(range(n))
    g, nv, rif = schedule(n)
    kind = "Narrow" if n <= NARROW_MAX_N else "Wide"
    assert f"LnSchedule<kLn{kind}Lanes, {nv}, kLn{kind}InFlight>" in _CU, (n, g, nv, rif)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("m", ROWS)
def test_ln_bwd_owns_every_row_once_in_its_chunks_block(m, n):
    """Every row is owned once, by the block of its chunk (no chunk spans
    two blocks), and a row group's rows in flight are RIF consecutive rows:
    at n ≤ 192 a half-warp's two, so a warp holds four consecutive rows."""
    chunk = vb.LN_CHUNK_ROWS
    g, _, rif = schedule(n)
    seen = np.zeros(m, dtype=np.int64)
    for b, groups in enumerate(ln_bwd_rows(m, n, chunk)):
        assert len(groups) == THREADS // g and len({len(steps) for steps in groups}) == 1
        for steps in groups:
            for step in steps:
                assert len(step) <= rif and step == sorted(step) and (not step or step[-1] - step[0] == len(step) - 1)
                for r in step:
                    assert r // chunk == b
                    seen[r] += 1
        if g == NARROW[0] and b < m // chunk:  # a whole chunk: each warp's step is four consecutive rows
            for w in range(0, len(groups), 2):
                for t in range(len(groups[w])):
                    warp = groups[w][t] + groups[w + 1][t]
                    assert warp == list(range(warp[0], warp[0] + 2 * rif))
    assert (seen == 1).all()


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("m", ROWS + (32768,))
def test_ln_rows_persistent_grid_owns_every_row_once(m, n):
    """``ln_rows``' persistent grid at the card's 132 SMs owns every row
    once, each block's row groups the same count of steps (the shuffles
    stay uniform), and the blocks' row counts within one of each other, so
    that every SM moves as many rows: at the train shape (32768 rows, n
    192) 396 blocks of 82 or 83 rows, three steps a row group."""
    seen = np.zeros(m, dtype=np.int64)
    blocks = ln_rows_rows(m, n)
    sizes = [sum(len(step) for steps in groups for step in steps) for groups in blocks]
    assert max(sizes) - min(sizes) <= 1
    for groups in blocks:
        assert len({len(steps) for steps in groups}) == 1
        for steps in groups:
            for step in steps:
                for r in step:
                    seen[r] += 1
    assert (seen == 1).all()
    if (m, n) == (32768, 192):
        assert len(blocks) == ROWS_BLOCKS_PER_SM * H100_SMS == 396
        assert set(sizes) == {82, 83} and len(blocks[0][0]) == 3


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("m", (127, 408, 1000))
def test_the_mirrors_in_order_dbeta_agrees_with_the_plain_version(m, n):
    """The dβ partials in the kernel's order (``in_order_part_b``, which the
    card's ``ln_bwd`` must equal bit for bit) against the plain version's
    (``torch.sum`` over each chunk, another order): two fp32 sums of the
    same c terms differ by at most 2 (c − 1) 2^-24 Σ|term|."""
    x, gamma, _, dln, base = _inputs(n, m)
    dln_t = torch.from_numpy(dln)
    *_, want = vb.block_ln_bwd_reference(dln_t, torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(base))
    got = in_order_part_b(dln_t, vb.LN_CHUNK_ROWS)
    chunk = vb.LN_CHUNK_ROWS
    bound = 2 * (chunk - 1) * 2.0**-24 * torch.from_numpy(_abs_chunk_sums(dln, chunk)).float()
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())


def test_the_ln_wrappers_on_the_cpu_are_the_plain_versions():
    """A CPU tensor takes the plain versions and launches nothing."""
    x, gamma, beta, dln, base = (torch.from_numpy(t) for t in _inputs(192, 40))
    before = (vb.block_ln.launches, vb.block_ln_bwd.launches)
    assert torch.equal(vb.block_ln(x, gamma, beta), vb.block_ln_reference(x, gamma, beta))
    for got, want in zip(vb.block_ln_bwd(dln, x, gamma, base), vb.block_ln_bwd_reference(dln, x, gamma, base)):
        assert torch.equal(got, want)
    assert (vb.block_ln.launches, vb.block_ln_bwd.launches) == before
