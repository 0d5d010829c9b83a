"""The fp32 grouped expert FFN's dx kernel (K8, ``moe_ffn_dx_tf32x3``), emulated on the CPU.

On the card, without ``--amp`` and with ``--moe-dispatch gmm``, K8 runs
every product on the tensor cores as three tf32 products
(``ops/csrc/tf32x3.cuh``), on K7's expert-aligned units
(``moe_gmm.expert_tiles``): per 64-column hidden chunk, h1 = x . W1c and
dg = dy . W2cᵀ over d (192) in one accumulator each, dh = gelu'(h1 + b1) dg
in fp32, then dh . W1cᵀ over the chunk in a fresh accumulator added to dx
in fp32.  The kernel runs only on the card (``tests/test_torch_port_gpu.py``);
here ``k8_emulated`` follows its summation with the emulation helpers of
``test_torch_port_moe_tf32.py`` (each 8-depth step's three products added
to the accumulator rounding toward zero, the card's measured truncation)
and is held against fp64, the port's plain version and the JAX
``grouped_ffn``'s VJP in Pallas interpret mode at ``highest`` precision.

The tolerance is ``chip_smoke.py``'s fp32 bound on dx: per kept row 2^-10
of the row's rms (rtol 0).  One tf32 product alone (big·big) keeps about
2^-11 an operand, which the bound rejects.  The emulation's constants, and
the kernel's shuffles that put dh in the natural slots' contraction order,
are read from the CUDA source.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.ops.moe_gmm import grouped_ffn as jax_grouped_ffn
from distributed_training_comparison_tpu_torch.ops import moe_gmm
from test_torch_port_moe_tf32 import CASES, DIM, HIDDEN, ROW_SHARE, _gelu_grad, _inputs, mm, row_share

CSRC = Path(moe_gmm.__file__).parent / "csrc"
CHUNK = moe_gmm.HIDDEN_MULTIPLE[torch.float32]  # hidden columns a chunk: dx's fresh accumulator
TILE = moe_gmm.TILE_ROWS  # a consumer warpgroup's rows
UNIT = moe_gmm.UNIT_ROWS  # a block's rows: expert_tiles' unit
SLOTS = 3 * DIM // 32  # ring slots a chunk: W1cᵀ (h1), W2c (dg), W1c (dx), 32 depths of d or 64 of d each


def k8_emulated(xs, dy, w1, b1, w2, starts, cap, *, passes=3):
    """``moe_ffn_dx_tf32x3``'s arithmetic on ``expert_tiles``' schedule: each
    tile of up to 64 rows of one expert (rows past its end zero), per
    64-column hidden chunk h1 = x . W1c and dg = dy . W2cᵀ in one accumulator
    over d each, dh = gelu'(h1 + b1) dg in fp32, then dh . W1cᵀ over the
    chunk in a fresh accumulator added to dx in fp32; every other row 0."""
    n, d = xs.shape
    dx = torch.zeros_like(xs)
    for e, lo, hi in moe_gmm.expert_tiles(starts, cap, n):
        if hi <= lo:
            continue
        x, g = torch.zeros(TILE, d), torch.zeros(TILE, d)
        x[:hi - lo], g[:hi - lo] = xs[lo:hi], dy[lo:hi]
        acc = torch.zeros(TILE, d)
        for c0 in range(0, w1.shape[2], CHUNK):
            w1c = w1[e][:, c0:c0 + CHUNK]
            h1 = mm(x, w1c, passes=passes)
            dg = mm(g, w2[e][c0:c0 + CHUNK].T.contiguous(), passes=passes)
            dh = _gelu_grad(h1 + b1[e][c0:c0 + CHUNK]) * dg
            acc = acc + mm(dh, w1c.T.contiguous(), passes=passes)
        dx[lo:hi] = acc[:hi - lo]
    return dx


def _fp64_dx(xs, dy, w1, b1, w2, starts, cap):
    """dx of the kept rows in fp64 (plain products)."""
    xs, dy, w1, b1, w2 = (t.double() for t in (xs, dy, w1, b1, w2))
    dx = torch.zeros_like(xs)
    for e, (lo, hi) in enumerate(moe_gmm.kept_ranges(starts, cap, xs.shape[0])):
        if hi > lo:
            v = xs[lo:hi] @ w1[e] + b1[e]
            dx[lo:hi] = (_gelu_grad(v) * (dy[lo:hi] @ w2[e].T)) @ w1[e].T
    return dx


def _jax_dx(xs, w1, b1, w2, b2, starts, dy, cap):
    """dx from ``jax.vjp`` of the JAX ``grouped_ffn`` (Pallas, interpret mode)
    at ``highest`` matmul precision."""
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: jax_grouped_ffn(*a, jnp.asarray(starts), cap, interpret=True),
                         *map(jnp.asarray, (xs, w1, b1, w2, b2)))
        return np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    label, counts, cap, pad = request.param
    arrays = _inputs(len(label), counts, pad)
    xs, w1, b1, w2, b2, starts, dy = (torch.from_numpy(a) for a in arrays)
    return {
        "cap": cap, "t": (xs, dy, w1, b1, w2, starts),
        "kept": moe_gmm.kept_mask(starts, cap, xs.shape[0]),
        "jax": torch.from_numpy(_jax_dx(*arrays[:6], arrays[6], cap).copy()),
    }


def test_k8_emulation_holds_against_fp64_plain_and_jax(case):
    """The emulated K8 per kept row within a sixteenth of the 2^-10 bound (of
    the row's rms) of fp64, of the plain version and of the JAX kernel's VJP
    in interpret mode (it reads about 1e-5: 3xTF32 is fp32-accurate); every
    row no expert keeps exactly 0."""
    xs, dy, w1, b1, w2, starts = case["t"]
    cap, kept = case["cap"], case["kept"]
    dx = k8_emulated(xs, dy, w1, b1, w2, starts, cap)
    plain = moe_gmm.grouped_ffn_dx_reference(xs, dy, w1, b1, w2, starts, cap)
    for want in (_fp64_dx(xs, dy, w1, b1, w2, starts, cap), plain, case["jax"]):
        assert row_share(dx[kept], want[kept]) <= ROW_SHARE / 16
    assert (dx[~kept].view(torch.int32) == 0).all()


def test_one_tf32_product_misses_the_dx_bound():
    """big·big alone (1xTF32), with the same sums: dx misses 2^-10 of a
    row's rms against fp64, so the bound tells a kernel that lost fp32 from
    the 3xTF32 one."""
    label, counts, cap, pad = CASES[0]
    xs, w1, b1, w2, _, starts, dy = (torch.from_numpy(a) for a in _inputs(len(label), counts, pad))
    kept = moe_gmm.kept_mask(starts, cap, xs.shape[0])
    want = _fp64_dx(xs, dy, w1, b1, w2, starts, cap)
    assert row_share(k8_emulated(xs, dy, w1, b1, w2, starts, cap, passes=1)[kept], want[kept]) > ROW_SHARE


def test_dx_sums_its_hidden_chunks_far_inside_the_row_bound():
    """dx at the train shape's depth (768 hidden, 12 chunks) on one 64-row
    tile of the experts' xavier-scaled weights: a fresh accumulator a
    64-column chunk, added in fp32, keeps dx under a sixty-fourth of 2^-10
    of a row's rms from fp64."""
    rng = np.random.default_rng(13)
    h = 768
    xs = torch.from_numpy(rng.standard_normal((64, DIM)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((64, DIM)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((1, DIM, h)) / np.sqrt(DIM)).astype(np.float32))
    b1 = torch.from_numpy((0.1 * rng.standard_normal((1, h))).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((1, h, DIM)) / np.sqrt(h)).astype(np.float32))
    starts = torch.tensor([0, 64], dtype=torch.int32)
    dx = k8_emulated(xs, dy, w1, b1, w2, starts, 64)
    assert row_share(dx, _fp64_dx(xs, dy, w1, b1, w2, starts, 64)) < ROW_SHARE / 64


@pytest.mark.parametrize("where", ["x", "dy"])
def test_a_nan_reaches_the_emulated_dx_as_the_plain_version(where):
    """A NaN in one element of a kept row of x, or of dy: the emulated K8's
    dx is NaN in that row alone, exactly where the plain version puts it
    (the split keeps a NaN a NaN)."""
    label, counts, cap, pad = CASES[1]
    xs, w1, b1, w2, _, starts, dy = (torch.from_numpy(a) for a in _inputs(len(label), counts, pad))
    (xs if where == "x" else dy)[40, 17] = float("nan")  # expert 1's rows start at 30
    dx = k8_emulated(xs, dy, w1, b1, w2, starts, cap)
    plain = moe_gmm.grouped_ffn_dx_reference(xs, dy, w1, b1, w2, starts, cap)
    assert torch.equal(dx.isnan(), plain.isnan())
    assert dx[40].isnan().all() and int(dx.isnan().sum()) == DIM


def _source_value(name: str, source: str) -> int:
    """The value of ``constexpr int name = <expression>;`` in ``source``
    (exactly one), the identifiers of the expression read the same way."""
    found = re.findall(rf"constexpr int {name} = ([^;]+);", (CSRC / source).read_text())
    assert len(found) == 1, (name, source, found)
    expr = found[0].replace("moeh::", "")
    for ident in sorted(set(re.findall(r"[A-Za-z_]\w*", expr)), key=len, reverse=True):
        expr = re.sub(rf"\b{ident}\b", str(_source_value(ident, "moe_gmm_hopper.cuh")), expr)
    assert re.fullmatch(r"[\d\s*/+()-]+", expr), expr
    return eval(expr.replace("/", "//"))  # integer arithmetic, as the C++


@pytest.mark.parametrize("mirror, source, name", [
    (CHUNK, "moe_gmm_hopper.cuh", "kChunk"),
    (UNIT, "moe_gmm_hopper.cuh", "kUnitRows"),
    (SLOTS, "moe_gmm_bwd.cu", "kDxF32Slots"),
], ids=["hidden chunk", "unit rows", "slots a chunk"])
def test_the_dx_emulations_constants_are_the_kernels(mirror, source, name):
    """The emulation sums as the kernel does only while its constants are
    the CUDA sources': the hidden chunk (dx's fresh accumulator), the rows
    of a unit (``expert_tiles``' schedule, two 64-row tiles) and the ring's
    18 slots a chunk (six each for h1, dg and dx)."""
    assert mirror == _source_value(name, source)


def test_the_fp32_k8_takes_those_constants():
    """``moe_ffn_dx_tf32x3`` finds its unit with ``expert_unit``, walks the
    hidden dimension a ``kChunk`` at a time, h1 and dg over d in one
    accumulator each (six slots each), dx over the chunk in ``sums``' fresh
    accumulators, and launches ``ceil(n / kUnitRows) + E`` blocks from the
    fp32 branch of ``moe_gmm_dx``; the first port's SIMT K8 and its tiles
    are gone."""
    bwd = (CSRC / "moe_gmm_bwd.cu").read_text()
    body = bwd[bwd.index("moe_ffn_dx_tf32x3(const DxF32Args p) {"):]
    body = body[:body.index("\n}\n")]
    assert "moeh::expert_unit(st, p.e, p.cap, p.n, blockIdx.x, e, lo, hi)" in body
    assert "for (int c0 = 0; c0 < p.h; c0 += moeh::kChunk)" in body
    assert "h1_over_d(h1, head, x0, x8, in0, in8, ring, bars, u, lane);" in body
    assert "scores<kD>(dg, own, ring, bars, u, lane);" in body
    assert "acc_frags_natural(big, small, dg, lane);" in body
    assert "sums<kD, 8>(dx, big, small, ring, bars, u, lane);" in body
    assert re.search(r"const int blocks = \(p\.n \+ moeh::kUnitRows - 1\) / moeh::kUnitRows \+ p\.e;\n"
                     r"\s+moe_ffn_dx_tf32x3<<<blocks, 384, kDxF32Bytes, s>>>\(p\);", bwd)
    entry = bwd[bwd.index('extern "C" int moe_gmm_dx('):]
    assert "return launch_dx_f32(p, s);" in entry[:entry.index("\n}\n")]
    assert "moe_gmm_dx_kernel" not in bwd
    assert "struct Tile" not in (CSRC / "moe_gmm_common.cuh").read_text()


def test_the_quad_shuffles_put_dh_in_the_natural_order():
    """``acc_frags_natural`` mirrored on a warp: every lane (quad thread t,
    group g) holds its accumulator's elements 4n + 2i + j at (row g + 8i,
    column 8n + 2t + j); after the two shuffles a pair its fragment element
    e of k-step n is (row g + 8 (e % 2), column 8n + t + 4 (e // 2)), the
    order of the natural W1c slots dx reads.  The mirror's lines are the
    kernel's."""
    bwd = (CSRC / "moe_gmm_bwd.cu").read_text()
    for line in (
        "const int t = lane & 3, quad = lane & ~3, half = t >> 1, odd = t & 1;",
        "const int src1 = quad | half | (odd << 1), src2 = quad | half | ((odd ^ 1) << 1);",
        "const float s1 = __shfl_sync(0xffffffffu, half ? v1 : v0, src1);",
        "const float s2 = __shfl_sync(0xffffffffu, half ? v0 : v1, src2);",
        "split_tf32(odd ? s2 : s1, big[n][i], small[n][i]);",
        "split_tf32(odd ? s1 : s2, big[n][2 + i], small[n][2 + i]);",
    ):
        assert line in bwd, line
    acc = [{4 * n + 2 * i + j: (lane // 4 + 8 * i, 8 * n + 2 * (lane % 4) + j)
            for n in range(8) for i in range(2) for j in range(2)} for lane in range(32)]
    for lane in range(32):
        t, quad = lane & 3, lane & ~3
        half, odd = t >> 1, t & 1
        src1, src2 = quad | half | (odd << 1), quad | half | ((odd ^ 1) << 1)
        for n in range(8):
            for i in range(2):
                def sent(src, first):  # what lane src sends in the first or second shuffle
                    h = (src & 3) >> 1
                    return acc[src][4 * n + 2 * i + (h if first else 1 - h)]
                s1, s2 = sent(src1, True), sent(src2, False)
                frag = {i: s2 if odd else s1, 2 + i: s1 if odd else s2}
                for e, got in frag.items():
                    assert got == (lane // 4 + 8 * (e % 2), 8 * n + t + 4 * (e // 2)), (lane, n, e, got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_check_card_takes_the_dx_hidden_rule_from_hidden_multiple(dtype):
    """``grouped_ffn_dx`` checks the hidden width against ``HIDDEN_MULTIPLE``
    in both dtypes, as K7 and K9 do: 96 raises, 128 passes; the first
    port's 32-column rule for the fp32 K8 is gone."""
    assert not hasattr(moe_gmm, "DX_HIDDEN_MULTIPLE")
    assert moe_gmm.HIDDEN_MULTIPLE[dtype] == 64
    ne, n = 2, 16
    starts = torch.tensor([0, 8, 16], dtype=torch.int32)
    xs, dy = torch.zeros(n, DIM, dtype=dtype), torch.zeros(n, DIM, dtype=dtype)
    for h, ok in ((96, False), (HIDDEN, True)):
        w1, b1 = torch.zeros(ne, DIM, h, dtype=dtype), torch.zeros(ne, h, dtype=dtype)
        w2 = torch.zeros(ne, h, DIM, dtype=dtype)
        if ok:
            moe_gmm._check_card("grouped_ffn_dx", xs, w1, b1, w2, starts, dy=dy)
        else:
            with pytest.raises(ValueError, match="hidden a multiple of 64"):
                moe_gmm._check_card("grouped_ffn_dx", xs, w1, b1, w2, starts, dy=dy)
