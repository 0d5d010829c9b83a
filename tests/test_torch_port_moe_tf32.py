"""The fp32 grouped expert FFN's 3xTF32 kernels (K7, K9), emulated on the CPU.

On the card, without ``--amp`` and with ``--moe-dispatch gmm``, K7
(``moe_ffn_fwd_tf32x3``) and K9 (``moe_ffn_dw_tf32x3``) run every product
on the tensor cores as three tf32 products (``ops/csrc/tf32x3.cuh``): each
fp32 operand x splits into ``big = tf32(x) + x·0`` and
``small = tf32(x - big)`` (round to nearest, ties away, by an integer add
and mask), and a·b is small_a·big_b + big_a·small_b + big_a·big_b in fp32.
A tf32 ``wgmma`` takes 8 depths a step, and the tensor cores add each
step's products to the fp32 accumulator rounding toward zero; the
emulation does the same (each step's products exact, their add to the
accumulator truncated), a model that reads the card's measured drift
(``test_the_truncation_model_reads_the_cards_drift``).

K7 sums h over d (192) in one accumulator and y over each 64-column hidden
chunk in a fresh one, added to y in fp32; K9 recomputes h1 and dg over d,
then sums each 64-row step's weight products in a fresh accumulator added
to the warpgroup's total in fp32, its row walk split over a cluster of
``K9_CLUSTER`` CTAs (``moe_gmm.dw_walks``) whose partials are added in rank
order.  Those kernels run only on the card (``tests/test_torch_port_gpu.py``);
here their arithmetic, on seeded numpy inputs, is held against fp64, the
port's plain versions and the JAX ``grouped_ffn`` in Pallas interpret mode
at ``highest`` precision.

Tolerances are ``chip_smoke.py``'s fp32 bounds: per kept row of y 2^-10 of
the row's rms (rtol 0), each of K9's four gradients 2^-14 relative L2.  One
tf32 product alone (big·big) keeps about 2^-11 an operand, which both
bounds reject.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_training_comparison_tpu.ops.moe_gmm import grouped_ffn as jax_grouped_ffn
from distributed_training_comparison_tpu_torch.ops import moe_gmm

CSRC = Path(moe_gmm.__file__).parent / "csrc"
ROW_SHARE = 2**-10  # of each kept row's rms, rtol 0: chip_smoke.py's fp32 bound on y
GRAD_TOL = 2**-14  # relative L2 of each gradient: chip_smoke.py's GMM_GRAD_TOL in fp32
KSTEP = 8  # depths of one tf32 wgmma (m64nNk8)
CHUNK = moe_gmm.HIDDEN_MULTIPLE[torch.float32]  # hidden columns a chunk: y's fresh accumulator (K7), an owner (K9)
STEP = moe_gmm.TILE_ROWS  # rows of a K9 step: its weight products' fresh accumulator
CLUSTER = moe_gmm.K9_CLUSTER  # CTAs a K9 owner's walk splits over
_GELU_C, _GELU_A = 0.7978845608028654, 0.044715


def tf32(x: torch.Tensor) -> torch.Tensor:
    """The kernels' ``to_tf32``: 10 mantissa bits, to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``split_tf32``: big = tf32(x) + x·0 (a NaN stays a NaN), small = tf32(x - big)."""
    big = tf32(x) + x * 0
    return big, tf32(x - big)


def _add_rz(acc: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``acc + p`` (p exact, in fp64) rounded to fp32 toward zero."""
    exact = acc.double() + p
    r = exact.float()
    return torch.where(r.double().abs() > exact.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def mm(a: torch.Tensor, b: torch.Tensor, *, passes: int = 3, fresh: int | None = None) -> torch.Tensor:
    """``a @ b`` (fp32, (M, K) by (K, N)) as the kernels' products compute
    it: each fp32 product three tf32 products (``passes=1``: big·big alone),
    8 depths a step, each step's products added to the accumulator rounding
    toward zero; with ``fresh``, each ``fresh`` depths in a fresh
    accumulator added to the total in fp32 to nearest."""
    ab, as_ = split(a)
    bb, bs = split(b)
    pairs = ((as_, bb), (ab, bs), (ab, bb)) if passes == 3 else ((ab, bb),)
    total = torch.zeros(a.shape[0], b.shape[1])
    acc = torch.zeros_like(total)
    for k in range(0, a.shape[1], KSTEP):
        if fresh and k and k % fresh == 0:
            total, acc = total + acc, torch.zeros_like(total)
        for x, y in pairs:
            acc = _add_rz(acc, x[:, k:k + KSTEP].double() @ y[k:k + KSTEP].double())
    return total + acc


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gelu_grad(x):
    t = torch.tanh(_GELU_C * (x + _GELU_A * x * x * x))
    return 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * _GELU_C * (1 + 3 * _GELU_A * x * x)


def k7_emulated(xs, w1, b1, w2, b2, starts, cap, *, passes=3):
    """``moe_ffn_fwd_tf32x3``'s arithmetic: per kept row of expert e, per
    64-column hidden chunk, h = x . W1 chunk in one accumulator over d, g =
    gelu(h + b1) in fp32, then g . W2 chunk in a fresh accumulator added to y
    in fp32; y + b2; every other row 0."""
    y = torch.zeros_like(xs)
    for e, (lo, hi) in enumerate(moe_gmm.kept_ranges(starts, cap, xs.shape[0])):
        if hi <= lo:
            continue
        acc = torch.zeros(hi - lo, xs.shape[1])
        for c0 in range(0, w1.shape[2], CHUNK):
            g = _gelu(mm(xs[lo:hi], w1[e][:, c0:c0 + CHUNK], passes=passes) + b1[e][c0:c0 + CHUNK])
            acc = acc + mm(g, w2[e][c0:c0 + CHUNK], passes=passes)
        y[lo:hi] = acc + b2[e]
    return y


def k9_emulated(xs, dy, w1, b1, w2, starts, cap, *, passes=3):
    """``moe_ffn_dw_tf32x3``'s arithmetic on ``dw_walks``' schedule: each CTA
    of an owner (expert e, hidden chunk c) walks its rows in 64-row steps
    (rows past the kept end zero), h1ᵀ = W1cᵀ . xᵀ and dgᵀ = W2c . dymᵀ in
    one accumulator over d each, dhᵀ = gelu'(h1 + b1) dgᵀ and gᵀ = gelu(h1 +
    b1), then dW1cᵀ and dW2c over the step's rows in a fresh accumulator
    added to the CTA's total in fp32; the CTAs' totals added in rank order;
    db1 and db2 as fp32 sums."""
    ne, d, h = w1.shape
    n = xs.shape[0]
    dw1, db1 = torch.zeros(ne, d, h), torch.zeros(ne, h)
    dw2, db2 = torch.zeros(ne, h, d), torch.zeros(ne, d)
    walks = moe_gmm.dw_walks(starts, cap, n, h)
    for i in range(0, len(walks), CLUSTER):
        owner = walks[i:i + CLUSTER]
        e, c = owner[0][:2]
        c0 = CHUNK * c
        w1t, w2c, b1c = w1[e][:, c0:c0 + CHUNK].T.contiguous(), w2[e][c0:c0 + CHUNK], b1[e][c0:c0 + CHUNK]
        sums = []
        for _, _, lo, hi in owner:  # rank order
            t1, t2, s1 = torch.zeros(CHUNK, d), torch.zeros(CHUNK, d), torch.zeros(CHUNK)
            for r0 in range(lo, hi, STEP):
                x, g_out = torch.zeros(STEP, d), torch.zeros(STEP, d)
                x[:min(hi, r0 + STEP) - r0] = xs[r0:min(hi, r0 + STEP)]
                g_out[:min(hi, r0 + STEP) - r0] = dy[r0:min(hi, r0 + STEP)]
                v = mm(w1t, x.T.contiguous(), passes=passes) + b1c[:, None]
                dg = mm(w2c, g_out.T.contiguous(), passes=passes)
                dh = _gelu_grad(v) * dg
                t1 = t1 + mm(dh, x, passes=passes)
                t2 = t2 + mm(_gelu(v), g_out, passes=passes)
                s1 = s1 + dh.sum(1)
            sums.append((t1, t2, s1))
        t1, t2, s1 = (sum(parts[1:], parts[0]) for parts in zip(*sums))
        dw1[e][:, c0:c0 + CHUNK], dw2[e][c0:c0 + CHUNK], db1[e][c0:c0 + CHUNK] = t1.T, t2, s1
    for e, (lo, hi) in enumerate(moe_gmm.kept_ranges(starts, cap, n)):
        if hi > lo:
            db2[e] = dy[lo:hi].sum(0)
    return dw1, db1, dw2, db2


def _fp64_ffn(xs, w1, b1, w2, b2, dy, starts, cap):
    """y and the four gradients of the kept rows in fp64 (plain products)."""
    xs, w1, b1, w2, b2, dy = (t.double() for t in (xs, w1, b1, w2, b2, dy))
    ne, d, h = w1.shape
    y = torch.zeros_like(xs)
    grads = [torch.zeros(ne, d, h, dtype=torch.float64), torch.zeros(ne, h, dtype=torch.float64),
             torch.zeros(ne, h, d, dtype=torch.float64), torch.zeros(ne, d, dtype=torch.float64)]
    for e, (lo, hi) in enumerate(moe_gmm.kept_ranges(starts, cap, xs.shape[0])):
        if hi > lo:
            x, g_out = xs[lo:hi], dy[lo:hi]
            v = x @ w1[e] + b1[e]
            y[lo:hi] = _gelu(v) @ w2[e] + b2[e]
            dh = _gelu_grad(v) * (g_out @ w2[e].T)
            for g, val in zip(grads, (x.T @ dh, dh.sum(0), _gelu(v).T @ g_out, g_out.sum(0))):
                g[e] = val
    return y, grads


def row_share(got, want) -> float:
    want = want.double()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((got.double() - want).abs() / rms).max())


def rel_l2(got, want) -> float:
    want = torch.as_tensor(np.asarray(want), dtype=torch.float64)
    return float((torch.as_tensor(np.asarray(got), dtype=torch.float64) - want).norm() / want.norm().clamp_min(1e-30))


# (label, group counts, cap, padding rows past starts[E]): E 4, d 192 (the
# kernels' width), h 128 (two chunks); an empty group and groups over
# capacity in both, one ending at n, one with padding rows
CASES = [
    ("an empty group, two over capacity, the last ending at n", (150, 0, 90, 200), 128, 0),
    ("the last group empty, one over capacity, padding rows", (30, 70, 160, 0), 64, 5),
]
NE, DIM, HIDDEN = 4, 192, 128


def _inputs(seed, counts, pad):
    rng = np.random.default_rng(seed)
    n = sum(counts) + pad
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    xs = rng.standard_normal((n, DIM)).astype(np.float32)
    xs[sum(counts):] = 0.0  # padding rows are zero, as the scatter leaves them
    w1 = (rng.standard_normal((NE, DIM, HIDDEN)) / np.sqrt(DIM)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal((NE, HIDDEN))).astype(np.float32)
    w2 = (rng.standard_normal((NE, HIDDEN, DIM)) / np.sqrt(HIDDEN)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal((NE, DIM))).astype(np.float32)
    dy = rng.standard_normal((n, DIM)).astype(np.float32)
    return xs, w1, b1, w2, b2, starts, dy


def _jax(xs, w1, b1, w2, b2, starts, dy, cap):
    """The JAX ``grouped_ffn`` (Pallas, interpret mode) and its ``jax.vjp``
    at ``highest`` matmul precision."""
    with jax.default_matmul_precision("highest"):
        y, vjp = jax.vjp(lambda *a: jax_grouped_ffn(*a, jnp.asarray(starts), cap, interpret=True),
                         *map(jnp.asarray, (xs, w1, b1, w2, b2)))
        return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(dy))[1:]]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    label, counts, cap, pad = request.param
    arrays = _inputs(len(label), counts, pad)
    t = [torch.from_numpy(a) for a in arrays]
    xs, w1, b1, w2, b2, starts, dy = t
    return {
        "cap": cap, "arrays": arrays, "t": t,
        "kept": moe_gmm.kept_mask(starts, cap, xs.shape[0]),
        "fp64": _fp64_ffn(xs, w1, b1, w2, b2, dy, starts, cap),
        "jax": _jax(*arrays[:6], arrays[6], cap),
    }


def test_the_split_keeps_fp32_accuracy_and_a_nan():
    """big and small are tf32 (low 13 bits zero) and big + small is x within
    2^-22 |x| (``tf32x3.cuh``); a NaN splits into a NaN big, so it reaches
    every product it enters."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(100_000).astype(np.float32))
    big, small = split(x)
    assert not ((big.view(torch.int32) | small.view(torch.int32)) & 0x1FFF).any()
    assert ((x.double() - big.double() - small.double()).abs() <= 2**-22 * x.double().abs()).all()
    nan_big, _ = split(torch.tensor([float("nan")]))
    assert nan_big.isnan().all()


def test_the_truncation_model_reads_the_cards_drift():
    """One accumulator over 4096 depths of 3xTF32 products drifts to
    1.7e-4 of a row's rms on the card (PERF.md, the fp32 flash backward's
    first build); the emulation's truncation, each 8-depth step's products
    added rounding toward zero, reads the same within a factor of two,
    where rounding each single product's add would read six times more."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 4096)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4096, 64)).astype(np.float32))
    share = row_share(mm(a, b), a.double() @ b.double())
    assert 1.7e-4 / 2 < share < 1.7e-4 * 2, share


def test_k7_emulation_holds_against_fp64_plain_and_jax(case):
    """The emulated K7 per kept row within a sixteenth of the 2^-10 bound
    (of the row's rms) of fp64, of the plain version and of the JAX kernel
    in interpret mode (it reads about 1.1e-5: 3xTF32 is fp32-accurate); every
    row no expert keeps exactly 0."""
    xs, w1, b1, w2, b2, starts, dy = case["t"]
    cap, kept = case["cap"], case["kept"]
    y = k7_emulated(xs, w1, b1, w2, b2, starts, cap)
    plain = moe_gmm.grouped_ffn_reference(xs, w1, b1, w2, b2, starts, cap)
    jax_y = torch.from_numpy(case["jax"][0].copy())
    for want in (case["fp64"][0], plain, jax_y):
        assert row_share(y[kept], want[kept]) <= ROW_SHARE / 16
    assert (y[~kept] == 0).all()


def test_k9_emulation_holds_against_fp64_plain_and_jax(case):
    """The emulated K9 (``dw_walks``' split over the cluster, partials in
    rank order) within a quarter of the 2^-14 bound (relative L2) of each
    gradient's fp64, plain and JAX (``jax.vjp`` of the interpret-mode
    kernel) values; it reads about 2.5e-6."""
    xs, w1, b1, w2, b2, starts, dy = case["t"]
    cap = case["cap"]
    got = k9_emulated(xs, dy, w1, b1, w2, starts, cap)
    plain = moe_gmm.grouped_ffn_dw_reference(xs, dy, w1, b1, w2, starts, cap)
    for name, g, want64, p, j in zip(("dw1", "db1", "dw2", "db2"), got, case["fp64"][1], plain, case["jax"][1]):
        for want in (want64, p, j):
            assert rel_l2(g, want) <= GRAD_TOL / 4, name


def test_one_tf32_product_misses_the_bounds():
    """big·big alone (1xTF32), with the same sums: y misses 2^-10 of a
    row's rms and K9's weight gradients miss 2^-14, so the bounds tell a
    kernel that lost fp32 from the 3xTF32 ones."""
    label, counts, cap, pad = CASES[0]
    xs, w1, b1, w2, b2, starts, dy = (torch.from_numpy(a) for a in _inputs(len(label), counts, pad))
    y64, grads64 = _fp64_ffn(xs, w1, b1, w2, b2, dy, starts, cap)
    kept = moe_gmm.kept_mask(starts, cap, xs.shape[0])
    assert row_share(k7_emulated(xs, w1, b1, w2, b2, starts, cap, passes=1)[kept], y64[kept]) > ROW_SHARE
    one = k9_emulated(xs, dy, w1, b1, w2, starts, cap, passes=1)
    assert rel_l2(one[0], grads64[0]) > GRAD_TOL and rel_l2(one[2], grads64[2]) > GRAD_TOL


def test_fresh_steps_keep_a_2560_row_walk_far_inside_the_gradient_bound():
    """A K9 weight gradient element sums one product a kept row: 2560 rows
    at the train shape's capacity.  In one accumulator the truncation takes
    more than a quarter of the 2^-14 bound (too much for one source of
    error: the gradient's other errors need the rest); 64 rows a fresh
    accumulator added in fp32, the walk split over ``CLUSTER`` CTAs added in
    rank order (the kernel's sums), stays under a sixty-fourth of it."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((64, 2560)).astype(np.float32))  # xᵀ: 64 of d x the rows
    b = torch.from_numpy(rng.standard_normal((2560, 64)).astype(np.float32))  # dh: the rows x a chunk
    exact = a.double() @ b.double()
    assert rel_l2(mm(a, b), exact) > GRAD_TOL / 4
    half = 2560 // CLUSTER
    parts = [mm(a[:, r:r + half], b[r:r + half], fresh=STEP) for r in range(0, 2560, half)]
    assert rel_l2(sum(parts[1:], parts[0]), exact) < GRAD_TOL / 64


def test_y_sums_its_hidden_chunks_far_inside_the_row_bound():
    """y at the train shape's depth (768 hidden, 12 chunks): a fresh
    accumulator a 64-column chunk, added in fp32, drifts under a
    sixty-fourth of 2^-10 of a row's rms; one accumulator over all 768
    would also stay inside a quarter of it (so the fresh chunks are margin,
    not a need)."""
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((768, 192)) / np.sqrt(768)).astype(np.float32))
    exact = g.double() @ w2.double()
    assert row_share(mm(g, w2, fresh=CHUNK), exact) < ROW_SHARE / 64
    assert row_share(mm(g, w2), exact) < ROW_SHARE / 4


def test_a_nan_in_x_reaches_the_emulated_kernels_as_the_plain_versions():
    """A NaN in one element of a kept row of x: K7's emulation is NaN in
    that row alone, K9's in the expert's dW1, db1 and dW2, exactly where the
    plain versions put it."""
    label, counts, cap, pad = CASES[1]
    xs, w1, b1, w2, b2, starts, dy = (torch.from_numpy(a) for a in _inputs(len(label), counts, pad))
    xs[40, 17] = float("nan")  # expert 1's rows start at 30
    y = k7_emulated(xs, w1, b1, w2, b2, starts, cap)
    assert torch.equal(y.isnan(), moe_gmm.grouped_ffn_reference(xs, w1, b1, w2, b2, starts, cap).isnan())
    assert y[40].isnan().all() and int(y.isnan().sum()) == DIM
    got = k9_emulated(xs, dy, w1, b1, w2, starts, cap)
    for g, p in zip(got, moe_gmm.grouped_ffn_dw_reference(xs, dy, w1, b1, w2, starts, cap)):
        assert torch.equal(g.isnan(), p.isnan())
    assert got[0][1].isnan().all() and not got[0][0].isnan().any()


def _constant(name: str, source: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert len(found) == 1, (name, source, found)
    return int(found[0])


@pytest.mark.parametrize("mirror, source, name", [
    (CHUNK, "moe_gmm_hopper.cuh", "kChunk"),
    (STEP, "moe_gmm_hopper.cuh", "kRows"),
    (CLUSTER, "moe_gmm_bwd.cu", "kDwCluster"),
], ids=["hidden chunk", "K9 step rows", "K9 cluster"])
def test_the_emulations_constants_are_the_kernels(mirror, source, name):
    """The emulation sums as the kernels do only while its constants are the
    CUDA sources': the hidden chunk (K7's fresh accumulator of y, a K9
    owner's width), the rows of a K9 step (its fresh accumulator) and the
    CTAs a K9 walk splits over."""
    assert mirror == _constant(name, source)


def test_the_fp32_kernels_take_those_constants():
    """K7 walks the hidden dimension a ``kChunk`` at a time, summing each
    chunk's y products in a fresh accumulator (``sums`` over 8 k-steps of
    8, 64 hidden columns) after h over d in one (``scores``); K9 launches a
    ``kDwCluster``-CTA cluster an owner, splits its ``kRows``-row steps over
    it as ``dw_walks`` does, and adds each step's products to its total;
    both split with ``to_tf32``'s add and mask."""
    fwd = (CSRC / "moe_gmm_fwd.cu").read_text()
    k7 = fwd[fwd.index("moe_ffn_fwd_tf32x3(const"):]
    assert "for (int c0 = 0; c0 < p.h; c0 += moeh::kChunk)" in k7
    assert "scores<kD>(hacc, own, ring, bars, u, lane);" in k7
    assert "sums<kD, 8>(y, big, small, ring, bars, u, lane);" in k7
    bwd = (CSRC / "moe_gmm_bwd.cu").read_text()
    k9 = bwd[bwd.index("__cluster_dims__(kDwCluster, 1, 1) __launch_bounds__(384, 1) moe_ffn_dw_tf32x3"):]
    assert "const int k0 = rank * steps / kDwCluster, nk = (rank + 1) * steps / kDwCluster - k0;" in k9
    assert "(hi - lo + moeh::kRows - 1) / moeh::kRows" in k9
    assert "for (int i = 0; i < 32; ++i) total[32 * pp + i] += part[i];" in k9
    assert "moe_ffn_dw_tf32x3<<<p.e * (p.h / moeh::kChunk) * kDwCluster, 384" in bwd
    assert "(__float_as_uint(x) + 0x1000u) & 0xFFFFE000u" in (CSRC / "tf32x3.cuh").read_text()
