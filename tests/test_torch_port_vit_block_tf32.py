"""The fused ViT block's fp32 chains (K5, K6) in 3xTF32, emulated on the CPU.

On the card, without ``--amp``, every product of the fused block chains
runs on the tensor cores as three tf32 products (``ops/csrc/tf32x3.cuh``):
each fp32 operand x splits into ``big = tf32(x) + x·0`` and
``small = tf32(x - big)`` (round to nearest, ties away, as
``cvt.rna.tf32.f32``), and a·b is small_a·big_b + big_a·small_b +
big_a·big_b in fp32, the small·small term dropped.  The GEMMs
(``block_gemm_tf32x3``, ``dgrad_tf32x3``, ``wgrad_tf32x3``) take each 64
depths' products in a fresh accumulator; the attention
(``block_attn_tf32x3``; ``block_attn_dq_tf32x3`` and
``block_attn_dkv_tf32x3``) streams 64-key tiles with an online softmax, and
its backward takes each row's statistics in a pass of its own.  Those
kernels run only on the card (``tests/test_torch_port_gpu.py``); here their
arithmetic, emulated in numpy and torch on seeded inputs, is held against
fp64, against the port's plain versions and against the JAX package's
``_block_call`` in interpret mode at ``highest``.

Tolerance: ``chip_smoke.py``'s fp32 bound, per row 2^-10 of the row's rms,
rtol 0.  3xTF32 differs from fp32 by the dropped small·small term and the
rounding of small, at most 2^-22 relative an operand (the header's bound),
and by summation order; one tf32 product alone keeps about 2^-11 an
operand, which a test shows the bound rejects.  The card's tensor cores
also round each accumulation toward zero; a test shows why the kernels
take 64 depths at a time in a fresh accumulator.
"""

import functools
import importlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_vit_block_bwd import (
    _SCALE_OF,
    _jax_block_params,
    _jax_raw_params,
    _leaf_error,
    _np,
    _port_grads_as_jax,
    _port_params,
)

from distributed_training_comparison_tpu.ops.vit_block import _block_call

vb = importlib.import_module("distributed_training_comparison_tpu_torch.ops.vit_block")
small = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention_small")
CSRC = Path(vb.__file__).parent / "csrc"

ROW_SHARE = 2**-10  # of each row's rms, rtol 0: chip_smoke.py's fp32 tolerance
FRESH = 64  # depths a fresh accumulator takes (block_gemm_tf32.cuh: kSumStages x kBK)
KEYS, QUERIES = 64, 32  # keys a streamed tile (forward, dq), queries a tile (dk/dv)
DIM, HEADS = 128, 2  # the chains' small width: 2 heads of 64


def tf32(x: np.ndarray) -> np.ndarray:
    """The kernels' ``to_tf32``: fp32 rounded to 10 mantissa bits, to nearest,
    ties away from zero, by an integer add and mask."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernels' ``split_tf32``: big = tf32(x) + x·0, small = tf32(x - big)."""
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        big = (tf32(x) + x * np.float32(0)).astype(np.float32)
        return big, tf32((x - big).astype(np.float32))


def _tsplit(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big, sm = split(t.contiguous().numpy())
    return torch.from_numpy(big), torch.from_numpy(sm)


def mm3(a: torch.Tensor, b: torch.Tensor, *, passes: int = 3) -> torch.Tensor:
    """``a @ b`` over the last two axes with each fp32 product three tf32
    products (``passes=1``: big·big alone), each FRESH depths' products
    summed in a fresh fp32 accumulator added to the total."""
    ab, as_ = _tsplit(a)
    bb, bs = _tsplit(b)
    out = torch.zeros((*a.shape[:-1], b.shape[-1]))
    for k0 in range(0, a.shape[-1], FRESH):
        x, y = ab[..., k0:k0 + FRESH], bb[..., k0:k0 + FRESH, :]
        part = x @ y
        if passes == 3:
            part = as_[..., k0:k0 + FRESH] @ y + x @ bs[..., k0:k0 + FRESH, :] + part
        out += part
    return out


def row_share(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt((want**2).mean(-1, keepdims=True))
    return float((np.abs(got - want) / rms).max())


# ------------------------------------------------------------ the split


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e3, 1e30], ids=lambda s: f"{s:g}")
def test_the_split_keeps_fp32_accuracy(scale):
    """big and small are tf32 (their low 13 bits zero) and big + small is x
    within 2^-22 |x| (tf32x3.cuh's header), at every scale where small is a
    normal fp32 number (|x| above 2^-114; below, small loses bits as a
    subnormal)."""
    x = (scale * np.random.default_rng(1).standard_normal(100_000)).astype(np.float32)
    big, sm = split(x)
    assert not ((big.view(np.uint32) | sm.view(np.uint32)) & np.uint32(0x1FFF)).any()
    x64 = np.abs(x.astype(np.float64))
    err = np.abs(x.astype(np.float64) - big.astype(np.float64) - sm.astype(np.float64))
    normal = x64 >= 2.0**-114
    assert normal.mean() > 0.99
    assert (err[normal] <= 2**-22 * x64[normal]).all()


# (label, M, K, N): the chains' GEMM depths: K 192 (qkv, proj, up; dy·W_dn,
# dr1·W_o), 576 (dqkv·W_qkv), 768 (down; dup·W_up), and a weight gradient's
# 1024-row chunk, its depth
PRODUCT_SHAPES = [
    ("K 192", 64, 192, 64),
    ("K 576", 64, 576, 64),
    ("K 768", 64, 768, 64),
    ("wgrad chunk, depth 1024", 64, 1024, 64),
]


def _product_bound(a, b, k):
    """Each product of split operands is within 3·2^-22 of a·b (two
    operands' 2^-22, the dropped small·small term), and an fp32 sum of
    FRESH terms, then of k / FRESH partials, adds (FRESH + k / FRESH)·2^-24
    of the sum of |a·b|: per element, of |A|·|B|."""
    return (3 * 2**-22 + (FRESH + k / FRESH) * 2**-24) * (np.abs(a) @ np.abs(b))


@pytest.mark.parametrize("label,m,k,n", PRODUCT_SHAPES, ids=[s[0] for s in PRODUCT_SHAPES])
def test_the_3xtf32_product_is_fp32_accurate_at_the_chains_shapes(label, m, k, n):
    """The emulated 3xTF32 product (``mm3``) against the exact product in
    fp64 within ``_product_bound``, at the chains' depths; one tf32
    product (big·big alone) misses that bound by far."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    bound = _product_bound(a.astype(np.float64), b.astype(np.float64), k)
    got = mm3(torch.from_numpy(a), torch.from_numpy(b)).numpy().astype(np.float64)
    assert (np.abs(got - exact) <= bound).all()
    one = mm3(torch.from_numpy(a), torch.from_numpy(b), passes=1).numpy().astype(np.float64)
    assert (np.abs(one - exact) > bound).mean() > 0.5


def _sum_rz(terms: np.ndarray) -> np.ndarray:
    """Terms (n, ...) summed in order in fp32, each add rounded toward zero:
    the tensor cores' accumulation."""
    acc = np.zeros(terms.shape[1:], np.float32)
    for t in terms:
        exact = acc.astype(np.float64) + t.astype(np.float64)
        r = exact.astype(np.float32)
        acc = np.where(np.abs(r.astype(np.float64)) > np.abs(exact), np.nextafter(r, np.float32(0)), r)
    return acc


def test_fresh_accumulators_keep_the_truncation_from_growing_with_the_chunk():
    """Over a weight gradient's 1024-row chunk, one accumulator rounding
    toward zero drifts with the chunk's length; 64 rows a fresh accumulator,
    the 16 partials added in fp32 to nearest (``wgrad_tf32x3``), err several
    times less.  Positive-mean terms, as a gradient's products often are,
    so that the truncation's bias adds up."""
    rng = np.random.default_rng(7)
    terms = (rng.standard_normal((1024, 64, 64)) + 0.5).astype(np.float32)
    exact = terms.astype(np.float64).sum(0)
    long_err = np.abs(_sum_rz(terms) - exact)
    parts = np.stack([_sum_rz(terms[r:r + FRESH]) for r in range(0, 1024, FRESH)])
    fresh = np.zeros(parts.shape[1:], np.float32)
    for p in parts:
        fresh = (fresh + p).astype(np.float32)
    fresh_err = np.abs(fresh - exact)
    assert long_err.mean() > 4 * fresh_err.mean()
    assert fresh_err.max() <= 2**-14 * np.abs(terms.astype(np.float64)).sum(0).max()


# -------------------------------------------------------- the shape rule


def _constant(name: str, source: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert len(found) == 1, (name, source, found)
    return int(found[0])


def test_the_emulation_takes_the_kernels_tiles():
    """The emulation sums and tiles as the kernels do only while its
    constants are theirs: FRESH depths a fresh accumulator (kSumStages
    stages of kBK), KEYS keys a streamed tile (the forward and dq), QUERIES
    queries a tile (dk/dv)."""
    gemm = "block_gemm_tf32.cuh"
    assert _constant("kSumStages", gemm) * _constant("kBK", gemm) == FRESH
    assert _constant("kTf32Keys", "vit_block_fwd.cu") == _constant("kTf32Keys", "vit_block_bwd.cu") == KEYS
    assert _constant("kTf32Queries", "vit_block_bwd.cu") == QUERIES



def test_the_kernels_head_dims_are_the_wrappers():
    """The fp32 attention kernels' entry points (``vit_block_attention``,
    ``vit_block_attention_bwd``) take exactly the head dims
    ``_check_head_dim`` passes in fp32 (multiples of 16 up to 128), each
    padded to 64 or 128, the least of the two that holds it."""
    for name in ("vit_block_fwd.cu", "vit_block_bwd.cu"):
        text = (CSRC / name).read_text()
        assert text.count("if (head_dim % 16 || head_dim < 16 || head_dim > 128) return ") >= 2, name
        assert re.search(r"head_dim <= 64 \? launch_attention\w*tf32x3<64>", text), name
    for d in range(1, 257):
        try:
            vb._check_head_dim(d, torch.float32)
            taken = True
        except ValueError:
            taken = False
        assert taken == (d % 16 == 0 and 16 <= d <= 128), d
        if taken:
            pad = 64 if d <= 64 else 128
            assert 0 <= pad - d < 64


# ------------------------------------------------------ the attention


def _heads(x: torch.Tensor, seq: int, heads: int, parts: int, dp: int) -> list[torch.Tensor]:
    """The (B, H, S, DP) tiles of packed rows, zero past the head dim: what
    the kernels' copies take (no column of the next head)."""
    rows, width = x.shape
    d = width // parts // heads
    t = x.view(rows // seq, seq, parts, heads, d).permute(2, 0, 3, 1, 4)
    return list(F.pad(t, (0, dp - d)).unbind(0))


def _pack(t: torch.Tensor, d: int) -> torch.Tensor:
    b, h, s, _ = t.shape
    return t[..., :d].permute(0, 2, 1, 3).reshape(b * s, h * d)


def attention_3x(qkv: torch.Tensor, *, seq: int, heads: int) -> torch.Tensor:
    """``block_attn_tf32x3``'s arithmetic: per 64-key tile S = Q·K_jᵀ in
    3xTF32, keys past S masked, the running max (in units of scale·log2e)
    and sum, O rescaled and O += P·V_j (P split as the kernel splits its
    accumulator), a fresh accumulator a tile; O / l at the end."""
    dim = qkv.shape[1] // 3
    d = dim // heads
    dp = 64 if d <= 64 else 128
    q, k, v = _heads(qkv, seq, heads, 3, dp)
    sl2 = d**-0.5 * math.log2(math.e)
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for n0 in range(0, seq, KEYS):
        kt, vt = k[..., n0:n0 + KEYS, :], v[..., n0:n0 + KEYS, :]
        s = mm3(q, kt.transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1) * sl2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm3(p, vt)
        m = m_new
    return _pack(o / l[..., None], d)


def attention_bwd_3x(qkv: torch.Tensor, do: torch.Tensor, *, seq: int, heads: int) -> torch.Tensor:
    """``block_attn_dq_tf32x3`` then ``block_attn_dkv_tf32x3``: a first pass
    over the 64-key tiles for each row's max, sum of exp and sum of P·dP
    (rescaled as the max grows), so delta = Σ P dP; a second for dS = P (dP -
    delta) scale with P = exp(S scale - lse) and dQ += dS·K_j; then per
    32-query tile Sᵀ and dPᵀ, Pᵀ and dSᵀ from the statistics, dV += Pᵀ·dO_i
    and dK += dSᵀ·Q_i.  Every product 3xTF32, a fresh accumulator a tile."""
    dim = qkv.shape[1] // 3
    d = dim // heads
    dp_ = 64 if d <= 64 else 128
    scale = d**-0.5
    sl2 = scale * math.log2(math.e)
    q, k, v = _heads(qkv, seq, heads, 3, dp_)
    (dout,) = _heads(do, seq, heads, 1, dp_)
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    w = torch.zeros(q.shape[:-1])
    for n0 in range(0, seq, KEYS):
        s = mm3(q, k[..., n0:n0 + KEYS, :].transpose(-1, -2))
        dp = mm3(dout, v[..., n0:n0 + KEYS, :].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1) * sl2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * sl2 - m_new[..., None])
        l, w, m = l * alpha + p.sum(-1), w * alpha + (p * dp).sum(-1), m_new
    lse = m * math.log(2) + torch.log(l)
    delta = w / l
    dq = torch.zeros(q.shape)
    for n0 in range(0, seq, KEYS):
        kt = k[..., n0:n0 + KEYS, :]
        s = mm3(q, kt.transpose(-1, -2))
        dp = mm3(dout, v[..., n0:n0 + KEYS, :].transpose(-1, -2))
        ds = torch.exp(s * scale - lse[..., None]) * (dp - delta[..., None]) * scale
        dq += mm3(ds, kt)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for m0 in range(0, seq, QUERIES):
        qi, doi = q[..., m0:m0 + QUERIES, :], dout[..., m0:m0 + QUERIES, :]
        st = mm3(k, qi.transpose(-1, -2))
        dpt = mm3(v, doi.transpose(-1, -2))
        pt = torch.exp(st * scale - lse[..., None, m0:m0 + QUERIES])
        dst = pt * (dpt - delta[..., None, m0:m0 + QUERIES]) * scale
        dv += mm3(pt, doi)
        dk += mm3(dst, qi)
    return torch.cat([_pack(t, d) for t in (dq, dk, dv)], dim=1)


# (B, S, heads, head dim): the vit_tiny p2 head dim at a ragged S (136: the
# last key tile 8 keys, the last query tile of dk/dv 8 queries), and head
# dims the kernels pad (48 to 64, 80 to 128)
ATTENTION_CASES = [(2, 136, 2, 64), (2, 136, 3, 48), (1, 72, 2, 80)]


@pytest.mark.parametrize("b,s,heads,d", ATTENTION_CASES, ids=lambda v: str(v))
def test_3xtf32_attention_matches_the_packed_attention(b, s, heads, d):
    """The forward's emulation against ``packed_attention_reference`` and
    the backward's against ``packed_attention_bwd_reference`` (dq, dk and dv
    each), per row within 2^-10 of the rms."""
    rng = np.random.default_rng(b * s + d)
    dim = heads * d
    qkv = torch.from_numpy(rng.standard_normal((b * s, 3 * dim)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((b * s, dim)).astype(np.float32))
    got = attention_3x(qkv, seq=s, heads=heads)
    assert row_share(got, small.packed_attention_reference(qkv, seq=s, heads=heads)) <= ROW_SHARE
    got = attention_bwd_3x(qkv, do, seq=s, heads=heads)
    want = small.packed_attention_bwd_reference(qkv, do, seq=s, heads=heads)
    for j in range(3):
        cols = slice(j * dim, (j + 1) * dim)
        assert row_share(got[:, cols], want[:, cols]) <= ROW_SHARE, "qkv"[j]


# ---------------------------------------------------- the chains against JAX


def gemm_3x(a, weights, biases, *, ln=None, norm_f32=True, gelu=False, residual=None, stream=None):
    """``block_gemm_tf32x3``: the LayerNorm (fp32 statistics) applied to A,
    A·Wᵀ in 3xTF32, then bias, gelu or the residual in fp32."""
    assert norm_f32
    if ln is not None:
        a = vb._ln_fwd(a, ln[0], ln[1], True)
    out = mm3(a, torch.cat(list(weights)).T.contiguous()) + torch.cat(list(biases))
    if gelu:
        out = vb._gelu(out)
    return out if residual is None else residual + out


def dgrad_3x(g, weights, *, gelu_of=None, out_f32=False, stream=None):
    """``dgrad_tf32x3``: G·W in 3xTF32; the gelu backward against up, with
    gelu(up) beside it."""
    acc = mm3(g, torch.cat(list(weights)))
    return acc if gelu_of is None else (vb._gelu_bwd(gelu_of, acc), vb._gelu(gelu_of))


def wgrad_3x(g, a, bias_src, *, stream=None):
    """``wgrad_tf32x3``: per chunk of rows Gᵀ·A in 3xTF32 and the bias
    source's column sums."""
    c = vb.WGRAD_CHUNK_ROWS
    parts = [mm3(g[i:i + c].T.contiguous(), a[i:i + c]) for i in range(0, g.shape[0], c)]
    return torch.stack(parts), vb._chunk_sums(bias_src.float(), c)


@functools.lru_cache(maxsize=None)
def _jax_case(b: int, s: int):
    """Seeded inputs at dim 128 (2 heads of 64) and the JAX kernel's forward
    and backward (``_block_call`` in interpret mode at ``highest``, one item
    a grid step)."""
    jp = _jax_block_params(seed=31, dim=DIM)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((b * s, DIM)).astype(np.float32)
    dy = rng.standard_normal((b * s, DIM)).astype(np.float32)
    d = DIM // HEADS
    raw = _jax_raw_params(jp, jnp.float32, True)
    with jax.default_matmul_precision("highest"):
        out = _block_call(jnp.asarray(x), None, raw, 1, s, HEADS, d, d**-0.5, True, True)
        dx, grads = _block_call(jnp.asarray(x), jnp.asarray(dy), raw, 1, s, HEADS, d, d**-0.5, True, True)
    return jp, x, dy, _np(out), _np(dx), [_np(g) for g in grads]


def test_fused_block_cpu_path_matches_jax_block_call():
    """Unchanged: the fused block's CPU path (``fused_vit_block`` and
    ``fused_vit_block_bwd`` on CPU tensors: the plain versions, no launch)
    in fp32 against the JAX kernels, output and dx per row and the twelve
    raw gradients per leaf within 2e-5 (summation order only)."""
    b, s = 2, 256
    jp, x, dy, out_j, dx_j, grads_j = _jax_case(b, s)
    params = _port_params(jp)
    xt, dyt = torch.from_numpy(x).view(b, s, DIM), torch.from_numpy(dy).view(b, s, DIM)
    before = vb.block_gemm.launches, vb.block_attention.launches, vb.block_gemm_wgrad.launches
    out = vb.fused_vit_block(xt, params, heads=HEADS)
    dx, grads = vb.fused_vit_block_bwd(xt, dyt, params, heads=HEADS)
    assert (vb.block_gemm.launches, vb.block_attention.launches, vb.block_gemm_wgrad.launches) == before
    assert row_share(out.reshape(b * s, DIM).numpy(), out_j) <= 2e-5
    assert row_share(dx.reshape(b * s, DIM).numpy(), dx_j) <= 2e-5
    got = _port_grads_as_jax({k: v.numpy() for k, v in grads.items()})
    for i, (g, w) in enumerate(zip(got, grads_j)):
        assert _leaf_error(np.asarray(g), w, grads_j[_SCALE_OF.get(i, i)]) <= 2e-5, i


def test_3xtf32_chains_match_jax_block_call(monkeypatch):
    """The K5 chain (``_chain``) and the K6 chain (``_bwd_chain``) as the
    card runs them in fp32, every GEMM and attention wrapper replaced by its
    3xTF32 emulation, against the JAX kernels: the output and dx per row and
    the twelve raw gradients per leaf within 2e-5, the bound the plain
    chains meet (3xTF32 adds 2^-22 relative an operand)."""
    b, s = 2, 256
    jp, x, dy, out_j, dx_j, grads_j = _jax_case(b, s)
    params = _port_params(jp)

    def attend(qkv, *, seq, heads, stream=None):
        return attention_3x(qkv, seq=seq, heads=heads)

    def attend_bwd(qkv, do, *, seq, heads, stream=None):
        return attention_bwd_3x(qkv, do, seq=seq, heads=heads)

    out = vb._chain(torch.from_numpy(x).view(b, s, DIM), params, HEADS, True, gemm_3x, attend)
    assert row_share(out.reshape(b * s, DIM).numpy(), out_j) <= 2e-5
    for name, fn in (("block_gemm", gemm_3x), ("block_gemm_dgrad", dgrad_3x), ("block_gemm_wgrad", wgrad_3x),
                     ("block_attention", attend), ("block_attention_bwd", attend_bwd)):
        monkeypatch.setattr(vb, name, fn)
    dx, grads = vb._bwd_chain(torch.from_numpy(x), torch.from_numpy(dy), params, s, HEADS)
    assert row_share(dx.numpy(), dx_j) <= 2e-5
    got = _port_grads_as_jax({k: v.numpy() for k, v in grads.items()})
    for i, (g, w) in enumerate(zip(got, grads_j)):
        assert _leaf_error(np.asarray(g), w, grads_j[_SCALE_OF.get(i, i)]) <= 2e-5, i
