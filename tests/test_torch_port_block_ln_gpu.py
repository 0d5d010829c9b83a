"""The fused block backward's LayerNorm kernels on the card (``gpu`` marker).

``block_ln`` launches ``ln_rows`` and ``block_ln_bwd`` launches ``ln_bwd``
(``csrc/vit_block_bwd.cu``); CUDA kernels have no interpret mode, so these
tests need an NVIDIA Hopper card and skip inside their fixture where
``torch.cuda.is_available()`` is false.  The file imports no JAX; where JAX
is not installed, skip ``tests/conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_port_block_ln_gpu.py

Tolerances are the K6 stage bounds ``chip_smoke.py`` derives
(``BWD_CASES``): per row, bf16 within 2^-5 of the row's rms plus 2^-6·|y|,
fp32 within 2^-10 of the rms; the kernels and the plain versions round at
the same points and differ by fp32 summation order, and in bf16 by the
rare one-ulp flip of a rounded output.
"""

import importlib
import re
from pathlib import Path

import pytest
import torch

from distributed_training_comparison_tpu_torch._device import pin_fp32_math

vb = importlib.import_module("distributed_training_comparison_tpu_torch.ops.vit_block")

WIDTHS = (16, 128, 192, 1024)
ROWS = (1, 127, 128, 408, 1000)
TOL = {torch.bfloat16: (2**-5, 2**-6), torch.float32: (2**-10, 0.0)}
_CU = (Path(vb.__file__).parent / "csrc" / "vit_block_bwd.cu").read_text()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    pin_fp32_math()
    return torch.device("cuda")


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


def in_order_part_b(dln: torch.Tensor, chunk: int) -> torch.Tensor:
    """dβ partials in ``ln_bwd``'s order, by fp32 adds on dln's device: per
    chunk and column, row group g of the block's THREADS / G adds its rows
    lo + (t groups + g) RIF + k one at a time from 0, then the groups' sums
    are added in group order from 0 (``tests/test_torch_port_block_ln.py``
    mirrors the schedule row by row)."""
    m, n = dln.shape
    lanes, rif = ((_const("kLnNarrowLanes"), _const("kLnNarrowInFlight")) if n <= _const("kLnNarrowMaxN")
                  else (_const("kLnWideLanes"), _const("kLnWideInFlight")))
    groups = _const("kLnThreads") // lanes
    nc = -(-m // chunk)
    d = torch.cat([dln, dln.new_zeros(nc * chunk - m, n)]).view(nc, chunk, n)
    valid = (torch.arange(nc * chunk, device=dln.device) < m).view(nc, chunk, 1)
    total = dln.new_zeros(nc, n)
    for g in range(groups):
        acc = dln.new_zeros(nc, n)
        for t in range(-(-chunk // (groups * rif))):
            for k in range(rif):
                r = (t * groups + g) * rif + k
                if r < chunk:
                    acc = torch.where(valid[:, r], acc + d[:, r], acc)
        total = total + acc
    return total


def _inputs(n, m, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed + 31 * n + m)
    x = (1.5 * torch.randn(m, n, generator=gen) + 0.3).to(device=device, dtype=dtype)
    gamma = (1 + 0.1 * torch.randn(n, generator=gen)).to(device)
    beta = (0.1 * torch.randn(n, generator=gen)).to(device)
    dln = torch.randn(m, n, generator=gen).to(device)
    base = torch.randn(m, n, generator=gen).to(device)
    return x, gamma, beta, dln, base if m % 2 == 0 else base.to(dtype)


def _row_share(got, want, rtol):
    w = want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float((((got.float() - w).abs() - rtol * w.abs()) / rms).max())


CASES = [(d, n, m) for d in (torch.bfloat16, torch.float32) for n in WIDTHS for m in ROWS]
IDS = [f"{'bf16' if d == torch.bfloat16 else 'fp32'}-n{n}-m{m}" for d, n, m in CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,m", CASES, ids=IDS)
def test_ln_kernels_match_plain_replay_and_mirror_on_card(cuda_device, dtype, n, m):
    """``ln_rows`` and ``ln_bwd`` at the edge shapes (one row, ragged chunks,
    n 16 to 1024; an even m with an fp32 base, an odd one with a base in
    the compute dtype) against their plain versions within the K6 bounds,
    one launch a call; a second call bit-identical; ``ln_bwd``'s dβ
    partials bit-equal to the in-order fp32 sum of its schedule."""
    x, gamma, beta, dln, base = _inputs(n, m, dtype, cuda_device)
    share, rtol = TOL[dtype]
    before = (vb.block_ln.launches, vb.block_ln_bwd.launches)
    y = vb.block_ln(x, gamma, beta)
    got = vb.block_ln_bwd(dln, x, gamma, base)
    torch.cuda.synchronize()
    assert (vb.block_ln.launches, vb.block_ln_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_y = vb.block_ln_reference(x, gamma, beta)
    assert y.dtype == dtype and bool(torch.isfinite(y).all())
    assert _row_share(y, want_y, rtol) <= share, _row_share(y, want_y, rtol)
    for g, w in zip(got, vb.block_ln_bwd_reference(dln, x, gamma, base)):
        assert g.dtype == w.dtype and g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _row_share(g, w, rtol) <= share, _row_share(g, w, rtol)
    assert torch.equal(vb.block_ln(x, gamma, beta), y)
    assert all(torch.equal(a, b) for a, b in zip(vb.block_ln_bwd(dln, x, gamma, base), got))
    assert torch.equal(got[3], in_order_part_b(dln, vb.LN_CHUNK_ROWS))


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["x", "dln"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_a_nan_lands_where_the_plain_version_puts_it(cuda_device, dtype, where):
    """A NaN in x (its row's statistics: the row of y, of both sums and of
    its chunk's dγ) or in dln (the row's two means: the row of both sums,
    and its column of its chunk's dγ and dβ) makes NaN exactly where the
    plain versions do, and nowhere else."""
    x, gamma, beta, dln, base = _inputs(192, 408, dtype, cuda_device, seed=7)
    (x if where == "x" else dln)[300, 77] = float("nan")
    got = [vb.block_ln(x, gamma, beta), *vb.block_ln_bwd(dln, x, gamma, base)]
    torch.cuda.synchronize()
    want = [vb.block_ln_reference(x, gamma, beta), *vb.block_ln_bwd_reference(dln, x, gamma, base)]
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert bool(torch.isnan(got[1][300]).all()) and not bool(torch.isnan(got[1][:300]).any())


@pytest.mark.gpu
def test_ln_wrappers_launch_their_kernels_by_symbol(cuda_device):
    """At the train shape (32768 rows of 192) each wrapper call is one
    launch of its kernel, ``ln_rows`` or ``ln_bwd``, and no other kernel of
    the port's."""
    x, gamma, beta, dln, base = _inputs(192, 32768, torch.bfloat16, cuda_device)
    vb.block_ln(x, gamma, beta)
    vb.block_ln_bwd(dln, x, gamma, base)
    torch.cuda.synchronize()
    symbol = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)[<(]")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        vb.block_ln(x, gamma, beta)
        vb.block_ln_bwd(dln, x, gamma, base, keep_f32=False)
        torch.cuda.synchronize()
    ours = {}
    for e in prof.key_averages():
        if m := symbol.match(e.key):
            ours[m.group(1)] = ours.get(m.group(1), 0) + e.count
    assert ours == {"ln_rows": 1, "ln_bwd": 1}, ours


@pytest.mark.gpu
def test_ln_wrappers_raise_on_rows_wider_than_the_kernels_take(cuda_device):
    x, gamma, beta, dln, base = _inputs(1040, 4, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="up to 1024"):
        vb.block_ln(x, gamma, beta)
    with pytest.raises(ValueError, match="up to 1024"):
        vb.block_ln_bwd(dln, x, gamma, base)
