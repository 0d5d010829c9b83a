"""The port's CUDA kernels on the card (``gpu`` marker).

These tests need an NVIDIA Hopper card: the CUDA kernels (flash
attention, K1-K4; the fused block chains, K5 and K6; the grouped expert
FFN, K7-K9; the short-sequence attention, K10 and K11) have no interpret
mode.
Each skips inside its fixture where ``torch.cuda.is_available()`` is
false.  The file imports no JAX, so it
also runs where JAX is not installed; there, skip ``tests/conftest.py``
(which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import importlib

import pytest
import torch

port = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention")
vit = importlib.import_module("distributed_training_comparison_tpu_torch.models.vit")
vb = importlib.import_module("distributed_training_comparison_tpu_torch.ops.vit_block")
gmm = importlib.import_module("distributed_training_comparison_tpu_torch.ops.moe_gmm")
small = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention_small")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    # the plain versions are held in true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv_views(gen, dtype, b, h, sq, skv, d, layout, device):
    """q, k, v as (B, H, S, D) views: of (B, S, H, D) tensors for bshd (the
    ViT's projections, read in place), contiguous for bhsd."""
    def one(s):
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        return x.transpose(1, 2) if layout == "bshd" else x

    return one(sq), one(skv), one(skv)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,b,h,sq,skv,d,causal,layout",
    [
        (torch.bfloat16, 2, 4, 1024, 1024, 128, False, "bshd"),
        (torch.bfloat16, 1, 3, 130, 130, 64, True, "bshd"),
        (torch.float32, 1, 2, 200, 200, 128, True, "bshd"),
        (torch.float32, 2, 2, 77, 77, 64, False, "bshd"),
        # the bf16 kernel's 128-row tile edges: one row, one short of a
        # tile, a whole tile, one past it, and S 1000 ending inside a tile
        (torch.bfloat16, 1, 2, 1, 1, 128, False, "bshd"),
        (torch.bfloat16, 2, 2, 127, 127, 128, False, "bshd"),
        (torch.bfloat16, 2, 2, 128, 128, 128, False, "bshd"),
        (torch.bfloat16, 2, 2, 129, 129, 128, False, "bshd"),
        (torch.bfloat16, 2, 4, 1000, 1000, 128, False, "bshd"),
        # causal past one tile at D 64 (V's 64 columns against 128-key tiles)
        (torch.bfloat16, 2, 2, 257, 257, 64, True, "bshd"),
        (torch.bfloat16, 2, 3, 300, 300, 128, True, "bhsd"),
        # cross attention: more keys than queries, neither a tile multiple
        (torch.bfloat16, 2, 2, 100, 300, 128, False, "bshd"),
    ],
)
def test_kernel_matches_reference_on_card(cuda_device, dtype, b, h, sq, skv, d, causal, layout):
    """Tolerances as in chip_smoke.py, where they are derived: out within
    atol_share · rms(row) + rtol · |out| per element, a row being one
    query's D outputs; bf16 2^-5 and 2^-6 (P and out rounded to bf16),
    lse 1e-3; fp32 2^-10 and 0, lse 1e-4."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + skv)
    qt, kt, vt = _qkv_views(gen, dtype, b, h, sq, skv, d, layout, cuda_device)
    before = port.flash_attention.launches
    out, lse = port.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert port.flash_attention.launches == before + 1
    assert out.shape == qt.shape and out.stride() == qt.stride()  # layout kept
    ref, ref_lse = port.mha_reference(qt, kt, vt, causal=causal, return_lse=True)
    share, rtol = (2**-5, 2**-6) if dtype == torch.bfloat16 else (2**-10, 0.0)
    want = ref.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (out.float() - want).abs()
    assert bool((diff <= share * rms + rtol * want.abs()).all()), float(diff.max())
    assert float((lse - ref_lse).abs().max()) <= (1e-3 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_is_bitwise_deterministic(cuda_device, dtype):
    """Each output row is one block's fixed-order sum: two calls on the same
    inputs give bit-identical out and lse."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    qt, kt, vt = _qkv_views(gen, dtype, 2, 4, 1000, 1000, 128, "bshd", cuda_device)
    first = port.flash_attention(qt, kt, vt, causal=True, return_lse=True)
    second = port.flash_attention(qt, kt, vt, causal=True, return_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_kernel_launch_counter_moves_by_one_a_call(cuda_device):
    """``flash_attention.launches`` counts kernel launches: one per forward
    call, none for a backward (its kernels have their own counters)."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    qt, kt, vt = (x.requires_grad_() for x in
                  _qkv_views(gen, torch.bfloat16, 1, 2, 256, 256, 64, "bhsd", cuda_device))
    before = port.flash_attention.launches
    for n in range(1, 4):
        out = port.flash_attention(qt, kt, vt)
        assert port.flash_attention.launches == before + n
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert port.flash_attention.launches == before + 3


@pytest.mark.gpu
def test_failed_tensor_map_encode_raises(cuda_device, monkeypatch):
    """A TMA map that CUDA refuses (here q's row stride of 12 elements, 24
    bytes, planted past ``_kernel_operand``) makes the wrapper raise;
    nothing falls back to another path and the counter does not move."""
    q = torch.zeros(1, 1, 128, 64, device=cuda_device, dtype=torch.bfloat16)
    strides = port._strides
    monkeypatch.setattr(
        port, "_strides", lambda *xs: [12 if i == 2 else n for i, n in enumerate(strides(*xs))]
    )
    before = port.flash_attention.launches
    with pytest.raises(RuntimeError, match="did not encode"):
        port.flash_attention(q, q, q)
    assert port.flash_attention.launches == before


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 1, 64, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        port.flash_attention(q, q, q)
    h = torch.zeros(1, 1, 64, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        port.flash_attention(h, h, h)


@pytest.mark.gpu
def test_auto_dispatch_raises_on_a_head_dim_the_kernel_lacks(cuda_device):
    """``auto`` picks the kernel by sequence length alone, as the JAX
    dispatcher does; on the card a head dim the kernel lacks raises there
    instead of running the plain version."""
    q = torch.zeros(1, 1, 4096, 32, device=cuda_device, dtype=torch.bfloat16)
    assert port.auto_impl("cuda", 4096, 4096, 32, False) == "kernel"
    before = port.flash_attention.launches
    with pytest.raises(ValueError, match="head dims"):
        port.attention(q, q, q, impl="auto")
    assert port.flash_attention.launches == before


@pytest.mark.gpu
def test_vit_kernel_path_matches_reference_path(cuda_device):
    """A 2-block ViT at 1024 tokens (128 px, patch 4; head dim 64), where
    ``auto`` takes the kernel on the card: every block launches it once, and
    the logits agree with the same weights through the reference attention
    (bf16 bound as in chip_smoke.py's serve phase)."""
    kw = dict(depth=2, dim=128, heads=2, image_size=128, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    model = vit.ViT(**kw)
    model.init_weights(gen)
    reference = vit.ViT(**kw, attn_impl="reference")
    reference.load_state_dict(model.state_dict())
    model, reference = model.to(cuda_device), reference.to(cuda_device)
    x = torch.randn(4, 128, 128, 3, generator=gen).to(cuda_device)
    before = port.flash_attention.launches
    with torch.inference_mode():
        got = model(x)
        want = reference(x)
    torch.cuda.synchronize()
    assert port.flash_attention.launches == before + 2
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 3e-2 + 3e-2 * scale


def _row_share(got, want, rtol):
    """The least share of each row's rms under which ``got`` holds against
    ``want`` elementwise with ``rtol`` (a row: one query's or key's D values)."""
    w = want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float((((got.float() - w).abs() - rtol * w.abs()) / rms).max())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,b,h,s,d,causal,with_dlse",
    [
        (torch.bfloat16, 2, 4, 1024, 128, False, False),
        (torch.bfloat16, 1, 3, 130, 64, True, True),
        (torch.float32, 1, 2, 200, 128, True, True),
        (torch.float32, 2, 2, 77, 64, False, False),
        # the bf16 kernels' tile edges: S 1000 is a multiple of neither dq's
        # 128-key tiles nor dk/dv's 64-query tiles; causal S 257 at D 64 with
        # dlse (one row and one key past two tiles); one head at S 4096 (the
        # size-1 batch and head strides of the TMA maps)
        (torch.bfloat16, 2, 4, 1000, 128, False, False),
        (torch.bfloat16, 2, 2, 257, 64, True, True),
        (torch.bfloat16, 1, 1, 4096, 128, False, False),
    ],
)
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, b, h, s, d, causal, with_dlse):
    """dq (K3) and dk/dv (K4) against ``flash_attention_bwd_reference`` on
    the same forward residuals, (B, S, H, D) views read in place.  Bounds
    as in chip_smoke.py, where they are derived: per row, bf16 2^-5 of the
    row's rms plus 2^-6·|x| (one bf16 rounding of each gradient), fp32
    2^-10 of the rms (summation order only)."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v, do = (
        torch.randn(b, s, h, d, generator=gen, device=cuda_device).to(dtype)
        for _ in range(4)
    )
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = port.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    dlse = torch.randn(b, h, s, generator=gen, device=cuda_device) if with_dlse else None
    before = (port.flash_attention_dq.launches, port.flash_attention_dkv.launches)
    scale = d ** -0.5
    got = port.flash_attention_bwd(qt, kt, vt, out, lse, dot, dlse, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert (port.flash_attention_dq.launches, port.flash_attention_dkv.launches) == (
        before[0] + 1, before[1] + 1,
    )
    want = port.flash_attention_bwd_reference(
        qt, kt, vt, out, lse, dot, dlse, causal=causal, scale=scale
    )
    share, rtol = (2**-5, 2**-6) if dtype == torch.bfloat16 else (2**-10, 0.0)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (qt, kt, vt)):
        assert g.dtype == dtype and g.stride() == x.stride(), name  # layout kept
        assert bool(torch.isfinite(g).all()), name
        assert _row_share(g, w, rtol) <= share, (name, _row_share(g, w, rtol))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_backward_kernels_are_bitwise_deterministic(cuda_device, causal):
    """Each dq row and each dk/dv row is one block's fixed-order sum (no
    atomics): two calls on the same bf16 inputs give bit-identical dq, dk
    and dv."""
    gen = torch.Generator(device=cuda_device).manual_seed(9 + causal)
    q, k, v, do = (
        torch.randn(2, 1000, 4, 128, generator=gen, device=cuda_device).to(torch.bfloat16)
        for _ in range(4)
    )
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = port.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    dlse = torch.randn(2, 4, 1000, generator=gen, device=cuda_device)
    kw = dict(causal=causal, scale=128 ** -0.5)
    first = port.flash_attention_bwd(qt, kt, vt, out, lse, dot, dlse, **kw)
    second = port.flash_attention_bwd(qt, kt, vt, out, lse, dot, dlse, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def grad_errors(model, reference) -> dict[str, float]:
    """Each parameter gradient's relative L2 error against the reference
    model's.  ``k_proj.bias`` is the exception: its exact gradient is zero
    (softmax ignores a shift shared by a row's scores), so both paths hold
    rounding noise there, measured against the same block's
    ``k_proj.weight`` gradient instead."""
    ref = dict(reference.named_parameters())
    out = {}
    for name, p in model.named_parameters():
        r = ref[name].grad
        if name.endswith("k_proj.bias"):
            scale = ref[name.replace("bias", "weight")].grad.norm()
        else:
            scale = r.norm()
        out[name] = float((p.grad - r).norm() / scale.clamp_min(1e-30))
    return out


@pytest.mark.gpu
def test_vit_training_step_through_kernels_matches_reference(cuda_device):
    """A 2-block ViT at 1024 tokens (128 px, patch 4; head dim 64), bf16:
    loss.backward() through the kernels launches the forward, dq and dk/dv
    kernels once per block, and every parameter gradient agrees with the
    same weights through the reference attention within 2^-5 relative L2
    (the bound chip_smoke.py's train phase derives: the paths round P and
    ds to bf16 at different points, a 2^-9 relative difference carried
    through bf16 GEMMs)."""
    kw = dict(depth=2, dim=128, heads=2, image_size=128, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    model = vit.ViT(**kw)
    model.init_weights(gen)
    reference = vit.ViT(**kw, attn_impl="reference")
    reference.load_state_dict(model.state_dict())
    model, reference = model.to(cuda_device), reference.to(cuda_device)
    x = torch.randn(2, 128, 128, 3, generator=gen).to(cuda_device)
    labels = torch.tensor([3, 7], device=cuda_device)
    counters = (port.flash_attention, port.flash_attention_dq, port.flash_attention_dkv)
    before = [c.launches for c in counters]
    torch.nn.functional.cross_entropy(model(x), labels).backward()
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2, 2]
    torch.nn.functional.cross_entropy(reference(x), labels).backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    errors = grad_errors(model, reference)
    assert max(errors.values()) <= 2**-5, errors



def _block_params(dim, heads, gen, device):
    """A ``ViTBlock``'s parameters with non-trivial LayerNorm and biases."""
    params = {}
    for name, p in vit.ViTBlock(dim, heads).named_parameters():
        if p.dim() == 2:
            t = (torch.rand(p.shape, generator=gen) * 2 - 1) * (6.0 / sum(p.shape)) ** 0.5
        elif name.startswith("ln") and name.endswith("weight"):
            t = 1 + 0.1 * torch.randn(p.shape, generator=gen)
        else:
            t = 0.1 * torch.randn(p.shape, generator=gen)
        params[name] = t.to(device)
    return params


def _k5_counts():
    return [c.launches for c in (vb.fused_vit_block, vb.block_gemm, vb.block_attention)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,b,s,dim,heads",
    [
        (torch.bfloat16, 32, 256, 192, 3),
        (torch.float32, 32, 256, 192, 3),
        (torch.bfloat16, 3, 136, 128, 2),
    ],
)
def test_fused_block_chain_matches_plain_on_card(cuda_device, dtype, b, s, dim, heads):
    """The K5 chain against ``fused_vit_block_reference`` at the vit_tiny
    p2 serve shape (bf16 and fp32) and a ragged S, per row as in
    chip_smoke.py, where the bounds are derived: bf16 2^-5 of the row's rms
    plus 2^-6·|out|, fp32 2^-10 of the rms."""
    gen = torch.Generator().manual_seed(s)
    params = _block_params(dim, heads, gen, cuda_device)
    x = torch.randn(b, s, dim, generator=gen).to(device=cuda_device, dtype=dtype)
    before = _k5_counts()
    got = vb.fused_vit_block(x, params, heads=heads)
    torch.cuda.synchronize()
    assert [n - m for n, m in zip(_k5_counts(), before)] == [1, 4, 1]
    want = vb.fused_vit_block_reference(x, params, heads=heads)
    assert got.dtype == dtype and got.shape == x.shape and bool(torch.isfinite(got).all())
    share, rtol = (2**-5, 2**-6) if dtype == torch.bfloat16 else (2**-10, 0.0)
    assert _row_share(got, want, rtol) <= share, _row_share(got, want, rtol)


@pytest.mark.gpu
def test_fused_block_raises_on_what_the_kernels_do_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(1, 128, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):  # head dim 8
        vb.fused_vit_block(x, _block_params(32, 4, gen, cuda_device), heads=4)
    x = torch.zeros(1, 128, 256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 128"):  # head dim 256
        vb.fused_vit_block(x, _block_params(256, 1, gen, cuda_device), heads=1)
    x = torch.zeros(1, 128, 64, device=cuda_device, dtype=torch.bfloat16)
    params = _block_params(64, 2, gen, cuda_device)
    with pytest.raises(NotImplementedError, match="norm_dtype=None"):
        vb.fused_vit_block(x, params, heads=2, norm_f32=False)


@pytest.mark.gpu
def test_vit_fused_path_matches_composed_on_card(cuda_device):
    """A 2-block ViT at 256 tokens (32 px, patch 2) under inference mode:
    ``auto`` runs every block through the K5 chain, and the logits agree
    with the same weights through the composed reference path (the bf16
    bound of chip_smoke.py's serve_tiny phase)."""
    kw = dict(depth=2, dim=192, heads=3, patch=2, image_size=32, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    model = vit.ViT(**kw)
    model.init_weights(gen)
    reference = vit.ViT(**kw, attn_impl="reference")
    reference.load_state_dict(model.state_dict())
    model, reference = model.to(cuda_device), reference.to(cuda_device)
    x = torch.randn(8, 32, 32, 3, generator=gen).to(cuda_device)
    before = _k5_counts()
    with torch.inference_mode():
        got = model(x)
        want = reference(x)
    torch.cuda.synchronize()
    assert [n - m for n, m in zip(_k5_counts(), before)] == [2, 8, 2]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 3e-2 + 3e-2 * scale


def _k6_counts():
    return [c.launches for c in (vb.fused_vit_block, vb.fused_vit_block_bwd, vb.block_gemm,
                                 vb.block_attention, vb.block_attention_bwd)]


@pytest.mark.gpu
def test_vit_tiny_p2_train_step_on_card_fuses(cuda_device):
    """A ``vit_tiny --patch-size 2`` train step on the card under ``auto``
    runs every block's forward through K5 and its backward through K6 (12
    of each, no flash launch), and its gradients agree with the same
    weights through the composed path (``--block-fusion off``) within the
    bound chip_smoke.py's train_tiny phase derives for bf16: 2^-4 relative
    L2 per parameter, ``k_proj.bias`` against its weight's scale."""
    gen = torch.Generator().manual_seed(1)
    model = vit.ViTTiny(patch=2, dtype=torch.bfloat16)
    model.init_weights(gen)
    composed = vit.ViTTiny(patch=2, dtype=torch.bfloat16, block_fusion="off")
    composed.load_state_dict(model.state_dict())
    model, composed = model.to(cuda_device), composed.to(cuda_device)
    x = torch.randn(4, 32, 32, 3, generator=gen).to(cuda_device)
    labels = torch.tensor([1, 2, 3, 4], device=cuda_device)
    before, flash = _k6_counts(), port.flash_attention.launches
    torch.nn.functional.cross_entropy(model(x), labels).backward()
    torch.cuda.synchronize()
    assert [n - m for n, m in zip(_k6_counts(), before)] == [12, 12, 12 * 4 + 12 * 3, 24, 12]
    assert port.flash_attention.launches == flash
    torch.nn.functional.cross_entropy(composed(x), labels).backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    errors = grad_errors(model, composed)
    assert max(errors.values()) <= 2**-4, errors


# (dtype, B, S, dim, heads): chip_smoke.py's BWD_CASES at a batch the test
# file runs quickly, the train shape in bf16 and fp32, the window top, a
# ragged S with 2 heads
BWD_SHAPES = [
    (torch.bfloat16, 32, 256, 192, 3),
    (torch.float32, 8, 256, 192, 3),
    (torch.bfloat16, 2, 512, 192, 3),
    (torch.bfloat16, 3, 136, 128, 2),
]


def _leaf_errors(got, want):
    """max |got - want| / max |want| per gradient, ``k_proj.bias`` against
    ``k_proj.weight``'s scale (its exact gradient is zero)."""
    return {
        n: float((got[n] - w).abs().max()
                 / want["k_proj.weight" if n == "k_proj.bias" else n].abs().max())
        for n, w in want.items()
    }


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,s,dim,heads", BWD_SHAPES)
def test_fused_block_bwd_matches_plain_on_card(cuda_device, dtype, b, s, dim, heads):
    """The K6 chain against ``fused_vit_block_bwd_reference``, with the
    bounds chip_smoke.py derives (``BWD_CASES``): dx per row, bf16 2^-5 of
    the row's rms plus 2^-6·|dx|, fp32 2^-10 of the rms; each parameter
    gradient within 2^-7 (bf16) or 2^-14 (fp32) of its leaf's largest
    entry."""
    gen = torch.Generator().manual_seed(s + dim)
    params = _block_params(dim, heads, gen, cuda_device)
    x = torch.randn(b, s, dim, generator=gen).to(device=cuda_device, dtype=dtype)
    dy = torch.randn(b, s, dim, generator=gen).to(device=cuda_device, dtype=dtype)
    before = vb.fused_vit_block_bwd.launches
    dx, grads = vb.fused_vit_block_bwd(x, dy, params, heads=heads)
    torch.cuda.synchronize()
    assert vb.fused_vit_block_bwd.launches == before + 1
    want_dx, want = vb.fused_vit_block_bwd_reference(x, dy, params, heads=heads)
    assert dx.dtype == dtype and dx.shape == x.shape and bool(torch.isfinite(dx).all())
    share, rtol = (2**-5, 2**-6) if dtype == torch.bfloat16 else (2**-10, 0.0)
    assert _row_share(dx, want_dx, rtol) <= share, _row_share(dx, want_dx, rtol)
    errors = _leaf_errors(grads, want)
    assert max(errors.values()) <= (2**-7 if dtype == torch.bfloat16 else 2**-14), errors


@pytest.mark.gpu
def test_fused_block_bwd_is_bitwise_deterministic(cuda_device):
    """No atomics: two calls on the same inputs give bit-identical dx and
    gradients (the partials are summed over the row chunks in order)."""
    gen = torch.Generator().manual_seed(5)
    params = _block_params(192, 3, gen, cuda_device)
    x = torch.randn(16, 256, 192, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    dy = torch.randn(16, 256, 192, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    dx1, g1 = vb.fused_vit_block_bwd(x, dy, params, heads=3)
    dx2, g2 = vb.fused_vit_block_bwd(x, dy, params, heads=3)
    assert torch.equal(dx1, dx2)
    assert all(torch.equal(g1[n], g2[n]) for n in g1)


@pytest.mark.gpu
def test_fused_block_bwd_raises_on_what_the_kernels_do_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(1, 128, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):  # head dim 8
        vb.fused_vit_block_bwd(x, x, _block_params(32, 4, gen, cuda_device), heads=4)
    x = torch.zeros(1, 128, 64, device=cuda_device, dtype=torch.bfloat16)
    params = _block_params(64, 2, gen, cuda_device)
    with pytest.raises(NotImplementedError, match="norm_dtype=None"):
        vb.fused_vit_block_bwd(x, x, params, heads=2, norm_f32=False)
    with pytest.raises(ValueError, match="dy must match"):
        vb.fused_vit_block_bwd(x, x.float(), params, heads=2)
    h = x.half()
    with pytest.raises(ValueError, match="bf16 or fp32"):
        vb.block_ln(h.view(128, 64), params["ln_attn.weight"], params["ln_attn.bias"])


@pytest.mark.gpu
def test_fused_block_under_autograd_reaches_x_and_every_parameter(cuda_device):
    """The repaired fault: ``fused_vit_block`` under autograd on the card
    used to return an output with no autograd history.  Gradients now reach
    x and every parameter through K5 and K6, and agree with the composed
    ``ViTBlock`` on the same weights within 2^-4 relative L2 (bf16; the
    composed block's own attention backward rounds differently, as
    chip_smoke.py's train phase finds), ``k_proj.bias`` against its
    weight's scale."""
    gen = torch.Generator().manual_seed(9)
    composed = vit.ViTBlock(192, 3, dtype=torch.bfloat16, block_fusion="off").to(cuda_device)
    params = {n: p for n, p in composed.named_parameters()}
    x = torch.randn(8, 256, 192, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    dy = torch.randn(8, 256, 192, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    xf, xc = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = _k6_counts()
    out = vb.fused_vit_block(xf, params, heads=3)
    assert out.grad_fn is not None
    fused = torch.autograd.grad(out, (xf, *params.values()), dy)
    assert [n - m for n, m in zip(_k6_counts(), before)] == [1, 1, 7, 2, 1]
    want = torch.autograd.grad(composed(xc), (xc, *params.values()), dy)
    names = ["x", *params]
    scale = dict(zip(names, want))
    for name, g, w in zip(names, fused, want):
        assert g is not None and g.dtype == w.dtype and bool(torch.isfinite(g).all()), name
        ref = scale["k_proj.weight"] if name == "k_proj.bias" else w
        err = float((g.float() - w.float()).norm() / ref.float().norm())
        assert err <= 2**-4, (name, err)


# (B, S, dim, heads) of the fused block's bf16 attention kernels: the
# vit_tiny p2 paths (S 256, 3 heads of 64), a ragged S (136, 2 heads of 64)
# and the top of the gate's window (S 512, the keys split between two
# warpgroups)
ATTENTION_SHAPES = [(8, 256, 192, 3), (3, 136, 128, 2), (2, 512, 192, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,dim,heads", ATTENTION_SHAPES)
def test_block_attention_matches_plain_on_card(cuda_device, b, s, dim, heads):
    """``block_attention`` (bf16, ``block_attn_wgmma``) against
    ``packed_attention_reference`` per row, with chip_smoke.py's bf16 bound:
    both round P and the output at the same points, so 2^-5 of the row's
    rms plus 2^-6·|out|."""
    gen = torch.Generator().manual_seed(s + dim)
    qkv = torch.randn(b * s, 3 * dim, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    before = vb.block_attention.launches
    got = vb.block_attention(qkv, seq=s, heads=heads)
    torch.cuda.synchronize()
    assert vb.block_attention.launches == before + 1
    want = small.packed_attention_reference(qkv, seq=s, heads=heads)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _row_share(got, want, 2**-6) <= 2**-5, _row_share(got, want, 2**-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,dim,heads", ATTENTION_SHAPES)
def test_block_attention_bwd_matches_plain_on_card(cuda_device, b, s, dim, heads):
    """``block_attention_bwd`` (bf16, ``attn_dq_wgmma`` then
    ``attn_dkv_wgmma``) against ``packed_attention_bwd_reference``: dq, dk
    and dv each per row within 2^-5 of the row's rms plus 2^-6·|grad|, as
    chip_smoke.py holds each K6 stage (the same rounding points: P, dS and
    each gradient)."""
    gen = torch.Generator().manual_seed(s + dim + 1)
    qkv = torch.randn(b * s, 3 * dim, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    do = torch.randn(b * s, dim, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    before = vb.block_attention_bwd.launches
    got = vb.block_attention_bwd(qkv, do, seq=s, heads=heads)
    torch.cuda.synchronize()
    assert vb.block_attention_bwd.launches == before + 1
    want = small.packed_attention_bwd_reference(qkv, do, seq=s, heads=heads)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape and bool(torch.isfinite(got).all())
    for j, name in enumerate("qkv"):
        cols = slice(j * dim, (j + 1) * dim)
        share = _row_share(got[:, cols], want[:, cols], 2**-6)
        assert share <= 2**-5, (name, share)


@pytest.mark.gpu
def test_block_attention_bwd_is_bitwise_deterministic(cuda_device):
    """No atomics and every sum in a fixed order: two calls give
    bit-identical dqkv."""
    gen = torch.Generator().manual_seed(8)
    qkv = torch.randn(16 * 256, 576, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    do = torch.randn(16 * 256, 192, generator=gen).to(device=cuda_device, dtype=torch.bfloat16)
    first = vb.block_attention_bwd(qkv, do, seq=256, heads=3)
    assert torch.equal(first, vb.block_attention_bwd(qkv, do, seq=256, heads=3))


@pytest.mark.gpu
def test_block_attention_raises_on_a_bf16_head_dim_other_than_64(cuda_device):
    """bf16 takes head dim 64 only (the one fused zoo head dim); fp32 still
    takes head dim 32."""
    qkv = torch.zeros(2 * 128, 3 * 64, device=cuda_device, dtype=torch.bfloat16)
    do = torch.zeros(2 * 128, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 64 in bf16"):
        vb.block_attention(qkv, seq=128, heads=2)
    with pytest.raises(ValueError, match="head dim 64 in bf16"):
        vb.block_attention_bwd(qkv, do, seq=128, heads=2)
    got = vb.block_attention(qkv.float(), seq=128, heads=2)
    torch.cuda.synchronize()
    assert got.shape == (2 * 128, 64) and got.dtype == torch.float32


# The bf16 GEMM kernels of the fused block chains, launch by launch: (wrapper,
# M, K or out, N or in, weight segments, epilogue).  The vit_tiny p2 serve
# shape (bucket 32: 8192 rows) and train shape (batch 128: 32768 rows, 32
# weight-gradient chunks), a ragged M of 408 rows at dim 128, three weight
# segments of 48 rows (K 144 ends inside a 64-column chunk), K 768 and K
# 512, dim 1024's K 4096, 3072 and 1024 (slabs of 8, 16 and 32 columns),
# 64 weight-gradient input columns (its 64-column tile), every epilogue:
# LayerNorm, gelu, residual; dgrad modes 0 (rounded), 1 (gelu backward) and
# 2 (fp32); the weight gradient's fp32 and bf16 bias sources and a ragged
# last chunk.
GEMM_CASES = [
    ("block_gemm", 8192, 192, 576, 3, "ln"),
    ("block_gemm", 8192, 192, 192, 1, "residual"),
    ("block_gemm", 8192, 192, 768, 1, "ln_gelu"),
    ("block_gemm", 8192, 768, 192, 1, "residual"),
    ("block_gemm", 32768, 192, 576, 3, ""),
    ("block_gemm", 32768, 192, 768, 1, ""),
    ("block_gemm", 408, 128, 384, 3, "ln"),
    ("block_gemm", 408, 512, 128, 1, "residual"),
    ("block_gemm", 408, 128, 512, 1, "ln_gelu"),
    ("block_gemm", 408, 128, 144, 3, "ln"),
    ("block_gemm", 200, 4096, 1024, 1, "residual"),
    ("block_gemm_dgrad", 32768, 192, 768, 1, "gelu"),
    ("block_gemm_dgrad", 32768, 768, 192, 1, "f32"),
    ("block_gemm_dgrad", 32768, 192, 192, 1, ""),
    ("block_gemm_dgrad", 32768, 576, 192, 3, "f32"),
    ("block_gemm_dgrad", 408, 384, 128, 3, "f32"),
    ("block_gemm_dgrad", 408, 128, 512, 1, "gelu"),
    ("block_gemm_dgrad", 408, 512, 128, 1, ""),
    ("block_gemm_dgrad", 408, 144, 128, 3, "f32"),
    ("block_gemm_dgrad", 200, 3072, 1024, 3, ""),
    ("block_gemm_dgrad", 200, 1024, 512, 1, "gelu"),
    ("block_gemm_wgrad", 32768, 576, 192, 1, ""),
    ("block_gemm_wgrad", 32768, 192, 192, 1, "f32"),
    ("block_gemm_wgrad", 32768, 768, 192, 1, ""),
    ("block_gemm_wgrad", 32768, 192, 768, 1, ""),
    ("block_gemm_wgrad", 408, 384, 128, 1, ""),
    ("block_gemm_wgrad", 2100, 128, 512, 1, "f32"),
    ("block_gemm_wgrad", 408, 128, 64, 1, ""),
]


def _gemm_call(gen, device, name, m, k, n, segs, epilogue):
    """The wrapper's arguments for one GEMM_CASES case, seeded: (args,
    kwargs).  Weights xavier-uniform, LayerNorm scales near 1, biases and
    activations of the block's scale."""
    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(device)

    def xavier(rows, cols):
        limit = (6.0 / (rows + cols)) ** 0.5
        return ((torch.rand((rows, cols), generator=gen) * 2 - 1) * limit).to(device)

    bf = torch.bfloat16
    if name == "block_gemm":
        seg = n // segs
        kw = {}
        if "ln" in epilogue:
            kw["ln"] = (1 + randn(k, scale=0.1), randn(k, scale=0.1))
        if "gelu" in epilogue:
            kw["gelu"] = True
        if epilogue == "residual":
            kw["residual"] = randn(m, n).to(bf)
        args = (randn(m, k).to(bf), [xavier(seg, k) for _ in range(segs)],
                [randn(seg, scale=0.1) for _ in range(segs)])
        return args, kw
    if name == "block_gemm_dgrad":
        seg = k // segs
        kw = {"gelu_of": randn(m, n).to(bf)} if epilogue == "gelu" else {"out_f32": epilogue == "f32"}
        return (randn(m, k).to(bf), [xavier(seg, n) for _ in range(segs)]), kw
    g, a = randn(m, k).to(bf), randn(m, n).to(bf)
    return (g, a, randn(m, k) if epilogue == "f32" else g), {}


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,k,n,segs,epilogue", GEMM_CASES)
def test_block_gemm_kernels_match_plain_on_card(cuda_device, name, m, k, n, segs, epilogue):
    """Each bf16 GEMM kernel of the fused chains against its plain version
    on the same inputs, per row (a row: one output row's columns, or one
    weight-gradient partial row), within chip_smoke.py's bf16 tolerances:
    2^-5 of the row's rms plus 2^-6 of each value.  Both round at the same
    points; they differ by the fp32 summation order and the one-ulp flips
    of a rounding that order causes.  Each call launches its kernel once."""
    gen = torch.Generator().manual_seed(m + k + n)
    args, kw = _gemm_call(gen, cuda_device, name, m, k, n, segs, epilogue)
    wrapper, plain = getattr(vb, name), getattr(vb, f"{name}_reference")
    before = wrapper.launches
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain(*args, **kw)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    if name == "block_gemm_wgrad":
        assert got[0].shape == (-(-m // vb.WGRAD_CHUNK_ROWS), k, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _row_share(g, w, 2**-6) <= 2**-5, _row_share(g, w, 2**-6)


@pytest.mark.gpu
@pytest.mark.parametrize("slab", [32, 64])
def test_block_gemm_slabs_across_segment_edges(cuda_device, monkeypatch, slab):
    """Slabs that straddle the q/k/v segments: three segments of 48 rows
    (N 144, K 128, LayerNorm prologue, ragged M 408) through slabs of 32 or
    64 columns, forced (the width rule pads least and so takes 16, which
    divides 48).  Each slab row reads its own segment's weight and bias."""
    gen = torch.Generator().manual_seed(slab)
    args, kw = _gemm_call(gen, cuda_device, "block_gemm", 408, 128, 144, 3, "ln")
    monkeypatch.setattr(vb, "slab_width", lambda k, n: slab)
    got = vb.block_gemm(*args, **kw)
    torch.cuda.synchronize()
    want = vb.block_gemm_reference(*args, **kw)
    assert bool(torch.isfinite(got).all())
    assert _row_share(got, want, 2**-6) <= 2**-5, _row_share(got, want, 2**-6)


@pytest.mark.gpu
def test_block_gemm_wgrad_is_bitwise_deterministic(cuda_device):
    """No atomics: every partial and every bias column sum is one block's
    fixed-order sum, so two calls give bit-identical results."""
    gen = torch.Generator().manual_seed(11)
    args, _ = _gemm_call(gen, cuda_device, "block_gemm_wgrad", 32768, 192, 768, 1, "f32")
    first = vb.block_gemm_wgrad(*args)
    second = vb.block_gemm_wgrad(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ---------------------------------------------------- grouped expert FFN (K7-K9)

# (dtype, E, d, h, group counts, cap, padding rows): the vit_moe serve shape
# (bucket 32: n 2048, cap 320) with a skewed routing, a ragged fp32 case
# with an empty group, a group over capacity and a group ending at n, a
# bf16 case of 4 experts and hidden 256 with padding rows past starts[E],
# the serve shape at bucket 1 (n 64: every group under one tile, some over
# capacity), and a bf16 case whose second expert starts mid-tile with
# fewer than 64 kept rows (in the last two, a walk of one 64-row step
# leaves one CTA of the bf16 K9's 2-CTA cluster no rows)
MOE_CASES = [
    (torch.bfloat16, 8, 192, 768, (400, 100, 300, 0, 250, 320, 350, 328), 320, 0),
    (torch.float32, 8, 192, 768, (200, 0, 90, 130, 60, 170, 150, 200), 128, 0),
    (torch.bfloat16, 4, 192, 256, (70, 0, 130, 33), 64, 7),
    (torch.bfloat16, 8, 192, 768, (12, 9, 0, 15, 8, 7, 6, 7), 10, 0),
    (torch.bfloat16, 4, 192, 256, (90, 37, 0, 140), 128, 5),
]


def _moe_inputs(dtype, ne, d, h, counts, pad, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n = sum(counts) + pad
    starts = torch.tensor([0, *torch.tensor(counts).cumsum(0).tolist()], dtype=torch.int32)
    xs = torch.randn(n, d, generator=gen)
    xs[sum(counts):] = 0
    w1 = torch.randn(ne, d, h, generator=gen) / d**0.5
    b1 = 0.1 * torch.randn(ne, h, generator=gen)
    w2 = torch.randn(ne, h, d, generator=gen) / h**0.5
    b2 = 0.1 * torch.randn(ne, d, generator=gen)
    dy = torch.randn(n, d, generator=gen)
    cast = [t.to(device=device, dtype=dtype) for t in (xs, w1, b1, w2, b2, dy)]
    return (*cast[:5], starts.to(device), cast[5])


def _gmm_counts():
    return [f.launches for f in (gmm.grouped_ffn_fwd, gmm.grouped_ffn_dx, gmm.grouped_ffn_dw)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,ne,d,h,counts,cap,pad", MOE_CASES)
def test_grouped_ffn_kernels_match_plain_on_card(cuda_device, dtype, ne, d, h, counts, cap, pad):
    """K7 (output) and K8 (dx) against their plain versions per row:
    |kernel - plain| <= atol_share * rms(row) + rtol * |plain|, bf16 2^-5
    and 2^-6 (the same rounding points, fp32 sums in another order, and the
    rare one-ulp flip of a rounded intermediate that causes), fp32 2^-10 and
    0; the rows no expert keeps exactly 0.  K9's four gradients against
    theirs in relative L2, bf16 2^-7, fp32 2^-14.  One launch each."""
    _check_grouped_ffn(dtype, ne, d, h, counts, cap, pad, cuda_device)


def _check_grouped_ffn(dtype, ne, d, h, counts, cap, pad, device):
    xs, w1, b1, w2, b2, starts, dy = _moe_inputs(dtype, ne, d, h, counts, pad, device)
    n = xs.shape[0]
    share, rtol = (2**-5, 2**-6) if dtype == torch.bfloat16 else (2**-10, 0.0)
    before = _gmm_counts()
    out = gmm.grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap)
    dx = gmm.grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap)
    dws = gmm.grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_gmm_counts(), before)] == [1, 1, 1]
    kept = gmm.kept_mask(starts, cap, n)
    for got, want in ((out, gmm.grouped_ffn_reference(xs, w1, b1, w2, b2, starts, cap)),
                      (dx, gmm.grouped_ffn_dx_reference(xs, dy, w1, b1, w2, starts, cap))):
        assert bool((got[~kept] == 0).all())
        assert _row_share(got[kept], want[kept], rtol) <= share
    for got, want in zip(dws, gmm.grouped_ffn_dw_reference(xs, dy, w1, b1, w2, starts, cap)):
        assert got.dtype == torch.float32
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= (2**-7 if dtype == torch.bfloat16 else 2**-14), err


@pytest.mark.gpu
def test_grouped_ffn_forward_is_bitwise_deterministic(cuda_device):
    """K7 writes each output once, from one accumulator: two calls give
    bit-identical outputs."""
    xs, w1, b1, w2, b2, starts, _ = _moe_inputs(torch.bfloat16, *MOE_CASES[0][1:5], 0, cuda_device, seed=4)
    cap = MOE_CASES[0][5]
    first = gmm.grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap)
    second = gmm.grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_grouped_ffn_backward_is_bitwise_deterministic(cuda_device):
    """K8 and K9 sum in a fixed order with no atomics: two calls on the
    same inputs give bit-identical dx and weight gradients."""
    args = _moe_inputs(torch.bfloat16, *MOE_CASES[0][1:5], 0, cuda_device, seed=3)
    xs, w1, b1, w2, _, starts, dy = args
    cap = MOE_CASES[0][5]
    first = (gmm.grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap),
             *gmm.grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap))
    second = (gmm.grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap),
              *gmm.grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_grouped_ffn_raises_on_what_the_kernels_do_not_take(cuda_device):
    xs, w1, b1, w2, b2, starts, _ = _moe_inputs(torch.bfloat16, 4, 192, 256, (8, 8, 8, 8), 0, cuda_device)
    with pytest.raises(ValueError, match="d in"):
        gmm.grouped_ffn_fwd(xs[:, :48].contiguous(), w1[:, :48].contiguous(), b1,
                            w2[:, :, :48].contiguous(), b2[:, :48].contiguous(), starts, 16)
    with pytest.raises(ValueError, match="hidden a multiple"):
        gmm.grouped_ffn_fwd(xs, w1[:, :, :200].contiguous(), b1[:, :200].contiguous(),
                            w2[:, :200].contiguous(), b2, starts, 16)
    # bf16 walks the hidden dimension in 64-column chunks, fp32 in 32
    with pytest.raises(ValueError, match="hidden a multiple of 64"):
        gmm.grouped_ffn_fwd(xs, w1[:, :, :96].contiguous(), b1[:, :96].contiguous(),
                            w2[:, :96].contiguous(), b2, starts, 16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        gmm.grouped_ffn_fwd(xs.half(), w1, b1, w2, b2, starts, 16)
    with pytest.raises(ValueError, match="int32"):
        gmm.grouped_ffn_fwd(xs, w1, b1, w2, b2, starts.long(), 16)
    with pytest.raises(ValueError, match="w2 must be"):
        gmm.grouped_ffn_fwd(xs, w1, b1, w2.float(), b2, starts, 16)


@pytest.mark.gpu
def test_vit_moe_gmm_step_matches_gather_on_card(cuda_device):
    """A bf16 ``vit_moe`` (full width, 2 blocks) on one batch of 32: one
    train step's loss and gradients through K7-K9 (``gmm``) against the
    same weights through ``gather`` (cuBLAS batched GEMMs), which route the
    same tokens; the loss within 2^-6 relative, the gradients within 2^-4
    relative L2 per parameter (bf16 rounding at other points in two
    blocks; ``k_proj.bias``, whose exact gradient is 0, against its
    weight's scale).  Each MoE block launches K7 once a forward and K8 and
    K9 once a backward."""
    from distributed_training_comparison_tpu_torch.models import get_model
    from distributed_training_comparison_tpu_torch.train import forward_backward

    torch.manual_seed(0)
    models = {d: get_model("vit_moe", depth=2, dtype=torch.bfloat16, moe_dispatch=d)
              for d in ("gmm", "gather")}
    models["gather"].load_state_dict(models["gmm"].state_dict())
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (32, 32, 32, 3), generator=gen, dtype=torch.uint8).to(cuda_device)
    labels = torch.randint(0, 100, (32,), generator=gen).to(cuda_device)
    out = {}
    for d, m in models.items():
        m.to(cuda_device)
        before = _gmm_counts()
        loss, _, extras = forward_backward(m, images, labels, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        counts = [a - b for a, b in zip(_gmm_counts(), before)]
        assert counts == ([2, 2, 2] if d == "gmm" else [0, 0, 0]), (d, counts)
        assert set(extras) == {"moe_dropped_frac", "moe_load_max"}
        out[d] = (float(loss), {n: p.grad.float() for n, p in m.named_parameters()})
    assert abs(out["gmm"][0] - out["gather"][0]) <= 2**-6 * abs(out["gather"][0])
    ref = out["gather"][1]
    for name, g in out["gmm"][1].items():
        scale = ref[name.replace("bias", "weight") if name.endswith("k_proj.bias") else name]
        err = float((g - ref[name]).norm() / scale.norm().clamp_min(1e-30))
        assert err <= 2**-4, (name, err)


# (dtype, B, S, H, D, causal): vit_tiny's serve bucket and train batch at 64
# tokens, a ragged causal S of 24, a multi-tile S of 256 at head dim 128;
# and for the bf16 one-tile kernels (S <= 64) the tile at head dim 128, the
# smallest tile (S 8) and a ragged S of 40 without the causal mask
SMALL_CASES = [
    (torch.bfloat16, 32, 64, 3, 64, False),
    (torch.float32, 16, 64, 3, 64, True),
    (torch.bfloat16, 6, 24, 2, 64, True),
    (torch.bfloat16, 4, 256, 2, 128, True),
    (torch.float32, 2, 256, 2, 128, False),
    (torch.bfloat16, 8, 64, 2, 128, True),
    (torch.bfloat16, 16, 8, 3, 64, False),
    (torch.bfloat16, 6, 40, 3, 64, False),
]


def _packed_qkvdo(gen, b, s, h, d, dtype, device):
    return [torch.randn(b * s, h * d, generator=gen).to(device=device, dtype=dtype)
            for _ in range(4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,s,h,d,causal", SMALL_CASES)
def test_small_mha_kernels_match_plain_on_card(cuda_device, dtype, b, s, h, d, causal):
    """K10 and K11 against ``small_mha_reference`` and
    ``small_mha_bwd_reference`` per row (one token's D values of one head),
    with the flash kernels' bounds from chip_smoke.py: bf16 2^-5 of the
    row's rms plus 2^-6·|x| (the same rounding points; a summation-order
    flip of one P or ds rounding, and each result's own rounding), fp32
    2^-10 of the rms (summation order and expf only)."""
    gen = torch.Generator().manual_seed(b * s + d)
    q, k, v, do = _packed_qkvdo(gen, b, s, h, d, dtype, cuda_device)
    kw = dict(seq=s, heads=h, causal=causal)
    before = (small.small_mha_fwd.launches, small.small_mha_bwd.launches)
    out = small.small_mha_fwd(q, k, v, **kw)
    grads = small.small_mha_bwd(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert (small.small_mha_fwd.launches, small.small_mha_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    unpack = [x.view(b, s, h, d) for x in (q, k, v, do)]
    want = [small.small_mha_reference(*unpack[:3], causal=causal),
            *small.small_mha_bwd_reference(*unpack, causal=causal)]
    share, rtol = (2**-5, 2**-6) if dtype == torch.bfloat16 else (2**-10, 0.0)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), want):
        assert got.dtype == dtype and got.shape == q.shape, name
        assert bool(torch.isfinite(got).all()), name
        got = got.view(b, s, h, d)
        assert _row_share(got, ref, rtol) <= share, (name, _row_share(got, ref, rtol))


@pytest.mark.gpu
def test_small_mha_backward_is_bitwise_deterministic(cuda_device):
    """No atomics in K11: two calls give bit-identical dq, dk and dv."""
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = _packed_qkvdo(gen, 64, 64, 3, 64, torch.bfloat16, cuda_device)
    first = small.small_mha_bwd(q, k, v, do, seq=64, heads=3, causal=True)
    second = small.small_mha_bwd(q, k, v, do, seq=64, heads=3, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_small_mha_backward_is_one_kernel_at_one_tile(cuda_device):
    """bf16 at S 64: one ``small_mha_bwd`` call runs exactly one kernel on
    the card, ``attn_small_bwd_onetile``, by torch.profiler's kernel names
    (the tracer now and then delivers no device event for so short a run:
    it is taken again, at most three times, as chip_smoke.py does)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(5)
    q, k, v, do = _packed_qkvdo(gen, 32, 64, 3, 64, torch.bfloat16, cuda_device)
    small.small_mha_bwd(q, k, v, do, seq=64, heads=3)  # builds and loads outside the trace
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            small.small_mha_bwd(q, k, v, do, seq=64, heads=3)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "attn_small_bwd_onetile" in kernels[0], kernels


@pytest.mark.gpu
def test_small_mha_raises_on_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 64, 3, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        small.small_mha(q, q, q)
    h = torch.zeros(2, 64, 3, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        small.small_mha(h, h, h)
    x = torch.zeros(128, 192, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):  # mixed dtypes
        small.small_mha_bwd(x, x, x, x.float(), seq=64, heads=3)


@pytest.mark.gpu
def test_fused_small_reaches_q_k_v_under_autograd(cuda_device):
    """``attention(impl="fused_small")`` on the card: K10 forward, and K11
    under autograd, whose gradients reach q, k and v (projections seen as
    (B, S, H, D), as the ViT block hands them over) and agree with the
    plain backward within the bf16 row bound above."""
    gen = torch.Generator().manual_seed(4)
    b, s, h, d = 8, 64, 3, 64
    q, k, v, do = (x.view(b, s, h, d) for x in
                   _packed_qkvdo(gen, b, s, h, d, torch.bfloat16, cuda_device))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (small.small_mha_fwd.launches, small.small_mha_bwd.launches)
    out = port.attention(*leaves, impl="fused_small", layout="bshd")
    out.backward(do)
    torch.cuda.synchronize()
    assert (small.small_mha_fwd.launches, small.small_mha_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = small.small_mha_bwd_reference(q, k, v, do)
    for leaf, ref in zip(leaves, want):
        assert leaf.grad is not None and leaf.grad.shape == leaf.shape
        assert _row_share(leaf.grad, ref, 2**-6) <= 2**-5
