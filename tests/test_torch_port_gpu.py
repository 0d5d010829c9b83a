"""The port's CUDA kernels on the card (``gpu`` marker).

These tests need an NVIDIA Hopper card: the CUDA kernels have no
interpret mode.  Each skips inside its fixture where
``torch.cuda.is_available()`` is false.  The file imports no JAX, so it
also runs where JAX is not installed; there, skip ``tests/conftest.py``
(which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import importlib

import pytest
import torch

port = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention")
vit = importlib.import_module("distributed_training_comparison_tpu_torch.models.vit")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    # the plain versions are held in true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype,b,h,s,d,causal",
    [
        (torch.bfloat16, 2, 4, 1024, 128, False),
        (torch.bfloat16, 1, 3, 130, 64, True),
        (torch.float32, 1, 2, 200, 128, True),
        (torch.float32, 2, 2, 77, 64, False),
    ],
)
def test_kernel_matches_reference_on_card(cuda_device, dtype, b, h, s, d, causal):
    """Tolerances as in chip_smoke.py, where they are derived: out within
    atol_share · rms(row) + rtol · |out| per element, a row being one
    query's D outputs; bf16 2^-5 and 2^-6 (P and out rounded to bf16),
    lse 1e-3; fp32 2^-10 and 0, lse 1e-4."""
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    q, k, v = (
        torch.randn(b, s, h, d, generator=gen, device=cuda_device).to(dtype)
        for _ in range(3)
    )
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    before = port.flash_attention.launches
    out, lse = port.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert port.flash_attention.launches == before + 1
    assert out.shape == qt.shape and out.stride() == qt.stride()  # layout kept
    ref, ref_lse = port.mha_reference(q, k, v, causal=causal, return_lse=True, layout="bshd")
    share, rtol = (2**-5, 2**-6) if dtype == torch.bfloat16 else (2**-10, 0.0)
    want = ref.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (out.transpose(1, 2).float() - want).abs()
    assert bool((diff <= share * rms + rtol * want.abs()).all()), float(diff.max())
    assert float((lse - ref_lse).abs().max()) <= (1e-3 if dtype == torch.bfloat16 else 1e-4)


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
