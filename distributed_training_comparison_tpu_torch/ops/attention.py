"""Multi-head attention: the plain PyTorch version, the CUDA flash-attention
forward, and the dispatcher between them.

Counterpart of ``distributed_training_comparison_tpu/ops/attention.py``.
``mha_reference`` has that module's semantics exactly (einsum forms, fp32
scores and softmax, P rounded to the value dtype before P·V, the causal
offset rule, ``lse`` as (B, H, Sq)).  ``flash_attention`` replaces the
Pallas forward kernels ``_fwd_kernel`` and ``_fwd_kernel_tiled`` with one
CUDA kernel (``csrc/flash_attention_fwd.cu``): a tensor on the CPU goes to
``mha_reference``, a tensor on the card goes to the kernel or raises.

The TPU artefacts are gone: no head-dim pad to 128, no (bh, S, 8) lse stub
dimension, no sequence padding (the kernel masks the true key length).  The
kernel has no backward yet, so the port's attention is inference-only.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30  # finite "-inf": keeps fully-masked rows NaN-free
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
    return_lse: bool = False,
    layout: str = "bhsd",
):
    """Plain attention with the softmax in fp32: the plain version the
    kernel is held against.

    ``layout`` is ``"bhsd"`` (B, H, S, D) or ``"bshd"`` (B, S, H, D).
    Scores are the fp32 product of the input-dtype values (a product of two
    bf16 values is exact in fp32, so upcasting first is the same arithmetic
    as a bf16 matmul with fp32 accumulation).  ``return_lse=True`` also
    returns the per-row log-sum-exp of the scaled scores, (B, H, Sq) fp32.
    """
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown attention layout {layout!r}")
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    seq_ax = -3 if layout == "bshd" else -2
    sq, skv = q.shape[seq_ax], k.shape[seq_ax]
    if layout == "bshd":
        score_eq, out_eq = "bqhd,bkhd->bqhk", "bqhk,bkhd->bqhd"
    else:
        score_eq, out_eq = "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd"
    s = torch.einsum(score_eq, q.float(), k.float()) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        mask = rows >= torch.arange(skv, device=q.device)[None, :]
        if layout == "bshd":
            mask = mask[:, None, :]  # broadcast over the h axis of (q, h, k)
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum(out_eq, p.to(v.dtype).float(), v.float()).to(q.dtype)
    if return_lse:
        lse = torch.logsumexp(s, dim=-1)
        if layout == "bshd":
            lse = lse.transpose(1, 2)  # (b, q, h) → (B, H, S)
        return out, lse.contiguous()
    return out


def _c_args() -> list:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return [ptr] * 5 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, i32, i32, ptr]


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel reads it: unit stride over D, the other strides
    whole 16-byte rows and a 16-byte aligned base (its vector copies need
    both).  A strided view that already meets that is passed as it is."""
    item = x.element_size()
    if (
        x.stride(-1) != 1
        or any(s * item % 16 for s in x.stride()[:3])
        or x.data_ptr() % 16
    ):
        x = x.contiguous()
    return x


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    from . import _build

    b, h, sq, d = q.shape
    skv = k.shape[2]
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel takes bf16 or fp32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}"
        )
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"q/k/v shapes disagree: {q.shape}, {k.shape}, {v.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if sq == 0 or skv == 0:
        raise ValueError("flash_attention needs non-empty sequences")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty_like(q)  # a dense strided view keeps its layout
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    lib = _build.load("flash_attention_fwd", _c_args())
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, h, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Flash attention forward over (B, H, S, D).

    On the card this launches the CUDA kernel (bf16 or fp32, head dim 64 or
    128) and raises on anything it does not take; strided views (such as the
    (B, S, H, D) projections seen as (B, H, S, D)) are read in place and the
    output keeps the input's layout.  A CPU tensor takes ``mha_reference``.
    ``flash_attention.launches`` counts the kernel's launches.
    """
    sq, skv = q.shape[2], k.shape[2]
    if causal and sq != skv:
        raise ValueError("causal flash attention requires q_len == kv_len")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, scale=scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    out, lse = _flash_fwd_cuda(q, k, v, causal, scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def auto_impl(
    device_type: str, q_len: int, kv_len: int, head_dim: int, causal: bool
) -> str:
    """``attention(impl="auto")``'s choice, as a pure function.

    The JAX package's predicate with "on TPU" read as "on the card": the
    kernel for square-or-non-causal attention at ``S >= 512`` (head dim
    >= 128) or ``S >= 1024`` (smaller heads), the reference otherwise.
    Those crossovers were measured on the TPU; they stand here until the
    kernel's own crossover is measured on the H100.  The head dim does not
    enter the choice: a head dim the kernel does not take raises there.
    """
    kernel_ok = not causal or q_len == kv_len
    min_seq = 512 if head_dim >= 128 else 1024
    if device_type == "cuda" and kernel_ok and q_len >= min_seq:
        return "kernel"
    return "reference"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
    impl: str = "auto",
    return_lse: bool = False,
    layout: str = "bhsd",
):
    """Dispatch between the kernel and ``mha_reference``.

    ``impl``: ``"auto"`` (:func:`auto_impl`), ``"kernel"`` (``"pallas"`` is
    kept as an alias), or ``"reference"``.  The sequence-parallel and
    short-sequence implementations of the JAX package are not ported yet.
    ``layout="bshd"`` takes (B, S, H, D): the kernel reads it through a
    transposed view, with no copy."""
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown attention layout {layout!r}")
    seq_ax = 1 if layout == "bshd" else 2
    kind = impl.partition(":")[0]
    if kind in ("ring", "ulysses", "fused_small"):
        raise NotImplementedError(
            f"attention(impl={impl!r}) is not ported yet (ROADMAP.md, queue 1)"
        )
    if impl == "auto":
        impl = auto_impl(
            q.device.type, q.shape[seq_ax], k.shape[seq_ax], q.shape[-1], causal
        )
    if impl in ("kernel", "pallas"):

        def to_bhsd(x):
            return x.transpose(1, 2) if layout == "bshd" else x

        out = flash_attention(
            to_bhsd(q), to_bhsd(k), to_bhsd(v),
            causal=causal, scale=scale, return_lse=return_lse,
        )
        if return_lse:
            return to_bhsd(out[0]), out[1]
        return to_bhsd(out)
    if impl == "reference":
        return mha_reference(
            q, k, v, causal=causal, scale=scale, return_lse=return_lse, layout=layout
        )
    raise ValueError(f"unknown attention impl {impl!r}")
