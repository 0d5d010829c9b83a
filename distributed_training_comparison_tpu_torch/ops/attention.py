"""Multi-head attention: the plain PyTorch version, the CUDA flash-attention
forward and backward, and the dispatcher between them.

Counterpart of ``distributed_training_comparison_tpu/ops/attention.py``.
``mha_reference`` has that module's semantics exactly (einsum forms, fp32
scores and softmax, P rounded to the value dtype before P·V, the causal
offset rule, ``lse`` as (B, H, Sq)).  ``flash_attention`` replaces the
Pallas forward kernels ``_fwd_kernel`` and ``_fwd_kernel_tiled`` with one
CUDA kernel (``csrc/flash_attention_fwd.cu``): a tensor on the CPU goes to
``mha_reference``, a tensor on the card goes to the kernel or raises.

The backward replaces the Pallas kernels ``_dq_kernel`` (K3) and
``_dkv_kernel`` (K4) with two CUDA kernels (``csrc/flash_attention_bwd.cu``)
behind a ``torch.autograd.Function`` that, like the JAX package's
``_flash_core`` custom VJP, differentiates through both ``out`` and ``lse``;
``flash_attention_bwd_reference`` is their plain version.

The TPU artefacts are gone: no head-dim pad to 128, no (bh, S, 8) lse stub
dimension, no sequence padding (the kernels mask the true lengths).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .attention_small import small_mha

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


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    dlse: torch.Tensor | None,
    *,
    causal: bool,
    scale: float,
):
    """Plain flash-attention backward over (B, H, S, D): the plain version
    the backward kernels are held against, and the CPU path of
    :func:`flash_attention`'s gradient.  Returns ``(dq, dk, dv)``.

    The JAX package's ``_flash_bwd`` arithmetic: ``p = exp(s - lse)`` from
    fp32 scores; ``p`` rounded to ``do``'s dtype for ``dv = pᵀ·do``;
    ``ds = p·(do·vᵀ + (dlse - delta))·scale`` with ``delta = rowsum(do∘out)``
    in fp32, rounded to the input dtype for ``dq = ds·k`` and ``dk = dsᵀ·q``;
    products accumulate in fp32 and each gradient is rounded once to its
    input's dtype.  Causal pairs above the diagonal take ``p = 0``; the key
    length is the true one (nothing here is padded, so no other mask
    applies).  ``dlse=None`` is a zero lse cotangent.
    """
    adj = _row_adjustment(out, do, dlse)
    return _bwd_plain(q, k, v, do, lse, adj, causal=causal, scale=scale)


def _row_adjustment(out, do, dlse) -> torch.Tensor:
    """``dlse - delta`` with ``delta = rowsum(do∘out)``, fp32 (B, H, Sq)."""
    delta = (do.float() * out.float()).sum(-1)
    return -delta if dlse is None else dlse.float() - delta


def _bwd_plain(q, k, v, do, lse, adj, *, causal: bool, scale: float):
    sq, skv = q.shape[2], k.shape[2]
    f32 = torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32)) * scale
    p = torch.exp(s - lse.to(f32)[..., None])
    del s
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        p = torch.where(rows >= torch.arange(skv, device=q.device)[None, :], p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).to(f32), do.to(f32)).to(v.dtype)
    ds = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), v.to(f32))
    ds = (p * (ds + adj.to(f32)[..., None]) * scale).to(q.dtype).to(f32)
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(f32)).to(q.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f32)).to(k.dtype)
    return dq, dk, dv


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels read it: unit stride over D, the other strides
    whole 16-byte rows and a 16-byte aligned base (their vector copies and
    the bf16 forward's TMA maps need both).  A dimension of size 1 is never
    stepped, so its stride does not count.  A strided view that already
    meets that is passed as it is; anything else is copied, a contiguous
    tensor with an unaligned base too."""
    item = x.element_size()
    if (
        x.stride(-1) != 1
        or any(s * item % 16 for n, s in zip(x.shape[:3], x.stride()[:3]) if n > 1)
        or x.data_ptr() % 16
    ):
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def _check_kernel_operands(q, k, v, *more) -> None:
    """Raise on what the CUDA kernels do not take: a dtype other than bf16
    or fp32, mixed dtypes, a head dim other than 64 or 128, shapes that
    disagree, tensors on several devices, empty sequences."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    tensors = (q, k, v, *more)
    if q.dtype not in KERNEL_DTYPES or any(x.dtype != q.dtype for x in tensors):
        raise ValueError(
            "flash_attention kernels take bf16 or fp32 tensors of one dtype, got "
            + "/".join(str(x.dtype) for x in tensors)
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernels take head dims {KERNEL_HEAD_DIMS}, got {d}"
        )
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"q/k/v shapes disagree: {q.shape}, {k.shape}, {v.shape}")
    if any(x.shape != q.shape for x in more):
        raise ValueError(f"out/do shapes {[x.shape for x in more]} differ from q {q.shape}")
    if any(x.device != q.device for x in tensors):
        raise ValueError("flash_attention tensors must be on one device")
    if sq == 0 or skv == 0:
        raise ValueError("flash_attention needs non-empty sequences")


def _strides(*tensors) -> list[int]:
    return [s for x in tensors for s in x.stride()[:3]]


def _row_stats(lse: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    b, h, sq = like.shape[:3]
    if lse.shape != (b, h, sq):
        raise ValueError(f"row statistics must be {(b, h, sq)}, got {tuple(lse.shape)}")
    return lse.to(device=like.device, dtype=torch.float32).contiguous()


def _fwd_c_args() -> list:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return [ptr] * 5 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, i32, i32, ptr]


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    from . import _build

    _check_kernel_operands(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty_like(q)  # a dense strided view keeps its layout
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    fn = _build.load("flash_attention_fwd", _fwd_c_args())
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, h, sq, skv, d, *_strides(q, k, v, out),
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err < 0:
        raise RuntimeError(f"flash_attention_fwd: a TMA tensor map did not encode: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def _bwd_c_args(n_out: int) -> list:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    n = 6 + n_out
    return [ptr] * n + [i32] * 5 + [i64] * (3 * (4 + n_out)) + [ctypes.c_float, i32, i32, ptr]


def _bwd_operands(q, k, v, do, lse, adj):
    _check_kernel_operands(q, k, v, do)
    q, k, v, do = (_kernel_operand(x) for x in (q, k, v, do))
    return q, k, v, do, _row_stats(lse, q), _row_stats(adj, q)


def flash_attention_dq(q, k, v, do, lse, adj, *, causal: bool, scale: float):
    """dq of flash attention: the CUDA kernel ``flash_bwd_dq`` (K3).

    (B, H, S, D) bf16 or fp32 views of one dtype; ``lse`` is the forward's
    (B, H, Sq) fp32 log-sum-exp and ``adj = dlse - rowsum(do∘out)``, fp32.
    ``dq`` is allocated in ``q``'s layout.  ``flash_attention_dq.launches``
    counts the kernel's launches.  A CPU tensor takes the plain version.
    """
    from . import _build

    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, adj, causal=causal, scale=scale)[0]
    q, k, v, do, lse, adj = _bwd_operands(q, k, v, do, lse, adj)
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    fn = _build.load("flash_attention_bwd", _bwd_c_args(1), symbol="flash_attention_bwd_dq")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), adj.data_ptr(), dq.data_ptr(),
            b, h, sq, k.shape[2], d, *_strides(q, k, v, do, dq),
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA error {err}")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, adj, *, causal: bool, scale: float):
    """dk and dv of flash attention: the CUDA kernel ``flash_bwd_dkv`` (K4),
    with :func:`flash_attention_dq`'s arguments.  ``dk``/``dv`` are
    allocated in the layouts of ``k``/``v``.  ``flash_attention_dkv.launches``
    counts the kernel's launches.  A CPU tensor takes the plain version."""
    from . import _build

    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, adj, causal=causal, scale=scale)[1:]
    q, k, v, do, lse, adj = _bwd_operands(q, k, v, do, lse, adj)
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.load("flash_attention_bwd", _bwd_c_args(2), symbol="flash_attention_bwd_dkv")
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), adj.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, k.shape[2], d, *_strides(q, k, v, do, dk, dv),
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA error {err}")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, dlse, *, causal: bool, scale: float):
    """(dq, dk, dv) of flash attention.  On the card: the row terms
    ``adj = dlse - rowsum(do∘out)`` in fp32 (a torch op, as the JAX package
    computes ``delta`` outside its kernels), then the dq kernel and the
    dk/dv kernel.  A CPU tensor takes :func:`flash_attention_bwd_reference`."""
    adj = _row_adjustment(out, do, dlse)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, adj, causal=causal, scale=scale)
    dq = flash_attention_dq(q, k, v, do, lse, adj, causal=causal, scale=scale)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, adj, causal=causal, scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``(out, lse)`` of flash attention with both outputs differentiable
    (the JAX package's ``_flash_core`` custom VJP): the lse cotangent folds
    into the backward as ``p·dlse``.  Saves q, k, v, out and lse; a CUDA
    tensor runs the kernels, a CPU tensor their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cpu":
            out, lse = mha_reference(q, k, v, causal=causal, scale=scale, return_lse=True)
        else:
            out, lse = _flash_fwd_cuda(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)  # an unused lse passes None, not zeros
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, dlse, causal=ctx.causal, scale=ctx.scale
        )
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Flash attention over (B, H, S, D), differentiable in q, k, v and
    through both outputs.

    On the card the forward launches the CUDA kernel (bf16 or fp32, head
    dim 64 or 128) and the backward the dq and dk/dv kernels, raising on
    anything they do not take; strided views (such as the (B, S, H, D)
    projections seen as (B, H, S, D)) are read in place, and the output and
    gradients keep their inputs' layouts.  A CPU tensor takes the plain
    versions, ``mha_reference`` and :func:`flash_attention_bwd_reference`.
    ``flash_attention.launches`` counts the forward kernel's launches.
    """
    sq, skv = q.shape[2], k.shape[2]
    if causal and sq != skv:
        raise ValueError("causal flash attention requires q_len == kv_len")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    out, lse = _FlashAttention.apply(q, k, v, causal, scale)
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
    """Dispatch between the kernels and ``mha_reference``.

    ``impl``: ``"auto"`` (:func:`auto_impl`), ``"kernel"`` (``"pallas"`` is
    kept as an alias), ``"reference"``, or ``"fused_small"``: the
    short-sequence kernels (``attention_small.small_mha``, K10 and K11),
    ``bshd`` only and without lse, which ``auto`` never selects, as in the
    JAX package.  The sequence-parallel implementations of the JAX package
    are not ported yet.  ``layout="bshd"`` takes (B, S, H, D): the flash
    kernel reads it through a transposed view, the short-sequence kernels
    as packed rows, with no copy."""
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown attention layout {layout!r}")
    seq_ax = 1 if layout == "bshd" else 2
    kind = impl.partition(":")[0]
    if kind in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention(impl={impl!r}) is not ported yet (ROADMAP.md, queue 1)"
        )
    if impl == "auto":
        impl = auto_impl(
            q.device.type, q.shape[seq_ax], k.shape[seq_ax], q.shape[-1], causal
        )
    if impl == "fused_small":
        if return_lse:
            raise ValueError("impl='fused_small' does not return lse")
        if layout != "bshd":
            raise ValueError("impl='fused_small' requires layout='bshd'")
        return small_mha(q, k, v, causal=causal, scale=scale)
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
