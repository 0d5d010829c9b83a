"""The fused pre-LN ViT block forward: the plain PyTorch version and the
CUDA kernel chain that replaces the Pallas kernel
``distributed_training_comparison_tpu/ops/vit_block.py::_block_fwd_kernel``
(K5).

One block is

    x ── LN₁ ── qkv GEMM ── MHA ── out-proj ──(+x)── LN₂ ── up GEMM ── gelu ── down GEMM ──(+r1)── out

with the TPU kernel's numerics: LayerNorm statistics in fp32 as
var = E[x²] − μ², eps 1e-6, γ/β applied in fp32 before the cast to the
compute dtype; every GEMM accumulates in fp32, rounds to the compute dtype
and then adds the bias in the compute dtype; the tanh gelu; the residual
adds in the compute dtype; attention as ``ops/attention_small.py``.

The TPU kernel keeps a 512-row tile and every block weight in VMEM.  On
Hopper neither fits in a block's 227 KB of shared memory, so K5 is a chain
of two CUDA kernels (``csrc/vit_block_fwd.cu``): ``block_gemm``, launched
four times per block (LN₁ + qkv, out-proj + bias + x, LN₂ + up + gelu,
down + bias + r1), and ``block_attention``, once.  The GEMMs read the fp32
parameters and round them to the compute dtype as they stage them, which
is the arithmetic of casting first, with no cast kernel per call; the q, k
and v projections are read as three weight pointers, not concatenated.

A CPU tensor takes the plain versions (:func:`fused_vit_block_reference`,
:func:`block_gemm_reference`, ``attention_small.packed_attention_reference``);
a CUDA tensor launches the kernels or raises.  Each wrapper counts its
launches in a plain-int ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

from .attention_small import packed_attention_reference

LN_EPS = 1e-6
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 128  # head dims: multiples of 16 up to this
MAX_DIM = 1024
QKV = ("q_proj", "k_proj", "v_proj")


def _ln_fwd(x, gamma, beta, norm_f32: bool) -> torch.Tensor:
    """The TPU kernel's LayerNorm: statistics in fp32 (``norm_f32``) or in
    the compute dtype, var = E[x²] − μ²; the result in ``x``'s dtype."""
    xs = x.float() if norm_f32 else x
    mu = xs.mean(-1, keepdim=True)
    var = (xs * xs).mean(-1, keepdim=True) - mu * mu
    xhat = (xs - mu) * torch.rsqrt(var + LN_EPS)
    return (xhat * gamma + beta).to(x.dtype)


def block_gemm_reference(
    a: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    ln: tuple[torch.Tensor, torch.Tensor] | None = None,
    norm_f32: bool = True,
    gelu: bool = False,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """``epilogue(prologue(a) · Wᵀ)``: the plain version of ``block_gemm``.

    ``a`` is (M, K) in the compute dtype; ``weights`` one or more (n, K)
    fp32 matrices (nn.Linear's layout) whose rows stack to N, ``biases``
    theirs.  Prologue: LayerNorm with ``ln = (γ, β)``.  Epilogue: the fp32
    product rounded to the compute dtype, ``+ bias`` in the compute dtype,
    then the tanh gelu (in fp32, rounded once) or ``+ residual``."""
    cd = a.dtype
    if ln is not None:
        ln_dt = torch.float32 if norm_f32 else cd
        a = _ln_fwd(a, ln[0].to(ln_dt), ln[1].to(ln_dt), norm_f32)
    w = torch.cat(list(weights)).to(cd)
    out = (a.float() @ w.float().T).to(cd) + torch.cat(list(biases)).to(cd)
    if gelu:
        out = F.gelu(out.float(), approximate="tanh").to(cd)
    if residual is not None:
        out = residual + out
    return out


def _chain(x, params, heads, norm_f32, gemm: Callable, attend: Callable):
    b, s, dim = x.shape
    p = params
    x2 = x.reshape(b * s, dim)
    qkv = gemm(
        x2, [p[f"{n}.weight"] for n in QKV], [p[f"{n}.bias"] for n in QKV],
        ln=(p["ln_attn.weight"], p["ln_attn.bias"]), norm_f32=norm_f32,
    )
    o = attend(qkv, seq=s, heads=heads)
    r1 = gemm(o, [p["proj.weight"]], [p["proj.bias"]], residual=x2)
    hmid = gemm(
        r1, [p["mlp_up.weight"]], [p["mlp_up.bias"]],
        ln=(p["ln_mlp.weight"], p["ln_mlp.bias"]), norm_f32=norm_f32, gelu=True,
    )
    out = gemm(hmid, [p["mlp_down.weight"]], [p["mlp_down.bias"]], residual=r1)
    return out.reshape(b, s, dim)


def _check_block(x: torch.Tensor, heads: int) -> None:
    """The JAX ``fused_vit_block``'s shape rules."""
    b, s, dim = x.shape
    if dim % heads:
        raise ValueError(f"dim {dim} not divisible by heads {heads}")
    if s % 8 or (dim // heads) % 8:
        raise ValueError(
            f"fused_vit_block needs S and head dim multiples of 8; got "
            f"S={s}, head_dim={dim // heads}"
        )


def fused_vit_block_reference(
    x: torch.Tensor, params: Mapping[str, torch.Tensor], *, heads: int,
    norm_f32: bool = True,
) -> torch.Tensor:
    """The plain version of :func:`fused_vit_block`: ``_block_fwd_kernel``'s
    arithmetic step by step in PyTorch."""
    _check_block(x, heads)
    return _chain(x, params, heads, norm_f32, block_gemm_reference, packed_attention_reference)


# ------------------------------------------------------------------ card


def _operand(t: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``t`` (cast to ``dtype``) contiguous with a 16-byte aligned base, as
    the kernels' vector loads need; a tensor that already is is passed as
    it is."""
    if (dtype is None or t.dtype == dtype) and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t  # the common case, without a dispatcher call
    if dtype is not None:
        t = t.to(dtype)
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _gemm_c_args() -> list:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return [ptr] * 11 + [i32] * 6 + [ptr]


def block_gemm(
    a: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    *,
    ln: tuple[torch.Tensor, torch.Tensor] | None = None,
    norm_f32: bool = True,
    gelu: bool = False,
    residual: torch.Tensor | None = None,
    stream: int | None = None,
) -> torch.Tensor:
    """:func:`block_gemm_reference`'s function; on the card the CUDA kernel
    ``block_gemm`` (bf16 on the tensor cores, fp32 SIMT), which takes K and
    N multiples of 16, one to three weight segments of equal shape and fp32
    LayerNorm statistics only.  It launches on ``stream`` (a raw CUDA stream
    handle, with the tensors' device current) or else on the tensors'
    device's current stream.  ``block_gemm.launches`` counts its launches."""
    if a.device.type == "cpu":
        return block_gemm_reference(
            a, weights, biases, ln=ln, norm_f32=norm_f32, gelu=gelu, residual=residual
        )
    if stream is None:
        with torch.cuda.device(a.device):
            return block_gemm(a, weights, biases, ln=ln, norm_f32=norm_f32, gelu=gelu,
                              residual=residual, stream=_stream(a))
    from . import _build

    if a.dim() != 2 or a.dtype not in KERNEL_DTYPES:
        raise ValueError(f"block_gemm takes a 2-D bf16 or fp32 a, got {a.dtype} {tuple(a.shape)}")
    m, k = a.shape
    if not 1 <= len(weights) <= 3 or len(biases) != len(weights):
        raise ValueError("block_gemm takes one to three weight segments, each with its bias")
    seg = weights[0].shape[0]
    if any(w.shape != (seg, k) for w in weights) or any(b.shape != (seg,) for b in biases):
        raise ValueError(
            f"block_gemm weight segments must all be ({seg}, {k}) with ({seg},) biases, got "
            f"{[tuple(w.shape) for w in weights]} / {[tuple(b.shape) for b in biases]}"
        )
    n = seg * len(weights)
    if k % 16 or n % 16:
        raise ValueError(f"block_gemm takes K and N multiples of 16, got K={k}, N={n}")
    if ln is not None and not norm_f32:
        raise NotImplementedError(
            "block_gemm's LayerNorm prologue takes fp32 statistics only (norm_f32=True); "
            "norm_dtype=None runs on the CPU's plain version"
        )
    if residual is not None and (residual.shape != (m, n) or residual.dtype != a.dtype):
        raise ValueError(f"residual must be ({m}, {n}) {a.dtype}, got {residual.dtype} {tuple(residual.shape)}")
    tensors = [a, *weights, *biases, *(ln or ()), *([residual] if residual is not None else [])]
    if any(t.device != a.device for t in tensors):
        raise ValueError("block_gemm tensors must be on one device")
    a = _operand(a)
    ws = [_operand(w, torch.float32) for w in weights] + [None] * (3 - len(weights))
    bs = [_operand(b, torch.float32) for b in biases] + [None] * (3 - len(biases))
    g, beta = (_operand(t, torch.float32) for t in ln) if ln is not None else (None, None)
    res = None if residual is None else _operand(residual)
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    fn = _build.load("vit_block_fwd", _gemm_c_args(), symbol="vit_block_gemm")
    err = fn(
        a.data_ptr(), *map(_ptr, ws), *map(_ptr, bs), _ptr(g), _ptr(beta), _ptr(res),
        out.data_ptr(), m, n, k, seg, int(gelu), int(a.dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"block_gemm launch failed: CUDA error {err}")
    block_gemm.launches += 1
    return out


block_gemm.launches = 0


def _attention_c_args() -> list:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return [ptr] * 2 + [i32] * 4 + [ctypes.c_float, i32, ptr]


def _check_head_dim(d: int) -> None:
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"the fused block's CUDA kernels take head dims that are multiples of 16 "
            f"up to {MAX_HEAD_DIM}, got {d}"
        )


def block_attention(
    qkv: torch.Tensor, *, seq: int, heads: int, scale: float | None = None,
    stream: int | None = None,
) -> torch.Tensor:
    """``packed_attention_reference``'s function; on the card the CUDA
    kernel ``block_attention``: one block per (item, head, 64-query tile)
    with an exact two-sweep softmax, launched as :func:`block_gemm` is.
    ``block_attention.launches`` counts its launches."""
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, seq=seq, heads=heads, scale=scale)
    if stream is None:
        with torch.cuda.device(qkv.device):
            return block_attention(qkv, seq=seq, heads=heads, scale=scale, stream=_stream(qkv))
    from . import _build

    rows, three_dim = qkv.shape
    dim = three_dim // 3
    if qkv.dtype not in KERNEL_DTYPES or three_dim % 3 or dim % heads:
        raise ValueError(
            f"block_attention takes a bf16 or fp32 (B·S, 3·dim) qkv split into {heads} "
            f"heads, got {qkv.dtype} {tuple(qkv.shape)}"
        )
    if seq <= 0 or rows % seq:
        raise ValueError(f"{rows} rows are not whole items of {seq} tokens")
    d = dim // heads
    _check_head_dim(d)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qkv = _operand(qkv)
    out = torch.empty((rows, dim), device=qkv.device, dtype=qkv.dtype)
    fn = _build.load("vit_block_fwd", _attention_c_args(), symbol="vit_block_attention")
    err = fn(
        qkv.data_ptr(), out.data_ptr(), rows // seq, seq, heads, d, float(scale),
        int(qkv.dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"block_attention launch failed: CUDA error {err}")
    block_attention.launches += 1
    return out


block_attention.launches = 0


def fused_vit_block(
    x: torch.Tensor, params: Mapping[str, torch.Tensor], *, heads: int,
    norm_f32: bool = True,
) -> torch.Tensor:
    """One pre-LN transformer block as the fused chain (the JAX
    ``fused_vit_block`` minus its TPU-only ``block_items`` and
    ``interpret``).

    ``x``: (B, S, dim) activations in the compute dtype (bf16 or fp32).
    ``params``: the composed ``ViTBlock``'s parameters by name
    (``ln_attn.weight``, ``q_proj.weight``, ... ``mlp_down.bias``), fp32.
    A CPU tensor takes :func:`fused_vit_block_reference`.  On the card the
    chain launches ``block_gemm`` four times and ``block_attention`` once,
    and raises on head dims that are not multiples of 16 up to 128, on
    dim above 1024 and on ``norm_f32=False``.  ``fused_vit_block.launches``
    counts the blocks run through the kernels.
    """
    _check_block(x, heads)
    if x.device.type == "cpu":
        return fused_vit_block_reference(x, params, heads=heads, norm_f32=norm_f32)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_block runs on cuda or cpu, not {x.device}")
    dim = x.shape[-1]
    _check_head_dim(dim // heads)
    if dim > MAX_DIM:
        raise ValueError(f"the fused block's CUDA kernels take dim up to {MAX_DIM}, got {dim}")
    if not norm_f32:
        raise NotImplementedError(
            "fused_vit_block on the card takes fp32 LayerNorm statistics only; "
            "norm_dtype=None runs on the CPU's plain version"
        )
    with torch.cuda.device(x.device):  # one device switch and stream lookup per block
        stream = _stream(x)
        out = _chain(
            _operand(x), params, heads, norm_f32,
            functools.partial(block_gemm, stream=stream),
            functools.partial(block_attention, stream=stream),
        )
    fused_vit_block.launches += 1
    return out


fused_vit_block.launches = 0
