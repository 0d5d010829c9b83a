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
parameters and round them to the compute dtype themselves, which is the
arithmetic of casting first, with no cast kernel per call; the q, k and v
projections are read as three weight pointers, not concatenated.

The bf16 GEMMs (``block_gemm``, ``block_gemm_dgrad``, ``block_gemm_wgrad``;
``csrc/block_gemm.cuh``) are bound by bytes at the block's shapes and are
built for Hopper: every product is a ``wgmma``, fed by a multi-stage TMA
ring.  ``block_gemm`` and ``block_gemm_dgrad`` are weight-stationary: a
block converts one slab of W (all of K by :func:`slab_width` output
columns) to bf16 once per call and streams the activation's row tiles past
it; ``block_gemm_wgrad`` reads G and A MN-major as they land, with no
transposed staging, in tiles of :func:`wgrad_width` input columns.
The bf16 attention stages (``block_attention``, ``block_attention_bwd``;
``csrc/attention_tiles.cuh``, shared with ``attention_small``) take head
dim 64, the zoo's only fused one, and up to 512 tokens: a block stages its
item's K and V once and computes the scores once, every product a
``wgmma``.

fp32, the entry point's default precision, runs the same functions in
3xTF32 on ``wgmma`` (``csrc/tf32x3.cuh``): each fp32 operand splits into
two tf32 terms and each product into three tf32 products, fp32 accuracy at
the tensor cores' rate.  The GEMMs share one core
(``csrc/block_gemm_tf32.cuh``: ``block_gemm_tf32x3``, ``dgrad_tf32x3``,
``wgrad_tf32x3``), both operands streamed through a ring that a producer
warpgroup fills and splits; the attention (``block_attn_tf32x3``,
``block_attn_dq_tf32x3``, ``block_attn_dkv_tf32x3``) runs the flash
kernels' schedules over the packed qkv, any head dim the card takes padded
to 64 or 128.

The backward (K6, ``_block_bwd_kernel``) recomputes the forward from x
alone, then produces dx and the twelve parameter gradients at the TPU
kernel's rounding points (:func:`fused_vit_block_bwd_reference`).  The TPU
kernel walks the rows on a sequential grid and accumulates the gradients
in VMEM; Hopper's blocks run in no order, and the training kernels use no
atomics, so on the card (``csrc/vit_block_bwd.cu``) every parameter
gradient is a two-pass deterministic reduction: fp32 partials per row
chunk, then a fixed-order sum (``block_grad_reduce``).  Its chain, per
block: ``block_ln`` (LN₁, LN₂ rows, rounded) and the K5 kernels for the
recompute (``block_gemm`` ×3, ``block_attention``); ``block_gemm_dgrad``
×4 (G·W: dh with the gelu backward, dLN₂, dO, dLN₁); ``block_ln_bwd`` ×2
(the LayerNorm backward plus residual, with the dγ/dβ partials);
``block_attention_bwd`` (dq, dk, dv with P recomputed); ``block_gemm_wgrad``
×4 (Gᵀ·A with the bias column sums); one ``block_grad_reduce``.

``fused_vit_block`` under autograd goes through ``_FusedViTBlock``, the
counterpart of the JAX ``_block_core`` custom VJP: it saves x and the
parameters only, and its backward is the K6 chain on the card and the
plain backward on the CPU.

A CPU tensor takes the plain versions (:func:`fused_vit_block_reference`,
:func:`fused_vit_block_bwd_reference`, each wrapper's ``*_reference``,
``attention_small``'s); a CUDA tensor launches the kernels or raises.  Each
wrapper counts its launches in a plain-int ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections.abc import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

from .attention_small import packed_attention_bwd_reference, packed_attention_reference

LN_EPS = 1e-6
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_HEAD_DIM = 128  # fp32 head dims: multiples of 16 up to this
BF16_HEAD_DIM = 64  # bf16: the one head dim of a zoo model the fusion gate fuses
MAX_BF16_SEQ = 512  # bf16 attention: the top of the gate's token window
MAX_DIM = 1024
QKV = ("q_proj", "k_proj", "v_proj")
DENSE = (*QKV, "proj", "mlp_up", "mlp_down")
# the autograd Function's parameter order: the composed ViTBlock's sublayers
BLOCK_PARAMS = tuple(
    f"{m}.{p}"
    for m in ("ln_attn", *QKV, "proj", "ln_mlp", "mlp_up", "mlp_down")
    for p in ("weight", "bias")
)
# rows per partial of the two-pass parameter-gradient reductions on the card
WGRAD_CHUNK_ROWS = 1024  # block_gemm_wgrad: one partial per chunk of rows
LN_CHUNK_ROWS = 128  # block_ln_bwd: one partial per block of rows
# block_grad_reduce's schedule (grad_reduce_plan): threads a block (the
# kernel's kReduceThreads), and the chunk count above which a partial takes
# one element a thread, not four
REDUCE_THREADS = 256
REDUCE_LONG_CHAIN = 64
# The bf16 GEMM kernels' tile widths (csrc/block_gemm.cuh): block_gemm and
# block_gemm_dgrad hold a bf16 slab of B, all of K by a slab width of output
# columns, of at most SLAB_BYTES (the kernel's kSlabBytes); block_gemm_wgrad
# takes tiles of 64, 128 or 192 input columns
SLAB_BYTES = 96 * 1024
SLAB_WIDTHS = (64, 32, 16, 8)
WGRAD_WIDTHS = (192, 128, 64)
_GELU_C, _GELU_A = 0.7978845608028654, 0.044715


def _ln_parts(x, gamma, beta, norm_f32: bool):
    """The TPU kernel's LayerNorm (``_ln_fwd``): statistics in fp32
    (``norm_f32``) or in the compute dtype, var = E[x²] − μ².  Returns
    ``(y in x's dtype, xhat, 1/σ)``."""
    xs = x.float() if norm_f32 else x
    mu = xs.mean(-1, keepdim=True)
    var = (xs * xs).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + LN_EPS)
    xhat = (xs - mu) * inv
    return (xhat * gamma + beta).to(x.dtype), xhat, inv


def _ln_fwd(x, gamma, beta, norm_f32: bool) -> torch.Tensor:
    return _ln_parts(x, gamma, beta, norm_f32)[0]


def _ln_bwd(dy, xhat, inv, gamma) -> torch.Tensor:
    """dx of ``y = xhat·γ + β`` for an fp32 ``dy`` (``_ln_bwd``), fp32."""
    dxhat = dy * gamma
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * inv


def _gelu(up: torch.Tensor) -> torch.Tensor:
    """The tanh gelu in fp32, rounded once to ``up``'s dtype."""
    return F.gelu(up.float(), approximate="tanh").to(up.dtype)


def _gelu_bwd(up: torch.Tensor, dh: torch.Tensor) -> torch.Tensor:
    """``gelu'(up)·dh`` for the tanh gelu, in fp32, rounded once."""
    x = up.float()
    t = torch.tanh(_GELU_C * (x + _GELU_A * x * x * x))
    d = 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * _GELU_C * (1 + 3 * _GELU_A * x * x)
    return (d * dh.float()).to(up.dtype)


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
        out = _gelu(out)
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


def _tile_width(n: int, widths: Sequence[int]) -> int:
    """The width of ``widths`` whose tiles cover ``n`` columns with the least
    padding, the widest of those."""
    return min(widths, key=lambda w: (-(-n // w) * w, -w))


@functools.lru_cache(maxsize=None)
def slab_width(k: int, n: int) -> int:
    """``block_gemm``'s and ``block_gemm_dgrad``'s slab width on the card
    for a product of depth ``k`` and ``n`` output columns: of the widths
    whose bf16 slab (``k`` padded to whole 64-column boxes) fits in
    SLAB_BYTES, the one covering ``n`` with the least padding."""
    kpad = -(-k // 64) * 64
    return _tile_width(n, [w for w in SLAB_WIDTHS if kpad * w * 2 <= SLAB_BYTES])


@functools.lru_cache(maxsize=None)
def wgrad_width(n_in: int) -> int:
    """``block_gemm_wgrad``'s tile width on the card for ``n_in`` input
    columns: the one of WGRAD_WIDTHS covering them with the least padding."""
    return _tile_width(n_in, WGRAD_WIDTHS)


def _gemm_c_args() -> list:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return [ptr] * 11 + [i32] * 7 + [ptr]


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
    ``block_gemm`` (bf16 ``block_gemm_wgmma``, fp32 ``block_gemm_tf32x3``),
    which takes K and N multiples of 16, one to three weight segments of
    equal shape and fp32 LayerNorm statistics only.  It launches on ``stream`` (a raw CUDA stream
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
    bf16 = a.dtype == torch.bfloat16
    fn = _build.load("vit_block_fwd", _gemm_c_args(), symbol="vit_block_gemm")
    err = fn(
        a.data_ptr(), *map(_ptr, ws), *map(_ptr, bs), _ptr(g), _ptr(beta), _ptr(res),
        out.data_ptr(), m, n, k, seg, int(gelu), int(bf16), slab_width(k, n) if bf16 else 0,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"block_gemm launch failed: CUDA error {err}")
    block_gemm.launches += 1
    return out


block_gemm.launches = 0


def _attention_c_args() -> list:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return [ptr] * 2 + [i32] * 4 + [ctypes.c_float, i32, ptr]


def _check_head_dim(d: int, dtype: torch.dtype) -> None:
    """The head dims the fused block's attention kernels are instantiated
    for: only the zoo's in bf16 (its Hopper kernels), any multiple of 16 up
    to MAX_HEAD_DIM in fp32."""
    if dtype == torch.bfloat16 and d != BF16_HEAD_DIM:
        raise ValueError(
            f"the fused block's CUDA kernels take head dim {BF16_HEAD_DIM} in bf16 (the one "
            f"head dim of a zoo model the fusion gate fuses; fp32 takes multiples of 16 up "
            f"to {MAX_HEAD_DIM}), got {d}"
        )
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"the fused block's CUDA kernels take head dims that are multiples of 16 "
            f"up to {MAX_HEAD_DIM}, got {d}"
        )


def _check_seq(seq: int, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16 and seq > MAX_BF16_SEQ:
        raise ValueError(
            f"the fused block's bf16 attention kernels hold an item's keys on chip and take "
            f"up to {MAX_BF16_SEQ} tokens (the gate's window), got {seq}"
        )


def block_attention(
    qkv: torch.Tensor, *, seq: int, heads: int, scale: float | None = None,
    stream: int | None = None,
) -> torch.Tensor:
    """``packed_attention_reference``'s function; on the card the CUDA
    kernel ``block_attention``, launched as :func:`block_gemm` is: one block
    per (item, head, 64-query tile).  bf16 (head dim 64, S up to 512) runs
    ``block_attn_wgmma``, which stages the item's K and V once and computes
    the scores once on ``wgmma``; fp32 (head dims that are multiples of 16
    up to 128) ``block_attn_tf32x3``: 3xTF32 ``wgmma``, 128 query rows a
    block, K and V streamed, the softmax online.
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
    _check_head_dim(d, qkv.dtype)
    _check_seq(seq, qkv.dtype)
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


def _check_card_block(x: torch.Tensor, heads: int, norm_f32: bool) -> None:
    """What the fused block's CUDA kernels take, beyond the JAX shape rules."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused block runs on cuda or cpu, not {x.device}")
    if not norm_f32:
        raise NotImplementedError(
            "the fused block on the card takes fp32 LayerNorm statistics only; "
            "norm_dtype=None runs on the CPU's plain version"
        )
    dim = x.shape[-1]
    _check_head_dim(dim // heads, x.dtype)
    _check_seq(x.shape[1], x.dtype)
    if dim > MAX_DIM:
        raise ValueError(f"the fused block's CUDA kernels take dim up to {MAX_DIM}, got {dim}")


def _block_forward(x: torch.Tensor, params: Mapping[str, torch.Tensor], heads: int,
                   norm_f32: bool) -> torch.Tensor:
    """The forward: the plain version on the CPU, the K5 chain on the card."""
    if x.device.type == "cpu":
        return fused_vit_block_reference(x, params, heads=heads, norm_f32=norm_f32)
    _check_card_block(x, heads, norm_f32)
    with torch.cuda.device(x.device):  # one device switch and stream lookup per block
        stream = _stream(x)
        out = _chain(
            _operand(x), params, heads, norm_f32,
            functools.partial(block_gemm, stream=stream),
            functools.partial(block_attention, stream=stream),
        )
    fused_vit_block.launches += 1
    return out


class _FusedViTBlock(torch.autograd.Function):
    """The JAX ``_block_core`` custom VJP: the forward saves ``x`` and the
    parameters only, and the backward recomputes everything from them
    (:func:`fused_vit_block_bwd`).  The parameter gradients are cast as
    ``_block_core_bwd`` casts them: the JAX primals of the Dense weights
    and biases are their compute-dtype casts, so their gradients are
    rounded to the compute dtype before they reach the fp32 parameters;
    the LayerNorm gradients stay fp32 (``norm_f32``) or are rounded to the
    compute dtype."""

    @staticmethod
    def forward(ctx, x, heads, norm_f32, *flat):
        ctx.heads, ctx.norm_f32 = heads, norm_f32
        ctx.save_for_backward(x, *flat)
        return _block_forward(x, dict(zip(BLOCK_PARAMS, flat)), heads, norm_f32)

    @staticmethod
    def backward(ctx, dy):
        x, *flat = ctx.saved_tensors
        dx, grads = fused_vit_block_bwd(
            x, dy, dict(zip(BLOCK_PARAMS, flat)), heads=ctx.heads, norm_f32=ctx.norm_f32
        )
        cd = x.dtype
        ln_dt = torch.float32 if ctx.norm_f32 else cd
        dparams = [
            grads[name].to(ln_dt if name.startswith("ln") else cd).to(p.dtype)
            for name, p in zip(BLOCK_PARAMS, flat)
        ]
        return (dx, None, None, *dparams)


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
    and raises on a head dim other than 64 in bf16 and than a multiple of
    16 up to 128 in fp32, on more than 512 tokens in bf16, on dim above
    1024 and on ``norm_f32=False``.  ``fused_vit_block.launches``
    counts the blocks run through the kernels.  Where autograd records the
    call, it goes through ``_FusedViTBlock``, whose backward is
    :func:`fused_vit_block_bwd`.
    """
    _check_block(x, heads)
    if torch.is_grad_enabled() and (
        x.requires_grad or any(params[n].requires_grad for n in BLOCK_PARAMS)
    ):
        return _FusedViTBlock.apply(x, heads, norm_f32, *(params[n] for n in BLOCK_PARAMS))
    return _block_forward(x, params, heads, norm_f32)


fused_vit_block.launches = 0


# ------------------------------------------------------------- backward (K6)


def fused_vit_block_bwd_reference(
    x: torch.Tensor, dy: torch.Tensor, params: Mapping[str, torch.Tensor], *,
    heads: int, norm_f32: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The plain version of :func:`fused_vit_block_bwd`:
    ``_block_bwd_kernel``'s arithmetic step by step in PyTorch.

    Returns ``(dx in x's dtype, {parameter name: raw fp32 gradient})``, the
    gradients in the parameters' shapes, before ``_FusedViTBlock``'s casts.
    The forward is recomputed from ``x``; ``dh = dy·W_dn`` and
    ``dup = gelu'(up)·dh`` are rounded to the compute dtype, dLN₂ and dLN₁
    stay fp32; ``dr1`` is fp32, its rounded copy feeds ``dW_o`` and ``dO``
    while ``db_o`` sums the unrounded ``dr1``; ``db_qkv`` and ``db_up``
    sum the rounded ``dqkv`` and ``dup``; dx is rounded once."""
    _check_block(x, heads)
    b, s, dim = x.shape
    cd = x.dtype
    p = params
    ln_dt = torch.float32 if norm_f32 else cd
    g1, bt1, g2, bt2 = (
        p[n].to(ln_dt) for n in ("ln_attn.weight", "ln_attn.bias", "ln_mlp.weight", "ln_mlp.bias")
    )
    w = {n: p[f"{n}.weight"].to(cd).float() for n in DENSE}  # (out, in), rounded

    def dense(a, names):
        wt = torch.cat([w[n] for n in names])
        bias = torch.cat([p[f"{n}.bias"] for n in names]).to(cd)
        return (a.float() @ wt.T).to(cd) + bias

    x2, dy2 = x.reshape(b * s, dim), dy.reshape(b * s, dim)
    # forward recompute (x is the only saved residual)
    ln1, xhat1, inv1 = _ln_parts(x2, g1, bt1, norm_f32)
    qkv = dense(ln1, QKV)
    o = packed_attention_reference(qkv, seq=s, heads=heads)
    r1 = x2 + dense(o, ["proj"])
    ln2, xhat2, inv2 = _ln_parts(r1, g2, bt2, norm_f32)
    up = dense(ln2, ["mlp_up"])
    hmid = _gelu(up)

    g = {}
    dyf = dy2.float()
    # MLP branch: out = r1 + (hmid·W_dnᵀ + b_dn)
    g["mlp_down.weight"] = dyf.T @ hmid.float()
    g["mlp_down.bias"] = dyf.sum(0)
    dup = _gelu_bwd(up, (dyf @ w["mlp_down"]).to(cd))
    g["mlp_up.weight"] = dup.float().T @ ln2.float()
    g["mlp_up.bias"] = dup.float().sum(0)
    dln2 = dup.float() @ w["mlp_up"]
    g["ln_mlp.weight"] = (dln2 * xhat2).sum(0)
    g["ln_mlp.bias"] = dln2.sum(0)
    dr1 = dyf + _ln_bwd(dln2, xhat2, inv2, g2)
    # attention branch: r1 = x + (o·W_oᵀ + b_o)
    dr1c = dr1.to(cd)
    g["proj.weight"] = dr1c.float().T @ o.float()
    g["proj.bias"] = dr1.sum(0)
    do = (dr1c.float() @ w["proj"]).to(cd)
    dqkv = packed_attention_bwd_reference(qkv, do, seq=s, heads=heads).float()
    for j, n in enumerate(QKV):
        dj = dqkv[:, j * dim:(j + 1) * dim]
        g[f"{n}.weight"] = dj.T @ ln1.float()
        g[f"{n}.bias"] = dj.sum(0)
    dln1 = dqkv @ torch.cat([w[n] for n in QKV])
    g["ln_attn.weight"] = (dln1 * xhat1).sum(0)
    g["ln_attn.bias"] = dln1.sum(0)
    dx = (dr1 + _ln_bwd(dln1, xhat1, inv1, g1)).to(cd)
    return dx.reshape(x.shape), {n: g[n] for n in BLOCK_PARAMS}


def _chunk_sums(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(M, ...) → (ceil(M / chunk), ...): the sum of each chunk of rows."""
    m = t.shape[0]
    n = -(-m // chunk)
    pad = torch.zeros((n * chunk - m, *t.shape[1:]), dtype=t.dtype, device=t.device)
    return torch.cat([t, pad]).reshape(n, chunk, *t.shape[1:]).sum(1)


def _cuda_call(name: str, symbol: str, argtypes: list, *args) -> None:
    from . import _build

    err = _build.load("vit_block_bwd", argtypes, symbol=symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_card_operands(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} takes bf16 or fp32 operands, got {dtype}")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name} tensors must be on one device")


def block_ln_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """LayerNorm of the rows of ``x`` with fp32 statistics, rounded to
    ``x``'s dtype (the block's LN₁ and LN₂ outputs)."""
    return _ln_fwd(x, gamma.float(), beta.float(), True)


def block_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
             stream: int | None = None) -> torch.Tensor:
    """:func:`block_ln_reference`'s function; on the card the CUDA kernel
    ``ln_rows`` (a persistent grid; a half-warp a row, a warp past 192
    columns), which takes n a multiple of 16 up to ``MAX_DIM``.
    ``block_ln.launches`` counts its launches."""
    if x.device.type == "cpu":
        return block_ln_reference(x, gamma, beta)
    _check_card_operands("block_ln", x.dtype, x, gamma, beta)
    m, n = x.shape
    if n % 16 or n > MAX_DIM or gamma.shape != (n,) or beta.shape != (n,):
        raise ValueError(
            f"block_ln takes (M, n) rows, n a multiple of 16 up to {MAX_DIM}, and (n,) γ, β; got {tuple(x.shape)}"
        )
    x, gamma, beta = _operand(x), _operand(gamma, torch.float32), _operand(beta, torch.float32)
    out = torch.empty_like(x)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    _cuda_call("block_ln", "vit_block_ln", [ptr] * 4 + [i32] * 3 + [ptr],
               x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), m, n,
               int(x.dtype == torch.bfloat16), stream if stream is not None else _stream(x))
    block_ln.launches += 1
    return out


block_ln.launches = 0


def block_gemm_dgrad_reference(
    g: torch.Tensor, weights: Sequence[torch.Tensor], *,
    gelu_of: torch.Tensor | None = None, out_f32: bool = False,
):
    """``G·W``: ``g`` (M, K) in the compute dtype; ``weights`` one or more
    fp32 ``nn.Linear`` weights whose rows stack to K (the data gradient of
    ``a·Wᵀ``), rounded to the compute dtype.  The fp32 product is returned
    as it is (``out_f32``), or rounded; with ``gelu_of = up`` the rounded
    product is ``dh`` and the result is ``(gelu'(up)·dh, gelu(up))``, each
    rounded (``dup`` and the recomputed ``hmid``)."""
    w = torch.cat(list(weights)).to(g.dtype).float()
    acc = g.float() @ w
    if out_f32:
        return acc
    c = acc.to(g.dtype)
    if gelu_of is None:
        return c
    return _gelu_bwd(gelu_of, c), _gelu(gelu_of)


def _dgrad_c_args() -> list:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return [ptr] * 7 + [i32] * 7 + [ptr]


def block_gemm_dgrad(
    g: torch.Tensor, weights: Sequence[torch.Tensor], *,
    gelu_of: torch.Tensor | None = None, out_f32: bool = False, stream: int | None = None,
):
    """:func:`block_gemm_dgrad_reference`'s function; on the card the CUDA
    kernel ``block_gemm_dgrad`` (bf16 ``dgrad_wgmma``, fp32 ``dgrad_tf32x3``),
    which takes K and N multiples of 16 and one to three weight segments of
    equal shape.  ``block_gemm_dgrad.launches`` counts its launches."""
    if g.device.type == "cpu":
        return block_gemm_dgrad_reference(g, weights, gelu_of=gelu_of, out_f32=out_f32)
    _check_card_operands("block_gemm_dgrad", g.dtype, g, *weights,
                         *([gelu_of] if gelu_of is not None else []))
    m, k = g.shape
    seg, n = weights[0].shape
    if not 1 <= len(weights) <= 3 or any(w.shape != (seg, n) for w in weights) \
            or seg * len(weights) != k or k % 16 or n % 16:
        raise ValueError(
            f"block_gemm_dgrad takes (M, K) G and one to three (K/segments, N) weights, "
            f"K and N multiples of 16; got {tuple(g.shape)} / {[tuple(w.shape) for w in weights]}"
        )
    if gelu_of is not None and (gelu_of.shape != (m, n) or gelu_of.dtype != g.dtype or out_f32):
        raise ValueError(f"gelu_of must be ({m}, {n}) {g.dtype}, without out_f32")
    g = _operand(g)
    ws = [_operand(w, torch.float32) for w in weights] + [None] * (3 - len(weights))
    up = None if gelu_of is None else _operand(gelu_of)
    out = torch.empty((m, n), device=g.device, dtype=torch.float32 if out_f32 else g.dtype)
    hmid = None if up is None else torch.empty_like(up)
    mode = 2 if out_f32 else (1 if up is not None else 0)
    bf16 = g.dtype == torch.bfloat16
    _cuda_call("block_gemm_dgrad", "vit_block_dgrad", _dgrad_c_args(),
               g.data_ptr(), *map(_ptr, ws), _ptr(up), _ptr(hmid), out.data_ptr(),
               m, n, k, seg, mode, int(bf16), slab_width(k, n) if bf16 else 0,
               stream if stream is not None else _stream(g))
    block_gemm_dgrad.launches += 1
    return out if up is None else (out, hmid)


block_gemm_dgrad.launches = 0


def block_ln_bwd_reference(
    dln: torch.Tensor, xin: torch.Tensor, gamma: torch.Tensor, base: torch.Tensor,
):
    """The LayerNorm backward plus residual: ``base + LNᵀ(dln)`` for the
    LayerNorm of ``xin`` (fp32 statistics recomputed from ``xin``) with
    scale ``gamma``; ``dln`` fp32 (M, n), ``base`` fp32 or the compute
    dtype.  Returns ``(the sum in fp32, rounded to xin's dtype, per-chunk
    partials of dγ = Σ dln·xhat and dβ = Σ dln, each (ceil(M /
    LN_CHUNK_ROWS), n))``."""
    _, xhat, inv = _ln_parts(xin, gamma.float(), 0.0, True)
    out = base.float() + _ln_bwd(dln, xhat, inv, gamma.float())
    return (out, out.to(xin.dtype), _chunk_sums(dln * xhat, LN_CHUNK_ROWS),
            _chunk_sums(dln, LN_CHUNK_ROWS))


def block_ln_bwd(
    dln: torch.Tensor, xin: torch.Tensor, gamma: torch.Tensor, base: torch.Tensor, *,
    keep_f32: bool = True, stream: int | None = None,
):
    """:func:`block_ln_bwd_reference`'s function; on the card the CUDA
    kernel ``ln_bwd`` (a block per LN_CHUNK_ROWS rows writing its partials;
    a half-warp a row, a warp past 192 columns), which takes n a multiple
    of 16 up to ``MAX_DIM`` and writes the fp32 sum only with ``keep_f32``
    (else that slot of the result is None).  ``block_ln_bwd.launches``
    counts its launches."""
    if xin.device.type == "cpu":
        return block_ln_bwd_reference(dln, xin, gamma, base)
    _check_card_operands("block_ln_bwd", xin.dtype, dln, xin, gamma, base)
    m, n = xin.shape
    if dln.shape != (m, n) or dln.dtype != torch.float32 or base.shape != (m, n) \
            or base.dtype not in (torch.float32, xin.dtype) or gamma.shape != (n,) \
            or n % 16 or n > MAX_DIM:
        raise ValueError(
            f"block_ln_bwd takes fp32 dln and a base (fp32 or {xin.dtype}) of xin's shape "
            f"{tuple(xin.shape)}, n a multiple of 16 up to {MAX_DIM}"
        )
    dln, xin, base = _operand(dln), _operand(xin), _operand(base)
    gamma = _operand(gamma, torch.float32)
    nc = -(-m // LN_CHUNK_ROWS)
    out32 = torch.empty((m, n), device=xin.device) if keep_f32 else None
    outc = torch.empty_like(xin)
    part = torch.empty((2, nc, n), device=xin.device)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    _cuda_call("block_ln_bwd", "vit_block_ln_bwd", [ptr] * 4 + [i32] + [ptr] * 4 + [i32] * 4 + [ptr],
               dln.data_ptr(), xin.data_ptr(), gamma.data_ptr(), base.data_ptr(),
               int(base.dtype == torch.float32), _ptr(out32), outc.data_ptr(),
               part[0].data_ptr(), part[1].data_ptr(), m, n, LN_CHUNK_ROWS,
               int(xin.dtype == torch.bfloat16), stream if stream is not None else _stream(xin))
    block_ln_bwd.launches += 1
    return out32, outc, part[0], part[1]


block_ln_bwd.launches = 0


def block_gemm_wgrad_reference(
    g: torch.Tensor, a: torch.Tensor, bias_src: torch.Tensor,
):
    """Per chunk of WGRAD_CHUNK_ROWS rows, the weight gradient ``Gᵀ·A`` of
    ``a·Wᵀ`` (``g`` (M, out) and ``a`` (M, in) in the compute dtype,
    products accumulated in fp32) and the column sums of ``bias_src``
    (M, out; fp32 or the compute dtype): ``((chunks, out, in),
    (chunks, out))`` fp32 partials."""
    c = WGRAD_CHUNK_ROWS
    parts = [g[i:i + c].float().T @ a[i:i + c].float() for i in range(0, g.shape[0], c)]
    return torch.stack(parts), _chunk_sums(bias_src.float(), c)


def block_gemm_wgrad(
    g: torch.Tensor, a: torch.Tensor, bias_src: torch.Tensor, *, stream: int | None = None,
):
    """:func:`block_gemm_wgrad_reference`'s function; on the card the CUDA
    kernel ``block_gemm_wgrad``: one block per (output tile, row chunk),
    bf16 ``wgrad_wgmma``, fp32 ``wgrad_tf32x3``, out and in multiples of 16.
    ``block_gemm_wgrad.launches`` counts its launches."""
    if g.device.type == "cpu":
        return block_gemm_wgrad_reference(g, a, bias_src)
    _check_card_operands("block_gemm_wgrad", g.dtype, g, a, bias_src)
    m, n_out = g.shape
    n_in = a.shape[1]
    if a.shape[0] != m or a.dtype != g.dtype or bias_src.shape != (m, n_out) \
            or bias_src.dtype not in (torch.float32, g.dtype) \
            or n_out % 16 or n_in % 16:
        raise ValueError(
            f"block_gemm_wgrad takes G (M, out), A (M, in) of one dtype and an (M, out) bias "
            f"source, out and in multiples of 16; got "
            f"{tuple(g.shape)} / {tuple(a.shape)} / {tuple(bias_src.shape)}"
        )
    g, a, bias_src = _operand(g), _operand(a), _operand(bias_src)
    nc = -(-m // WGRAD_CHUNK_ROWS)
    part_w = torch.empty((nc, n_out, n_in), device=g.device)
    part_b = torch.empty((nc, n_out), device=g.device)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    bf16 = g.dtype == torch.bfloat16
    _cuda_call("block_gemm_wgrad", "vit_block_wgrad", [ptr] * 3 + [i32] + [ptr] * 2 + [i32] * 6 + [ptr],
               g.data_ptr(), a.data_ptr(), bias_src.data_ptr(),
               int(bias_src.dtype == torch.float32), part_w.data_ptr(), part_b.data_ptr(),
               m, n_out, n_in, WGRAD_CHUNK_ROWS, int(bf16), wgrad_width(n_in) if bf16 else 0,
               stream if stream is not None else _stream(g))
    block_gemm_wgrad.launches += 1
    return part_w, part_b


block_gemm_wgrad.launches = 0


def block_attention_bwd(
    qkv: torch.Tensor, do: torch.Tensor, *, seq: int, heads: int, stream: int | None = None,
) -> torch.Tensor:
    """``packed_attention_bwd_reference``'s function; on the card the CUDA
    kernels of ``block_attention_bwd``, one call launching two: dq with
    each query row's softmax max, sum and ``Σ dp·P`` written to an fp32
    scratch (per item, head and 64-query tile), then dk and dv (per item,
    head and 64-key tile, reading that scratch).  bf16
    (head dim 64, S up to 512) runs ``attn_dq_wgmma`` and ``attn_dkv_wgmma``
    (K and V, Q and dO staged once a block, every product on ``wgmma``);
    fp32 ``block_attn_dq_tf32x3`` (a pass for the statistics, then dq) and
    ``block_attn_dkv_tf32x3``, 3xTF32 ``wgmma``.  No atomics: each block
    owns its output rows.
    ``block_attention_bwd.launches`` counts its calls."""
    if qkv.device.type == "cpu":
        return packed_attention_bwd_reference(qkv, do, seq=seq, heads=heads)
    _check_card_operands("block_attention_bwd", qkv.dtype, qkv, do)
    rows, three_dim = qkv.shape
    dim = three_dim // 3
    if three_dim % 3 or dim % heads or do.shape != (rows, dim) or do.dtype != qkv.dtype:
        raise ValueError(
            f"block_attention_bwd takes a (B·S, 3·dim) qkv split into {heads} heads and a "
            f"(B·S, dim) do of its dtype; got {tuple(qkv.shape)} / {do.dtype} {tuple(do.shape)}"
        )
    if seq <= 0 or rows % seq:
        raise ValueError(f"{rows} rows are not whole items of {seq} tokens")
    d = dim // heads
    _check_head_dim(d, qkv.dtype)
    _check_seq(seq, qkv.dtype)
    qkv, do = _operand(qkv), _operand(do)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((rows, heads, 3), device=qkv.device)  # max, sum, Σ dp·P per query
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    _cuda_call("block_attention_bwd", "vit_block_attention_bwd",
               [ptr] * 4 + [i32] * 4 + [ctypes.c_float, i32, ptr],
               qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
               rows // seq, seq, heads, d, 1.0 / math.sqrt(d), int(qkv.dtype == torch.bfloat16),
               stream if stream is not None else _stream(qkv))
    block_attention_bwd.launches += 1
    return dqkv


block_attention_bwd.launches = 0


def block_grad_reduce_reference(partials: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each (chunks, ...) fp32 partial summed over its chunks."""
    return [t.sum(0) for t in partials]


def grad_reduce_plan(shapes: Sequence[tuple[int, int]]) -> tuple[list[tuple[int, int, int]], int]:
    """``block_grad_reduce``'s schedule for partials of ``(chunks,
    elements)``: ``(plan, blocks)``, ``plan`` one ``(partial, elements a
    thread, first block)`` a partial in launch order, the longest chains
    first, and ``blocks`` in all.  A partial of more than
    ``REDUCE_LONG_CHAIN`` chunks, or whose elements are no multiple of 4,
    takes one element a thread, any other 4 adjacent ones; each takes the
    fewest blocks of ``REDUCE_THREADS`` threads that cover its elements,
    and block b belongs to the last partial whose first block is at or
    before b (``csrc/vit_block_bwd.cu::grad_reduce``)."""
    order = sorted(range(len(shapes)), key=lambda i: -shapes[i][0])
    plan, first = [], 0
    for i in order:
        chunks, size = shapes[i]
        vec = 1 if chunks > REDUCE_LONG_CHAIN or size % 4 else 4
        plan.append((i, vec, first))
        first += -(-size // (vec * REDUCE_THREADS))
    return plan, first


def block_grad_reduce(
    partials: Sequence[torch.Tensor], *, stream: int | None = None,
) -> list[torch.Tensor]:
    """:func:`block_grad_reduce_reference`'s function; on the card one
    launch of the CUDA kernel ``block_grad_reduce`` (``grad_reduce``, on
    :func:`grad_reduce_plan`'s schedule) sums every partial over its chunks
    in chunk order from 0, as a sequential fp32 sum does, so two calls on
    the same partials give bit-identical sums.  At most 16 partials.
    ``block_grad_reduce.launches`` counts its launches."""
    dev = partials[0].device
    if dev.type == "cpu":
        return block_grad_reduce_reference(partials)
    if len(partials) > 16 or any(t.dtype != torch.float32 or t.device != dev for t in partials):
        raise ValueError("block_grad_reduce takes up to 16 fp32 partials on one device")
    partials = [_operand(t) for t in partials]
    shapes = [(t.shape[0], math.prod(t.shape[1:])) for t in partials]
    # each sum starts 16-byte aligned, for the kernel's 16-byte stores
    starts = [0]
    for _, size in shapes:
        starts.append(starts[-1] + -(-size // 4) * 4)
    out = torch.empty(starts[-1], device=dev)
    outs = [out[a:a + size] for a, (_, size) in zip(starts, shapes)]
    plan, blocks = grad_reduce_plan(shapes)
    if blocks:
        desc = (ctypes.c_longlong * (6 * len(plan)))(*[
            v for i, vec, first in plan
            for v in (partials[i].data_ptr(), outs[i].data_ptr(), *shapes[i], vec, first)
        ])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _cuda_call("block_grad_reduce", "vit_block_grad_reduce", [ptr, i32, i32, ptr],
                   desc, len(plan), blocks, stream if stream is not None else _stream(out))
        block_grad_reduce.launches += 1
    return [o.view(t.shape[1:]) for o, t in zip(outs, partials)]


block_grad_reduce.launches = 0


def _bwd_chain(x2: torch.Tensor, dy2: torch.Tensor, params: Mapping[str, torch.Tensor],
               seq: int, heads: int, stream: int | None = None):
    """The K6 chain over the kernel wrappers (their plain versions on the
    CPU, which the tests hold against :func:`fused_vit_block_bwd_reference`):
    ``(dx2, {name: raw fp32 gradient})``."""
    p = params
    kw = dict(stream=stream)
    dim = x2.shape[1]
    wqkv = [p[f"{n}.weight"] for n in QKV]
    # forward recompute: the LayerNorm outputs kept for the weight gradients
    ln1 = block_ln(x2, p["ln_attn.weight"], p["ln_attn.bias"], **kw)
    qkv = block_gemm(ln1, wqkv, [p[f"{n}.bias"] for n in QKV], **kw)
    o = block_attention(qkv, seq=seq, heads=heads, **kw)
    r1 = block_gemm(o, [p["proj.weight"]], [p["proj.bias"]], residual=x2, **kw)
    ln2 = block_ln(r1, p["ln_mlp.weight"], p["ln_mlp.bias"], **kw)
    up = block_gemm(ln2, [p["mlp_up.weight"]], [p["mlp_up.bias"]], **kw)
    # backward: the data gradients, then the weight gradients
    dup, hmid = block_gemm_dgrad(dy2, [p["mlp_down.weight"]], gelu_of=up, **kw)
    dln2 = block_gemm_dgrad(dup, [p["mlp_up.weight"]], out_f32=True, **kw)
    dr1, dr1c, pg2, pb2 = block_ln_bwd(dln2, r1, p["ln_mlp.weight"], dy2, **kw)
    do = block_gemm_dgrad(dr1c, [p["proj.weight"]], **kw)
    dqkv = block_attention_bwd(qkv, do, seq=seq, heads=heads, **kw)
    dln1 = block_gemm_dgrad(dqkv, wqkv, out_f32=True, **kw)
    _, dx, pg1, pb1 = block_ln_bwd(dln1, x2, p["ln_attn.weight"], dr1, keep_f32=False, **kw)
    partials = [
        *block_gemm_wgrad(dqkv, ln1, dqkv, **kw),
        *block_gemm_wgrad(dr1c, o, dr1, **kw),  # db_o sums the unrounded dr1
        *block_gemm_wgrad(dup, ln2, dup, **kw),
        *block_gemm_wgrad(dy2, hmid, dy2, **kw),
        pg1, pb1, pg2, pb2,
    ]
    (dwqkv, dbqkv, dwo, dbo, dwup, dbup, dwdn, dbdn,
     dg1, db1, dg2, db2) = block_grad_reduce(partials, **kw)
    g = {
        "ln_attn.weight": dg1, "ln_attn.bias": db1,
        "proj.weight": dwo, "proj.bias": dbo, "ln_mlp.weight": dg2, "ln_mlp.bias": db2,
        "mlp_up.weight": dwup, "mlp_up.bias": dbup,
        "mlp_down.weight": dwdn, "mlp_down.bias": dbdn,
    }
    for j, n in enumerate(QKV):
        g[f"{n}.weight"] = dwqkv[j * dim:(j + 1) * dim]
        g[f"{n}.bias"] = dbqkv[j * dim:(j + 1) * dim]
    return dx, {n: g[n] for n in BLOCK_PARAMS}


def fused_vit_block_bwd(
    x: torch.Tensor, dy: torch.Tensor, params: Mapping[str, torch.Tensor], *,
    heads: int, norm_f32: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The block's backward for the output cotangent ``dy``: ``(dx, {name:
    raw fp32 gradient})`` as :func:`fused_vit_block_bwd_reference` returns
    them.  A CPU tensor takes that plain version; on the card the K6 chain
    runs (the kernels take what the forward's take and raise on the rest)
    and two calls on the same inputs give bit-identical results.
    ``fused_vit_block_bwd.launches`` counts the blocks run through it."""
    _check_block(x, heads)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: {x.dtype} {tuple(x.shape)}, got {dy.dtype} {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return fused_vit_block_bwd_reference(x, dy, params, heads=heads, norm_f32=norm_f32)
    _check_card_block(x, heads, norm_f32)
    b, s, dim = x.shape
    with torch.cuda.device(x.device):
        dx, grads = _bwd_chain(
            _operand(x).view(b * s, dim), _operand(dy.contiguous()).view(b * s, dim),
            params, s, heads, stream=_stream(x),
        )
    fused_vit_block_bwd.launches += 1
    return dx.view(b, s, dim), grads


fused_vit_block_bwd.launches = 0
