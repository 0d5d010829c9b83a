"""Short-sequence multi-head attention over the packed projection layout:
the plain PyTorch versions of ``distributed_training_comparison_tpu/ops/
attention_small.py`` (``_softmax_small``, ``_head_probs``, ``head_fwd``,
``head_bwd``, ``small_mha``) and the CUDA kernels that replace its Pallas
kernels ``_fwd_kernel`` (K10) and ``_bwd_kernel`` (K11).

Per (item, head): fp32 scores times the scale, under ``causal`` the keys
past the row set to -1e30 before the max, a max-shifted fp32 softmax
``e / Σe``, P rounded to the compute dtype, P·V accumulated in fp32 and
rounded once.  The backward recomputes P the same way: ``dp = dO·Vᵀ`` in
fp32, ``ds = P∘(dp − Σ dp∘P)`` on the unrounded P, ``ds·scale`` rounded to
the compute dtype, and dq, dk, dv each accumulated in fp32 and rounded
once, dv from the rounded P.  These are also the attention stage of the
fused ViT block (K5, K6) and the plain versions its CUDA kernels
``block_attention`` and ``block_attention_bwd`` are held against.

The TPU kernel stacks ``tb`` items into one ``(tb·S, tb·S)`` score matmul
masked block-diagonally to fill its matrix unit; off-diagonal blocks add
exact zeros, so per-item attention is the same function, and that is what
this module and its kernels (``csrc/attention_small.cu``) compute.

:func:`small_mha` is ``attention(impl="fused_small")``: q, k and v
``(B, S, H, D)`` go to the kernels as the packed ``(B·S, H·D)`` rows (a
free reshape of the contiguous projections), through ``_SmallMHA``, the
counterpart of the JAX ``_small_core`` custom VJP, which saves q, k and v
only.  A CPU tensor takes the plain versions; a CUDA tensor launches
:func:`small_mha_fwd` (K10) and, under autograd, :func:`small_mha_bwd`
(K11) or raises.  The kernels take bf16 or fp32 and head dims 64 and 128
(the zoo's); the plain versions take any S and D.  Which CUDA kernels a
call launches is one rule on the dtype and S (:func:`kernel_symbols`): bf16
items of at most ``ONE_TILE`` tokens (``vit_tiny`` and ``vit_small`` at 64
tokens) run one ``wgmma`` kernel each way, the longer ones (``vit_small
--patch-size 2``: 256 tokens) and fp32 a forward kernel and a backward pair
that passes each query row's softmax statistics through an fp32 scratch.

The longer bf16 items run ``wgmma`` kernels too, which hold a 64-query
tile's scores in registers up to a resident number of keys (the rule is
in :func:`kernel_symbols`) and so form them once; a query tile that sees
more keys walks them twice, a first sweep for each row's max and sum.
Either way P is the exact
``e / Σe`` before its rounding.  At ``vit_small --patch-size 2``'s train
shape (B 128, S 256, 6 heads of 64) they are bound by bytes (K10 100.7 MB,
0.030 ms at 3.35 TB/s; K11 176.2 MB, 0.053 ms).

fp32 (``vit_tiny`` without ``--amp``, the default precision) runs every
product on the tensor cores as three tf32 products (``csrc/tf32x3.cuh``:
each operand split into a tf32 big and small part, fp32 accuracy), one
warpgroup a block for 64 rows of an item and head.  At the train shape
(B 256, S 64, 3 heads of 64) the kernels are bound by bytes (K10 50.3 MB,
0.015 ms at 3.35 TB/s; K11 88.1 MB, 0.026 ms), so each block copies all of
a tile's inputs at once and forms each product once: the forward's scores
once with the softmax in registers, the dq kernel's S and dP once with
each row's statistics taken from its registers, the dk/dv kernel's S^T and
dP^T once from those statistics.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG_INF = -1e30  # finite "-inf", as the JAX ``_softmax_small``
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
ONE_TILE = 64  # the longest bf16 item the one-tile kernels take: one 64-key wgmma tile
# The tiled bf16 kernels (S > ONE_TILE): keys whose scores a forward block
# (two warpgroups of two 64-key tiles) holds in registers, and whose S and
# dP a dq block (a warpgroup a 64-key tile) holds: four warpgroups at head
# dim 64 for items of at most LONG_ITEM tokens, two otherwise.  Items past
# LONG_ITEM run the kernels' builds with a second sweep over the keys.
LONG_ITEM = 256
FWD_RESIDENT_KEYS = 256
DQ_RESIDENT_KEYS = 256
DQ_RESIDENT_KEYS_LONG = 128


def one_tile(dtype: torch.dtype, seq: int) -> bool:
    """The rule of the C entry points (``csrc/attention_small.cu``): bf16
    items of at most ``ONE_TILE`` tokens run the one-tile kernels."""
    return dtype == torch.bfloat16 and seq <= ONE_TILE


def kernel_symbols(dtype: torch.dtype, seq: int) -> dict[str, tuple[str, ...]]:
    """The CUDA kernels one call of :func:`small_mha_fwd` (``"fwd"``) and of
    :func:`small_mha_bwd` (``"bwd"``) launches for items of ``seq`` tokens
    in ``dtype``, in launch order.

    The tiled bf16 kernels walk the keys a 64-query tile sees (all ``seq``,
    or under causal those up to its last row) once, the scores formed once
    and each row's max and sum taken from the registers, up to the keys
    their blocks hold, and twice past them: ``attn_small_fwd_bf16`` holds
    ``FWD_RESIDENT_KEYS``; ``attn_small_dq_bf16`` holds
    ``DQ_RESIDENT_KEYS`` at head dim 64 for items of at most ``LONG_ITEM``
    tokens and ``DQ_RESIDENT_KEYS_LONG`` otherwise;
    ``attn_small_dkv_bf16`` reads the statistics and walks its query tiles
    once."""
    if one_tile(dtype, seq):
        return {"fwd": ("attn_small_fwd_onetile",), "bwd": ("attn_small_bwd_onetile",)}
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    return {"fwd": (f"attn_small_fwd_{kind}",),
            "bwd": (f"attn_small_dq_{kind}", f"attn_small_dkv_{kind}")}


def row_stats_shape(dtype: torch.dtype, rows: int, heads: int, seq: int):
    """Shape of the fp32 scratch :func:`small_mha_bwd` hands its kernels
    for each query row's max, sum and ``Σ dp·P`` (``rows`` packed rows of
    items of ``seq`` tokens), or None where one kernel computes all of K11
    and no statistic leaves it."""
    return None if one_tile(dtype, seq) else (rows, heads, 3)


def _items(t: torch.Tensor, seq: int) -> torch.Tensor:
    """(B·S, D) rows → (B, S, D) fp32."""
    rows, d = t.shape
    return t.reshape(rows // seq, seq, d).float()


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float, causal: bool = False) -> torch.Tensor:
    """fp32 (B, S, S) softmax probabilities of fp32 (B, S, D) q and k
    (``_head_probs``): scores times ``scale``, under ``causal`` the keys
    past each row set to -1e30, max-shifted, ``e / Σe``."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full((), _NEG_INF, device=s.device))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _fwd_items(q, k, v, scale: float, causal: bool, dtype: torch.dtype) -> torch.Tensor:
    """fp32 (B, S, D) output of fp32 items whose values are ``dtype``'s,
    before its rounding to ``dtype``."""
    p = _probs(q, k, scale, causal).to(dtype).float()
    return torch.einsum("bqk,bkd->bqd", p, v)


def _bwd_items(q, k, v, do, scale: float, causal: bool, dtype: torch.dtype):
    """fp32 (dq, dk, dv) of fp32 items, before their rounding to ``dtype``."""
    pf = _probs(q, k, scale, causal)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = pf * (dp - (dp * pf).sum(-1, keepdim=True))
    ds = (ds * scale).to(dtype).float()
    p = pf.to(dtype).float()
    dq = torch.einsum("bqk,bkd->bqd", ds, k)
    dk = torch.einsum("bqk,bqd->bkd", ds, q)
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    return dq, dk, dv


def head_fwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, seq: int,
             scale: float, causal: bool = False) -> torch.Tensor:
    """One head's attention: ``qh``/``kh``/``vh`` are (B·S, D) rows of
    ``B`` items of ``seq`` tokens each; returns (B·S, D) in ``qh``'s dtype."""
    q, k, v = (_items(t, seq) for t in (qh, kh, vh))
    return _fwd_items(q, k, v, scale, causal, qh.dtype).to(qh.dtype).reshape(qh.shape)


def head_bwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, doh: torch.Tensor,
             seq: int, scale: float, causal: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One head's (dq, dk, dv) for the output cotangent ``doh``, all (B·S, D)
    in ``qh``'s dtype, with P recomputed as :func:`head_fwd` forms it."""
    grads = _bwd_items(*(_items(t, seq) for t in (qh, kh, vh, doh)), scale, causal, qh.dtype)
    return tuple(t.to(qh.dtype).reshape(qh.shape) for t in grads)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) → (B·H, S, D) fp32 items."""
    b, s, h, d = t.shape
    return t.float().transpose(1, 2).reshape(b * h, s, d)


def _bshd(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B·H, S, D) fp32 items → (B, S, H, D) contiguous in ``like``'s dtype."""
    b, s, h, d = like.shape
    return t.reshape(b, h, s, d).transpose(1, 2).to(like.dtype).contiguous()


def small_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """Self-attention over ``(B, S, H, D)`` with the numerics of the JAX
    ``head_fwd``, per (item, head): the plain version of K10."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    o = _fwd_items(*(_heads_first(t) for t in (q, k, v)), scale, causal, q.dtype)
    return _bshd(o, q)


def small_mha_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = False,
                            scale: float | None = None):
    """``(dq, dk, dv)`` of :func:`small_mha_reference` for the output
    cotangent ``do``, all ``(B, S, H, D)`` in ``q``'s dtype, with the
    numerics of the JAX ``head_bwd``: the plain version of K11."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    grads = _bwd_items(*(_heads_first(t) for t in (q, k, v, do)), scale, causal, q.dtype)
    return tuple(_bshd(g, q) for g in grads)


def _heads(qkv: torch.Tensor, seq: int, heads: int) -> tuple[int, int]:
    """(dim, head dim) of a packed (B·S, 3·dim) qkv, checked."""
    rows, three_dim = qkv.shape
    dim = three_dim // 3
    if three_dim % 3 or dim % heads or rows % seq:
        raise ValueError(
            f"packed qkv {tuple(qkv.shape)} does not split into 3 x {heads} heads "
            f"over items of {seq} tokens"
        )
    return dim, dim // heads


def _head_columns(qkv: torch.Tensor, dim: int, d: int, h: int) -> list[torch.Tensor]:
    return [qkv[:, j * dim + h * d:j * dim + (h + 1) * d] for j in range(3)]


def packed_attention_reference(
    qkv: torch.Tensor, *, seq: int, heads: int, scale: float | None = None
) -> torch.Tensor:
    """Multi-head attention of the packed ``(B·S, 3·dim)`` projections
    (q, k, v side by side, each ``heads`` columns blocks of ``dim // heads``)
    → ``(B·S, dim)`` in ``qkv``'s dtype, head-major columns as the output
    projection reads them."""
    dim, d = _heads(qkv, seq, heads)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    outs = [head_fwd(*_head_columns(qkv, dim, d, h), seq, scale) for h in range(heads)]
    return torch.cat(outs, dim=1)


def packed_attention_bwd_reference(
    qkv: torch.Tensor, do: torch.Tensor, *, seq: int, heads: int,
) -> torch.Tensor:
    """The backward of :func:`packed_attention_reference`: the output
    cotangent ``do`` (B·S, dim) → ``dqkv`` (B·S, 3·dim) in ``qkv``'s dtype,
    in the packed layout (dq | dk | dv, heads head-major in each)."""
    dim, d = _heads(qkv, seq, heads)
    scale = 1.0 / math.sqrt(d)
    grads = [
        head_bwd(*_head_columns(qkv, dim, d, h), do[:, h * d:(h + 1) * d], seq, scale)
        for h in range(heads)
    ]
    return torch.cat([g[j] for j in range(3) for g in grads], dim=1)


# ------------------------------------------------------------------ card


def _packed_head_dim(name: str, tensors, seq: int, heads: int) -> int:
    """The head dim of packed ``(B·S, H·D)`` tensors of one shape, checked."""
    shape = tensors[0].shape
    if len(shape) != 2 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{name} takes 2-D tensors of one shape, got {[tuple(t.shape) for t in tensors]}")
    rows, dim = shape
    if seq <= 0 or rows % seq or dim % heads:
        raise ValueError(
            f"{name}: ({rows}, {dim}) rows are not whole items of {seq} tokens "
            f"and {heads} heads"
        )
    return dim // heads


def _unpacked(t: torch.Tensor, seq: int, heads: int) -> torch.Tensor:
    rows, dim = t.shape
    return t.reshape(rows // seq, seq, heads, dim // heads)


def _check_card(name: str, tensors, d: int) -> None:
    """Raise on what the CUDA kernels do not take."""
    q = tensors[0]
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(f"{name} runs on one CUDA device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in KERNEL_DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"{name} kernels take bf16 or fp32 tensors of one dtype, got "
            + "/".join(str(t.dtype) for t in tensors)
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernels take head dims {KERNEL_HEAD_DIMS}, got {d}")


def _c_args(n_ptr: int) -> list:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return [ptr] * n_ptr + [i32] * 4 + [ctypes.c_float, i32, i32, ptr]


def small_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, seq: int,
                  heads: int, causal: bool = False, scale: float | None = None) -> torch.Tensor:
    """K10: attention of the packed ``(B·S, H·D)`` q, k, v rows, returned
    in that layout.  On the card one CUDA kernel (:func:`kernel_symbols`):
    bf16 at S ≤ ``ONE_TILE`` ``attn_small_fwd_onetile``, one warpgroup per
    item and head; longer bf16 items ``attn_small_fwd_bf16`` (two
    warpgroups splitting the key tiles, every product a ``wgmma``, the
    scores formed once up to ``FWD_RESIDENT_KEYS``) and fp32
    ``attn_small_fwd_f32``, a block per item, head and 64-query tile.  The
    fp32 kernel (3xTF32 ``wgmma``, replacing the TPU ``_fwd_kernel``) is
    bound by bytes and forms the scores once: K as natural slots and V as
    transposed ones, copied together, S = Q·Kᵀ, the softmax in registers
    (online past one 64-key tile), O = P·V.  A CPU tensor takes
    :func:`small_mha_reference`.
    ``small_mha_fwd.launches`` counts the kernel's launches."""
    from . import _build

    d = _packed_head_dim("small_mha_fwd", (q, k, v), seq, heads)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if q.device.type == "cpu":
        o = small_mha_reference(*(_unpacked(t, seq, heads) for t in (q, k, v)),
                                causal=causal, scale=scale)
        return o.reshape(q.shape)
    from .vit_block import _operand, _stream

    _check_card("small_mha_fwd", (q, k, v), d)
    q, k, v = (_operand(t) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = _build.load("attention_small", _c_args(4), symbol="attention_small_fwd")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 q.shape[0] // seq, seq, heads, d, float(scale), int(causal),
                 int(q.dtype == torch.bfloat16), _stream(q))
    if err != 0:
        raise RuntimeError(f"attention_small_fwd launch failed: CUDA error {err}")
    small_mha_fwd.launches += 1
    return out


small_mha_fwd.launches = 0


def small_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
                  seq: int, heads: int, causal: bool = False, scale: float | None = None):
    """K11: ``(dq, dk, dv)`` of :func:`small_mha_fwd` for the output
    cotangent ``do``, all packed ``(B·S, H·D)``.  On the card
    (:func:`kernel_symbols`): bf16 at S ≤ ``ONE_TILE`` one CUDA kernel,
    ``attn_small_bwd_onetile``, computes all three gradients of an item
    and head, and no scratch is allocated; longer bf16 items and fp32
    launch two, ``attn_small_dq_*`` (dq and each query row's softmax
    statistics, into a scratch buffer) and then ``attn_small_dkv_*`` (dk
    and dv, reading them).  No atomics: each block owns its output rows.
    In bf16 both are ``wgmma`` kernels: the dq kernel, persistent over the
    64-query tiles with the next tile's copies under this one's products,
    forms S and dP once a key tile (a warpgroup each) up to its resident
    keys (:func:`kernel_symbols`); the dk/dv kernel streams the query tiles
    and their statistics through a two-stage ring.
    In fp32 both are 3xTF32 ``wgmma`` kernels (replacing the TPU
    ``_bwd_kernel``), bound by bytes: the dq kernel forms S and dP once and
    at one key tile takes each row's max, sum and Σ dp·P from its registers
    (past one, from a first pass over the tiles); the dk/dv kernel forms Sᵀ
    and dPᵀ once for each 32-query tile and reads the statistics back.
    A CPU tensor takes :func:`small_mha_bwd_reference`.
    ``small_mha_bwd.launches`` counts the calls."""
    from . import _build

    d = _packed_head_dim("small_mha_bwd", (q, k, v, do), seq, heads)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if q.device.type == "cpu":
        grads = small_mha_bwd_reference(*(_unpacked(t, seq, heads) for t in (q, k, v, do)),
                                        causal=causal, scale=scale)
        return tuple(g.reshape(q.shape) for g in grads)
    from .vit_block import _operand, _ptr, _stream

    _check_card("small_mha_bwd", (q, k, v, do), d)
    q, k, v, do = (_operand(t) for t in (q, k, v, do))  # autograd may hand a strided do
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats_shape = row_stats_shape(q.dtype, q.shape[0], heads, seq)
    stats = None if stats_shape is None else torch.empty(stats_shape, device=q.device)
    fn = _build.load("attention_small", _c_args(8), symbol="attention_small_bwd")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), _ptr(stats), q.shape[0] // seq, seq,
                 heads, d, float(scale), int(causal), int(q.dtype == torch.bfloat16), _stream(q))
    if err != 0:
        raise RuntimeError(f"attention_small_bwd launch failed: CUDA error {err}")
    small_mha_bwd.launches += 1
    return dq, dk, dv


small_mha_bwd.launches = 0


class _SmallMHA(torch.autograd.Function):
    """The JAX ``_small_core`` custom VJP over the packed rows: saves q, k
    and v only (no lse, no P), and recomputes P in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, seq: int, heads: int, causal: bool, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(seq=seq, heads=heads, causal=causal, scale=scale)
        return small_mha_fwd(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*small_mha_bwd(q, k, v, do, **ctx.args), None, None, None, None)


def small_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float | None = None,
    block_items: int | None = None,
) -> torch.Tensor:
    """Short-sequence self-attention over ``(B, S, H, D)`` (bshd),
    differentiable in q, k and v: K10 forward and K11 backward on the card,
    their plain versions on the CPU.  Requires ``S % 8 == 0`` and
    ``D % 8 == 0``, and q, k, v of one shape (self-attention).

    ``block_items`` is the TPU kernel's stacking factor ``tb``, accepted for
    the JAX signature; it has no effect on the result, because per-item
    attention is the same function for every ``tb``.
    """
    del block_items
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"small_mha is self-attention only: q {tuple(q.shape)} vs k {tuple(k.shape)} "
            f"/ v {tuple(v.shape)}"
        )
    if s % 8 or d % 8:
        raise ValueError(f"small_mha needs S, D multiples of 8; got {s}, {d}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale

    def pack(x):
        return x.reshape(b * s, h * d)  # adjacent dims: free for the projections

    return _SmallMHA.apply(pack(q), pack(k), pack(v), s, h, causal, scale).reshape(b, s, h, d)
