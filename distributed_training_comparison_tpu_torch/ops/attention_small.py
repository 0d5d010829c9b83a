"""Short-sequence attention over the packed projection layout: the numerics
of ``distributed_training_comparison_tpu/ops/attention_small.py``
(``_softmax_small``, ``_head_probs``, ``head_fwd``, ``head_bwd``) as plain
PyTorch.

Per (item, head): fp32 scores times 1/√d, a max-shifted fp32 softmax
``e / Σe``, P rounded to the compute dtype, P·V accumulated in fp32 and
rounded once.  The backward recomputes P the same way: ``dp = dO·Vᵀ`` in
fp32, ``ds = P∘(dp − Σ dp∘P)`` on the unrounded P, ``ds·scale`` rounded to
the compute dtype, and dq, dk, dv each accumulated in fp32 and rounded once.
This is the attention stage of the fused ViT block (K5, K6) and the plain
version its CUDA kernels ``block_attention`` and ``block_attention_bwd``
are held against.

The TPU kernel stacks ``tb`` items into one ``(tb·S, tb·S)`` score matmul
masked block-diagonally to fill its matrix unit; off-diagonal blocks add
exact zeros, so per-item attention is the same function, and that is what
this module computes.  Non-causal only, as K5 is.
"""

from __future__ import annotations

import math

import torch


def _items(t: torch.Tensor, seq: int) -> torch.Tensor:
    """(B·S, D) rows → (B, S, D) fp32."""
    rows, d = t.shape
    return t.reshape(rows // seq, seq, d).float()


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 (B, S, S) softmax probabilities of fp32 (B, S, D) q and k
    (``_head_probs``): scores times ``scale``, max-shifted, ``e / Σe``."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def head_fwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, seq: int,
             scale: float) -> torch.Tensor:
    """One head's attention: ``qh``/``kh``/``vh`` are (B·S, D) rows of
    ``B`` items of ``seq`` tokens each; returns (B·S, D) in ``qh``'s dtype."""
    q, k, v = (_items(t, seq) for t in (qh, kh, vh))
    p = _probs(q, k, scale).to(qh.dtype)
    o = torch.einsum("bqk,bkd->bqd", p.float(), v)
    return o.to(qh.dtype).reshape(qh.shape)


def head_bwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, doh: torch.Tensor,
             seq: int, scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One head's (dq, dk, dv) for the output cotangent ``doh``, all (B·S, D)
    in ``qh``'s dtype, with P recomputed as :func:`head_fwd` forms it."""
    cd = qh.dtype
    q, k, v, do = (_items(t, seq) for t in (qh, kh, vh, doh))
    pf = _probs(q, k, scale)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    ds = pf * (dp - (dp * pf).sum(-1, keepdim=True))
    ds = (ds * scale).to(cd).float()
    p = pf.to(cd).float()
    dq = torch.einsum("bqk,bkd->bqd", ds, k)
    dk = torch.einsum("bqk,bqd->bkd", ds, q)
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    return tuple(t.to(cd).reshape(qh.shape) for t in (dq, dk, dv))


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
